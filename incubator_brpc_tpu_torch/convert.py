"""Carry state from the JAX package into the port.

``tensor_from_reference`` turns a numpy array (for example
``np.asarray`` of a ``jax.Array``) into the port's tensor with the same
dtype, shape and bytes.  numpy has no native bfloat16; JAX hands out
its ``ml_dtypes`` bfloat16, which crosses here bit for bit.
``params_from_reference`` carries a whole parameter store (the JAX
``PsService``'s stored matrices, key by key) the same way;
``decode_weights_from_reference`` the decode/prefill weight matrix;
``training_state_from_reference`` the JAX ``make_training_step``'s
parameters and batch, split over a port mesh.  A JAX cache value
(uint8 bytes or a float32 KV layer) crosses with
``tensor_from_reference`` too.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from incubator_brpc_tpu_torch.parallel.mesh import device_for_chip


def tensor_from_reference(array, device=None) -> torch.Tensor:
    """A tensor equal to ``array`` on ``device`` (default: the CUDA
    device of chip 0; raises without a card unless a device is given)."""
    a = np.array(array, order="C")  # a writable copy the tensor may own
    dev = device_for_chip(0, device)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(dev)


def params_from_reference(params: Mapping[str, np.ndarray],
                          device=None) -> Dict[str, torch.Tensor]:
    """Each named array of ``params`` as a tensor with its bytes on
    ``device`` (default as for :func:`tensor_from_reference`), ready for
    the port's ``PsService.put_param``."""
    dev = device_for_chip(0, device)
    return {key: tensor_from_reference(a, dev) for key, a in params.items()}


def decode_weights_from_reference(jax_loop, device=None) -> torch.Tensor:
    """The JAX ``DecodeLoop``'s (or ``PrefillService``'s) weight matrix
    ``_w`` as a float32 tensor on ``device`` (default as for
    :func:`tensor_from_reference`): bit for bit what the port's loop
    draws from the same seed and places once."""
    return tensor_from_reference(jax_loop._w, device)


def training_state_from_reference(params: Mapping[str, np.ndarray], x,
                                  mesh) -> Tuple[Dict[str, object], object]:
    """The JAX ``make_training_step``'s ``params`` ({"w1", "w2"}) and
    batch ``x``, given as numpy arrays (``np.asarray`` of the JAX
    step's outputs), as the port's (params, x) on ``mesh``: each a
    ``ShardedTensor`` under the step's shardings, ready for the port's
    ``step_fn``."""
    from incubator_brpc_tpu_torch.models.parameter_server import train_specs
    from incubator_brpc_tpu_torch.parallel.collectives import shard_tensor

    specs = train_specs()
    cpu = torch.device("cpu")
    sharded = {key: shard_tensor(tensor_from_reference(params[key], cpu), mesh, specs[key])
               for key in ("w1", "w2")}
    return sharded, shard_tensor(tensor_from_reference(x, cpu), mesh, specs["x"])
