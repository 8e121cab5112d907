"""Carry state from the JAX package into the port.

There are no weights on the echo path: the state carried across is the
payload.  ``tensor_from_reference`` turns a numpy array (for example
``np.asarray`` of a ``jax.Array``) into the port's tensor with the same
dtype, shape and bytes.  numpy has no native bfloat16; JAX hands out
its ``ml_dtypes`` bfloat16, which crosses here bit for bit.
"""

from __future__ import annotations

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
