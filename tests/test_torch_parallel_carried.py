"""The merge ops of ``ops/merge.py``, carried by hand from ``tests/test_parallel.py``.

The JAX file's mesh and collective cases are held by
``tests/test_torch_parallel.py`` (each lowering against the JAX one on the
same values), and its ``__graft_entry__`` cases drive the JAX package's
TPU entry, which the port does not have.  Here the stacked values are
``torch.Tensor``s on the device the case runs on (the CPU, or the card);
on the CPU each merge is held to the JAX package's on the same values.
"""

import numpy as np
import torch

from torch_carry import torch_device  # noqa: F401  (fixture)


def test_ops_merge(torch_device):
    from incubator_brpc_tpu_torch.ops import merge

    values = np.arange(3 * 4, dtype=np.float32).reshape(3, 4)
    stacked = torch.from_numpy(values).to(torch_device)
    valid = torch.tensor([0.0, 1.0, 1.0], device=torch_device)
    assert np.allclose(merge.merge_sum(stacked).cpu(), values.sum(0))
    assert np.allclose(merge.merge_max(stacked).cpu(), values.max(0))
    out = merge.merge_first_valid(stacked, valid)
    assert np.allclose(out.cpu(), values[1])
    cat = merge.merge_concat([stacked, stacked])
    assert cat.shape == (6, 4)
    if torch_device.type == "cpu":
        import jax.numpy as jnp

        from incubator_brpc_tpu.ops import merge as jax_merge

        ref = jnp.asarray(values)
        for got, want in (
            (merge.merge_sum(stacked), jax_merge.merge_sum(ref)),
            (merge.merge_max(stacked), jax_merge.merge_max(ref)),
            (out, jax_merge.merge_first_valid(ref, jnp.array([0.0, 1.0, 1.0]))),
            (cat, jax_merge.merge_concat([ref, ref])),
        ):
            assert got.numpy().tobytes() == np.asarray(want).tobytes()
