"""Response-merge ops for fan-out channels.

Port of the JAX package's ``ops/merge.py``.  ParallelChannel's
ResponseMerger (reference parallel_channel.h:64-103) folds N
sub-responses into one.  When sub-responses are tensors these merges
are single torch ops on the tensors' device (the JAX package jits each
into one XLA op; they are not Pallas kernels).  Inputs may be tensors
or numpy arrays, as the JAX functions take both.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    # a read-only buffer (np.frombuffer of response bytes) is copied:
    # torch tensors are writable
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def merge_sum(stacked) -> torch.Tensor:
    """[N, ...] sub-responses → elementwise sum (AllReduce-style merge),
    in the input's dtype as ``jnp.sum`` keeps it."""
    t = _tensor(stacked)
    return torch.sum(t, dim=0, dtype=None if t.dtype == torch.bool else t.dtype)


def merge_mean(stacked) -> torch.Tensor:
    t = _tensor(stacked)
    return torch.mean(t if t.is_floating_point() else t.float(), dim=0)


def merge_max(stacked) -> torch.Tensor:
    return torch.amax(_tensor(stacked), dim=0)


def merge_concat(parts) -> torch.Tensor:
    """Partition merge: concatenate shards (AllGather-style merge)."""
    return torch.cat([_tensor(p) for p in parts], dim=0)


def merge_first_valid(stacked, valid) -> torch.Tensor:
    """Hedged-read merge: pick the first sub-response flagged valid
    (backup-request semantics on tensor payloads); the first row when
    none is."""
    idx = torch.argmax(_tensor(valid).to(torch.int32))
    return _tensor(stacked)[idx]


def merge_partial_sum(parts) -> torch.Tensor:
    """Shard fan-out merge: each shard contributed a PARTIAL result
    (its rows of the contraction), the full result is their elementwise
    sum — one stack and one sum (the host-side analog of the psum
    collective the in-mesh sharded lowering uses)."""
    return merge_sum(torch.stack([_tensor(p) for p in parts]))
