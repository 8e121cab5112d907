"""Collective lowerings for combo channels and streaming.

Port of the JAX package's ``parallel/collectives.py``.  The mapping
(SURVEY.md §2.6):

| RPC construct            | collective lowering                   |
|--------------------------|---------------------------------------|
| ParallelChannel broadcast + merge | psum / all_gather over "chip" |
| PartitionChannel scatter/reshard  | all_to_all over "chip"        |
| Streaming RPC ring (long payload) | ppermute neighbor exchange    |
| Backup request (hedged read)      | psum of first-valid mask      |

The JAX package writes each as a jitted ``shard_map`` program over a
``jax.sharding.Mesh``.  Here the mesh is single-controller too
(``parallel/mesh.py``): one process drives every chip, a value split
over the mesh is a :class:`ShardedTensor` (each chip's shard on that
chip's device, in mesh order), and each lowering is torch ops across
those devices, run per group of chips along the named axis (the chips
that share every other mesh coordinate).  A shard that another chip
needs moves with ``.to(device)``: nothing on one card, a peer copy
across cards.

Two rules make the merges reproducible:

* **The psum adds in chip order**: chip 0's partial first, then one
  in-place add per chip in order (:func:`psum_in_order`), so it is
  bit-equal to the plain loop that adds the same partials in that
  order.  JAX's psum order is its own, so against JAX a sum agrees
  within float32 rounding.
* **A replicated output (``P()``) is a ShardedTensor marked
  replicated**: every chip's entry is the group's one result, shared
  by the chips of that device and copied to other devices.  ``full()``
  gives the logical value.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: per tensor dim, the mesh axis it
    is split over (a name, a tuple of names, or None); dims past the
    spec's length are not split."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _coords(mesh) -> List[tuple]:
    """Every chip's mesh index, in mesh (row-major) order."""
    return list(np.ndindex(mesh.devices.shape))


def _block(mesh, coord, spec, shape) -> tuple:
    """The slices of a ``shape`` tensor that chip ``coord`` holds under
    ``spec`` (ValueError when a dim does not divide)."""
    index = []
    for d, size in enumerate(shape):
        axes = _axes(spec[d]) if d < len(spec) else ()
        if not axes:
            index.append(slice(None))
            continue
        n, k = 1, 0
        for a in axes:
            pos = mesh.axis_names.index(a)
            n *= mesh.devices.shape[pos]
            k = k * mesh.devices.shape[pos] + coord[pos]
        if size % n:
            raise ValueError(
                f"dim {d} of size {size} does not split over {axes} ({n} chips)"
            )
        step = size // n
        index.append(slice(k * step, (k + 1) * step))
    return tuple(index)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    return torch.from_numpy(np.ascontiguousarray(a) if a.flags.writeable
                            else np.array(a, order="C"))


class ShardedTensor:
    """A logical tensor split over a mesh by ``spec``: ``shards`` holds
    one tensor per chip in mesh order (the counterpart of
    ``jax.Array.addressable_shards``), each on that chip's device.
    ``full()`` assembles the logical tensor."""

    __slots__ = ("mesh", "spec", "shards", "shape", "dtype")

    def __init__(self, mesh, spec, shards: Sequence[torch.Tensor], shape):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)
        self.shards = list(shards)
        self.shape = torch.Size(shape)
        self.dtype = self.shards[0].dtype

    @property
    def replicated(self) -> bool:
        return not any(_axes(e) for e in self.spec)

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @property
    def nbytes(self) -> int:
        """The device bytes the shards hold, each buffer counted once
        (replicas on one device may share a buffer)."""
        seen: Dict[tuple, int] = {}
        for s in self.shards:
            seen[(str(s.device), s.data_ptr())] = s.numel() * s.element_size()
        return sum(seen.values())

    def shard_at(self, coord) -> torch.Tensor:
        return self.shards[int(np.ravel_multi_index(coord, self.mesh.devices.shape))]

    def full(self, device=None) -> torch.Tensor:
        """The logical tensor on ``device`` (default: the first chip's):
        a fresh tensor assembled from the shards, or for a replicated
        value the first chip's copy."""
        dev = torch.device(device) if device is not None else self.device
        if self.replicated:
            return self.shards[0].to(dev)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        done = set()
        for coord, shard in zip(_coords(self.mesh), self.shards):
            index = _block(self.mesh, coord, self.spec, self.shape)
            key = tuple((s.start, s.stop) for s in index)
            if key not in done:
                done.add(key)
                out[index].copy_(shard)
        return out

    def __repr__(self) -> str:
        return (f"ShardedTensor({tuple(self.shape)}, {self.dtype}, {self.spec}, "
                f"{len(self.shards)} shards)")


def shard_tensor(x, mesh, spec) -> ShardedTensor:
    """Split ``x`` (a tensor or numpy array) over ``mesh`` by ``spec``:
    each chip gets its block as a contiguous copy of its own on its
    device, as ``jax.device_put`` to a ``NamedSharding`` copies (a shard
    is never a view that keeps the whole of ``x`` alive).  The
    counterpart of the JAX package's ``shard_map_relaxed`` in_specs."""
    t = _as_tensor(x)
    shards = []
    for coord in _coords(mesh):
        block = t[_block(mesh, coord, spec, t.shape)]
        shard = torch.empty(block.shape, dtype=t.dtype, device=mesh.devices[coord])
        shard.copy_(block)
        shards.append(shard)
    return ShardedTensor(mesh, spec, shards, t.shape)


def _as_sharded(x, mesh, spec) -> Tuple[ShardedTensor, bool]:
    """(x split over mesh by spec, whether its shards are fresh copies
    the lowering may overwrite)."""
    if isinstance(x, ShardedTensor):
        if x.mesh is mesh and x.spec == PartitionSpec(*spec):
            return x, False
        x = x.full()
    return shard_tensor(x, mesh, spec), True


def groups(mesh, axis: str) -> List[List[tuple]]:
    """The chips that run one collective over ``axis`` together: each
    group shares every other mesh coordinate, in ``axis`` order."""
    pos = mesh.axis_names.index(axis)
    n = mesh.devices.shape[pos]
    rest = mesh.devices.shape[:pos] + mesh.devices.shape[pos + 1:]
    return [[other[:pos] + (k,) + other[pos:] for k in range(n)]
            for other in np.ndindex(rest)]


def psum_in_order(parts: Sequence[torch.Tensor], owned: bool = False) -> torch.Tensor:
    """The psum of ``parts`` (chip order) on the first part's device:
    chip 0's partial, then one in-place add per chip in order.  With
    ``owned`` the first partial is the accumulator itself; otherwise it
    is copied first, and no input is written."""
    acc = parts[0] if owned else parts[0].clone()
    for p in parts[1:]:
        acc.add_(p.to(acc.device))
    return acc


def _pmax(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    acc = parts[0]
    for p in parts[1:]:
        acc = torch.maximum(acc, p.to(acc.device))
    return acc


def _replicate(mesh, per_group: Dict[tuple, torch.Tensor], shape) -> ShardedTensor:
    """A P() output: every chip's entry is its group's result, shared on
    that device, copied to another device."""
    shards = [per_group[c] if per_group[c].device == mesh.devices[c]
              else per_group[c].to(mesh.devices[c]) for c in _coords(mesh)]
    return ShardedTensor(mesh, P(), shards, shape)


def _traced(fn: Callable, op: str, axis: str) -> Callable:
    """Wrap a collective so each invocation inside a traced RPC leaves
    an rpcz sub-span (kind "collective") under the active task-local
    span — a fan-out RPC whose merge lowers to a collective shows the
    leg in its trace.  Outside any RPC (a plain training loop) no span
    is created: parentless spans at kHz step rates would drown the
    Collector's sampling budget and churn the /rpcz ring.  The span
    brackets dispatch (the card executes asynchronously; device time
    shows up in the profiler, not here)."""

    from incubator_brpc_tpu_torch.observability.span import Span

    label = f"{op}@{axis}"

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        span = Span.create_collective("collective", label)
        try:
            out = fn(*args, **kwargs)
        except Exception:
            if span is not None:
                span.end(1)
            raise
        if span is not None:
            span.end(0)
        return out

    return wrapper


def parallel_merge(mesh, axis: str = "chip", op: str = "sum") -> Callable:
    """ParallelChannel merge: every node holds a sub-response shard
    [*, ...]; returns the fused merged response replicated on all nodes
    (psum, pmean or pmax over the axis)."""

    def merged(x):
        if op not in ("sum", "mean", "max"):
            raise ValueError(op)
        xs, owned = _as_sharded(x, mesh, P(axis))
        out: Dict[tuple, torch.Tensor] = {}
        for group in groups(mesh, axis):
            parts = [xs.shard_at(c) for c in group]
            if op == "max":
                r = _pmax(parts)
            else:
                r = psum_in_order(parts, owned)
                if op == "mean":
                    r.div_(len(parts))
            out.update((c, r) for c in group)
        return _replicate(mesh, out, r.shape)

    return _traced(merged, f"psum_{op}", axis)


def parallel_broadcast_gather(mesh, axis: str = "chip") -> Callable:
    """ParallelChannel fan-out with concat merge: each node contributes
    its shard; all nodes receive the concatenation (AllGather)."""

    def gather(x):
        xs, _ = _as_sharded(x, mesh, P(axis))
        out: Dict[tuple, torch.Tensor] = {}
        for group in groups(mesh, axis):
            dev = mesh.devices[group[0]]
            r = torch.cat([xs.shard_at(c).to(dev) for c in group])
            out.update((c, r) for c in group)
        return _replicate(mesh, out, r.shape)

    return _traced(gather, "all_gather", axis)


def partition_reshard(mesh, axis: str = "chip") -> Callable:
    """PartitionChannel re-partitioning: switch which dimension is
    sharded across the partition group (AllToAll) — the collective form
    of DynamicPartitionChannel migrating partition schemes
    (partition_channel.h:54-110).  Chip i receives column block i of
    every chip's rows, in chip order."""

    def reshard(x):  # x: [rows, cols] sharded on rows; out: cols sharded
        xs, _ = _as_sharded(x, mesh, P(axis, None))
        out: Dict[tuple, torch.Tensor] = {}
        for group in groups(mesh, axis):
            n = len(group)
            local = [xs.shard_at(c) for c in group]
            cols = local[0].shape[1] // n
            if cols * n != local[0].shape[1]:
                raise ValueError(f"{local[0].shape[1]} columns do not split over {n} chips")
            for i, c in enumerate(group):
                dev = mesh.devices[c]
                out[c] = torch.cat([p[:, i * cols:(i + 1) * cols].to(dev) for p in local])
        shards = [out[c] for c in _coords(mesh)]
        n = mesh.shape[axis]
        return ShardedTensor(mesh, P(axis, None), shards,
                             (n * shards[0].shape[0], shards[0].shape[1]))

    return _traced(reshard, "all_to_all", axis)


def ring_stream(mesh, axis: str = "chip", hops: Optional[int] = None) -> Callable:
    """Streaming RPC's neighbor pipeline: pass chunks around the ICI
    ring with ppermute (the collective form of flow-controlled
    StreamWrite chains). Each hop both forwards the buffer and folds it
    into a running accumulator, so after N-1 hops every node has seen
    every shard while only ever holding one."""

    def ring(x):
        xs, _ = _as_sharded(x, mesh, P(axis))
        out: Dict[tuple, torch.Tensor] = {}
        for group in groups(mesh, axis):
            n = len(group)
            devs = [mesh.devices[c] for c in group]
            bufs = [xs.shard_at(c) for c in group]
            accs = list(bufs)
            for _ in range((n - 1) if hops is None else hops):
                # chip k receives chip k-1's buffer (perm i -> i+1)
                bufs = [bufs[(k - 1) % n].to(devs[k]) for k in range(n)]
                accs = [a + b for a, b in zip(accs, bufs)]
            out.update(zip(group, accs))
        return ShardedTensor(mesh, P(axis), [out[c] for c in _coords(mesh)], xs.shape)

    return _traced(ring, "ppermute_ring", axis)


def hedged_first_valid(mesh, axis: str = "chip") -> Callable:
    """Backup-request merge on tensors: each replica offers (response,
    valid flag); every node gets the response of the lowest-indexed
    valid replica (hedged read).  The pick stays on the card: a score
    per chip, their running minimum, and the psum of the one
    contribution left."""

    def pick(x, valid):
        xs, _ = _as_sharded(x, mesh, P(axis))
        vs, _ = _as_sharded(valid, mesh, P(axis))
        out: Dict[tuple, torch.Tensor] = {}
        for group in groups(mesh, axis):
            n = len(group)
            # a replica is valid if any of its flag elements is set;
            # valid replicas rank by index, invalid ones past the end
            scores = [torch.where(vs.shard_at(c).max() > 0, k, n + 1)
                      for k, c in enumerate(group)]
            best = scores[0]
            for s in scores[1:]:
                best = torch.minimum(best, s.to(best.device))
            contrib = []
            for s, c in zip(scores, group):
                x_c = xs.shard_at(c)
                contrib.append(torch.where(s == best.to(s.device), x_c,
                                           torch.zeros_like(x_c)))
            r = psum_in_order(contrib, owned=True)
            out.update((c, r) for c in group)
        return _replicate(mesh, out, r.shape)

    return _traced(pick, "hedged_first_valid", axis)
