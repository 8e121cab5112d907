"""Sharded FusedKernel — the batched device op lowered over a mesh.

Port of the JAX package's ``batching/sharded.py`` (docs/sharded_ps.md):
``FusedKernel`` fuses N coalesced requests into ONE device execution on
one chip; ``ShardedFusedKernel`` lowers the same padded batch onto a
mesh, so the parameter operand lives sharded across every chip's
memory and the batch executes as ONE sharded computation whose
cross-shard partial results merge via a SINGLE collective (the psum
over the "chip" axis).

For the flagship ``Y = X @ W``:

  W  : (d_in, d_out)  sharded P(axis, None)   — each chip holds
                      d_in/n rows; per-chip memory, not one chip's,
                      bounds the servable parameter size
  X  : (bucket, d_in) sharded P(None, axis)   — the contraction dim
                      splits so each chip contracts its own W rows
  Y  : partial (bucket, d_out) per chip → psum(axis) → full Y
                      (ONE collective merge per batch)

The mesh is single-controller (``parallel/mesh.py``): one process
places each chip's rows on that chip's device, uploads each chip's
columns of X, runs one ``torch.matmul`` per chip (the JAX package
leaves the product to XLA outside any Pallas kernel, so it has no
hand-written counterpart; TF32 stays off) and adds the partials in
chip order (``parallel/collectives.psum_in_order``).  A parameter runs
on the mesh it was placed on: after ``remesh`` an old placement still
executes on its own chips, never through a cross-mesh transfer, until
its owner re-places it.

Proof hooks ("asserted via step-log count, not timing"):

* ``executions`` / ``collective_merges`` — host-side step log, one
  increment per fused call.  The bench-smoke guard pins
  ``executions == batches`` so a silently-unsharded fallback (N
  per-row executions) fails loudly.
* an rpcz sub-span (kind "collective", method ``psum_forward@<axis>``)
  per call, parented to the active request trace — a batched sharded
  Forward reads as one trace with exactly one collective leg.

Chaos: the merge dispatch is a registered injection site
(``collective.merge``: delay_us stretches the dispatch, reset fails
it).  A reset surfaces as ONE exception per batch which the caller
maps to per-row ERPC errors — batch-mates in other groups still
execute.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from incubator_brpc_tpu_torch.batching import fused as _fused
from incubator_brpc_tpu_torch.chaos import injector as _chaos
from incubator_brpc_tpu_torch.observability.profiling import hbm_account, kernel_section
from incubator_brpc_tpu_torch.parallel.collectives import (
    P,
    ShardedTensor,
    groups,
    psum_in_order,
    shard_tensor,
)

_STAGE_ACCT = hbm_account("sharded.batch_stage")


class CollectiveMergeError(RuntimeError):
    """An injected (or real) failure of the cross-shard merge; the
    batch handler maps it to per-row ERPC errors."""


def shardable_rows(shape, mesh, axis: str = "chip") -> bool:
    """True when a parameter of `shape` can row-shard over `axis`:
    2D with the leading (contraction) dim divisible by the axis size.
    Indivisible shapes stay on the single-chip path rather than pay a
    ragged-shard layout."""
    if mesh is None or len(shape) != 2:
        return False
    n = int(mesh.shape.get(axis, 1))
    return n > 1 and int(shape[0]) % n == 0


class ShardedFusedKernel:
    """The sharded variant of ``FusedKernel`` for the batched product.

        K = ShardedFusedKernel(mesh)          # axes ("slice","chip")
        W = K.shard_param(w)                  # rows spread over "chip"
        Y = K(W, X_padded)                    # ONE sharded execution,
                                              # ONE psum merge

    Shares the module trace counter with the unsharded kernels: one
    trace per first-seen padded batch signature on a mesh, so the
    padding buckets bound its count the same way
    (``fused.trace_count()`` diffs stay assertable).
    """

    def __init__(self, mesh, axis: str = "chip",
                 label: str = "PsService.Forward"):
        self.mesh = mesh
        self.axis = axis
        # chaos-match + rpcz label: the method whose batches run here
        self.label = label
        self._seen: set = set()
        self._lock = threading.Lock()
        # step log (see module docstring): one sharded device execution
        # and one collective merge per __call__, by construction —
        # tests and the bench-smoke guard count these, never timing
        self.executions = 0
        self.collective_merges = 0

    # ---- placement ---------------------------------------------------------
    def shard_param(self, w) -> ShardedTensor:
        """Place `w` (a tensor, a numpy array or a ShardedTensor of
        another placement) row-sharded over the mesh axis: each chip
        holds shape[0]/n rows, a contiguous copy on its device.  Raises
        ValueError for shapes that cannot shard — callers fall back to
        the single-chip store."""
        if not shardable_rows(getattr(w, "shape", ()), self.mesh, self.axis):
            raise ValueError(
                f"shape {getattr(w, 'shape', None)} cannot row-shard over "
                f"{self.axis!r} (size {self.mesh.shape.get(self.axis)})"
            )
        if isinstance(w, ShardedTensor):
            w = w.full()
        return shard_tensor(w, self.mesh, P(self.axis, None))

    def n_shards(self) -> int:
        return int(self.mesh.shape[self.axis])

    def remesh(self, mesh, axis: Optional[str] = None) -> None:
        """Re-target the kernel at a new mesh live (the server half of
        a scheme migration, docs/resharding.md): swap the mesh/axis and
        forget the traced signatures, so the next batch counts a trace
        on the new topology.  Callers must re-``shard_param`` stored
        parameters; until then an old placement runs on its own mesh.
        Step-log counters survive (the migration proof reads executions
        across the cutover)."""
        with self._lock:
            self.mesh = mesh
            if axis is not None:
                self.axis = axis
            self._seen = set()

    # ---- the fused sharded execution ---------------------------------------
    def __call__(self, w: ShardedTensor, x) -> torch.Tensor:
        """One padded batch: ``x`` (bucket, d_in) host array or tensor,
        ``w`` the shard_param()-placed parameter.  Returns the full
        (bucket, d_out) result, the replicated output's copy on the
        first chip's device."""
        from incubator_brpc_tpu_torch.observability.span import Span

        if _chaos.armed:
            spec = _chaos.check("collective.merge", method=self.label)
            if spec is not None:
                if spec.action == "delay_us":
                    _chaos.sleep_us(spec.arg)
                elif spec.action == "reset":
                    raise CollectiveMergeError(
                        "chaos: cross-shard collective merge reset"
                    )
        mesh, axis = w.mesh, w.spec[0]
        # one trace per new (padded shape, dtype) on this mesh
        _fused._first_seen(self._seen, (id(mesh),) + _fused._signature((x,)))
        # split the contraction dim so each chip contracts against its
        # own rows of W; each chip's columns of the batch ship once
        xs = shard_tensor(x, mesh, P(None, axis))
        # HBM ledger: the staged batch pins device memory for the call
        charged = _STAGE_ACCT.adopt(xs)
        # rpcz: the merge leg under the active request trace (outside
        # any RPC no span is created — same rule as parallel/collectives)
        span = Span.create_collective("collective", f"psum_forward@{axis}")
        try:
            # device-time attribution: the sharded dispatch window (the
            # caller's pull owns the wider family)
            with kernel_section(f"sharded.{self.label}"):
                merged = []
                for group in groups(mesh, axis):
                    parts = [_fused.promoted_matmul(w.shard_at(c), xs.shard_at(c))
                             for c in group]
                    # THE single cross-shard merge of the batch
                    merged.append(psum_in_order(parts, owned=True))
                out = merged[0]
        except Exception:
            if span is not None:
                span.end(1)
            raise
        finally:
            _STAGE_ACCT.release(charged)
        with self._lock:
            self.executions += 1
            self.collective_merges += 1
        if span is not None:
            span.annotate(
                f"sharded batch {tuple(x.shape)} over {mesh.shape[axis]} "
                f"shards, one psum merge"
            )
            span.end(0)
        return out
