"""Per-method per-phase latency aggregation behind /latency_breakdown.

Spans carry phase timestamps (observability/span.py PHASE_FIELDS); when
the Collector drain thread persists a span, its phase deltas fold into
one LatencyRecorder per (method, phase) — the same log-bucketed
percentile machinery /status uses, windowed by the 1 Hz bvar sampler.
Aggregation runs entirely off the RPC hot path (the drain thread), so
enabling rpcz costs the stamps, not the statistics.

Also hosts the runtime queue-wait recorders: the scheduler and
ExecutionQueues report time-in-queue here under the ``_runtime``
pseudo-method, closing the queue-in/queue-out leg spans can't see.

The whole family is exported to Prometheus as labeled series
``rpc_phase_latency_us{method=...,phase=...,stat=...}`` through a
MultiDimension façade the /metrics exposition walks.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

from incubator_brpc_tpu_torch.metrics.latency_recorder import LatencyRecorder
from incubator_brpc_tpu_torch.metrics.multi_dimension import MultiDimension

# distinct methods tracked before new ones collapse into "_other"
# (unbounded method names would leak recorders under hostile traffic)
_MAX_METHODS = 128

_lock = threading.Lock()
_recorders: Dict[Tuple[str, str], LatencyRecorder] = {}
_methods: set = set()


def recorder(method: str, phase: str) -> LatencyRecorder:
    key = (method, phase)
    rec = _recorders.get(key)
    if rec is not None:
        return rec
    with _lock:
        if method not in _methods and len(_methods) >= _MAX_METHODS:
            method = "_other"  # over the cap: collapse, don't grow
            key = (method, phase)
        rec = _recorders.get(key)
        if rec is None:
            _methods.add(method)
            rec = _recorders[key] = LatencyRecorder()
        return rec


def _method_key(span) -> str:
    """Aggregation key for one span. Collective legs carry per-pair
    method names ('slice0/chip1->slice0/chip2') — unbounded label
    cardinality on a pod — so they aggregate under their service
    ('ici'/'dcn'/'collective'); the pair stays visible on the span
    itself in /rpcz."""
    if span.kind == "collective":
        return span.service or "collective"
    method = f"{span.service}.{span.method}" if span.service else span.method
    return method or "_unknown"


def record_span(span) -> None:
    """Fold one finished span's phase deltas (called from the Collector
    drain thread via Span.dump_and_destroy — never the RPC path).
    update_batched keeps even the drain thread's cost at an append per
    observation — on a single shared core, drain-thread work still
    competes with serving."""
    method = _method_key(span)
    for phase, delta in span.phase_deltas():
        recorder(method, phase).update_batched(delta)
    recorder(method, f"total_{span.kind}").update_batched(span.latency_us)


def queue_wait_recorder(name: str):
    """Callable(wait_us) for ExecutionQueue/scheduler queue-out hooks;
    records under the _runtime pseudo-method with phase `name`.
    Flag-gated: with rpcz disabled the callable is a cheap no-op, and
    its ``gate`` attribute lets the queue skip even the enqueue-side
    clock read — runtime queues pay nothing when observability is
    off."""
    from incubator_brpc_tpu_torch.observability.span import _RPCZ_FLAG

    update = recorder("_runtime", name).update_batched

    def record(wait_us: int) -> None:
        if _RPCZ_FLAG.value:
            update(wait_us)

    record.gate = _RPCZ_FLAG
    return record


def snapshot() -> Dict[str, Dict[str, dict]]:
    """{method: {phase: {count, avg, p50, p90, p99, max}}}."""
    with _lock:
        items = list(_recorders.items())
    out: Dict[str, Dict[str, dict]] = {}
    for (method, phase), rec in items:
        n, avg, (p50, p90, p99) = rec.stats((0.5, 0.9, 0.99))
        if not n:
            continue
        out.setdefault(method, {})[phase] = {
            "count": n,
            "avg_us": avg,
            "p50_us": p50,
            "p90_us": p90,
            "p99_us": p99,
        }
    return out


def mergeable_snapshot() -> Dict[str, Dict[str, dict]]:
    """{method: {phase: LatencyRecorder.mergeable_snapshot()}} — the
    aggregation STATE of the whole family, for /cluster/export.  Merged
    across replicas (metrics.latency_recorder.merge_latency_snapshots)
    it yields exactly the pooled-sample percentiles; the pre-computed
    stats snapshot() returns can never be merged that way."""
    with _lock:
        items = list(_recorders.items())
    out: Dict[str, Dict[str, dict]] = {}
    for (method, phase), rec in items:
        snap = rec.mergeable_snapshot()
        if not snap["count"] and not snap["latency_num"]:
            continue
        out.setdefault(method, {})[phase] = snap
    return out


_PHASE_ORDER = {
    p: i
    for i, p in enumerate(
        ("parse", "queue", "batch_wait", "dispatch", "callback", "device",
         "write", "send")
    )
}


def render() -> str:
    """Plain-text table for the /latency_breakdown builtin page."""
    snap = snapshot()
    if not snap:
        return (
            "no phase data collected yet "
            "(rpcz_enabled must be true; make some calls)"
        )
    return render_table(snap)


def render_table(snap: Dict[str, Dict[str, dict]]) -> str:
    """Table body over a snapshot()-shaped stats dict — shared by the
    local page and /cluster/latency_breakdown's merged view."""
    out = []
    for method in sorted(snap):
        out.append(f"{method}:")
        phases = snap[method]
        for phase in sorted(
            phases, key=lambda p: (_PHASE_ORDER.get(p, 99), p)
        ):
            s = phases[phase]
            out.append(
                f"  {phase:<16} count={s['count']:<8} "
                f"avg={s['avg_us']:.0f}us p50={s['p50_us']:.0f} "
                f"p90={s['p90_us']:.0f} p99={s['p99_us']:.0f}"
            )
        out.append("")
    return "\n".join(out)


class _Value:
    """Minimal get_value carrier for the MultiDimension walk."""

    __slots__ = ("_v",)

    def __init__(self, v):
        self._v = v

    def get_value(self):
        return self._v

    def describe(self):
        v = self._v
        return f"{v:.6g}" if isinstance(v, float) else str(v)


class _PhaseDimension(MultiDimension):
    """Read-only MultiDimension over the recorder family: the /metrics
    exposition iterates items() and emits one labeled gauge per
    (method, phase, stat).  Each recorder is read once (its stats():
    one fold of its batched writes), so a page's cost follows the
    number of recorders, not four reads of each."""

    def __init__(self):
        super().__init__(lambda: None, ["method", "phase", "stat"])

    def items(self):
        with _lock:
            recs = list(_recorders.items())
        out = []
        for (method, phase), rec in recs:
            count, avg, (p50, p99) = rec.stats((0.5, 0.99))
            if not count:
                continue
            for stat, v in (("count", count), ("avg", avg), ("p50", p50), ("p99", p99)):
                out.append(((method, phase, stat), _Value(v)))
        return out

    def mergeable_snapshot(self) -> dict:
        """Override the generic walk: items() yields COMPUTED stats
        (avg/p50/p99) whose cross-replica sum would be nonsense.  Export
        the underlying recorder state per (method, phase) instead."""
        stats = {
            self._KEY_SEP.join((method, phase)): snap
            for method, phases in mergeable_snapshot().items()
            for phase, snap in phases.items()
        }
        return {"labels": ["method", "phase"], "stats": stats}


phase_dimension = _PhaseDimension().expose("rpc_phase_latency_us")

# scheduler queue-out hook: every task's spawn→run delay lands under
# _runtime/task_queue (the queue-wait leg spans can't see directly);
# the rpcz flag gates even the per-task clock reads
from incubator_brpc_tpu_torch.observability.span import _RPCZ_FLAG  # noqa: E402
from incubator_brpc_tpu_torch.runtime import scheduler as _scheduler  # noqa: E402

_scheduler.set_task_queue_observer(
    queue_wait_recorder("task_queue"), gate=_RPCZ_FLAG
)
