"""Device-plane profiling — HBM ledger, device time, occupancy.

Port of the JAX package's ``observability/profiling.py``: its three
instruments, which the builtin ``/hotspots`` pages render:

1. **HBM ledger** — ``hbm_account(tag)`` hands out a per-tag accounting
   handle every device-memory-pinning subsystem adopts (StagingRing
   slots, in-flight ICI payloads).  Adopted bytes aggregate into
   ``rpc_hbm_bytes{component}``.  ``hbm_profile`` cross-checks the
   ledger against the CUDA caching allocator's own census
   (``torch.cuda.memory_stats``), so bytes the ledger does not know
   about show as an explicit ``dark_bytes`` bucket.  CPU tensors have
   no allocator census; the ledger still charges their ``.nbytes``.

2. **Device-time attribution** — dispatch sites wrap their launches in
   :class:`kernel_section`, feeding per-family execution counts and
   dispatch-window EMAs.  The window never synchronizes the device: it
   measures the host side of the launch, like the JAX package's.

   ``/hotspots/device?seconds=N`` arms an on-demand ``torch.profiler``
   window (CPU activity, and CUDA activity once a CUDA context exists)
   and summarizes both the counters over it per kernel family and the
   profiler's CUDA events per kernel name.  The counters' ``device_us``
   is host dispatch (enqueue) time; the profiler's ``cuda_us`` is the
   time the card spent in each kernel.

3. **Runtime occupancy sampler** — per-worker run-queue depth, steals,
   runs, parks and task queue-wait from runtime/scheduler's plain
   counters, exported as ``rpc_worker_*`` gauges and /hotspots/runtime.

The JAX copy reads JAX's live arrays through ``sys.modules``; this one
reads torch only, so a process that imports both packages keeps two
independent ledgers.  The census is the CUDA caching allocator's
``allocated_bytes``: blocks rounded up by the allocator, and no pinned
host memory (the DCN bridge's staging buffers are not device memory).
"""

from __future__ import annotations

import os
import sys
import tempfile
import threading
import time
from typing import Dict, Optional

from incubator_brpc_tpu_torch.analysis.device_witness import allowed_transfer
from incubator_brpc_tpu_torch.metrics.multi_dimension import MultiDimension
from incubator_brpc_tpu_torch.metrics.passive_status import PassiveStatus, Status
from incubator_brpc_tpu_torch.metrics.reducer import Adder
from incubator_brpc_tpu_torch.runtime import scheduler as _sched
from incubator_brpc_tpu_torch.utils.flags import define_flag

_HBM_FLAG = define_flag(
    "profiler_hbm_enabled",
    True,
    "always-on HBM accounting (rpc_hbm_bytes)",
    validator=lambda v: isinstance(v, bool),
)
_DEVICE_FLAG = define_flag(
    "profiler_device_enabled",
    True,
    "always-on per-kernel-family dispatch-time attribution",
    validator=lambda v: isinstance(v, bool),
)
_OCC_FLAG = define_flag(
    "profiler_occupancy_enabled",
    True,
    "runtime occupancy sampling (rpc_worker_* / /hotspots/runtime)",
    validator=lambda v: isinstance(v, bool),
)

# ---------------------------------------------------------------------------
# (1) HBM ledger
# ---------------------------------------------------------------------------

rpc_hbm_bytes = MultiDimension(Adder, ["component"]).expose("rpc_hbm_bytes")
rpc_hbm_allocs = MultiDimension(Adder, ["component"]).expose("rpc_hbm_allocs")


class HbmAccount:
    """Per-tag accounting handle:

    - ``n = acct.adopt(tensor_or_nbytes)`` when a device buffer becomes
      this subsystem's responsibility (store the returned bytes);
    - ``acct.release(n)`` with exactly that value when it is freed or
      handed on.

    Reading ``.nbytes`` is metadata only — no device transfer."""

    __slots__ = ("tag", "_bytes", "_allocs")

    def __init__(self, tag: str):
        self.tag = tag
        self._bytes = rpc_hbm_bytes.get_stats([tag])
        self._allocs = rpc_hbm_allocs.get_stats([tag])

    def adopt(self, obj) -> int:
        if not _HBM_FLAG.value:
            return 0
        n = obj if isinstance(obj, int) else int(getattr(obj, "nbytes", 0) or 0)
        if n > 0:
            self._bytes << n
            self._allocs << 1
        return n

    def release(self, nbytes: int, allocs: int = 1) -> None:
        if nbytes > 0:
            self._bytes << -int(nbytes)
            self._allocs << -int(allocs)

    def live_bytes(self) -> int:
        return int(self._bytes.get_value())

    def live_allocs(self) -> int:
        return int(self._allocs.get_value())


_accounts: Dict[str, HbmAccount] = {}
_accounts_lock = threading.Lock()


def hbm_account(tag: str) -> HbmAccount:
    """Register (first call) or look up the accounting handle for tag."""
    acct = _accounts.get(tag)
    if acct is None:
        with _accounts_lock:
            acct = _accounts.get(tag)
            if acct is None:
                acct = HbmAccount(tag)
                _accounts[tag] = acct
    return acct


def device_census() -> dict:
    """The CUDA caching allocator's live bytes summed over the devices
    this process has touched.  Metadata only — no device sync.
    ``requested_bytes`` (where this torch reports it) is what callers
    asked for; ``bytes`` minus it is the allocator's rounding.  A
    process that never imported torch has nothing on a card: the page
    handler does not import it."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {
            "available": False,
            "source": None,
            "bytes": 0,
            "reason": "no CUDA context (nothing on a card)",
        }
    total, requested = 0, 0
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        total += int(stats.get("allocated_bytes.all.current", 0))
        requested += int(stats.get("requested_bytes.all.current", -1))
    cen = {"available": True, "source": "memory_stats", "bytes": total}
    if requested >= 0:
        cen["requested_bytes"] = requested
    return cen


# census baseline: device bytes that predate the accounting horizon
# (weights placed before adoption began, the profiler's own buffers).
# dark = census - baseline - accounted; rebase_census() snaps the
# horizon "everything currently resident is explained".
_census_baseline = [0]


def rebase_census() -> dict:
    cen = device_census()
    _census_baseline[0] = cen["bytes"] if cen["available"] else 0
    return cen


def hbm_profile() -> dict:
    """Ledger snapshot + census cross-check (the /hotspots/hbm data)."""
    tags: Dict[str, dict] = {}
    with _accounts_lock:
        accounts = list(_accounts.values())
    for acct in accounts:
        b, a = acct.live_bytes(), acct.live_allocs()
        if b or a:
            tags[acct.tag] = {"bytes": b, "allocs": a}
    accounted = sum(v["bytes"] for v in tags.values())
    cen = device_census()
    dark: Optional[int] = None
    if cen["available"]:
        dark = max(0, cen["bytes"] - _census_baseline[0] - accounted)
    return {
        "tags": tags,
        "accounted_bytes": accounted,
        "census": cen,
        "census_baseline": _census_baseline[0],
        "dark_bytes": dark,
    }


def render_hbm(profile: Optional[dict] = None, top: int = 40) -> str:
    """pprof-style text profile: hottest tag first, then the census
    cross-check with the explicit ``<dark>`` bucket."""
    p = profile if profile is not None else hbm_profile()
    cen = p["census"]
    out = [
        "--- hbm",
        f"accounted_bytes: {p['accounted_bytes']}  tags: {len(p['tags'])}",
    ]
    if cen["available"]:
        rounding = ""
        if "requested_bytes" in cen:
            rounding = (
                f" rounding={cen['bytes'] - cen['requested_bytes']} "
                f"(allocated - requested: the caching allocator rounds "
                f"each block up, to 512 B at least)"
            )
        out.append(
            f"census: source={cen['source']} bytes={cen['bytes']} "
            f"baseline={p['census_baseline']}{rounding}"
        )
        dark = p["dark_bytes"]
        span = max(1, cen["bytes"] - p["census_baseline"])
        out.append(f"<dark>: {dark} bytes ({100.0 * dark / span:.1f}%)")
    else:
        out.append(f"census: unavailable ({cen.get('reason')}) — <dark> unknown")
    out.append("")
    rows = sorted(
        p["tags"].items(), key=lambda kv: kv[1]["bytes"], reverse=True
    )[:top]
    for tag, row in rows:
        out.append(f"{row['bytes']:>14} {row['allocs']:>8} @ {tag}")
    return "\n".join(out)


# growth baseline slot (same idiom as /hotspots/growth's tracemalloc
# slot): each fetch diffs against the previous one
_hbm_growth_baseline: list = [None]


def render_hbm_growth(top: int = 40) -> str:
    p = hbm_profile()
    base = _hbm_growth_baseline[0]
    _hbm_growth_baseline[0] = p
    if base is None:
        return "hbm baseline captured; re-fetch for growth"
    out = ["--- hbm growth since last fetch", ""]
    deltas = []
    for tag in sorted(set(p["tags"]) | set(base["tags"])):
        nb = p["tags"].get(tag, {}).get("bytes", 0)
        ob = base["tags"].get(tag, {}).get("bytes", 0)
        na = p["tags"].get(tag, {}).get("allocs", 0)
        oa = base["tags"].get(tag, {}).get("allocs", 0)
        if nb != ob or na != oa:
            deltas.append((nb - ob, na - oa, tag))
    deltas.sort(key=lambda t: abs(t[0]), reverse=True)
    for db, da, tag in deltas[:top]:
        out.append(f"{db:>+14} {da:>+8} @ {tag}")
    if len(out) == 2:
        out.append("(no per-tag change)")
    out.append("")
    out.append(
        f"accounted: {base['accounted_bytes']} -> {p['accounted_bytes']} "
        f"({p['accounted_bytes'] - base['accounted_bytes']:+d})"
    )
    if p["census"]["available"] and base["census"]["available"]:
        out.append(
            f"census:    {base['census']['bytes']} -> {p['census']['bytes']} "
            f"({p['census']['bytes'] - base['census']['bytes']:+d})"
        )
    return "\n".join(out)


# ---------------------------------------------------------------------------
# (2) device-time attribution
# ---------------------------------------------------------------------------

rpc_kernel_executions = MultiDimension(Adder, ["family"]).expose(
    "rpc_kernel_executions"
)
rpc_kernel_device_us_total = MultiDimension(Adder, ["family"]).expose(
    "rpc_kernel_device_us_total"
)
rpc_kernel_device_us_ema = MultiDimension(
    lambda: Status(0.0), ["family"]
).expose("rpc_kernel_device_us_ema")

_EMA_ALPHA = 0.2


class _KernelStat:
    __slots__ = ("family", "_exec", "_total", "_ema_var", "ema_us", "last_us")

    def __init__(self, family: str):
        self.family = family
        self._exec = rpc_kernel_executions.get_stats([family])
        self._total = rpc_kernel_device_us_total.get_stats([family])
        self._ema_var = rpc_kernel_device_us_ema.get_stats([family])
        self.ema_us: Optional[float] = None
        self.last_us = 0.0

    def note(self, us: float) -> None:
        self._exec << 1
        self._total << us
        self.last_us = us
        ema = self.ema_us
        self.ema_us = us if ema is None else ema + _EMA_ALPHA * (us - ema)
        self._ema_var.set_value(round(self.ema_us, 2))


_kernels: Dict[str, _KernelStat] = {}
_kernels_lock = threading.Lock()


def _kernel_stat(family: str) -> _KernelStat:
    st = _kernels.get(family)
    if st is None:
        fresh = _KernelStat(family)
        with _kernels_lock:
            st = _kernels.setdefault(family, fresh)
    return st


class kernel_section:
    """Times one kernel-family dispatch window.  Disarmed cost is one
    flag load; armed cost is two perf_counter reads plus the counter
    folds.  Never synchronizes the device."""

    __slots__ = ("family", "_t0")

    def __init__(self, family: str):
        self.family = family
        self._t0 = 0

    def __enter__(self) -> "kernel_section":
        if _DEVICE_FLAG.value:
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._t0 and exc_type is None:
            _kernel_stat(self.family).note(
                (time.perf_counter_ns() - self._t0) / 1000.0
            )
        return False


def kernel_snapshot() -> Dict[str, dict]:
    """family → {executions, total_us, ema_us, last_us}."""
    with _kernels_lock:
        stats = list(_kernels.values())
    out: Dict[str, dict] = {}
    for st in stats:
        out[st.family] = {
            "executions": int(st._exec.get_value()),
            "total_us": float(st._total.get_value()),
            "ema_us": round(st.ema_us, 2) if st.ema_us is not None else 0.0,
            "last_us": round(st.last_us, 2),
        }
    return out


def render_device(snapshot: Optional[Dict[str, dict]] = None) -> str:
    snap = snapshot if snapshot is not None else kernel_snapshot()
    out = [
        "--- device",
        f"kernel_families: {len(snap)}",
        "",
        f"{'executions':>12} {'total_us':>14} {'ema_us':>10} "
        f"{'last_us':>10}  family",
    ]
    for family, row in sorted(
        snap.items(), key=lambda kv: kv[1]["total_us"], reverse=True
    ):
        out.append(
            f"{row['executions']:>12} {row['total_us']:>14.1f} "
            f"{row['ema_us']:>10.1f} {row['last_us']:>10.1f}  {family}"
        )
    return "\n".join(out)


# ---- on-demand deep capture ------------------------------------------------

rpc_profiler_captures_total = Adder(0).expose("rpc_profiler_captures_total")
rpc_profiler_capture_failures_total = Adder(0).expose(
    "rpc_profiler_capture_failures_total"
)

_capture_lock = threading.Lock()
_trace_active = [False]
MAX_CAPTURE_SECONDS = 10.0
TRACE_FILE = "trace.json"


class CaptureError(RuntimeError):
    """A deep capture that could not run (chaos drop, concurrent
    capture, profiler failure).  The page maps it to an error response;
    serving continues and no armed profiler survives it."""


def capture_active() -> bool:
    return _trace_active[0]


def _cuda_kernels(prof) -> Dict[str, dict]:
    """The profiler's CUDA events summed per name: {count, cuda_us}."""
    import torch

    out: Dict[str, dict] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            row = out.setdefault(e.name, {"count": 0, "cuda_us": 0.0})
            row["count"] += 1
            row["cuda_us"] += e.time_range.elapsed_us()
    return out


def device_capture(seconds: float) -> dict:
    """Arm a ``torch.profiler`` window for ``seconds`` and return a
    per-kernel-family summary of what executed inside it, plus the
    profiler's CUDA events per kernel name (``kernels``) and the Chrome
    trace it exported (``trace_dir``/trace.json).  The profiler records
    CUDA activity when this process has a CUDA context; its device
    events cover every thread's launches.  The chaos site
    ``profile.capture`` sits on this path: ``drop`` fails the capture
    (CaptureError → error page), ``delay_us`` stretches its start.  The
    profiler is stopped in a ``finally`` — a failed or chaos-faulted
    capture can never leak an armed profiler."""
    from incubator_brpc_tpu_torch.chaos import injector as _chaos

    seconds = min(max(float(seconds), 0.0), MAX_CAPTURE_SECONDS)
    if _chaos.armed:
        spec = _chaos.check("profile.capture")
        if spec is not None:
            if spec.action == "delay_us":
                _chaos.sleep_us(spec.arg)
            elif spec.action == "drop":
                rpc_profiler_capture_failures_total << 1
                raise CaptureError(
                    "deep capture dropped (chaos site profile.capture)"
                )
    if not _capture_lock.acquire(blocking=False):
        raise CaptureError("a device capture is already in progress")
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        before = kernel_snapshot()
        t0 = time.perf_counter()
        cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        trace_dir: Optional[str] = None
        trace_error: Optional[str] = None
        kernels: Dict[str, dict] = {}
        prof = None
        try:
            activities = [ProfilerActivity.CPU]
            if cuda:
                activities.append(ProfilerActivity.CUDA)
            trace_dir = tempfile.mkdtemp(prefix="device-trace-")
            prof = profile(activities=activities)
            prof.start()
            _trace_active[0] = True
        except Exception as e:  # noqa: BLE001 — degrade to counters-only
            trace_error = repr(e)
            trace_dir, prof = None, None
        try:
            time.sleep(seconds)
        finally:
            if prof is not None:
                try:
                    if cuda:
                        # kernels enqueued inside the window finish
                        # before the profiler collects its device events
                        with allowed_transfer("profiler.capture-sync"):
                            torch.cuda.synchronize()
                    prof.stop()
                    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
                    kernels = _cuda_kernels(prof)
                except Exception as e:  # noqa: BLE001
                    trace_error = trace_error or repr(e)
                _trace_active[0] = False
        after = kernel_snapshot()
        rpc_profiler_captures_total << 1
        families: Dict[str, dict] = {}
        for family, row in after.items():
            prev = before.get(family, {"executions": 0, "total_us": 0.0})
            d_exec = row["executions"] - prev["executions"]
            if d_exec <= 0:
                continue
            families[family] = {
                "executions": d_exec,
                "device_us": round(row["total_us"] - prev["total_us"], 1),
                "ema_us": row["ema_us"],
            }
        return {
            "seconds": round(time.perf_counter() - t0, 3),
            "families": families,
            "trace_dir": trace_dir,
            "trace_error": trace_error,
            "kernels": kernels,
        }
    finally:
        _capture_lock.release()


def render_capture(result: dict) -> str:
    out = [
        "--- device capture",
        f"window_s: {result['seconds']}",
        f"trace_dir: {result['trace_dir'] or '(none)'}",
    ]
    if result["trace_error"]:
        out.append(f"trace: unavailable ({result['trace_error']}) — "
                   f"summary is counter-based")
    out.append("")
    out.append(f"{'executions':>12} {'device_us':>14} {'ema_us':>10}  family")
    for family, row in sorted(
        result["families"].items(),
        key=lambda kv: kv[1]["device_us"],
        reverse=True,
    ):
        out.append(
            f"{row['executions']:>12} {row['device_us']:>14.1f} "
            f"{row['ema_us']:>10.1f}  {family}"
        )
    if not result["families"]:
        out.append("(no kernel dispatches inside the window)")
    if "kernels" in result:
        out.append("")
        out.append("device_us above: host dispatch windows (kernel_section "
                   "counters); cuda_us below: the profiler's CUDA events")
        out.append(f"{'launches':>12} {'cuda_us':>14}  kernel")
        for name, row in sorted(
            result["kernels"].items(),
            key=lambda kv: kv[1]["cuda_us"],
            reverse=True,
        ):
            out.append(f"{row['count']:>12} {row['cuda_us']:>14.1f}  {name}")
        if not result["kernels"]:
            out.append("(no CUDA events inside the window)")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# (3) runtime occupancy sampler
# ---------------------------------------------------------------------------

# queue-wait aggregate fed by the scheduler's occupancy observer slot.
# Plain dict slots mutated under the GIL — a lost update under extreme
# contention costs one sample, never correctness.
_queue_wait = {"count": 0, "total_us": 0, "ema_us": 0.0}


def _occupancy_cb(wait_us: int) -> None:
    _queue_wait["count"] += 1
    _queue_wait["total_us"] += wait_us
    ema = _queue_wait["ema_us"]
    _queue_wait["ema_us"] = (
        float(wait_us) if not ema else ema + _EMA_ALPHA * (wait_us - ema)
    )


def _ctl():
    # never get_task_control(): a metrics render must not be what spawns
    # the worker pool
    return _sched._default_control


def occupancy_snapshot() -> dict:
    ctl = _ctl()
    base = (
        ctl.occupancy_snapshot()
        if ctl is not None
        else {
            "workers": 0,
            "blocked": 0,
            "parked": 0,
            "parks_total": 0,
            "steals_total": 0,
            "remote_q": 0,
            "per_worker": [],
        }
    )
    base["queue_wait"] = {
        "count": _queue_wait["count"],
        "total_us": _queue_wait["total_us"],
        "ema_us": round(_queue_wait["ema_us"], 1),
    }
    return base


def render_runtime(snapshot: Optional[dict] = None) -> str:
    s = snapshot if snapshot is not None else occupancy_snapshot()
    qw = s["queue_wait"]
    out = [
        "--- runtime occupancy",
        f"workers: {s['workers']}  blocked: {s['blocked']}  "
        f"parked: {s['parked']}",
        f"steals_total: {s['steals_total']}  parks_total: {s['parks_total']}  "
        f"remote_q: {s['remote_q']}",
        f"queue_wait: count={qw['count']} total_us={qw['total_us']} "
        f"ema_us={qw['ema_us']}",
        "",
        f"{'worker':>8} {'rq_depth':>10} {'steals':>8} {'runs':>10}",
    ]
    for w in s["per_worker"]:
        out.append(
            f"{w['worker_id']:>8} {w['rq_depth']:>10} {w['steals']:>8} "
            f"{w['runs']:>10}"
        )
    if not s["per_worker"]:
        out.append("(runtime not started)")
    return "\n".join(out)


# worker gauges: PassiveStatus over the (maybe not yet created) default
# control — 0 before the runtime starts, live numbers after
rpc_worker_count = PassiveStatus(
    lambda: _ctl().worker_count() if _ctl() else 0
).expose("rpc_worker_count")
rpc_worker_blocked = PassiveStatus(
    lambda: _ctl().blocked_count() if _ctl() else 0
).expose("rpc_worker_blocked")
rpc_worker_parked = PassiveStatus(
    lambda: _ctl().parked_count() if _ctl() else 0
).expose("rpc_worker_parked")
rpc_worker_parks_total = PassiveStatus(
    lambda: _ctl().parks_total() if _ctl() else 0
).expose("rpc_worker_parks_total")
rpc_worker_steals_total = PassiveStatus(
    lambda: _ctl().steals_total() if _ctl() else 0
).expose("rpc_worker_steals_total")
rpc_worker_runqueue_depth = PassiveStatus(
    lambda: _ctl().runqueue_depth() if _ctl() else 0
).expose("rpc_worker_runqueue_depth")
rpc_worker_queue_waits_total = PassiveStatus(
    lambda: _queue_wait["count"]
).expose("rpc_worker_queue_waits_total")
rpc_worker_queue_wait_us_ema = PassiveStatus(
    lambda: round(_queue_wait["ema_us"], 1)
).expose("rpc_worker_queue_wait_us_ema")

# arm the sampler: the scheduler stamps queue-in times only while an
# observer's gate is open, so flipping profiler_occupancy_enabled off
# removes even the per-spawn clock read (unless rpcz wants it too)
_sched.set_occupancy_observer(_occupancy_cb, gate=_OCC_FLAG)
