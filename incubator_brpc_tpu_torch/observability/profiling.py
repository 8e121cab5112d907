"""Device-plane profiling — the HBM ledger and device-time attribution.

Port of the JAX package's ``observability/profiling.py`` for the two
instruments the ICI fabric uses:

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

The JAX copy reads JAX's live arrays through ``sys.modules``; this one
reads torch only, so a process that imports both packages keeps two
independent ledgers.  The ``/hotspots`` capture and the runtime
occupancy sampler are ROADMAP.md queue 1 item 10.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from incubator_brpc_tpu_torch.metrics.multi_dimension import MultiDimension
from incubator_brpc_tpu_torch.metrics.passive_status import Status
from incubator_brpc_tpu_torch.metrics.reducer import Adder
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
    this process has touched.  Metadata only — no device sync."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {
            "available": False,
            "source": None,
            "bytes": 0,
            "reason": "no CUDA context (nothing on a card)",
        }
    total = 0
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        total += int(stats.get("allocated_bytes.all.current", 0))
    return {"available": True, "source": "memory_stats", "bytes": total}


def hbm_profile() -> dict:
    """Ledger snapshot + census cross-check."""
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
        dark = max(0, cen["bytes"] - accounted)
    return {
        "tags": tags,
        "accounted_bytes": accounted,
        "census": cen,
        "dark_bytes": dark,
    }


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
