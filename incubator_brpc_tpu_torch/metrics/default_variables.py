"""Process/system metrics from /proc (reference bvar/default_variables.cpp).

Exposed lazily by ``expose_default_variables()`` (the server calls this
at start): process_cpu_usage, process_memory_resident, process_fd_count,
process_uptime, plus runtime-specific gauges (worker/blocked counts).
"""

from __future__ import annotations

import os
import time

from incubator_brpc_tpu_torch.metrics.passive_status import PassiveStatus

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096
_CLK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100
_start_time = time.time()
_exposed = False


def _rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE
    except Exception:
        return 0


def _cpu_seconds() -> float:
    try:
        with open("/proc/self/stat") as f:
            parts = f.read().rsplit(")", 1)[1].split()
        utime, stime = int(parts[11]), int(parts[12])
        return (utime + stime) / _CLK
    except Exception:
        return 0.0


def _fd_count() -> int:
    try:
        return len(os.listdir("/proc/self/fd"))
    except Exception:
        return 0


def _thread_count() -> int:
    try:
        return len(os.listdir("/proc/self/task"))
    except Exception:
        return 0


def expose_default_variables():
    global _exposed
    if _exposed:
        return
    _exposed = True
    PassiveStatus(_rss_bytes).expose("process_memory_resident")
    PassiveStatus(_cpu_seconds).expose("process_cpu_seconds")
    PassiveStatus(_fd_count).expose("process_fd_count")
    PassiveStatus(_thread_count).expose("process_thread_count")
    PassiveStatus(lambda: time.time() - _start_time).expose("process_uptime")
    PassiveStatus(os.getpid).expose("process_pid")

    def _workers():
        from incubator_brpc_tpu_torch.runtime.scheduler import _default_control

        return _default_control.worker_count() if _default_control else 0

    def _blocked():
        from incubator_brpc_tpu_torch.runtime.scheduler import _default_control

        return _default_control.blocked_count() if _default_control else 0

    PassiveStatus(_workers).expose("runtime_worker_count")
    PassiveStatus(_blocked).expose("runtime_blocked_count")
