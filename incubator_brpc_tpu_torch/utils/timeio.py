"""Time utilities (analog of butil/time.h).

The reference reads the TSC (cpuwide_time_ns) for ~ns-cost timestamps on
the RPC hot path; CPython's time.monotonic_ns/perf_counter_ns are the
equivalent cheap monotonic clocks here.
"""

from __future__ import annotations

import time


def monotonic_ns() -> int:
    return time.monotonic_ns()


def monotonic_us() -> int:
    return time.monotonic_ns() // 1000


def monotonic_ms() -> int:
    return time.monotonic_ns() // 1_000_000


def gettimeofday_us() -> int:
    return time.time_ns() // 1000


cpuwide_time_ns = monotonic_ns
cpuwide_time_us = monotonic_us


class Timer:
    """Scoped stopwatch (butil::Timer)."""

    def __init__(self):
        self._start = 0
        self._stop = 0

    def start(self):
        self._start = time.perf_counter_ns()
        self._stop = self._start

    def stop(self):
        self._stop = time.perf_counter_ns()

    def n_elapsed(self) -> int:
        return self._stop - self._start

    def u_elapsed(self) -> int:
        return self.n_elapsed() // 1000

    def m_elapsed(self) -> int:
        return self.n_elapsed() // 1_000_000
