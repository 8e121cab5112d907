"""Contention profiler — lock-wait sampling through the Collector.

Analog of the reference's in-house contention profiler
(bthread/mutex.cpp:106-180): contended TaskMutex acquisitions submit a
(duration, stack) sample through the bvar Collector pipeline (bounded
overhead — the Collector's speed limit plus a 1-in-N sampling gate on
the stack capture itself); /hotspots/contention renders the aggregate
as a pprof-style text profile (count + wait time per unique stack).
"""

from __future__ import annotations

import threading
import traceback
from collections import defaultdict
from typing import Dict, List, Tuple

from incubator_brpc_tpu_torch.metrics.collector import Collected
from incubator_brpc_tpu_torch.utils.hashes import fast_rand

# capture a stack only for ~1 in N contended waits: stack extraction is
# the expensive part (reference samples at COLLECTOR_SAMPLING_BASE too)
SAMPLING_BASE = 16
_MAX_FRAMES = 12


class ContentionSample(Collected):
    __slots__ = ("duration_ns", "stack")

    def __init__(self, duration_ns: int, stack: Tuple[str, ...]):
        self.duration_ns = duration_ns
        self.stack = stack

    def dump_and_destroy(self):
        _profiler.add(self)

    def speed_limit(self) -> int:
        return 200  # samples/s ceiling through the Collector


class ContentionProfiler:
    """Aggregates samples by stack; rendered by /hotspots/contention."""

    def __init__(self):
        self._lock = threading.Lock()
        # stack -> [count, total_ns]
        self._agg: Dict[Tuple[str, ...], List[int]] = defaultdict(lambda: [0, 0])
        self.total_samples = 0
        self.total_wait_ns = 0

    def add(self, sample: ContentionSample):
        with self._lock:
            slot = self._agg[sample.stack]
            slot[0] += 1
            slot[1] += sample.duration_ns
            self.total_samples += 1
            self.total_wait_ns += sample.duration_ns

    def snapshot(self) -> Dict[Tuple[str, ...], List[int]]:
        """stack → [count, total_ns] copy (flamegraph rendering)."""
        with self._lock:
            return {k: list(v) for k, v in self._agg.items()}

    def reset(self):
        with self._lock:
            self._agg.clear()
            self.total_samples = 0
            self.total_wait_ns = 0

    def render(self, top: int = 40) -> str:
        """pprof-style text: '--- contention' header then per-stack
        'count  wait_us @ frame; frame; ...' hottest first."""
        with self._lock:
            rows = sorted(
                self._agg.items(), key=lambda kv: kv[1][1], reverse=True
            )[:top]
            total_s, total_ns = self.total_samples, self.total_wait_ns
        out = [
            "--- contention",
            f"sampling_base: {SAMPLING_BASE}",
            f"samples: {total_s}  total_wait_us: {total_ns // 1000}",
            "",
        ]
        for stack, (count, ns) in rows:
            out.append(f"{count:>8} {ns // 1000:>12}us @ " + "; ".join(stack))
        return "\n".join(out)


_profiler = ContentionProfiler()


def profiler() -> ContentionProfiler:
    return _profiler


def record_contention(duration_ns: int):
    """Called from TaskMutex on a contended acquire. The stack-capture
    gate keeps the fast path cheap; accepted samples flow through the
    Collector so aggregate work happens off the caller's thread."""
    if fast_rand() % SAMPLING_BASE:
        return
    frames = traceback.extract_stack(limit=_MAX_FRAMES + 2)[:-2]
    stack = tuple(
        f"{f.name}({f.filename.rsplit('/', 1)[-1]}:{f.lineno})" for f in frames
    )
    ContentionSample(duration_ns * SAMPLING_BASE, stack).submit()
