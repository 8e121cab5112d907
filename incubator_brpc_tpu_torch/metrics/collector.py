"""Collector — global bounded sampling pipeline.

Reference bvar/collector.{h,cpp} (collector.h:48-72): shared base for
rpcz spans and mutex-contention samples. Producers call
``Collected.submit()``; a speed limiter keeps collection below
`max_samples_per_second` (sampling, not backpressure: excess samples
are dropped), and a background drain thread groups samples by
preprocessor and invokes ``dump_and_destroy``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Optional

COLLECTOR_SAMPLING_BASE = 64
_MAX_PER_SECOND = 1000


class Collected:
    """Base for collectable samples (rpcz Span subclasses this)."""

    def submit(self):
        get_collector().submit(self)

    def dump_and_destroy(self):  # overridden
        pass

    def speed_limit(self) -> int:
        return _MAX_PER_SECOND


class Collector:
    def __init__(self):
        self._q: Deque[Collected] = deque(maxlen=4096)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._window_start = time.monotonic()
        # per-sample-class counts: rpcz spans declare a higher
        # speed_limit than contention samples, and a shared counter
        # would let heavy span traffic starve the other sample types
        self._window_counts: dict = {}
        self.dropped = 0
        self.collected = 0

    def submit(self, sample: Collected):
        now = time.monotonic()
        cls = type(sample)
        # over-limit fast path WITHOUT the lock: a dirty read of the
        # window counters may mis-drop/mis-admit a handful of samples
        # at the window edge (sampling is approximate by design), but
        # saturated producers — the RPC hot path under load — skip the
        # lock acquire entirely
        if (
            self._window_counts.get(cls, 0) >= sample.speed_limit()
            and now - self._window_start < 1.0
        ):
            self.dropped += 1
            return
        with self._lock:
            if now - self._window_start >= 1.0:
                self._window_start = now
                self._window_counts.clear()
            cnt = self._window_counts.get(cls, 0)
            if cnt >= sample.speed_limit():
                self.dropped += 1
                return
            self._window_counts[cls] = cnt + 1
            self._q.append(sample)
            self.collected += 1
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._drain, daemon=True, name="tpubrpc-collector"
                )
                self._thread.start()
            # No per-sample notify: the drain thread polls in rounds
            # (reference collector.cpp likewise sleeps between grabs).
            # Waking it per sample costs a futex wake + context switch
            # on the RPC hot path — thousands per second under load.

    _DRAIN_PERIOD_S = 0.1

    def _drain(self):
        while True:
            time.sleep(self._DRAIN_PERIOD_S)
            with self._lock:
                if not self._q:
                    continue
                batch = list(self._q)
                self._q.clear()
            for sample in batch:
                try:
                    sample.dump_and_destroy()
                except Exception:
                    pass


_collector: Optional[Collector] = None
_collector_lock = threading.Lock()


def get_collector() -> Collector:
    global _collector
    if _collector is None:
        with _collector_lock:
            if _collector is None:
                _collector = Collector()
    return _collector
