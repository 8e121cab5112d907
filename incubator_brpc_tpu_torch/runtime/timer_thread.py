"""TimerThread — dedicated timer scheduling thread.

Analog of bthread::TimerThread (timer_thread.h:50-90): one thread runs
all timers (RPC timeouts, backup-request triggers, health-check
probes). The reference hashes timers into 13 buckets to cut lock
contention; here a single heapq under one lock is enough for CPython.
Unschedule is best-effort exactly like the reference: a timer that
already started running cannot be stopped.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, Optional

from incubator_brpc_tpu_torch.utils.logging import log_error

_counter = itertools.count(1)


class TimerThread:
    def __init__(self, name: str = "tpubrpc-timer"):
        self._heap: list = []  # (deadline, seq, fn, args)
        self._live: set = set()  # seqs still in the heap
        self._cancelled: set = set()
        self._cond = threading.Condition()
        self._stopped = False
        self._thread = threading.Thread(target=self._run, daemon=True, name=name)
        self._thread.start()

    def schedule(self, fn: Callable, delay_s: float, *args) -> int:
        """Run fn(*args) after delay_s seconds. Returns a timer id."""
        deadline = time.monotonic() + max(0.0, delay_s)
        seq = next(_counter)
        with self._cond:
            heapq.heappush(self._heap, (deadline, seq, fn, args))
            self._live.add(seq)
            self._cond.notify()
        return seq

    def schedule_abs(self, fn: Callable, abstime_monotonic: float, *args) -> int:
        seq = next(_counter)
        with self._cond:
            heapq.heappush(self._heap, (abstime_monotonic, seq, fn, args))
            self._live.add(seq)
            self._cond.notify()
        return seq

    def unschedule(self, timer_id: int) -> None:
        """Best-effort cancel (TimerThread::unschedule). A timer that
        already fired is ignored (no leak: only live ids are tracked)."""
        with self._cond:
            if timer_id in self._live:
                self._cancelled.add(timer_id)

    def _run(self):
        while True:
            with self._cond:
                if self._stopped:
                    return
                now = time.monotonic()
                while self._heap and (
                    self._heap[0][1] in self._cancelled or self._heap[0][0] <= now
                ):
                    deadline, seq, fn, args = heapq.heappop(self._heap)
                    self._live.discard(seq)
                    if seq in self._cancelled:
                        self._cancelled.discard(seq)
                        continue
                    break
                else:
                    timeout = self._heap[0][0] - now if self._heap else None
                    self._cond.wait(timeout)
                    continue
            # run expired timer outside the lock
            try:
                fn(*args)
            except Exception as e:  # noqa: BLE001
                log_error("timer %r raised: %r", fn, e)

    def stop_and_join(self):
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout=1.0)


_default: Optional[TimerThread] = None
_default_lock = threading.Lock()


def get_timer_thread() -> TimerThread:
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = TimerThread()
    return _default
