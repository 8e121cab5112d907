"""ExecutionQueue — MPSC queue with auto-started consumer task.

Analog of bthread::ExecutionQueue (execution_queue.h:30-35,159,183):
producers from any thread call ``execute``; a single consumer task is
started on demand on the runtime, drains items in batches through the
user callback, and quits when empty (auto-start/auto-quit). Ordered
processing without a dedicated thread. High-priority items jump the
queue (reference execute with TASK_OPTIONS_URGENT).
"""

from __future__ import annotations

import threading
import time as _time
from collections import deque
from typing import Callable, Iterable, List, Optional

from incubator_brpc_tpu_torch.runtime import scheduler

# consumer callback: fn(iterator_of_items) -> None; a stopped queue passes
# is_stopped=True via the `stopped` attr on the batch.


class TaskIterator:
    def __init__(self, items: List, stopped: bool):
        self._items = items
        self.stopped = stopped

    def __iter__(self):
        return iter(self._items)

    def __len__(self):
        return len(self._items)


class ExecutionQueue:
    def __init__(
        self,
        consumer: Callable[[TaskIterator], None],
        batch_max: int = 64,
        wait_recorder: Optional[Callable[[int], None]] = None,
    ):
        """``wait_recorder(wait_us)`` — optional queue-in/queue-out
        latency observer: each item's time between enqueue and the
        consumer batch picking it up is reported (feeds the _runtime
        rows of /latency_breakdown). A ``gate`` attribute on the
        recorder (a Flag-like object) suppresses even the enqueue-side
        clock read while ``gate.value`` is false."""
        self._consumer = consumer
        self._batch_max = batch_max
        self._wait_recorder = wait_recorder
        self._wait_gate = getattr(wait_recorder, "gate", None)
        self._q: deque = deque()  # entries: (item, enqueue_ns | 0)
        self._lock = threading.Lock()
        self._running = False
        self._stopped = False
        self._drained = threading.Condition(self._lock)

    def _entry(self, item):
        if self._wait_recorder is not None and (
            self._wait_gate is None or self._wait_gate.value
        ):
            return (item, _time.monotonic_ns())
        return (item, 0)

    def execute(self, item, urgent: bool = False) -> bool:
        """Enqueue; starts the consumer task if idle. Wait-free for
        producers in the reference; O(1) under a short lock here."""
        with self._lock:
            if self._stopped:
                return False
            if urgent:
                self._q.appendleft(self._entry(item))
            else:
                self._q.append(self._entry(item))
            if self._running:
                return True
            self._running = True
        scheduler.spawn(self._consume_loop)
        return True

    def execute_batch(self, items) -> bool:
        """Enqueue several items with ONE lock acquisition and at most
        ONE consumer wake — the batch-wake API the ICI fabric's
        delivery bursts use (a fan-out that delivers N frames pays one
        task spawn instead of N lock/wake rounds).  All-or-nothing: a
        stopped queue refuses the whole batch (False) so the caller can
        release per-item resources (window credits) in one place."""
        items = list(items)
        if not items:
            return True
        with self._lock:
            if self._stopped:
                return False
            self._q.extend(self._entry(i) for i in items)
            if self._running:
                return True
            self._running = True
        scheduler.spawn(self._consume_loop)
        return True

    def execute_or_inline(self, item) -> bool:
        """Run ``item`` inline in the calling task when the queue is
        idle and empty (ordering is trivially preserved — nothing is
        pending or mid-flight); otherwise enqueue as ``execute`` does.
        Saves the consumer-task handoff in the common one-outstanding-
        item case."""
        with self._lock:
            if self._stopped:
                return False
            if self._running or self._q:
                self._q.append(self._entry(item))
                return True
            self._running = True
        try:
            self._consumer(TaskIterator([item], stopped=False))
        except Exception as e:  # noqa: BLE001
            from incubator_brpc_tpu_torch.utils.logging import log_error

            log_error("ExecutionQueue consumer raised: %r", e)
        # drain anything enqueued meanwhile; resets _running when empty
        self._consume_loop()
        return True

    def _consume_loop(self):
        while True:
            entries = None
            with self._lock:
                if not self._q:
                    self._running = False
                    self._drained.notify_all()
                    if self._stopped:
                        batch = TaskIterator([], stopped=True)
                    else:
                        return
                else:
                    entries = []
                    while self._q and len(entries) < self._batch_max:
                        entries.append(self._q.popleft())
                    items = [e[0] for e in entries]
                    batch = TaskIterator(items, stopped=False)
            if entries and self._wait_recorder is not None:
                # queue-out stamp: report each item's wait.  Outside the
                # queue lock — the recorder is a foreign observer with
                # its own locks (latency_breakdown); producers must not
                # contend with recorder work (callback-under-lock rule)
                now = _time.monotonic_ns()
                for _, t in entries:
                    if t:
                        try:
                            self._wait_recorder((now - t) // 1000)
                        except Exception:  # noqa: BLE001
                            pass
            try:
                self._consumer(batch)
            except Exception as e:  # noqa: BLE001
                from incubator_brpc_tpu_torch.utils.logging import log_error

                log_error("ExecutionQueue consumer raised: %r", e)
            if batch.stopped:
                return

    def stop(self):
        """Analog of execution_queue_stop: flush then signal stopped."""
        with self._lock:
            self._stopped = True
            if not self._running:
                self._running = True
                start = True
            else:
                start = False
        if start:
            scheduler.spawn(self._consume_loop)

    def join(self, timeout: Optional[float] = None) -> bool:
        with self._lock:
            return self._drained.wait_for(
                lambda: not self._q and not self._running, timeout
            )

    def __len__(self):
        return len(self._q)
