"""Task-aware sync primitives built on Butex (reference bthread/mutex.cpp,
condition_variable.cpp, countdown_event.cpp).

The reference's bthread_mutex has contention-profiler hooks
(mutex.cpp:106-180) feeding the bvar Collector; TaskMutex mirrors that
by recording wait time into a metrics Adder when contended.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from incubator_brpc_tpu_torch.runtime.butex import Butex


class TaskMutex:
    """Mutex with contention sampling (analog bthread_mutex_t)."""

    _contention_ns_total = 0  # exposed via metrics default_variables

    def __init__(self):
        self._butex = Butex(0)  # 0=unlocked, 1=locked, 2=locked+contended

    def acquire(self, timeout: Optional[float] = None) -> bool:
        with self._butex._cond:
            if self._butex._value == 0:
                self._butex._value = 1
                return True
        from incubator_brpc_tpu_torch.runtime import scheduler

        ctrl = scheduler.get_task_control() if scheduler.in_worker() else None
        if ctrl:
            ctrl.on_task_block()
        start = time.monotonic_ns()
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while True:
                with self._butex._cond:
                    if self._butex._value == 0:
                        self._butex._value = 2
                        waited = time.monotonic_ns() - start
                        TaskMutex._contention_ns_total += waited
                    else:
                        waited = -1
                        remain = (
                            None if deadline is None else deadline - time.monotonic()
                        )
                        if remain is not None and remain <= 0:
                            return False
                        self._butex._cond.wait(remain if remain is not None else 0.1)
                if waited >= 0:
                    # contention profiler (reference mutex.cpp:106-180)
                    # — sampled OUTSIDE the cond lock: stack capture in
                    # the critical section would inflate the very
                    # contention being measured
                    from incubator_brpc_tpu_torch.observability.contention import (
                        record_contention,
                    )

                    record_contention(waited)
                    return True
        finally:
            if ctrl:
                ctrl.on_task_unblock()

    def release(self):
        self._butex.set_and_wake(0, all=False)

    __enter__ = lambda self: self.acquire() and self or self
    def __exit__(self, *exc):
        self.release()


class CountdownEvent:
    """Analog of bthread::CountdownEvent."""

    def __init__(self, initial: int = 1):
        self._butex = Butex(initial)

    def signal(self, n: int = 1):
        with self._butex._cond:
            self._butex._value -= n
            if self._butex._value <= 0:
                self._butex._cond.notify_all()

    def add_count(self, n: int = 1):
        with self._butex._cond:
            self._butex._value += n

    def wait(self, timeout: Optional[float] = None) -> bool:
        from incubator_brpc_tpu_torch.runtime import scheduler

        ctrl = scheduler.get_task_control() if scheduler.in_worker() else None
        with self._butex._cond:
            if self._butex._value <= 0:
                return True
            if ctrl:
                ctrl.on_task_block()
            try:
                return self._butex._cond.wait_for(
                    lambda: self._butex._value <= 0, timeout
                )
            finally:
                if ctrl:
                    ctrl.on_task_unblock()
