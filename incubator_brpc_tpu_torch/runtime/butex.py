"""Butex — the single blocking primitive (reference bthread/butex.cpp).

A butex is a 32-bit-word futex for tasks: ``wait(expected)`` blocks the
caller only if the word still equals ``expected`` (the reference's
butex_wait contract, butex.h:36-60); wake/wake_all release waiters. All
higher-level sync (mutex, condition, CallId join, RPC join, stream flow
control) is built on it, exactly as in the reference.

Blocking here parks the OS thread; the scheduler is notified so it can
grow the worker pool (see scheduler.py docstring).
"""

from __future__ import annotations

import threading
from typing import Optional

from incubator_brpc_tpu_torch.runtime import scheduler


class Butex:
    __slots__ = ("_value", "_cond")

    def __init__(self, value: int = 0):
        self._value = value
        self._cond = threading.Condition()

    @property
    def value(self) -> int:
        return self._value

    def set_value(self, v: int):
        with self._cond:
            self._value = v

    def fetch_add(self, delta: int) -> int:
        with self._cond:
            old = self._value
            self._value = (self._value + delta) & 0xFFFFFFFF
            return old

    def wait(self, expected: int, timeout: Optional[float] = None) -> bool:
        """Block while value == expected. Returns False on timeout or if
        the value already differed (EWOULDBLOCK in the reference)."""
        ctrl = scheduler.get_task_control() if scheduler.in_worker() else None
        with self._cond:
            if self._value != expected:
                return False
            if ctrl:
                ctrl.on_task_block()
            try:
                ok = self._cond.wait_for(lambda: self._value != expected, timeout)
            finally:
                if ctrl:
                    ctrl.on_task_unblock()
            return ok

    def wake(self, n: int = 1) -> None:
        with self._cond:
            if n == 1:
                self._cond.notify()
            else:
                self._cond.notify(n)

    def wake_all(self) -> None:
        with self._cond:
            self._cond.notify_all()

    def set_and_wake(self, v: int, all: bool = True) -> None:
        with self._cond:
            self._value = v
            if all:
                self._cond.notify_all()
            else:
                self._cond.notify()
