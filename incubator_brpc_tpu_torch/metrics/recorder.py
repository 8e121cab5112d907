"""IntRecorder — average over a stream of ints (reference bvar/recorder.h:84).

The reference packs (sum, num) into one 64-bit word per agent for
atomicity; here each thread's agent keeps (sum, num) under its lock.
"""

from __future__ import annotations

import threading
from typing import List, Tuple

from incubator_brpc_tpu_torch.metrics.variable import Variable


class _Agent:
    __slots__ = ("sum", "num", "lock")

    def __init__(self):
        self.sum = 0
        self.num = 0
        self.lock = threading.Lock()


class IntRecorder(Variable):
    def __init__(self):
        super().__init__()
        self._agents: List[_Agent] = []
        self._agents_lock = threading.Lock()
        self._tls = threading.local()

    def _my_agent(self) -> _Agent:
        a = getattr(self._tls, "agent", None)
        if a is None:
            a = _Agent()
            with self._agents_lock:
                self._agents.append(a)
            self._tls.agent = a
        return a

    def update(self, value: int) -> "IntRecorder":
        a = self._my_agent()
        with a.lock:
            a.sum += value
            a.num += 1
        return self

    __lshift__ = update

    def sum_num(self) -> Tuple[int, int]:
        s = n = 0
        with self._agents_lock:
            agents = list(self._agents)
        for a in agents:
            with a.lock:
                s += a.sum
                n += a.num
        return s, n

    def get_value(self) -> float:
        s, n = self.sum_num()
        return s / n if n else 0.0

    average = get_value

    def mergeable_snapshot(self) -> dict:
        """Aggregation state for cross-process merging: (sum, num) add
        elementwise, so the merged average is exactly the pooled
        average — never export the computed average itself."""
        s, n = self.sum_num()
        return {"sum": s, "num": n}

    def reset(self) -> Tuple[int, int]:
        s = n = 0
        with self._agents_lock:
            agents = list(self._agents)
        for a in agents:
            with a.lock:
                s += a.sum
                n += a.num
                a.sum = 0
                a.num = 0
        return s, n
