"""Reducer → Adder / Maxer / Miner (reference bvar/reducer.h:69,224,258,308).

Per-thread agents make the write path uncontended: each writing thread
owns a private cell (reference detail/agent_group.h); ``get_value``
combines over all agents (detail/combiner.h). ``reset`` (used by the
Window sampler) atomically takes-and-zeros each agent.
"""

from __future__ import annotations

import threading
from typing import Callable, List

from incubator_brpc_tpu_torch.metrics.variable import Variable


class _Agent:
    __slots__ = ("value", "lock")

    def __init__(self, identity):
        self.value = identity
        self.lock = threading.Lock()


class Reducer(Variable):
    def __init__(self, op: Callable, identity):
        super().__init__()
        self._op = op
        self._identity = identity
        self._agents: List[_Agent] = []
        self._agents_lock = threading.Lock()
        self._tls = threading.local()

    def _my_agent(self) -> _Agent:
        agent = getattr(self._tls, "agent", None)
        if agent is None:
            agent = _Agent(self._identity)
            with self._agents_lock:
                self._agents.append(agent)
            self._tls.agent = agent
        return agent

    def update(self, value) -> "Reducer":
        """The hot write path: touch only this thread's agent."""
        agent = self._my_agent()
        with agent.lock:  # uncontended unless a read combines concurrently
            agent.value = self._op(agent.value, value)
        return self

    __lshift__ = update  # adder << 1, like the reference's operator<<

    def get_value(self):
        result = self._identity
        with self._agents_lock:
            agents = list(self._agents)
        for a in agents:
            with a.lock:
                result = self._op(result, a.value)
        return result

    def reset(self):
        """Combine and zero all agents (reference Reducer::reset, used by
        the window sampler for series)."""
        result = self._identity
        with self._agents_lock:
            agents = list(self._agents)
        for a in agents:
            with a.lock:
                result = self._op(result, a.value)
                a.value = self._identity
        return result


class Adder(Reducer):
    """bvar::Adder (reducer.h:224)."""

    def __init__(self, value=0):
        super().__init__(lambda a, b: a + b, type(value)())
        if value:
            self.update(value)

    def update(self, value) -> "Adder":
        # specialized hot path: no lambda dispatch (this is the single
        # most-called metrics op — several calls per RPC)
        agent = getattr(self._tls, "agent", None)
        if agent is None:
            agent = self._my_agent()
        with agent.lock:
            agent.value += value
        return self

    __lshift__ = update


class Maxer(Reducer):
    """bvar::Maxer (reducer.h:258)."""

    def __init__(self):
        super().__init__(max, float("-inf"))

    def get_value(self):
        v = super().get_value()
        return 0 if v == float("-inf") else v

    def reset(self):
        v = super().reset()
        return 0 if v == float("-inf") else v


class Miner(Reducer):
    """bvar::Miner (reducer.h:308)."""

    def __init__(self):
        super().__init__(min, float("inf"))

    def get_value(self):
        v = super().get_value()
        return 0 if v == float("inf") else v

    def reset(self):
        v = super().reset()
        return 0 if v == float("inf") else v
