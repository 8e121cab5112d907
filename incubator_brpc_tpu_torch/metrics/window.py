"""Window / PerSecond — time-windowed views over reducers.

Reference bvar/window.h:174,197 + detail/sampler.cpp: a background
sampler thread takes one sample per second from every windowed
variable into a per-variable ring; Window reads the delta over the
last N seconds, PerSecond divides by the window span.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional

from incubator_brpc_tpu_torch.metrics.variable import Variable
from incubator_brpc_tpu_torch.metrics.reducer import Adder, Maxer, Miner, Reducer


class _SamplerThread:
    """One global 1 Hz sampling thread (reference SamplerCollector)."""

    def __init__(self):
        self._samplers: List["_WindowSampler"] = []
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def add(self, s: "_WindowSampler"):
        with self._lock:
            self._samplers.append(s)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="tpubrpc-bvar-sampler"
                )
                self._thread.start()

    def remove(self, s: "_WindowSampler"):
        with self._lock:
            try:
                self._samplers.remove(s)
            except ValueError:
                pass

    def _run(self):
        while True:
            start = time.monotonic()
            with self._lock:
                samplers = list(self._samplers)
            for s in samplers:
                try:
                    s.take_sample()
                except Exception:
                    pass
            elapsed = time.monotonic() - start
            time.sleep(max(0.05, 1.0 - elapsed))


_sampler_thread = _SamplerThread()


class _WindowSampler:
    """Per-variable ring of (cumulative) samples."""

    def __init__(self, var: Reducer, window_size: int):
        self.var = var
        self.window_size = window_size
        self.samples: deque = deque(maxlen=window_size + 1)
        self.lock = threading.Lock()
        _sampler_thread.add(self)

    def take_sample(self):
        with self.lock:
            self.samples.append((time.monotonic(), self.var.get_value()))

    def window(self):
        """(oldest, newest, span_seconds) or None if <2 samples."""
        with self.lock:
            if len(self.samples) < 2:
                return None
            t0, v0 = self.samples[0]
            t1, v1 = self.samples[-1]
            return v0, v1, max(t1 - t0, 1e-9)


class Window(Variable):
    """Value over the last `window_size` seconds (bvar::Window).

    For Adder: delta over the window. For Maxer/Miner: extremum of the
    in-window deltas is not recoverable from cumulative samples, so the
    sampler records per-second reset values instead (matching the
    reference, which stores per-sample values for non-additive ops).
    """

    def __init__(self, var: Reducer, window_size: int = 10):
        super().__init__()
        self._var = var
        self._additive = not isinstance(var, (Maxer, Miner))
        self._sampler = _WindowSampler(var, window_size)
        self._resets: deque = deque(maxlen=window_size)
        if not self._additive:
            # sample by reset for extremum reducers
            self._sampler.take_sample = self._take_reset_sample  # type: ignore

    def _take_reset_sample(self):
        with self._sampler.lock:
            self._resets.append(self._var.reset())

    def get_value(self):
        if not self._additive:
            # the second under way counts too: what arrived since the last
            # tick sits in the reducer until the next reset takes it.  It
            # is read before the ticks' samples, so a tick between the two
            # reads moves it into a sample that the second read sees; the
            # samples are read under the lock the tick holds from its reset
            # to its append, so a live read that found the reducer reset
            # finds the sample appended
            live = Reducer.get_value(self._var)
            with self._sampler.lock:
                vals = list(self._resets)
            if not vals:  # no tick yet: the live read is the window
                return 0 if live == self._var._identity else live
            if live != self._var._identity:
                vals.append(live)
            return max(vals) if isinstance(self._var, Maxer) else min(vals)
        w = self._sampler.window()
        if w is None:
            return self._var.get_value()
        v0, v1, _ = w
        return v1 - v0

    def window_size(self) -> int:
        return self._sampler.window_size


class PerSecond(Variable):
    """Windowed delta divided by elapsed seconds (bvar::PerSecond)."""

    def __init__(self, var: Reducer, window_size: int = 10):
        super().__init__()
        self._sampler = _WindowSampler(var, window_size)
        self._var = var

    def get_value(self) -> float:
        w = self._sampler.window()
        if w is None:
            return 0.0
        v0, v1, span = w
        return (v1 - v0) / span
