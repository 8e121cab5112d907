"""What a traffic generator hands back: every call of one window."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, List


@dataclass
class Call:
    k: int  # the call's number in the window
    issue_ns: int  # perf_counter_ns when the call was issued
    done_ns: int  # ... and when its completion reached the client
    ok: bool
    record: Any  # what the deployment kept of the reply, for the check


@dataclass
class Window:
    start_ns: int = 0  # perf_counter_ns at the first timed call
    end_ns: int = 0  # ... after the drain and the final synchronise
    start_wall_us: int = 0
    end_wall_us: int = 0
    issued: int = 0
    calls: List[Call] = field(default_factory=list)

    def open(self) -> None:
        self.start_wall_us = time.time_ns() // 1000
        self.start_ns = time.perf_counter_ns()

    def close(self) -> None:
        self.end_ns = time.perf_counter_ns()
        self.end_wall_us = time.time_ns() // 1000

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def completed(self) -> List[Call]:
        return [c for c in self.calls if c.ok]

    def per_second(self) -> List[int]:
        """Completions in each second of the window, in order."""
        out = [0] * max(1, int(self.seconds + 1))
        for c in self.calls:
            if c.ok:
                out[min(len(out) - 1, max(0, (c.done_ns - self.start_ns) // 10**9))] += 1
        return out

    def latencies_ns(self) -> List[int]:
        return sorted(c.done_ns - c.issue_ns for c in self.calls if c.ok)
