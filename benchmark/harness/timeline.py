"""The device's timeline from a ``torch.profiler`` trace.

Busy time is the UNION of the device's kernel, memcpy and memset
intervals inside the traced window, never their sum: copies and kernels
on two streams overlap, and a sum would count the overlap twice (the
fault of ``chip_smoke.py``'s ``device_profile``, which this replaces).
Idle time is named by the innermost host range open while it lasted: of
the ``record_function`` ranges open at an instant, the one that began
last.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

WINDOW_RANGE = "bench.window"
NO_RANGE = "(no host range)"
DEVICE_KINDS = ("kernel", "memcpy", "memset")

Interval = Tuple[int, int]


@dataclass
class DeviceOp:
    name: str
    kind: str  # one of DEVICE_KINDS
    start_ns: int
    end_ns: int


@dataclass
class HostRange:
    name: str
    start_ns: int
    end_ns: int


def union(intervals: Iterable[Interval], lo: int, hi: int) -> List[Interval]:
    """The intervals clipped to [lo, hi] and merged, in order."""
    clipped = sorted((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi)
    merged: List[Interval] = []
    for a, b in clipped:
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def covered(merged: Sequence[Interval]) -> int:
    return sum(b - a for a, b in merged)


def gaps(merged: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    """The stretches of [lo, hi] that no merged interval covers."""
    out, at = [], lo
    for a, b in merged:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def idle_by_range(gap_list: Sequence[Interval], ranges: Sequence[HostRange]) -> Dict[str, int]:
    """The gaps' time, split by the innermost host range open at each
    instant (of the ranges open then, the one that began last; ranges of
    every thread count): {range name: ns}.  A gap inside one range goes
    to it whole; a gap across the end of one range and the start of the
    next is split between what the host was doing in each part."""
    points = []  # (time, order, what): ends before starts before gap edges at one instant
    for r in ranges:
        if r.end_ns > r.start_ns:
            points.append((r.start_ns, 1, r))
            points.append((r.end_ns, 0, r))
    for a, b in gap_list:
        points.append((a, 2, True))
        points.append((b, 2, False))
    points.sort(key=lambda p: (p[0], p[1]))
    open_heap: list = []  # (-start, id, range): the latest-begun range on top
    closed = set()
    out: Dict[str, int] = {}
    in_gap = False
    last = None
    for t, order, what in points:
        if in_gap and last is not None and t > last:
            while open_heap and id(open_heap[0][2]) in closed:
                heapq.heappop(open_heap)
            name = open_heap[0][2].name if open_heap else NO_RANGE
            out[name] = out.get(name, 0) + (t - last)
        last = t
        if order == 2:
            in_gap = what
        elif order == 1:
            heapq.heappush(open_heap, (-what.start_ns, id(what), what))
        else:
            closed.add(id(what))
    return out


class Timeline:
    """Device operations and host ranges inside one traced window."""

    def __init__(self, ops: List[DeviceOp], ranges: List[HostRange], lo: int, hi: int):
        self.lo, self.hi = lo, hi
        self.ops = [o for o in ops if o.end_ns > lo and o.start_ns < hi]
        self.ranges = ranges
        self.merged = union(((o.start_ns, o.end_ns) for o in self.ops), lo, hi)
        self.busy_ns = covered(self.merged)

    @property
    def window_ns(self) -> int:
        return self.hi - self.lo

    def op_count(self, kinds=DEVICE_KINDS) -> int:
        return sum(1 for o in self.ops if o.kind in kinds)

    def device_ops(self, top: int = 10) -> List[list]:
        """[[name, seconds], ...]: the device operations that took the
        most time, summed by name (their own durations, overlap and all)."""
        by: Dict[str, int] = {}
        for o in self.ops:
            t = min(o.end_ns, self.hi) - max(o.start_ns, self.lo)
            by[o.name] = by.get(o.name, 0) + t
        ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[name, ns / 1e9] for name, ns in ranked]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """[[host range, seconds], ...]: the device's idle time summed by
        the innermost host range open while it lasted, longest first."""
        by = idle_by_range(gaps(self.merged, self.lo, self.hi), self.ranges)
        ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[name, ns / 1e9] for name, ns in ranked]


def _kind(activity: str, name: str) -> Optional[str]:
    a = activity.lower()
    for k in DEVICE_KINDS:
        if k in a:
            return k
    if a:
        return None  # a device-side annotation or sync: no work
    n = name.lower()
    if n.startswith("memcpy"):
        return "memcpy"
    if n.startswith("memset"):
        return "memset"
    if n.endswith(" sync"):
        return None  # a synchronisation marker, no work
    return "kernel"


def from_profiler(prof) -> Timeline:
    """The window of ``WINDOW_RANGE`` in a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device, ranges = [], []
    window = None
    for e in prof.profiler.kineto_results.events():
        act = e.activity_type() if hasattr(e, "activity_type") else ""
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            # a record_function range is mirrored on the device's rows as
            # an annotation: it is no work of the device's
            if not e.is_user_annotation():
                device.append((e.name(), act, start, end))
        elif e.is_user_annotation() or act == "user_annotation":
            if e.name() == WINDOW_RANGE:
                window = (start, end)
            else:
                ranges.append(HostRange(e.name(), start, end))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_RANGE!r} range")
    host_names = {r.name for r in ranges} | {WINDOW_RANGE}
    ops: List[DeviceOp] = []
    for name, act, start, end in device:
        kind = None if name in host_names else _kind(act, name)
        if kind is not None:
            ops.append(DeviceOp(name, kind, start, end))
    ranges.append(HostRange(WINDOW_RANGE, *window))
    return Timeline(ops, ranges, *window)
