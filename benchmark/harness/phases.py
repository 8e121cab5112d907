"""Each call's phases from its rpcz spans' stamps, laid on a device
trace's clock, and the figures the phase run reports from them.

A phase runs from one of a span's stamps to the next (``CALL_PHASES``):
a client span's ``client.pack``, ``client.await`` and ``client.complete``,
an ICI leg's ``ici.place`` and ``ici.deliver``, a server span's
``server.parse`` to ``server.send`` (``server.batch_wait`` and
``server.dispatch`` split its queue), and ``ici.cq``, derived here: the
request leg's end to the server span's ``received_us``.  A program
whose spans lack the stamps (``placed_us``, ``batch_flush_us``) gives no
phases, and the taps here then keep nothing.

The spans stamp the wall clock (``time.time_ns()``, microseconds); a
``torch.profiler`` trace has its own clock.  ``clock_offset_ns`` takes
the shift between the two from an anchor: one ``time.time_ns()`` read
inside a ``record_function`` range of its own, just before the window.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from benchmark.harness.timeline import HostRange, idle_by_range

ANCHOR_RANGE = "harness.clock_anchor"
CQ_PHASE = "ici.cq"
# ranges of the benchmark itself: idle time under them is not named by a program phase
HARNESS_NAMES = ("client.call", "client.done", "bench.window", "(no host range)")

# (name, from-fields, to-field) by span kind: the first from-field
# stamped opens the phase; start_us and end_us are the span's own.  A
# client span's received_us is the reply's arrival at the client port,
# its response_write_us the request queued on the socket or port.
CALL_PHASES = {
    "client": (
        ("client.pack", ("start_us",), "response_write_us"),
        ("client.await", ("response_write_us",), "received_us"),
        ("client.complete", ("received_us",), "end_us"),
    ),
    "collective": (
        ("ici.place", ("start_us",), "placed_us"),
        ("ici.deliver", ("placed_us",), "end_us"),
    ),
    "server": (
        ("server.parse", ("received_us",), "parse_done_us"),
        ("server.batch_wait", ("enqueued_us",), "batch_flush_us"),
        ("server.dispatch", ("batch_flush_us", "enqueued_us"), "callback_start_us"),
        ("server.callback", ("callback_start_us",), "callback_done_us"),
        ("server.device", ("device_start_us",), "device_done_us"),
        ("server.write", ("callback_done_us",), "response_write_us"),
        ("server.send", ("response_write_us",), "sent_us"),
    ),
}


def phases_of(kind: str, stamp) -> List[tuple]:
    """(name, from_us, to_us) of each of the kind's phases whose stamps
    are set and in order; ``stamp(field)`` reads a stamp, 0 if unset."""
    out = []
    for name, frms, to in CALL_PHASES.get(kind, ()):
        b = stamp(to)
        a = next((v for v in map(stamp, frms) if v), 0)
        if a and b and b >= a:
            out.append((name, a, b))
    return out


def program_has_phases() -> bool:
    from incubator_brpc_tpu_torch.observability.span import PHASE_FIELDS

    return "placed_us" in PHASE_FIELDS and "batch_flush_us" in PHASE_FIELDS


# ---- every span's stamps, while a window runs ------------------------------
@dataclass
class SpanStamps:
    kind: str
    trace_id: int
    span_id: int
    parent_span_id: int
    start_us: int
    end_us: int
    received_us: int
    phases: list  # [(name, from_us, to_us)] of CALL_PHASES


def stamps_of(span) -> SpanStamps:
    return SpanStamps(span.kind, span.trace_id, span.span_id, span.parent_span_id,
                      span.start_us, span.end_us, span.phase("received_us"),
                      phases_of(span.kind, span.phase))


class SpanTap:
    """Keeps the stamps of every span the program's collector hands to the
    rpcz store from ``attach()`` on.  It chains in front of the store's
    ``add`` as ``spans.ServerSpans`` does, and is taken off with it: a
    ``ServerSpans`` entered after the tap wraps it, lifts the creation
    budget so every call is traced, and on leaving removes both."""

    def __init__(self):
        self.stamps: List[SpanStamps] = []

    def attach(self) -> "SpanTap":
        if not program_has_phases():
            return self
        from incubator_brpc_tpu_torch.observability.span import span_db

        db = span_db()
        store = db.add
        keep = self.stamps.append

        def add(span):
            keep(stamps_of(span))
            store(span)

        db.add = add
        return self


def cq_phases(spans: List[SpanStamps]) -> List[tuple]:
    """(``ici.cq``, request leg's end, server span's received_us): the
    request leg and the server span both hang under the client span.  A
    leg that ran the server inline ends after it and gives nothing."""
    legs = {}
    for s in spans:
        if s.kind == "collective" and s.end_us:
            legs.setdefault((s.trace_id, s.parent_span_id), s.end_us)
    out = []
    for s in spans:
        if s.kind == "server" and s.received_us:
            end = legs.get((s.trace_id, s.parent_span_id))
            if end and s.received_us >= end:
                out.append((CQ_PHASE, end, s.received_us))
    return out


def all_phases(spans: List[SpanStamps]) -> List[tuple]:
    """Every (name, from_us, to_us) of the spans, ``ici.cq`` included."""
    out = [p for s in spans for p in s.phases]
    out.extend(cq_phases(spans))
    return out


# ---- the figures of a window ---------------------------------------------------
def counters(batcher=None) -> Dict[str, int]:
    """The program's running totals the figures difference: the runtime's
    handoffs, and a micro-batcher's rows and wait where there is one."""
    from incubator_brpc_tpu_torch.runtime import scheduler

    out = {}
    if hasattr(scheduler, "handoffs_total"):
        out["handoffs"] = scheduler.handoffs_total()
    if batcher is not None and hasattr(batcher, "wait_ns"):
        out["batch_rows"] = batcher.rows
        out["batch_wait_ns"] = batcher.wait_ns
    return out


def figures(spans: List[SpanStamps], moved: Dict[str, int], calls: int,
            lo_us: int, hi_us: int) -> Dict[str, float]:
    """Over the window [lo_us, hi_us]:

    - ``client_host_us``: the mean over the client spans that ended in it
      of ``client.pack`` + ``client.complete``, the client host's own part;
    - ``fabric_place_us``: ``ici.place`` summed over the legs that ended
      in it (request and reply), over those client spans;
    - ``batch_wait_us``: the batcher's wait over its rows, from the
      counters ``moved`` across the window;
    - ``task_handoffs_per_call``: the handoffs over the ``calls`` completed.

    A figure with nothing to read is left out."""
    def inside(s):
        return lo_us <= s.end_us <= hi_us

    clients = [s for s in spans if s.kind == "client" and inside(s)]
    out = {}
    own = [sum(b - a for n, a, b in s.phases if n in ("client.pack", "client.complete"))
           for s in clients if {"client.pack", "client.complete"} <= {n for n, _, _ in s.phases}]
    if own:
        out["client_host_us"] = sum(own) / len(own)
    place = [b - a for s in spans if s.kind == "collective" and inside(s)
             for n, a, b in s.phases if n == "ici.place"]
    if place and clients:
        out["fabric_place_us"] = sum(place) / len(clients)
    if moved.get("batch_rows"):
        out["batch_wait_us"] = moved["batch_wait_ns"] / moved["batch_rows"] / 1000.0
    if "handoffs" in moved and calls:
        out["task_handoffs_per_call"] = moved["handoffs"] / calls
    return out


# ---- on the trace's clock ----------------------------------------------------
def clock_offset_ns(anchor: HostRange, wall_ns: int) -> int:
    """wall clock - trace clock, from one ``time.time_ns()`` read
    (``wall_ns``) inside the ``anchor`` range: the read is taken at the
    range's middle, so the offset is good to half the range's width."""
    return wall_ns - (anchor.start_ns + anchor.end_ns) // 2


def host_ranges(phases: List[tuple], offset_ns: int) -> List[HostRange]:
    """Each phase as a host range on the trace's clock."""
    return [HostRange(name, a * 1000 - offset_ns, b * 1000 - offset_ns)
            for name, a, b in phases if b > a]


def program_share(idle_gaps: List[list]) -> float:
    """The share of the idle time in ``idle_gaps`` ([[range, seconds]])
    that lies under a program phase, not under the benchmark's own ranges."""
    total = sum(s for _, s in idle_gaps)
    if total <= 0:
        return 0.0
    mine = sum(s for name, s in idle_gaps
               if name not in HARNESS_NAMES and not name.startswith("harness."))
    return mine / total


def per_second(spans: List[SpanStamps], lo_us: int, hi_us: int) -> List[dict]:
    """For each second of [lo_us, hi_us]: ``calls``, the client spans
    that ended in it; ``mean_us``, each phase's mean over the phases
    that ended in it (a phase's whole span, nested phases included); and
    ``self_us``, each phase's own time a call: the time it was the
    innermost phase open (``timeline.idle_by_range`` over the whole
    second), over the second's calls, ``(no host range)`` the time no
    phase was open."""
    n = max(1, -(-(hi_us - lo_us) // 1_000_000))
    calls = [0] * n
    sums: List[Dict[str, list]] = [{} for _ in range(n)]
    inside: List[List[HostRange]] = [[] for _ in range(n)]

    def second(t_us):
        k = (t_us - lo_us) // 1_000_000
        return k if 0 <= k < n and t_us <= hi_us else None

    for s in spans:
        if s.kind == "client" and s.end_us:
            k = second(s.end_us)
            if k is not None:
                calls[k] += 1
    for name, a, b in all_phases(spans):
        k = second(b)
        if k is not None:
            acc = sums[k].setdefault(name, [0, 0])
            acc[0] += 1
            acc[1] += b - a
        first = max(0, (a - lo_us) // 1_000_000)
        for j in range(first, min(n - 1, (b - lo_us) // 1_000_000) + 1):
            inside[j].append(HostRange(name, a * 1000, b * 1000))
    out = []
    for k in range(n):
        s_lo = (lo_us + k * 1_000_000) * 1000
        s_hi = min(lo_us + (k + 1) * 1_000_000, hi_us) * 1000
        own = idle_by_range([(s_lo, s_hi)], inside[k])
        per = max(1, calls[k])
        out.append({
            "calls": calls[k],
            "mean_us": {name: us / cnt for name, (cnt, us) in sorted(sums[k].items())},
            "self_us": {name: ns / 1000 / per for name, ns in sorted(own.items())},
        })
    return out


def slow_fast(seconds: List[dict], span: int = 10) -> Optional[dict]:
    """The ``span`` whole seconds with the fewest calls against the
    ``span`` with the most: calls a second and each phase's own time a
    call in both, and how much each grew in the slow ones, most first."""
    full = seconds[:-1] if len(seconds) > 1 else seconds  # the last second is cut short
    if len(full) < 2 * span:
        return None
    ranked = sorted(range(len(full)), key=lambda k: full[k]["calls"])
    slow, fast = ranked[:span], ranked[-span:]

    def mean_of(ks):
        calls = sum(full[k]["calls"] for k in ks)
        names = {n for k in ks for n in full[k]["self_us"]}
        # each second's own time a call, weighted by its calls
        per = {n: sum(full[k]["self_us"].get(n, 0.0) * full[k]["calls"] for k in ks) / max(1, calls)
               for n in names}
        return calls / len(ks), per

    slow_calls, slow_own = mean_of(slow)
    fast_calls, fast_own = mean_of(fast)
    growth = {n: slow_own.get(n, 0.0) - fast_own.get(n, 0.0) for n in set(slow_own) | set(fast_own)}
    return {"slow_calls_per_s": slow_calls, "fast_calls_per_s": fast_calls,
            "slow_self_us": slow_own, "fast_self_us": fast_own,
            "growth_us": dict(sorted(growth.items(), key=lambda kv: -kv[1]))}
