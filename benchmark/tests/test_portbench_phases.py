"""The call phases' harness module and the phase run, on synthetic
spans and on the tiny cells on the CPU."""

from __future__ import annotations

import pytest

from benchmark.harness import phases
from benchmark.harness.timeline import HostRange, Timeline
from benchmark.tests.conftest import run_tiny, tiny_cell


def _span(kind, trace, span_id, parent, start, end, received=0, ph=()):
    return phases.SpanStamps(kind, trace, span_id, parent, start, end, received, list(ph))


# ---- stamps to ranges on the trace's clock ----------------------------------
def test_clock_offset_is_taken_at_the_anchor_middle():
    anchor = HostRange(phases.ANCHOR_RANGE, 1_000, 1_040)
    assert phases.clock_offset_ns(anchor, 5_000_020) == 5_000_020 - 1_020


def test_host_ranges_shift_by_the_offset_and_drop_empty_phases():
    got = phases.host_ranges([("client.pack", 10, 12), ("ici.place", 12, 12)], 3_000)
    assert [(r.name, r.start_ns, r.end_ns) for r in got] == [("client.pack", 7_000, 9_000)]


def test_nested_phases_name_the_idle_time_innermost_and_clip_at_the_window():
    # the window is [0, 100] us on the trace; the device works in [40, 50]
    offset = 1_000_000  # wall = trace + 1 ms
    w = lambda us: us + offset // 1000  # noqa: E731 — a trace time as a wall stamp
    spans = [
        _span("client", 1, 10, 0, w(-20), w(90), ph=[
            ("client.pack", w(-20), w(10)), ("client.await", w(10), w(80)),
            ("client.complete", w(80), w(90))]),
        _span("collective", 1, 11, 10, w(20), w(70), ph=[
            ("ici.place", w(20), w(30)), ("ici.deliver", w(30), w(70))]),
        # a call across the window's end
        _span("client", 2, 20, 0, w(95), w(130), ph=[("client.pack", w(95), w(130))]),
    ]
    ranges = phases.host_ranges(phases.all_phases(spans), offset)
    from benchmark.harness.timeline import DeviceOp

    tl = Timeline([DeviceOp("k", "kernel", 40_000, 50_000)],
                  ranges + [HostRange("bench.window", -50_000, 100_000)], 0, 100_000)
    gaps = dict(tl.idle_gaps())
    assert gaps == pytest.approx({
        "client.pack": 10e-6 + 5e-6,  # [0, 10] and the cut call's [95, 100]
        "client.await": 10e-6 + 10e-6,  # [10, 20] and [70, 80], around the leg
        "ici.place": 10e-6,
        "ici.deliver": 10e-6 + 20e-6,  # [30, 40] and [50, 70]: the device's own 10 us is not idle
        "client.complete": 10e-6,
        "bench.window": 5e-6,  # [90, 95]
    })
    assert phases.program_share(tl.idle_gaps()) == pytest.approx(85 / 90)


def test_cq_runs_from_the_request_leg_to_the_server_receive():
    spans = [
        _span("client", 7, 1, 0, 100, 900),
        _span("collective", 7, 2, 1, 110, 150),  # request leg
        _span("server", 7, 3, 1, 180, 600, received=180),
        _span("collective", 7, 4, 3, 500, 560),  # reply leg, under the server span
        # an inline leg ends after the server span it ran: no queue
        _span("collective", 8, 6, 5, 110, 700),
        _span("server", 8, 7, 5, 200, 600, received=200),
    ]
    assert phases.cq_phases(spans) == [(phases.CQ_PHASE, 150, 180)]


def test_per_second_counts_calls_and_means_phases_and_finds_the_slow_seconds():
    lo = 10_000_000
    spans = []
    for k in range(25):  # second k: k calls, each a pack of 10 us, then an await of 100 * (25 - k) us
        for j in range(k):
            t = lo + k * 1_000_000 + 10_000 * j
            spans.append(_span("client", k * 100 + j, 1, 0, t, t + 5_000, ph=[
                ("client.pack", t, t + 10), ("client.await", t + 10, t + 10 + 100 * (25 - k))]))
    spans.append(_span("client", 9999, 1, 0, lo - 5, lo - 1))  # before the window
    per = phases.per_second(spans, lo, lo + 25_000_000)
    assert len(per) == 25
    assert [s["calls"] for s in per] == list(range(25))
    assert per[3]["mean_us"] == {"client.await": 2200.0, "client.pack": 10.0}
    own = per[3]["self_us"]
    assert own["client.pack"] == pytest.approx(10.0) and own["client.await"] == pytest.approx(2200.0)
    assert own["(no host range)"] == pytest.approx((1e6 - 3 * 2210) / 3)
    sf = phases.slow_fast(per, span=10)
    assert sf["slow_calls_per_s"] < sf["fast_calls_per_s"]
    growth = {n: g for n, g in sf["growth_us"].items() if n != "(no host range)"}
    assert list(growth) == ["client.await", "client.pack"]
    assert growth["client.pack"] == pytest.approx(0)
    assert phases.slow_fast(per[:15], span=10) is None


# ---- the phases of a span, and the figures of a window ---------------------------
class _FakeSpan:
    def __init__(self, kind, **stamps):
        self.kind = kind
        self.trace_id, self.span_id, self.parent_span_id = 1, 2, 0
        self.start_us = stamps.pop("start_us", 0)
        self.end_us = stamps.pop("end_us", 0)
        self._stamps = stamps

    def phase(self, field):
        return getattr(self, field, 0) if field in ("start_us", "end_us") else self._stamps.get(field, 0)


@pytest.mark.parametrize("kind,stamps,names", [
    ("client", dict(start_us=10, response_write_us=12, received_us=40, end_us=45),
     ["client.pack", "client.await", "client.complete"]),
    ("collective", dict(start_us=10, placed_us=14, end_us=20), ["ici.place", "ici.deliver"]),
    # a batched row: the flush stamp splits the queue
    ("server", dict(received_us=10, parse_done_us=11, enqueued_us=11, batch_flush_us=1011,
                    callback_start_us=1050, callback_done_us=1300, response_write_us=1310,
                    sent_us=1320),
     ["server.parse", "server.batch_wait", "server.dispatch", "server.callback",
      "server.write", "server.send"]),
    # an unbatched row: the dispatch runs from the enqueue
    ("server", dict(received_us=10, parse_done_us=11, enqueued_us=11, callback_start_us=20),
     ["server.parse", "server.dispatch"]),
    # a leg still open, and stamps out of order, give nothing
    ("collective", dict(start_us=10), []),
    ("client", dict(start_us=10, response_write_us=9), []),
])
def test_phases_of_a_span_run_stamp_to_stamp(kind, stamps, names):
    got = phases.stamps_of(_FakeSpan(kind, **stamps)).phases
    assert [n for n, _, _ in got] == names
    assert all(a <= b for _, a, b in got)
    if "server.dispatch" in names:
        start = dict((n, a) for n, a, _ in got)["server.dispatch"]
        assert start == stamps.get("batch_flush_us", stamps["enqueued_us"])


def _call(trace, at, pack, complete, legs_place=(), leg_end=None):
    """A client span ending at ``at`` us, with its phases, and its legs."""
    start = at - pack - complete - 100
    out = [_span("client", trace, 1, 0, start, at, ph=[
        ("client.pack", start, start + pack), ("client.await", start + pack, at - complete),
        ("client.complete", at - complete, at)])]
    for k, place in enumerate(legs_place):
        end = leg_end or at - complete - 1
        out.append(_span("collective", trace, 10 + k, 1, end - place - 5, end,
                         ph=[("ici.place", end - place - 5, end - 5), ("ici.deliver", end - 5, end)]))
    return out


def test_figures_read_the_window_spans_and_the_moved_totals():
    lo, hi = 1_000_000, 2_000_000
    spans = (_call(1, 1_100_000, 20, 30, legs_place=(40, 60))
             + _call(2, 1_200_000, 40, 10, legs_place=(80, 20))
             + _call(3, 900_000, 999, 999, legs_place=(999,))  # before the window
             + _call(4, 2_100_000, 999, 999, legs_place=(999,)))  # after it
    moved = {"handoffs": 300, "batch_rows": 500, "batch_wait_ns": 550_000_000}
    got = phases.figures(spans, moved, 100, lo, hi)
    assert got == pytest.approx({
        "client_host_us": (50 + 50) / 2,
        "fabric_place_us": (40 + 60 + 80 + 20) / 2,  # every leg's placing, a call
        "batch_wait_us": 1100.0,
        "task_handoffs_per_call": 3.0,
    })


@pytest.mark.parametrize("figure", ["client_host_us", "fabric_place_us", "batch_wait_us",
                                    "task_handoffs_per_call"])
def test_a_figure_with_nothing_to_read_is_left_out(figure):
    # no spans in the window, no batcher, no calls: a program without the stamps
    assert figure not in phases.figures([], {"handoffs": 5}, 0, 0, 10)
    # a call without legs, a batcher that took no rows, no call completed:
    # only the client's own time has something to read
    got = phases.figures(_call(1, 5, 1, 1), {"batch_rows": 0, "batch_wait_ns": 0}, 0, 0, 10)
    assert (figure in got) == (figure == "client_host_us")


def test_counters_read_the_runtime_and_a_batcher():
    from types import SimpleNamespace

    from incubator_brpc_tpu_torch.runtime import scheduler

    got = phases.counters(SimpleNamespace(rows=7, wait_ns=70))
    assert got["batch_rows"] == 7 and got["batch_wait_ns"] == 70
    assert got["handoffs"] <= scheduler.handoffs_total()
    assert set(phases.counters()) == {"handoffs"}
    # a batcher of a program before the wait counter
    assert set(phases.counters(SimpleNamespace(rows=7))) == {"handoffs"}


def test_the_tap_chains_under_the_server_span_keeper_and_leaves_with_it():
    from benchmark.harness.spans import ServerSpans
    from incubator_brpc_tpu_torch.observability.span import Span, span_db

    db = span_db()
    tap = phases.SpanTap().attach()
    with ServerSpans() as server:
        span = Span("server", "S", "M")
        span.received_us, span.enqueued_us, span.callback_start_us = 10, 11, 20
        db.add(span)
        kept = [s for s in tap.stamps if s.kind == "server"]
    assert "add" not in db.__dict__  # both taps are off
    assert len(kept) == 1 and kept[0].phases == [("server.dispatch", 11, 20)]
    assert server.stamps[-1][2:] == (10, 20)


# ---- on the tiny cells ----------------------------------------------------------
@pytest.mark.parametrize("name", ["echo.4kb", "ps.forward.p1"])
def test_the_phase_run_names_idle_time_by_program_phase(name):
    import torch

    from benchmark.phases import run_phases

    out = run_phases(tiny_cell(name), 11, 1.5, torch.device("cpu"))
    assert out["correct"]
    named = {n for n, _ in out["idle_gaps"]}
    assert {"client.pack", "client.complete", "ici.place"} <= named
    assert out["program_idle_share"] > 0.5
    assert abs(out["clock_offset_us"]) < 1000
    assert out["anchor_width_us"] >= 0
    assert len(out["phases_per_second"]) == 2
    assert sum(s["calls"] for s in out["phases_per_second"]) == pytest.approx(out["calls"], abs=2)
    assert "client.await" in out["phases_per_second"][0]["mean_us"]
    figures = out["figures"]
    assert {"client_host_us", "fabric_place_us", "task_handoffs_per_call"} <= set(figures)
    assert all(v >= 0 for v in figures.values())
    # the yardstick's own per-layer metrics, from the same run
    assert "server_wait_us" in out["metrics"]
    if name == "ps.forward.p1":
        assert {"server.batch_wait", "ici.cq"} <= named
        assert figures["batch_wait_us"] >= 900  # a lone row waits out the 1000 us timer
        assert figures["task_handoffs_per_call"] >= 2
    else:
        assert "batch_wait_us" not in figures


def test_a_traced_tiny_run_is_unchanged_by_the_phase_run_having_run():
    # the runner's hooks are put back: a plain traced run after the phase
    # run keeps no anchor range and reports as before
    import torch

    from benchmark.harness import runner
    from benchmark.harness.timeline import from_profiler
    from benchmark.phases import run_phases

    run_phases(tiny_cell("echo.4kb"), 12, 0.5, torch.device("cpu"))
    assert runner.from_profiler is from_profiler
    r = run_tiny("echo.4kb", seconds=0.5, trace=True)
    assert r.correct
    assert phases.ANCHOR_RANGE not in {n for n, _ in r.breakdown["idle_gaps"]}
