"""Each metric's arithmetic on synthetic traces and windows."""

from __future__ import annotations

import statistics
from types import SimpleNamespace

import pytest

from benchmark.harness import peaks
from benchmark.harness.cell import find_cell, load_module
from benchmark.harness.stats import percentile, spread
from benchmark.harness.timeline import (NO_RANGE, DeviceOp, HostRange, Timeline, _kind, gaps,
                                        idle_by_range, union)
from benchmark.harness.window import Call, Window

US = 1000  # ns


def ctx_of(cell, timeline=None, completed=0, counters=None, spans=None, window=None):
    if window is None:
        window = Window(start_ns=0, end_ns=10**9, issued=completed,
                        calls=[Call(k, 0, 1, True, None) for k in range(completed)])
    return SimpleNamespace(cell=cell, timeline=timeline, window=window,
                           completed=len(window.completed), window_s=window.seconds,
                           counters=counters or {}, server_spans=spans, setup_s=1.0)


def read(name, ctx):
    return load_module("metrics", name).read(ctx)


def test_busy_time_is_the_union_across_overlapping_streams():
    # a copy on one stream overlaps two kernels on another: 30 + 40 - 10 + 5
    ops = [DeviceOp("k1", "kernel", 0, 30 * US), DeviceOp("copy", "memcpy", 20 * US, 60 * US),
           DeviceOp("k2", "kernel", 50 * US, 55 * US), DeviceOp("set", "memset", 80 * US, 85 * US)]
    tl = Timeline(ops, [], 0, 100 * US)
    assert tl.busy_ns == 65 * US  # the sum of the durations would be 80 us
    assert tl.op_count() == 4
    assert union([(0, 5), (3, 9), (20, 30)], 4, 25) == [(4, 9), (20, 25)]
    assert gaps([(10, 20), (30, 40)], 0, 50) == [(0, 10), (20, 30), (40, 50)]
    top = dict((n, s) for n, s in tl.device_ops())
    assert top["copy"] == pytest.approx(40e-6) and top["k1"] == pytest.approx(30e-6)


def test_ops_outside_the_window_are_clipped_away():
    ops = [DeviceOp("before", "kernel", 0, 10), DeviceOp("edge", "kernel", 90, 110),
           DeviceOp("after", "kernel", 200, 300)]
    tl = Timeline(ops, [], 100, 150)
    assert tl.busy_ns == 10 and tl.op_count() == 1


def test_idle_time_is_named_by_the_innermost_range_open_while_it_lasts():
    ranges = [HostRange("bench.window", 1, 1000), HostRange("harness.wait", 10, 990),
              HostRange("client.call", 100, 300), HostRange("client.done", 150, 180),
              HostRange("client.call", 400, 450)]
    # inside one range, inside a nested one, across a range's end, before any range
    assert idle_by_range([(120, 140)], ranges) == {"client.call": 20}
    assert idle_by_range([(160, 170)], ranges) == {"client.done": 10}
    assert idle_by_range([(420, 500)], ranges) == {"client.call": 30, "harness.wait": 50}
    assert idle_by_range([(0, 5)], ranges) == {NO_RANGE: 1, "bench.window": 4}
    tl = Timeline([DeviceOp("k", "kernel", 0, 100), DeviceOp("k", "kernel", 300, 900)],
                  ranges, 0, 1000)
    assert dict((n, s) for n, s in tl.idle_gaps()) == pytest.approx({
        "client.call": 170e-9, "client.done": 30e-9, "harness.wait": 90e-9,
        "bench.window": 10e-9})


def test_a_range_mirrored_on_the_device_and_sync_markers_are_no_work():
    assert _kind("", "void copy_csum_blocks_kernel<F32>(...)") == "kernel"
    assert _kind("", "Memcpy HtoD (Pageable -> Device)") == "memcpy"
    assert _kind("", "Memset (Device)") == "memset"
    assert _kind("", "Context Sync") is None
    assert _kind("gpu_user_annotation", "client.call") is None
    assert _kind("kernel", "gemm") == "kernel"


def test_percentiles_take_every_sample_of_the_window():
    lats = sorted(range(1, 1001))
    assert percentile(lats, 0.5) == 500 and percentile(lats, 0.95) == 950
    assert percentile([7], 0.95) == 7
    vals = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, q2, q3 = statistics.quantiles(vals, n=4)
    assert spread(vals) == pytest.approx((q3 - q1) / q2)


def test_end_to_end_metrics_cover_the_whole_window():
    calls = [Call(k, 0, (k + 1) * 10**6, True, None) for k in range(100)]
    calls.append(Call(100, 0, 5, False, "timed out"))
    win = Window(start_ns=0, end_ns=2 * 10**9, issued=101, calls=calls)
    ctx = ctx_of(find_cell("echo.4kb"), window=win)
    assert read("calls_per_s", ctx) == pytest.approx(50.0)  # the failed call is not counted
    assert read("p50_ms", ctx) == pytest.approx(50.0)
    assert read("setup_s", ctx) == 1.0


def test_the_transmit_roofline_counts_two_hops_of_a_read_and_a_write():
    cell = find_cell("echo.64mb")
    payload = 8192 * 2048 * 4
    busy = 10 * 112 * US  # ten echoes at 112 us of device time each
    tl = Timeline([DeviceOp("K1", "kernel", 0, busy)], [], 0, 10**9)
    share = read("transmit_roofline_pct", ctx_of(cell, tl, completed=10))
    want = 100 * (10 * 4 * payload / peaks.HBM_BYTES_PER_S) / (busy / 1e9)
    assert share == pytest.approx(want)
    assert 60 < share < 80
    assert read("transmit_roofline_pct", ctx_of(cell, None, completed=10)) is None
    assert read("transmit_roofline_pct", ctx_of(find_cell("ps.forward.p1"), tl, 10)) is None


def test_the_forward_roofline_counts_served_rows_and_one_read_of_w_a_batch():
    cell = find_cell("ps.forward.p1")
    d = 6144
    fwd = load_module("metrics", "forward_roofline_pct")
    one = max(2 * 16 * d * d / peaks.FP32_FLOPS, (4 * d * d + 8 * 16 * d) / peaks.HBM_BYTES_PER_S)
    assert fwd.least_seconds(16, 1, d) == pytest.approx(one)
    assert one == pytest.approx((4 * d * d + 8 * 16 * d) / peaks.HBM_BYTES_PER_S)  # W-bound
    # 100 batches of 16 rows; padding to a bucket adds nothing to the count
    tl = Timeline([DeviceOp("gemm", "kernel", 0, 10**7)], [], 0, 10**9)
    share = read("forward_roofline_pct", ctx_of(
        cell, tl, counters={"forward_rows": 1600, "forward_batches": 100}))
    assert share == pytest.approx(100 * 100 * one / 1e-2)
    # past the ridge the operations bound it, and the sum never passes the true least time
    assert fwd.least_seconds(4096, 1, d) == pytest.approx(2 * 4096 * d * d / peaks.FP32_FLOPS)
    mixed = fwd.least_seconds(1 + 4096, 2, d)
    assert mixed <= fwd.least_seconds(1, 1, d) + fwd.least_seconds(4096, 1, d)
    assert read("forward_roofline_pct", ctx_of(find_cell("echo.64mb"), tl)) is None


def test_layer_counts_and_shares():
    cell = find_cell("ps.forward.p1")
    tl = Timeline([DeviceOp("a", "kernel", 0, 100), DeviceOp("b", "memcpy", 50, 250),
                   DeviceOp("c", "memset", 300, 400)], [], 0, 1000)
    ctx = ctx_of(cell, tl, completed=6, counters={"forward_rows": 30, "forward_batches": 2},
                 spans=[("PsService", "Forward", 100, 1100), ("PsService", "Forward", 200, 3200),
                        ("PsService", "Forward", 0, 50)])
    assert read("kernel_launches_per_call", ctx) == pytest.approx(0.5)
    assert read("device_idle_pct", ctx) == pytest.approx(65.0)
    assert read("rows_per_batch", ctx) == pytest.approx(15.0)
    assert read("server_wait_us", ctx) == pytest.approx(2000.0)  # the unstamped span is left out
    quiet = ctx_of(cell, Timeline([], [], 0, 1000), completed=6, spans=[])
    for name in ("kernel_launches_per_call", "device_idle_pct", "rows_per_batch",
                 "server_wait_us", "forward_roofline_pct"):
        assert read(name, quiet) is None
