"""One run of one cell: set-up, the window, the metrics, the check.

``run_cell`` does all of a run but the look for a card, so the tests
can drive it on the CPU at small sizes; ``benchmark/run.py`` looks for
the card first and prints what this returns.
"""

from __future__ import annotations

from contextlib import ExitStack
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from benchmark.harness import device as devmod
from benchmark.harness.cell import Cell, load_module
from benchmark.harness.ranges import Ranges
from benchmark.harness.spans import ServerSpans
from benchmark.harness.stats import percentile
from benchmark.harness.timeline import from_profiler
from benchmark.harness.window import Window


@dataclass
class RunContext:
    """What every metric reader is handed."""

    cell: Cell
    window: Window
    setup_s: float
    counters: Dict[str, int]  # the program's counters, moved across the window
    timeline: object = None  # harness.timeline.Timeline of a traced run
    server_spans: Optional[List] = None  # (service, method, received_us, callback_start_us)

    @property
    def completed(self) -> int:
        return len(self.window.completed)

    @property
    def window_s(self) -> float:
        return self.window.seconds


@dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: Dict[str, dict]
    device: dict
    checks: Dict[str, dict]
    breakdown: Optional[dict] = None
    notes: dict = field(default_factory=dict)

    def line(self) -> dict:
        out = {"correct": self.correct, "attempted": self.attempted, "failed": self.failed,
               "metrics": self.metrics, "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["checks"] = self.checks  # last, as the numbers compared with their limits
        return out


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, before_window=None, check=None) -> Result:
    """``t_start`` is the process's start on ``time.perf_counter``'s clock.
    ``before_window(dep)``, when given, runs after set-up (a test's or a
    control's change to the path under test); ``check(dep, window, ref)``,
    when given, takes the place of the deployment's own check (a control
    that puts the reference in the program's place)."""
    ranges = Ranges(trace)
    gen = load_module("traffic", cell.traffic["generator"])
    ref = load_module("reference", cell.config_name)
    dep = load_module("deployments", cell.config_name).Deployment(
        cell.config, cell.traffic, device, seed, ranges)
    try:
        dep.warm(gen, cell.traffic, ranges)
        dep.sync()
        if before_window is not None:
            before_window(dep)
        with ExitStack() as traced:
            spans = traced.enter_context(ServerSpans()) if trace else None
            prof = traced.enter_context(_profiler()) if trace else None
            c0 = dep.counters()
            with ranges("bench.window"):
                window = gen.run(dep, cell.traffic, seconds=seconds, ranges=ranges)
            c1 = dep.counters()
        setup_s = window.start_ns / 1e9 - t_start
        device_line = devmod.describe(device, cell.chips)  # the peak, read before the check
        timeline = None
        if trace:
            timeline = from_profiler(prof)
            device_line["busy_s"] = timeline.busy_ns / 1e9
            device_line["window_s"] = timeline.window_ns / 1e9
            prof = None  # the raw trace is not kept through the check
        ctx = RunContext(
            cell=cell, window=window, setup_s=setup_s,
            counters={k: c1[k] - c0[k] for k in c0}, timeline=timeline,
            server_spans=(spans.within(window.start_wall_us, window.end_wall_us)
                          if spans is not None else None),
        )
        metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, ctx)
        lats = window.latencies_ns()
        notes = {"calls": len(lats), "issued": window.issued, "window_s": window.seconds,
                 "memory_peak_bytes": device_line["memory_peak_bytes"],
                 "counters": ctx.counters, "per_second": window.per_second()}
        if lats:  # tails kept beside every cell's result, gated or not
            notes["p95_ms"] = percentile(lats, 0.95) / 1e6
            notes["p99_ms"] = percentile(lats, 0.99) / 1e6
        dep.close_program()  # the program's state goes before the reference runs
        values = (check or type(dep).check)(dep, window, ref)
    finally:
        dep.close()
    failed = window.issued - len(window.completed)
    checks = {name: {"value": values[name], "limit": cell.limits[name]} for name in cell.limits}
    correct = (failed == 0 and len(window.completed) > 0 and set(values) == set(cell.limits)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    breakdown = None
    if timeline is not None:
        breakdown = {"device_ops": timeline.device_ops(), "idle_gaps": timeline.idle_gaps()}
    return Result(correct, window.issued, failed, metrics, device_line, checks, breakdown, notes)


def read_metrics(entries, ctx: RunContext) -> Dict[str, dict]:
    """Each metric's reader, ``benchmark/metrics/<name>.py``; one that finds
    nothing to read returns None and the metric is left out."""
    out = {}
    for m in entries:
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
