"""Run one cell traced, with every rpcz span's stamps laid on the device
trace's clock, and print where the host's time goes, phase by phase.

    python3 benchmark/phases.py --workload echo.64mb --seed 7 --seconds 51 [--out phases.json]

A diagnostic beside the benchmark, not part of its yardstick: one run of
``benchmark/run.py --trace 1`` (``harness.runner.run_cell``, its set-up,
warm-up, window and check as they are), into which it taps every span
the program's collector stores and the program's running totals on each
side of the window (``harness/phases.py``).  The JSON line printed holds:

- ``correct`` and ``metrics``: the traced run's own result;
- ``clock_offset_us``: wall clock - trace clock, from one
  ``time.time_ns()`` read inside a range of its own just before the
  window, and ``anchor_width_us``, that range's width (the offset is
  good to half of it);
- ``idle_gaps``: the device's idle time by the innermost range open
  while it lasted, the program's call phases among the ranges, and
  ``program_idle_share``, the part of it under a program phase;
- ``launches``: of the transmit kernel's CUDA launches, how many the
  trace has and the share whose host call lies inside an ``ici.place``
  range;
- ``figures``: ``client_host_us``, ``fabric_place_us``,
  ``batch_wait_us`` and ``task_handoffs_per_call`` over the window
  (``phases.figures``);
- ``phases_per_second``: each second's calls completed, each phase's
  mean and its own time a call, and ``slow_fast``: the ten slowest
  seconds against the ten fastest, each phase's growth between them
  first; ``place_ops``: the host calls begun inside ``ici.place`` in
  those seconds, by name.

Exits 3 where the machine shows no card.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import phases  # noqa: E402

K1_NAME = "copy_csum"  # the transmit kernel's name holds this


def _launches(prof, lo: int, hi: int, place) -> dict:
    """The transmit kernel's CUDA launches in [lo, hi], and the share
    whose host call (joined by correlation id) lies inside one of the
    ``place`` ranges."""
    from torch.autograd import DeviceType

    host, device = {}, []
    for e in prof.profiler.kineto_results.events():
        cid = e.correlation_id()
        if not cid:
            continue
        if e.device_type() == DeviceType.CUDA:
            if K1_NAME in e.name() and lo <= e.start_ns() < hi:
                device.append(cid)
        elif "Launch" in e.name():
            host[cid] = e.start_ns()
    starts = sorted(host[c] for c in device if c in host)
    spans = sorted((r.start_ns, r.end_ns) for r in place)
    inside, j = 0, 0
    for t in starts:  # both sorted: walk the ranges once
        while j < len(spans) and spans[j][1] < t:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] <= t:
            if t <= spans[k][1]:
                inside += 1
                break
            k += 1
    return {"kernel": K1_NAME, "launches": len(device), "host_calls_found": len(starts),
            "inside_ici_place": inside,
            "share_inside": inside / len(starts) if starts else None}


def _ops_inside(prof, place, offset_ns: int, lo_us: int, per_s, top: int = 12) -> dict:
    """The host's torch and CUDA runtime calls that began inside an
    ``ici.place`` range, in the ten slowest and the ten fastest seconds
    (``slow_fast``'s): each name's microseconds a call in both, the
    names that grew most first (nested calls count in each name)."""
    import bisect

    from torch.autograd import DeviceType

    full = per_s[:-1]
    if len(full) < 20:
        return {}
    ranked = sorted(range(len(full)), key=lambda k: full[k]["calls"])
    side = {k: "slow" for k in ranked[:10]}
    side.update({k: "fast" for k in ranked[-10:]})
    spans = sorted((r.start_ns, r.end_ns) for r in place)
    starts = [a for a, _ in spans]
    sums = {"slow": {}, "fast": {}}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA or e.is_user_annotation():
            continue
        t = e.start_ns()
        i = bisect.bisect_right(starts, t) - 1
        if i < 0 or t > spans[i][1]:
            continue
        which = side.get((t + offset_ns) // 1000 // 1_000_000 - lo_us // 1_000_000)
        if which is not None:
            acc = sums[which]
            acc[e.name()] = acc.get(e.name(), 0) + e.duration_ns()
    calls = {w: max(1, sum(full[k]["calls"] for k, v in side.items() if v == w)) for w in sums}
    per = {w: {n: ns / 1000 / calls[w] for n, ns in sums[w].items()} for w in sums}
    growth = {n: per["slow"].get(n, 0.0) - per["fast"].get(n, 0.0)
              for n in set(per["slow"]) | set(per["fast"])}
    names = sorted(growth, key=lambda n: -growth[n])[:top]
    return {n: {"slow_us": per["slow"].get(n, 0.0), "fast_us": per["fast"].get(n, 0.0)} for n in names}


class _Probe:
    """What the phase run adds to one traced ``run_cell``: a tap on the
    span store, the program's totals and a clock anchor on each side of
    the window (through the deployment's ``counters()``, which the runner
    reads just before and just after it, under the profiler), and a look
    at the raw trace as the runner builds its timeline."""

    def __init__(self):
        self.tap = phases.SpanTap()
        self.totals = []  # the program's running totals before and after the window
        self.anchor_wall_ns = None
        self.trace = None

    def before_window(self, dep) -> None:
        from torch.profiler import record_function

        self.tap.attach()
        counters = dep.counters
        batcher = getattr(dep, "batcher", None)

        def around_window():
            if not self.totals:
                with record_function(phases.ANCHOR_RANGE):
                    self.anchor_wall_ns = time.time_ns()
            self.totals.append(phases.counters(batcher))
            return counters()

        dep.counters = around_window

    def reading(self, from_profiler):
        def read(prof):
            tl = from_profiler(prof)
            self.trace = self._read_trace(prof, tl)
            return tl

        return read

    def _read_trace(self, prof, tl) -> dict:
        from benchmark.harness.timeline import Timeline

        anchor = next((r for r in tl.ranges if r.name == phases.ANCHOR_RANGE), None)
        if anchor is None:
            raise RuntimeError(f"the trace holds no {phases.ANCHOR_RANGE!r} range")
        offset = phases.clock_offset_ns(anchor, self.anchor_wall_ns)
        lo_us, hi_us = (tl.lo + offset) // 1000, (tl.hi + offset) // 1000
        spans = self.tap.stamps
        mine = phases.host_ranges(phases.all_phases(spans), offset)
        place = [r for r in mine if r.name == "ici.place"]
        gaps = Timeline(tl.ops, tl.ranges + mine, tl.lo, tl.hi).idle_gaps(top=40)
        per_s = phases.per_second(spans, lo_us, hi_us)
        return {
            "lo_us": lo_us, "hi_us": hi_us,
            "clock_offset_us": offset / 1000,
            "anchor_width_us": (anchor.end_ns - anchor.start_ns) / 1000,
            "busy_s": tl.busy_ns / 1e9, "idle_gaps": gaps,
            "program_idle_share": phases.program_share(gaps),
            "launches": _launches(prof, tl.lo, tl.hi, place),
            "slow_fast": phases.slow_fast(per_s),
            "place_ops": _ops_inside(prof, place, offset, lo_us, per_s),
            "phases_per_second": per_s,
        }


def run_phases(cell, seed: int, seconds: float, device, t_start: float = None) -> dict:
    from benchmark.harness import runner

    probe = _Probe()
    build = runner.from_profiler
    runner.from_profiler = probe.reading(build)
    try:
        result = runner.run_cell(cell, seed, seconds, True, device,
                                 time.perf_counter() if t_start is None else t_start,
                                 before_window=probe.before_window)
    finally:
        runner.from_profiler = build
    trace = probe.trace
    lo_us, hi_us = trace.pop("lo_us"), trace.pop("hi_us")
    c0, c1 = probe.totals
    moved = {k: c1[k] - c0[k] for k in c0}
    calls = result.notes["calls"]
    return {
        "cell": cell.name, "seed": seed, "correct": result.correct, "calls": calls,
        "window_s": result.notes["window_s"], "spans": len(probe.tap.stamps),
        "metrics": {k: m["value"] for k, m in result.metrics.items()},
        "figures": phases.figures(probe.tap.stamps, moved, calls, lo_us, hi_us),
        **trace,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import device as devmod
    from benchmark.harness.cell import find_cell

    cell = find_cell(args.workload)
    try:
        devmod.require_cards(cell.chips)
    except devmod.NoCard as e:
        print(f"phases: {e}", file=sys.stderr)
        return 3
    out = run_phases(cell, args.seed, args.seconds, torch.device("cuda", 0), T_START)
    out["card"] = devmod.power_limit()
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
        out.pop("phases_per_second")  # long: in the file only
        line = json.dumps(out)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
