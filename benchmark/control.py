"""Read the numbers that decide ``correct`` from sound runs and from the
control, at a cell's own size and load, in one process on the card.

    python3 benchmark/control.py --workload ps.forward.p1 \
        --seeds 101,102,...,112 --control-seeds 201,202,203 --seconds 3 [--out readings.jsonl]

A limit lies between two readings: the largest a sound run gives over
the seeds, and the smallest the control gives.  The control is the
deployment's ``control_check``: the reference, one precision lower, in
the program's place for the same calls; ``--faults`` reads the faults
the deployment module names in ``FAULTS`` as well.  The benchmark's own
runs never run either.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_check(cell):
    """The configuration's control: its deployment's ``control_check``."""
    from benchmark.harness.cell import load_module

    return load_module("deployments", cell.config_name).Deployment.control_check


def faults_of(cell) -> dict:
    """The configuration's faults through the program's own paths, by name."""
    from benchmark.harness.cell import load_module

    return getattr(load_module("deployments", cell.config_name), "FAULTS", {})


def readings(cell, seeds, seconds, device, kind: str):
    """``kind``: "sound", "control", or the name of a fault."""
    from benchmark.harness.runner import run_cell

    before = check = None
    if kind == "control":
        check = control_check(cell)
    elif kind != "sound":
        before = faults_of(cell)[kind]
    for seed in seeds:
        r = run_cell(cell, seed, seconds, False, device, time.perf_counter(),
                     before_window=before, check=check)
        yield {"workload": cell.name, "kind": kind, "seed": seed, "correct": r.correct,
               "calls": r.notes["calls"],
               "checks": {n: c["value"] for n, c in r.checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--faults", action="store_true",
                    help="also read the configuration's faults on the control seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness.cell import find_cell
    from benchmark.harness.device import require_cards

    cell = find_cell(args.workload)
    require_cards(cell.chips)
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    lows, highs = {}, {}
    plan = [("sound", args.seeds), ("control", args.control_seeds)]
    if args.faults:
        plan += [(name, args.control_seeds) for name in faults_of(cell)]
    try:
        for kind, seeds in plan:
            for line in readings(cell, [int(s) for s in seeds.split(",") if s], args.seconds,
                                 device, kind):
                print(json.dumps(line), flush=True)
                if out:
                    out.write(json.dumps(line) + "\n")
                for n, v in line["checks"].items():
                    if kind == "sound":
                        lows[n] = max(lows.get(n, v), v)
                    else:  # the least that each number reads over the control and faults
                        highs.setdefault(kind, {})
                        highs[kind][n] = min(highs[kind].get(n, v), v)
    finally:
        if out:
            out.close()
    print(json.dumps({"workload": cell.name, "lower_reading": lows, "upper_reading": highs,
                      "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
