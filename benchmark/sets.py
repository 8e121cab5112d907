"""Run cells in sets of runs, each run a process of its own, and print each
metric's median and spread per set: the measurement a bound is set from.

    python3 benchmark/sets.py --workload echo.64mb --seeds 11,12,13,14,15,16 \
        --sets 2 --seconds 20 [--trace 0] [--out runs.jsonl]

Every set runs the same seeds in the same order.  A spread is
(third quartile - first quartile) / median, the quartiles of
``statistics.quantiles(values, n=4)``.  Each run's result line (and its
stderr tail where it failed) goes to ``--out`` as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from benchmark.harness.stats import spread  # noqa: E402


def run_once(workload: str, seed: int, seconds: float, trace: int, timeout: float) -> dict:
    cmd = [sys.executable, str(HERE / "run.py"), "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=HERE.parent)
    wall = time.perf_counter() - t0
    lines = [ln for ln in p.stdout.splitlines() if ln.strip()]
    out = {"workload": workload, "seed": seed, "trace": trace, "rc": p.returncode, "wall_s": wall}
    try:
        out["result"] = json.loads(lines[-1])
        out["kept"] = json.loads(lines[-2]).get("kept") if len(lines) > 1 else None
    except (IndexError, ValueError):
        out["stderr"] = p.stderr[-4000:]
    return out


def summary(runs) -> dict:
    by = {}
    for r in runs:
        for name, m in r.get("result", {}).get("metrics", {}).items():
            by.setdefault(name, []).append(m["value"])
    out = {}
    for name, vals in by.items():
        med = statistics.median(vals)
        out[name] = {"median": med, "spread": spread(vals) if len(vals) >= 2 else None,
                     "min": min(vals), "max": max(vals), "n": len(vals)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, action="append")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=1200)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    bad = 0
    try:
        for workload in args.workload:
            for k in range(args.sets):
                runs = []
                for seed in seeds:
                    r = run_once(workload, seed, args.seconds, args.trace, args.timeout)
                    r["set"] = k
                    runs.append(r)
                    res = r.get("result", {})
                    if r["rc"] != 0 or not res.get("correct"):
                        bad += 1
                    checks = {n: c["value"] for n, c in res.get("checks", {}).items()}
                    print(f"[run] {workload} set {k} seed {seed} rc {r['rc']} "
                          f"correct {res.get('correct')} wall {r['wall_s']:.1f}s "
                          f"metrics {json.dumps({n: m['value'] for n, m in res.get('metrics', {}).items()})} "
                          f"checks {json.dumps(checks)} kept {json.dumps(r.get('kept'))}", flush=True)
                    if "stderr" in r:
                        print(r["stderr"][-1500:], flush=True)
                    if out:
                        out.write(json.dumps(r) + "\n")
                        out.flush()
                print(f"[set] {workload} set {k} {json.dumps(summary(runs))}", flush=True)
    finally:
        if out:
            out.close()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
