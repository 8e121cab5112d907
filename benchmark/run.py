"""Run one cell of ``BENCHMARK.json`` once, on the card, and print its line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a run of its own under ``torch.profiler`` with
every rpcz span kept, and a breakdown of the trace.  The last line of
standard output is the result; the line before it holds the figures kept
beside it (p95 and p99 of every cell, the memory peak, the card's power
limit).  The numbers compared with the reference, each with its limit,
are the last lines of standard error and the result's last key.

Exits 3, printing no result, where the machine shows fewer cards than the
cell asks for, and 4 where ``jax``, ``jaxlib``, ``flax`` or the JAX
package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# build and kernel caches at fixed paths inside the checkout; a library
# that would load JAX on its own is kept from it
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".bench_cache" / "torch_extensions")
os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import device as devmod
    from benchmark.harness.cell import find_cell
    from benchmark.harness.guard import forbidden_loaded

    cell = find_cell(args.workload)
    try:
        devmod.require_cards(cell.chips)
    except devmod.NoCard as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3

    import torch

    from benchmark.harness.runner import run_cell

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    loaded = forbidden_loaded()
    if loaded:
        print(f"benchmark: loaded in the measuring process: {', '.join(loaded)}", file=sys.stderr)
        return 4
    notes = dict(result.notes, card=devmod.power_limit())
    print(json.dumps({"cell": cell.name, "seed": args.seed, "trace": args.trace, "kept": notes}))
    for name, c in result.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result.line()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
