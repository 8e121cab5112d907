"""Time the port's /metrics page after a history of test files in one process.

    JAX_PLATFORMS=cpu python tests/torch_metrics_history.py [--root DIR] [--files N] [--pages K]

Runs the first N (default 27) of ``DIR/tests/test_torch_*.py`` in name order
in this interpreter with pytest, as a one-process lane does, then renders
``/metrics`` K times (default 5) through the port's ``metrics_page`` and
prints one JSON line: the files run, the pytest exit code, the
``rpc_phase_latency_us`` keys the page prints, the phase recorders, the
``_flush_batches`` calls one page makes (all recorders, and the phase
recorders alone; the 1 Hz sampler's ticks not counted), each page's
milliseconds and, before each page, the milliseconds of reading the
``rpc_phase_latency_us`` family alone.  DIR (default: this checkout) may
be another checkout of the repository, so two commits can be compared on
one host.  Collected by pytest only when named; nothing here is a test.
"""

import argparse
import json
import os
import pathlib
import sys
import threading
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--files", type=int, default=27)
    ap.add_argument("--pages", type=int, default=5)
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    os.chdir(root)
    sys.path.insert(0, str(root))
    import pytest

    files = sorted(str(p.relative_to(root)) for p in (root / "tests").glob("test_torch_*.py"))
    files = files[: args.files]
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "not slow", *files])

    from incubator_brpc_tpu_torch.builtin import metrics_page
    from incubator_brpc_tpu_torch.metrics.latency_recorder import LatencyRecorder
    from incubator_brpc_tpu_torch.observability import latency_breakdown as lb

    me, folds = threading.current_thread(), {}
    flush = LatencyRecorder._flush_batches

    def counted(rec):
        if threading.current_thread() is me:
            folds[id(rec)] = folds.get(id(rec), 0) + 1
        return flush(rec)

    LatencyRecorder._flush_batches = counted
    with lb._lock:
        phase_ids = {id(r) for r in lb._recorders.values()}
    page_ms, family_ms, keys, per_page = [], [], 0, {}
    for _ in range(args.pages):
        t0 = time.perf_counter()
        lb.phase_dimension.items()
        family_ms.append((time.perf_counter() - t0) * 1e3)
        folds.clear()
        t0 = time.perf_counter()
        _, body, _ = metrics_page(None, None)
        page_ms.append((time.perf_counter() - t0) * 1e3)
        keys = len({line.rsplit(",stat=", 1)[0] for line in body.splitlines()
                    if line.startswith("rpc_phase_latency_us{")})
        per_page = dict(folds)
    LatencyRecorder._flush_batches = flush
    print(json.dumps({
        "root": str(root),
        "files": len(files),
        "last_file": files[-1] if files else None,
        "pytest_rc": int(rc),
        "phase_keys": keys,
        "phase_recorders": len(phase_ids),
        "flushes_per_page": sum(per_page.values()),
        "phase_flushes_per_page": sum(n for i, n in per_page.items() if i in phase_ids),
        "page_ms": page_ms,
        "phase_family_ms": family_ms,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
