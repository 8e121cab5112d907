"""parallel_http — mass concurrent HTTP fetcher.

Analog of reference tools/parallel_http/parallel_http.cpp: fetch many
URLs concurrently on the runtime's worker pool with a bounded
in-flight window, live 1 Hz progress (done/total, qps), per-fetch
latency percentiles, status/error accounting, and optional body output
to a directory (the reference's -output).
"""

from __future__ import annotations

import argparse
import os
import threading
import time
from typing import Dict, Optional


class FetchStats:
    """Aggregate of one fetch_all run."""

    def __init__(self):
        self.ok = 0
        self.failed = 0
        self.bytes = 0
        self.status_counts: Dict[int, int] = {}
        self.latencies_us: list = []
        self.wall_s = 0.0

    def percentile(self, ratio: float) -> int:
        if not self.latencies_us:
            return -1
        xs = sorted(self.latencies_us)
        return xs[min(len(xs) - 1, int(len(xs) * ratio))]

    def summary(self) -> str:
        total = self.ok + self.failed
        qps = total / self.wall_s if self.wall_s > 0 else 0.0
        return (
            f"fetched {self.ok}/{total} ok ({self.bytes} bytes) in "
            f"{self.wall_s:.2f}s ({qps:.1f} fetch/s)  latency_us "
            f"p50={self.percentile(0.5)} p90={self.percentile(0.9)} "
            f"p99={self.percentile(0.99)}  statuses={dict(sorted(self.status_counts.items()))}"
        )


def fetch_all(
    urls,
    concurrency: int = 16,
    timeout: float = 5.0,
    output_dir: Optional[str] = None,
    report=print,
    progress_interval_s: float = 1.0,
):
    """Fetch every `url` ("host:port/path") with at most `concurrency`
    in flight. Returns (results, stats) where results[url] = (ok, body
    or error-repr)."""
    from incubator_brpc_tpu_torch.runtime.scheduler import get_task_control
    from incubator_brpc_tpu_torch.runtime.sync import CountdownEvent
    from incubator_brpc_tpu_torch.tools.rpc_view import fetch_page_full

    ctrl = get_task_control()
    results = {}
    stats = FetchStats()
    lock = threading.Lock()
    done = CountdownEvent(len(urls))
    window = threading.Semaphore(max(1, concurrency))  # bounded in-flight
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)

    def one(idx, url):
        t0 = time.perf_counter_ns()
        try:
            server, _, page = url.partition("/")
            # retries=0: the connect-retry loop exists for the just-
            # started-server race in tests; a mass fetcher must not
            # serialize its window behind backoff sleeps to dead hosts
            # (and the latency percentiles must measure the fetch)
            status, ctype, body = fetch_page_full(
                server, page or "/", timeout, retries=0
            )
            us = (time.perf_counter_ns() - t0) // 1000
            # body write BEFORE the success accounting: a failed write
            # must count the url as failed, not as both
            if output_dir:
                with open(os.path.join(output_dir, f"{idx:06d}.body"), "wb") as f:
                    f.write(body)
            text = body.decode("utf-8", errors="replace")
            with lock:
                results[url] = (True, text)
                stats.ok += 1
                stats.bytes += len(body)
                stats.latencies_us.append(us)
                stats.status_counts[status] = (
                    stats.status_counts.get(status, 0) + 1
                )
        except Exception as e:  # noqa: BLE001 — per-url failure isolation
            with lock:
                results[url] = (False, repr(e))
                stats.failed += 1
        finally:
            window.release()
            done.signal()

    t0 = time.monotonic()
    stop_progress = threading.Event()

    def progress():
        while not stop_progress.wait(progress_interval_s):
            with lock:
                n = stats.ok + stats.failed
            el = time.monotonic() - t0
            report(f"... {n}/{len(urls)} ({n / el:.1f}/s)")

    ticker = threading.Thread(target=progress, daemon=True)
    ticker.start()
    for idx, url in enumerate(urls):
        window.acquire()  # backpressure: the submit loop IS the window
        ctrl.spawn(one, idx, url)
    completed = done.wait(timeout * max(1, len(urls)))
    stop_progress.set()
    stats.wall_s = time.monotonic() - t0
    if not completed:
        # stragglers still mutate the live objects: hand back a
        # DETACHED snapshot (copied under the lock) with the pending
        # fetches counted as failed, so the caller's view is stable
        # and ok+failed == len(urls)
        import copy

        with lock:
            snap = copy.deepcopy(stats)  # plain ints/list/dict only
            snap_results = dict(results)
        pending = len(urls) - (snap.ok + snap.failed)
        snap.failed += pending
        report(
            f"TIMED OUT with {pending} fetches still in flight "
            "(counted as failed)"
        )
        report(snap.summary())
        return snap_results, snap
    report(stats.summary())
    return results, stats


def main(argv=None):
    ap = argparse.ArgumentParser(description="parallel_http")
    ap.add_argument("urls", nargs="*", help="host:port/path entries")
    ap.add_argument("--file", help="file with one url per line")
    ap.add_argument("--concurrency", type=int, default=16)
    ap.add_argument("--timeout", type=float, default=5.0)
    ap.add_argument("--output", help="directory to save response bodies")
    args = ap.parse_args(argv)
    urls = list(args.urls)
    if args.file:
        urls += [l.strip() for l in open(args.file) if l.strip()]
    if not urls:
        ap.error("no urls")
    fetch_all(
        urls, args.concurrency, timeout=args.timeout, output_dir=args.output
    )


if __name__ == "__main__":
    main()
