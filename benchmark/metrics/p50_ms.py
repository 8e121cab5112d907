"""Median client-side latency, issue to completion, of every call in the window."""

from benchmark.harness.stats import percentile


def read(ctx):
    lats = ctx.window.latencies_ns()
    return percentile(lats, 0.50) / 1e6 if lats else None
