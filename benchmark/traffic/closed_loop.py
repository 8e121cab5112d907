"""Closed loop: ``inflight`` calls outstanding over the deployment's
channels in turn, each completion issuing the next, until the window's
time (or a number of calls) is spent; then the calls in flight drain and
the device is synchronised inside the window.

Rewritten from ``chip_smoke.py``'s ``closed_loop`` (itself the JAX
package's ``bench.py:2089-2150``): the same issue-on-completion loop,
with every call's issue and completion kept instead of a sorted list of
latencies, and the payload chosen by the deployment from its seeded pool
by the call's number.
"""

from __future__ import annotations

import threading
import time

from benchmark.harness.window import Call, Window

DRAIN_S = 120  # the longest a call in flight may take to come back


def run(dep, mix: dict, ranges, seconds=None, calls=None) -> Window:
    inflight = int(mix["inflight"])
    win = Window()
    lock = threading.Lock()
    active = [inflight]
    drained = threading.Event()
    budget = [calls]  # calls left to issue, when counted instead of timed
    stop_ns = [0]

    def more() -> bool:
        if budget[0] is None:
            return time.perf_counter_ns() < stop_ns[0]
        with lock:
            if budget[0] <= 0:
                return False
            budget[0] -= 1
            return True

    def finish() -> None:
        with lock:
            active[0] -= 1
            if active[0] == 0:
                drained.set()

    def issue(slot: int, k: int) -> None:
        def done(ok: bool, record) -> None:
            t1 = time.perf_counter_ns()
            with lock:
                win.calls.append(Call(k, t0, t1, ok, record))
            if more():
                issue(slot, k + inflight)
            else:
                finish()

        with lock:
            win.issued += 1
        t0 = time.perf_counter_ns()
        with ranges("client.call"):
            dep.call(slot % dep.channels, k, done)

    win.open()
    stop_ns[0] = win.start_ns + int((seconds or 0) * 1e9)
    for slot in range(inflight):
        if more():
            issue(slot, slot)
        else:
            finish()
    with ranges("harness.wait"):
        if not drained.wait(timeout=(seconds or 0) + DRAIN_S):
            raise RuntimeError(f"{active[0]} of {inflight} loops never drained")
    with ranges("harness.sync"):
        dep.sync()
    win.close()
    return win
