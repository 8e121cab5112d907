"""One call at a time: the caller's thread issues a synchronous call,
waits for its reply and issues the next, until the window's time (or a
number of calls) is spent; then the device is synchronised inside the
window.  The deployment's ``call_sync(k)`` chooses what call ``k``
sends: a payload of its seeded pool by the call's number, or, in a
chained mix, the reply it carries from the call before.

This is upstream brpc's ``example/echo_c++`` client (one sync call in a
loop); the chained form is rewritten from the chain of the port's
``tools/bench.py`` ``bench_ici_rpc`` (the JAX package's
``bench.py:755-869``), timed here as one window of calls with each
call's latency kept, instead of the median over repetitions of a long
chain minus a short one.  Where a server runs its handlers in the
dispatcher, the whole call runs on the caller's thread.
"""

from __future__ import annotations

import time

from benchmark.harness.window import Call, Window


def run(dep, mix: dict, ranges, seconds=None, calls=None) -> Window:
    win = Window()
    win.open()
    stop_ns = win.start_ns + int((seconds or 0) * 1e9)
    k = 0
    while (calls is None and time.perf_counter_ns() < stop_ns) or (calls is not None and k < calls):
        t0 = time.perf_counter_ns()
        with ranges("client.call"):
            ok, record = dep.call_sync(k)
        t1 = time.perf_counter_ns()
        win.issued += 1
        win.calls.append(Call(k, t0, t1, ok, record))
        k += 1
    with ranges("harness.sync"):
        dep.sync()
    win.close()
    return win
