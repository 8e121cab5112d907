"""The card's time for work queued back to back on the current stream.

``queued_ms(issue)`` holds the stream with a sleep kernel
(``torch.cuda._sleep``), records a CUDA event where the sleep ends, lets
``issue()`` enqueue its work behind it and records a second event after
that work.  The card then runs the work with no host gap between its
launches, so the time between the two events is the card's time for it,
whatever the host's rate of issue, provided the host finished issuing
before the sleep ended.  A window the host did not fill in time (its
issue took longer than the card slept) is taken again with twice the
sleep; after ``SLEEP_TRIES`` such windows the call raises.  ``issue``
must be safe to run again: a retried window runs it anew.

``chip_smoke.py``'s ``[times]`` phase times the kernels alone the same
way (its ``queued_windows``) and keeps its own copy, since it also times
checkouts that predate this module.
"""

from __future__ import annotations

import time

SLEEP_CYCLES = 20_000_000  # about 10 ms of an H100's sleep
SLEEP_TRIES = 5  # windows the host may overrun, the sleep doubled after each


def queued_ms(issue, cycles: int = SLEEP_CYCLES, tries: int = SLEEP_TRIES):
    """(device ms of the work ``issue()`` enqueued, what ``issue()``
    returned, the sleep in cycles that covered the host's issue).  Pass
    the cycles back in for the next window of the same work."""
    import torch

    from incubator_brpc_tpu_torch.analysis.device_witness import allowed_transfer

    overruns = []
    for _ in range(tries):
        with allowed_transfer("bench.device-time"):  # start from an idle stream
            torch.cuda.current_stream().synchronize()
        slept_ev, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        slept_ev.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        out = issue()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        with allowed_transfer("bench.device-time"):
            end.synchronize()
        slept = slept_ev.elapsed_time(start)
        if host_ms < slept:
            return start.elapsed_time(end), out, cycles
        overruns.append((round(host_ms, 3), round(slept, 3)))
        cycles *= 2
    raise RuntimeError(
        f"the host issued the work slower than the card slept in {tries} windows "
        f"(host ms, slept ms): {overruns}"
    )
