"""Recovery-invariant harness — run a workload under a FaultPlan and
prove the framework recovered.

The harness owns the arm/run/disarm lifecycle and checks the
invariants every resilience path must hold:

  * no deadlock — the workload completes within a bounded wall clock
    (a wedged read loop / lost wakeup shows up here, not in prod);
  * only ERPC-family error codes surface to callers — transport chaos
    may fail RPCs, but never with exceptions or alien codes;
  * pooled Controllers carry no state across a failed call — the
    freelist hands out objects indistinguishable from fresh ones;
  * metrics / windows return to baseline once the plan is done —
    receive windows, concurrency counters and inflight gauges drain
    back to their pre-chaos values (leaks here wedge later traffic).

Reply-ordering invariants (HTTP/RESP FIFO) are protocol-specific and
live in the chaos test suites; the harness supplies the lifecycle and
the generic checks.
"""

from __future__ import annotations

import threading
import time as _time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from incubator_brpc_tpu_torch import errors as _errors
from incubator_brpc_tpu_torch.chaos import injector
from incubator_brpc_tpu_torch.chaos.plan import FaultPlan

#: every code the framework may legitimately surface to a caller
#: (the ERPC family defined in errors.py), plus 0 for success.
#: Internal trigger codes are EXCLUDED: they drive arbitration inside
#: the id lock and must never reach a caller — leaking one is exactly
#: the class of bug this invariant exists to catch.
ERROR_WHITELIST = (
    frozenset(
        v for k, v in vars(_errors).items()
        if k.isupper() and isinstance(v, int)
    )
    - {_errors.EBACKUPREQUEST, _errors.EPCHANFINISH}
) | {0}


class InvariantViolation(AssertionError):
    """A recovery invariant failed under the armed plan."""


@dataclass
class ChaosReport:
    wall_s: float = 0.0
    hits: Dict[str, Dict[str, int]] = field(default_factory=dict)
    error_codes: List[int] = field(default_factory=list)
    violations: List[str] = field(default_factory=list)
    workload_result: object = None

    def ok(self) -> bool:
        return not self.violations


def wait_until(pred: Callable[[], bool], timeout_s: float = 5.0,
               interval_s: float = 0.01) -> bool:
    deadline = _time.monotonic() + timeout_s
    while _time.monotonic() < deadline:
        if pred():
            return True
        _time.sleep(interval_s)
    return bool(pred())


def controller_pool_clean(sample: int = 16) -> bool:
    """Sample the pooled-Controller freelist: every pooled object must
    be fully wiped (release() clears __dict__ back to class defaults).
    Non-destructive — sampled controllers go back to the pool."""
    from incubator_brpc_tpu_torch.client.controller import (
        acquire_controller,
        release_controller,
    )

    taken = []
    clean = True
    for _ in range(sample):
        c = acquire_controller()
        if c.__dict__:
            clean = False
        taken.append(c)
    for c in taken:
        release_controller(c)
    return clean


class RecoveryHarness:
    """Arm a plan, run a workload with a bounded wall clock, disarm,
    then check the recovery invariants.

    ``baseline_probes`` is a sequence of (name, fn) pairs; each fn
    returns a number captured before arming.  After the run the
    harness waits up to ``settle_s`` for every probe to return to its
    captured value (receive windows, concurrency counters, …).

    The workload callable receives the harness and may report
    per-call outcomes via :meth:`record_error`; its return value lands
    on the report.
    """

    def __init__(
        self,
        plan: FaultPlan,
        wall_clock_s: float = 30.0,
        settle_s: float = 5.0,
        baseline_probes: Sequence[Tuple[str, Callable[[], float]]] = (),
        check_controller_pool: bool = True,
    ):
        self.plan = plan
        self.wall_clock_s = wall_clock_s
        self.settle_s = settle_s
        self.baseline_probes = list(baseline_probes)
        self.check_controller_pool = check_controller_pool
        self._errors: List[int] = []
        self._errors_lock = threading.Lock()

    def record_error(self, code: int) -> None:
        """Workloads report each finished call's error code here."""
        with self._errors_lock:
            self._errors.append(int(code))

    def run(self, workload: Callable[["RecoveryHarness"], object]) -> ChaosReport:
        report = ChaosReport()
        baselines = [(name, fn()) for name, fn in self.baseline_probes]
        box: dict = {}

        def _runner():
            try:
                box["result"] = workload(self)
            except BaseException as e:  # noqa: BLE001 — judged below
                box["exc"] = e

        injector.arm(self.plan)
        t0 = _time.monotonic()
        worker = threading.Thread(
            target=_runner, daemon=True, name="chaos-workload"
        )
        worker.start()
        worker.join(self.wall_clock_s)
        still_running = worker.is_alive()
        report.wall_s = _time.monotonic() - t0
        injector.disarm()
        # capture AFTER disarm: counters persist until the next arm, and
        # a fault firing between a pre-disarm capture and the disarm
        # would show in chaos_injected_total but not on the report
        report.hits = injector.site_hits()
        if still_running:
            # one grace join after disarm: a workload blocked ON an
            # injected fault may finish immediately once it clears
            worker.join(2.0)
            if worker.is_alive():
                report.violations.append(
                    f"deadlock: workload still running after "
                    f"{self.wall_clock_s:.1f}s wall clock"
                )
        if "exc" in box:
            report.violations.append(
                f"workload raised {box['exc']!r} — chaos must surface as "
                f"error codes, not exceptions"
            )
        report.workload_result = box.get("result")
        with self._errors_lock:
            report.error_codes = list(self._errors)
        for code in report.error_codes:
            if code not in ERROR_WHITELIST:
                report.violations.append(
                    f"non-ERPC error code {code} surfaced to a caller"
                )
        if self.check_controller_pool and not controller_pool_clean():
            report.violations.append(
                "pooled Controller carried state across release()"
            )
        for (name, fn), (_, base) in zip(self.baseline_probes, baselines):
            if not wait_until(lambda f=fn, b=base: f() == b, self.settle_s):
                report.violations.append(
                    f"metric {name!r} did not return to baseline "
                    f"({fn()} != {base}) within {self.settle_s:.1f}s"
                )
        return report

    def run_or_raise(self, workload) -> ChaosReport:
        report = self.run(workload)
        if not report.ok():
            raise InvariantViolation("; ".join(report.violations))
        return report
