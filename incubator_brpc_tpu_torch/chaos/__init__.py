"""chaos/ — deterministic, seeded fault injection.

Every resilience path in the framework (retry/backoff, circuit
breaker + cluster recovery, health checks, backup requests,
receive-window accounting, the native partial-frame/burst-flush state
machines) is only proven by the failures it survives.  This package
turns those failures into deterministic, replayable tier-1 tests:

  * :mod:`chaos.plan` — FaultPlan / FaultSpec: seeded, declarative
    fault specs loadable from JSON;
  * :mod:`chaos.injector` — the process-wide site registry (near-zero
    disarmed cost) + ``chaos_injected_total`` metrics + the native
    ``ns_set_fault`` bridge;
  * :mod:`chaos.harness` — run a workload under a plan and check
    recovery invariants (bounded wall clock, ERPC-only errors, pooled
    Controller hygiene, metrics back to baseline).

Runtime control: the ``/chaos`` builtin (GET state, POST plan,
``?disarm=1``) and ``rpc_press --chaos-plan``.  See docs/chaos.md.
"""

from incubator_brpc_tpu_torch.chaos.plan import ACTIONS, FaultPlan, FaultSpec
from incubator_brpc_tpu_torch.chaos.harness import (
    ChaosReport,
    InvariantViolation,
    RecoveryHarness,
    controller_pool_clean,
)
from incubator_brpc_tpu_torch.chaos.storm import (
    admission_pressure_plan,
    replica_storm_plan,
    reshard_storm_plan,
    storm_plan,
)

__all__ = [
    "ACTIONS",
    "FaultPlan",
    "FaultSpec",
    "ChaosReport",
    "InvariantViolation",
    "RecoveryHarness",
    "controller_pool_clean",
    "admission_pressure_plan",
    "replica_storm_plan",
    "reshard_storm_plan",
    "storm_plan",
]
