"""Concurrency-correctness toolchain (static analysis + runtime witness).

The package is a deeply concurrent system: window chaining
in the batcher, StreamWait flow control, ExecutionQueue bursts,
TimerThread re-aiming, chaos hook slots.  Races there are easy to
miss by reading; this package replaces by-hand
heroics with machine-checked discipline:

- ``inventory``   — AST census of every ``Lock``/``RLock``/``Condition``
                    construction site in the package (~100+ sites), with
                    ``Condition(existing_lock)`` aliasing resolved.
- ``lockgraph``   — the inter-module lock-acquisition graph (which lock
                    is taken while which is held, including transitive
                    acquisitions through resolved calls), plus the
                    blocking-under-lock and callback-under-lock rules.
- ``invariants``  — project-invariant lints: chaos sites are documented
                    and tested, registered metrics render on /metrics,
                    ``_tls`` saves restore on all paths, completion
                    paths resolve each row exactly once, and broad
                    ``except Exception`` handlers in protocols/streaming
                    cannot swallow ERPC-coded failures.
- ``witness``     — runtime lock-witness mode: records ACTUAL
                    acquisition orders while the test suite runs and
                    cross-checks them against the static manifest, so
                    the analyzer is validated by execution.

The canonical lock-order manifest (``lock_order.json``) and the
violation allowlist (``allowlist.json``) are checked in next to this
file: new acquisitions show up as diffs, not noise.  Drive everything
through ``python -m incubator_brpc_tpu_torch.tools.check``.
"""

from incubator_brpc_tpu_torch.analysis.findings import (  # noqa: F401
    Allowlist,
    Finding,
    load_allowlist,
)
from incubator_brpc_tpu_torch.analysis.inventory import (  # noqa: F401
    LockSite,
    build_inventory,
)

PACKAGE_ROOT = __name__.rsplit(".", 1)[0]  # "incubator_brpc_tpu_torch"
