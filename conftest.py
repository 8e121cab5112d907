"""Build both packages' native engines once, before any test collects.

Under pytest-xdist every worker imports the test modules, and the JAX
package's native test files evaluate ``native.available()`` in a
module-level ``skipif`` at collection.  On a checkout with no built
engine each worker then compiles ``_engine.so`` through one shared
temporary, and a worker that loses the rename skips that package's
native tests for its whole session.  ``pytest_configure`` runs in the
xdist controller before the workers start (and again in each worker), so
building here, under a file lock, leaves every worker a finished build.

A build that fails is left as it is: ``available()`` answers False and
the tests skip or fail as they would without this hook.
"""

import fcntl
import os

_LOCK = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "incubator_brpc_tpu_torch", "native", ".engine_build.lock",
)


def pytest_configure(config):
    from incubator_brpc_tpu import native as jax_native
    from incubator_brpc_tpu_torch import native as torch_native

    with open(_LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            jax_native.available()
            torch_native.available()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
