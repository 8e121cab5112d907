"""pytest plugin arming the port's two runtime witnesses for a test run.

    BRPC_TORCH_LOCK_WITNESS=1 BRPC_TORCH_TRANSFER_WITNESS=1 \\
        python -m pytest -p incubator_brpc_tpu_torch.analysis.pytest_plugin tests/...

``BRPC_TORCH_LOCK_WITNESS=1`` wraps every lock the port creates in a
recording proxy (analysis/witness.py) and, at the session's end,
cross-checks the witnessed acquisition orders against the port's
lock-order manifest (report: ``$BRPC_TORCH_LOCK_WITNESS_REPORT``).
``BRPC_TORCH_TRANSFER_WITNESS=1`` arms the transfer guard and the
retrace witness (analysis/device_witness.py) and reports violations,
scope uses and retrace contradictions
(``$BRPC_TORCH_TRANSFER_WITNESS_REPORT``).  A contradiction, a
violation (even one an ``except`` swallowed) or a retrace past its
bound fails the session with exit status 3.

The plugin is imported while pytest parses its command line, before
any test module imports the port, so both witnesses are armed before
the port creates its locks or runs a hot path.
"""

from __future__ import annotations

import os

LOCK_ENV = "BRPC_TORCH_LOCK_WITNESS"
TRANSFER_ENV = "BRPC_TORCH_TRANSFER_WITNESS"

if os.environ.get(LOCK_ENV) or os.environ.get(TRANSFER_ENV):
    # both modules first: their own state locks stay raw primitives
    from incubator_brpc_tpu_torch.analysis import device_witness as _dwitness
    from incubator_brpc_tpu_torch.analysis import witness as _witness

    if os.environ.get(LOCK_ENV):
        _witness.enable()
    if os.environ.get(TRANSFER_ENV):
        _dwitness.enable()


def pytest_sessionfinish(session, exitstatus):
    bad = False
    if os.environ.get(LOCK_ENV):
        from incubator_brpc_tpu_torch.analysis import witness

        path = os.environ.get(
            LOCK_ENV + "_REPORT", ".torch_lock_witness_report.json"
        )
        result = witness.write_report(path)
        print(
            f"\nlock-witness (port): {result['witnessed_sites']} sites, "
            f"{result['checked']} mapped edges, "
            f"{len(result['new_edges'])} unmanifested, "
            f"{len(result['contradictions'])} contradiction(s) -> {path}"
        )
        for c in result["contradictions"]:
            print(f"lock-witness CONTRADICTION: {c}")
        bad = bad or bool(result["contradictions"])
    if os.environ.get(TRANSFER_ENV):
        from incubator_brpc_tpu_torch.analysis import device_witness

        path = os.environ.get(
            TRANSFER_ENV + "_REPORT", ".torch_transfer_witness_report.json"
        )
        result = device_witness.write_report(path)
        found = result["violations"] + result["retrace_contradictions"]
        print(
            f"\ntransfer-witness (port): "
            f"{sum(result['scope_uses'].values())} manifested pulls over "
            f"{len(result['scope_uses'])} scope(s), "
            f"{len(result['kernels'])} bounded kernel(s), "
            f"{len(result['violations'])} violation(s), "
            f"{len(result['retrace_contradictions'])} retrace "
            f"contradiction(s) -> {path}"
        )
        for v in found:
            print(f"transfer-witness CONTRADICTION: {v}")
        bad = bad or bool(found)
    if bad and session.exitstatus == 0:
        # wrap_session returns session.exitstatus after this hook runs
        session.exitstatus = 3
