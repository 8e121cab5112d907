"""Device-plane discipline toolchain (analysis/devicegraph.py +
analysis/device_witness.py + tools/check.py --device): the device-site
census, the golden-finding fixtures proving each rule fires (and the
clean twin proving none misfire), the transfer manifest, the runtime
transfer/retrace witness, and the partial-mode CLI contract.

Carried by hand from ``tests/test_device_analysis.py``: the port's
analyzers run over the same golden fixtures (``tests/analysis_fixtures``),
the CLI is ``python -m incubator_brpc_tpu_torch.tools.check``, the
seeded pull is a ``torch.Tensor`` under the port's armed guard, and the
witness lanes' variables are the port's (``BRPC_TORCH_*``).  The five
cases that assert JAX spellings (``jit``, ``pallas_call``, ``block``,
donation by ``jax.jit``) are held by ``tests/test_torch_analysis.py`` on
its torch-spelled twin of the fixtures; the census of the tree by its
census cases.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_ROOT = os.path.join(REPO_ROOT, "incubator_brpc_tpu_torch")
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "analysis_fixtures")

from incubator_brpc_tpu_torch.analysis import device_witness  # noqa: E402
from incubator_brpc_tpu_torch.analysis.devicegraph import (  # noqa: E402
    DeviceManifest,
    build_device_census,
    load_device_manifest,
    run_device_rules,
    run_dispatch_under_lock,
)
from incubator_brpc_tpu_torch.analysis.inventory import build_inventory  # noqa: E402
from incubator_brpc_tpu_torch.analysis.lockgraph import build_graph  # noqa: E402

HOT = ("fixture_device_hot", "fixture_device_clean")

FIXTURE_MANIFEST = DeviceManifest(
    [{"key": "fixture.known-key", "why": "clean-twin justification"}],
    path="<test>",
)


# ---------------------------------------------------------------------------
# census
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fx_census():
    return build_device_census(FIXTURES)


@pytest.fixture(scope="module")
def fx_findings(fx_census):
    return run_device_rules(
        fx_census, FIXTURE_MANIFEST, hot_prefixes=HOT
    )


# ---------------------------------------------------------------------------
# golden findings: every rule fires on the seeded module …
# ---------------------------------------------------------------------------

def test_fixture_transfer_manifest_rule_fires(fx_findings):
    keys = {f.key for f in fx_findings if f.rule == "transfer-manifest"}
    assert any("fixture.unknown-key" in k for k in keys), keys


def test_fixture_slot_lifecycle_rule_fires(fx_findings):
    keys = {f.key for f in fx_findings if f.rule == "slot-lifecycle"}
    assert "fixture_device_hot.py:leaky_slot:slot" in keys, keys


def test_fixture_dispatch_under_lock_rule_fires():
    inv = build_inventory(FIXTURES)
    graph = build_graph(inv, root=FIXTURES)
    out = run_dispatch_under_lock(graph)
    keys = {f.key for f in out}
    assert any(k.startswith("fixture_device_hot.py:dispatch:_kernel")
               for k in keys), keys
    # … and never on the clean twin's outside-the-lock dispatch
    assert not any("fixture_device_clean" in k for k in keys), keys


# ---------------------------------------------------------------------------
# transfer manifest
# ---------------------------------------------------------------------------

def test_manifest_rejects_blank_why():
    with pytest.raises(ValueError, match="justification"):
        DeviceManifest([{"key": "k", "why": "   "}])


def test_manifest_rejects_duplicate_key():
    with pytest.raises(ValueError, match="duplicated"):
        DeviceManifest([
            {"key": "k", "why": "a"},
            {"key": "k", "why": "b"},
        ])


def test_stale_manifest_entry_is_a_violation(fx_census):
    manifest = DeviceManifest(
        [
            {"key": "fixture.known-key", "why": "used by the clean twin"},
            {"key": "fixture.gone", "why": "stale on purpose"},
            {"key": "fixture.external", "why": "outside the scan",
             "external": True},
        ],
        path="<test>",
    )
    out = run_device_rules(fx_census, manifest, hot_prefixes=HOT)
    stale = {f.key for f in out if f.rule == "transfer-manifest-stale"}
    assert "fixture.gone" in stale, stale
    assert "fixture.known-key" not in stale
    # external entries live outside the package scan by declaration
    assert "fixture.external" not in stale


def test_checked_in_manifest_all_justified():
    m = load_device_manifest()
    assert m.entries, "device_transfers.json is empty?"
    for e in m.entries:
        assert e["why"].strip() and "TODO" not in e["why"], e


# ---------------------------------------------------------------------------
# runtime witness
# ---------------------------------------------------------------------------

@pytest.mark.skipif(
    bool(os.environ.get("BRPC_TORCH_TRANSFER_WITNESS")),
    reason="the witness is armed for the whole session",
)
def test_allowed_transfer_is_noop_when_disarmed():
    assert not device_witness.enabled()
    # unknown keys are not even validated while disarmed — zero cost on
    # every un-witnessed run
    with device_witness.allowed_transfer("no-such-key"):
        pass


def _run_child(code, timeout=120):
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=timeout, cwd=REPO_ROOT,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )


def test_witness_catches_seeded_unmanifested_transfer(tmp_path):
    """The lane's teeth: a package-scoped call site pulling a device
    value outside any allow scope raises and is recorded; the same pull
    under a manifested scope passes.  (Armed, the port's guard counts
    every tensor as a device value, so a CPU tensor stands in here.)"""
    mod = tmp_path / "seeded_transfer.py"
    mod.write_text(textwrap.dedent("""\
        import numpy as np

        def pull(x):
            return np.asarray(x)

        def pull_scoped(x):
            from incubator_brpc_tpu_torch.analysis.device_witness import (
                allowed_transfer,
            )
            with allowed_transfer("decode.token-sums"):
                return np.asarray(x)
    """))
    code = textwrap.dedent(f"""\
        import sys
        sys.path.insert(0, {str(REPO_ROOT)!r})
        from incubator_brpc_tpu_torch.analysis import device_witness as dw
        dw.enable(extra_scopes=[{str(tmp_path)!r}])
        sys.path.insert(0, {str(tmp_path)!r})
        import seeded_transfer as st
        import torch
        x = torch.ones((3,), dtype=torch.float32)
        try:
            st.pull(x)
            sys.exit(4)  # the unmanifested pull was NOT caught
        except dw.TransferWitnessError:
            pass
        ok = st.pull_scoped(x)
        assert ok.shape == (3,)
        rep = dw.cross_check()
        assert len(rep["violations"]) == 1, rep
        assert rep["violations"][0]["kind"] == "transfer", rep
        assert rep["scope_uses"].get("decode.token-sums") == 1, rep
        print("WITNESS-OK")
    """)
    proc = _run_child(code)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    assert "WITNESS-OK" in proc.stdout


def test_witness_rejects_unknown_scope_key():
    code = textwrap.dedent(f"""\
        import sys
        sys.path.insert(0, {str(REPO_ROOT)!r})
        from incubator_brpc_tpu_torch.analysis import device_witness as dw
        dw.enable()
        try:
            with dw.allowed_transfer("no-such-manifest-key"):
                sys.exit(4)
        except dw.TransferWitnessError:
            print("KEY-REFUSED")
    """)
    proc = _run_child(code)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    assert "KEY-REFUSED" in proc.stdout


# ---------------------------------------------------------------------------
# the CLI: device pass + partial-mode staleness contract
# ---------------------------------------------------------------------------

def _run_check(*flags):
    return subprocess.run(
        [sys.executable, "-m", "incubator_brpc_tpu_torch.tools.check",
         *flags, "-q"],
        capture_output=True, text=True, timeout=180, cwd=REPO_ROOT,
    )


def test_check_device_exits_zero_on_tree():
    proc = _run_check("--device")
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"


def test_check_partial_modes_do_not_promote_foreign_allowlist_entries():
    """--device alone must not report lock/invariant allowlist entries
    as stale (and vice versa): staleness for a rule is only decidable
    when the owning pass ran."""
    for flags in (("--device",), ("--locks",), ("--invariants",)):
        proc = _run_check(*flags)
        assert proc.returncode == 0, (
            f"{flags}: {proc.stdout}\n{proc.stderr}"
        )
        assert "stale-allowlist-entry" not in proc.stdout + proc.stderr, (
            f"{flags} promoted foreign allowlist entries to violations"
        )


def test_check_json_reports_device_sites(tmp_path):
    out = tmp_path / "check.json"
    proc = _run_check("--all", "--json", str(out))
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    payload = json.loads(out.read_text())
    assert payload["device_sites"] >= 75
    assert payload["violations"] == []
