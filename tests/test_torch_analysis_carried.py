"""Concurrency-correctness toolchain (incubator_brpc_tpu_torch/analysis/ +
its CLI, ``python -m incubator_brpc_tpu_torch.tools.check``): the lock
census, the acquisition graph + manifest, the seeded-violation fixtures
proving each rule fires, the invariant lints, the runtime lock witness,
and the tree-is-clean CI gate.

Carried by hand from ``tests/test_analysis.py``.  Besides the package
name: the CLI is the port's module (the JAX file loads the root
``tools/check.py``, which checks the JAX package), the lock witness is
armed through the port's pytest plugin and its ``BRPC_TORCH_*``
variables over the port's carried suites, and the sanitized engine is
the port's.  The cases ``tests/test_torch_analysis.py`` already holds
are not repeated here.
"""

import importlib
import json
import os
import subprocess
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_ROOT = os.path.join(REPO_ROOT, "incubator_brpc_tpu_torch")
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "analysis_fixtures")

from incubator_brpc_tpu_torch.analysis import invariants  # noqa: E402
from incubator_brpc_tpu_torch.analysis.findings import Allowlist, Finding  # noqa: E402
from incubator_brpc_tpu_torch.analysis.inventory import build_inventory  # noqa: E402
from incubator_brpc_tpu_torch.analysis.lockgraph import build_graph, find_cycles  # noqa: E402
from incubator_brpc_tpu_torch.analysis.manifest import (  # noqa: E402
    Manifest,
    check_graph_against_manifest,
    load_manifest,
)


def _load_check_module():
    return importlib.import_module("incubator_brpc_tpu_torch.tools.check")


# ---------------------------------------------------------------------------
# census
# ---------------------------------------------------------------------------

def test_inventory_scale_and_known_sites():
    inv = build_inventory(PKG_ROOT)
    # the smoke floor: a scan that silently misses most of the package
    # must fail loudly, not report a clean tree it never looked at
    assert len(inv.sites) > 80, f"census collapsed to {len(inv.sites)} sites"
    names = {s.name for s in inv.sites}
    for expected in (
        "batching/batcher.py:Batcher._lock",
        "streaming/stream.py:Stream._flow_cond",
        "runtime/execution_queue.py:ExecutionQueue._lock",
        "runtime/timer_thread.py:TimerThread._cond",
        "metrics/variable.py:<module>._registry_lock",
    ):
        assert expected in names, f"missing {expected}"


def test_inventory_resolves_condition_aliases():
    inv = build_inventory(PKG_ROOT)
    drained = inv.by_owner[
        ("runtime/execution_queue.py", "ExecutionQueue", "_drained")
    ]
    assert drained.kind == "condition"
    assert drained.base() == "runtime/execution_queue.py:ExecutionQueue._lock"


# ---------------------------------------------------------------------------
# the CI gate: the tree itself is clean
# ---------------------------------------------------------------------------

def test_check_all_exits_zero_on_tree():
    proc = subprocess.run(
        [sys.executable, "-m", "incubator_brpc_tpu_torch.tools.check",
         "--all", "-q"],
        capture_output=True, text=True, timeout=120, cwd=REPO_ROOT,
    )
    assert proc.returncode == 0, (
        f"tools.check --all failed:\n{proc.stdout}\n{proc.stderr}"
    )


def test_manifest_edges_all_justified():
    m = load_manifest()
    assert m.edges, "manifest is empty — the graph pass found nothing?"
    for e in m.edges:
        assert e["why"].strip() and "TODO" not in e["why"], e


def test_allowlist_rejects_unjustified_entry():
    with pytest.raises(ValueError, match="justification"):
        Allowlist([{"rule": "x", "key": "y", "why": "  "}])


def test_stale_allowlist_entry_is_a_violation():
    check = _load_check_module()
    al = Allowlist(
        [{"rule": "ghost-rule", "key": "nope*", "why": "stale on purpose"}]
    )
    violations, allowed, unused = al.split([])
    assert unused and not allowed and not violations


def test_todo_review_placeholder_why_is_a_finding():
    """A 'TODO review' why is a justification nobody wrote: both the
    allowlist and the lock-order manifest loaders surface it as a
    todo-review-why finding instead of letting the placeholder become
    permanent; a real one-liner passes clean."""
    from incubator_brpc_tpu_torch.analysis.findings import todo_review_findings
    from incubator_brpc_tpu_torch.analysis.manifest import (
        todo_review_findings as manifest_todo_findings,
    )

    al = Allowlist(
        [
            {"rule": "blocking-under-lock", "key": "a/*",
             "why": "TODO review: first seen mod.py:7"},
            {"rule": "blocking-under-lock", "key": "b/*",
             "why": "bounded sleep inside the retry backoff"},
        ],
        path="seeded-allowlist.json",
    )
    fs = todo_review_findings(al)
    assert len(fs) == 1, fs
    assert fs[0].rule == "todo-review-why"
    assert fs[0].key == "allowlist/blocking-under-lock/a/*"
    assert "placeholder" in fs[0].message
    assert fs[0].file == "seeded-allowlist.json"

    m = Manifest(
        edges=[
            {"from": "x.py:A._l", "to": "y.py:B._l",
             "why": "TODO review: first seen x.py:12"},
            {"from": "y.py:B._l", "to": "z.py:C._l",
             "why": "B drains into C's queue under both"},
        ],
        path="seeded-manifest.json",
    )
    fs = manifest_todo_findings(m)
    assert len(fs) == 1, fs
    assert fs[0].rule == "todo-review-why"
    assert fs[0].key == "lock-order/x.py:A._l->y.py:B._l"
    # stable keys: an fnmatch allowlist entry can name them exactly
    cover = Allowlist(
        [{"rule": "todo-review-why", "key": "lock-order/x.py:A._l*",
          "why": "grandfathered while the edge is reviewed"}]
    )
    violations, allowed, unused = cover.split(fs)
    assert allowed and not violations and not unused


def test_todo_review_wired_into_check_all(monkeypatch):
    """run_check surfaces a placeholder why in the loaded allowlist as
    a todo-review-why VIOLATION (it maps to the 'locks' pass), not a
    warning — skipping the review edit fails the gate."""
    from incubator_brpc_tpu_torch.analysis import findings as findings_mod

    check = _load_check_module()
    assert check.RULE_PASS["todo-review-why"] == "locks"
    real = findings_mod.load_allowlist(
        os.path.join(PKG_ROOT, "analysis", "allowlist.json")
    )
    seeded = Allowlist(
        real.entries
        + [{"rule": "blocking-under-lock", "key": "seeded/nothing/*",
            "why": "TODO review: never edited"}],
        path=real.path,
    )
    monkeypatch.setattr(
        findings_mod, "load_allowlist", lambda path: seeded
    )
    out = check.run_check(locks=True, invariants=False, device=False)
    todo = [f for f in out["violations"] if f.rule == "todo-review-why"]
    assert todo, [f.format() for f in out["violations"]]
    assert "seeded/nothing/*" in todo[0].key


# ---------------------------------------------------------------------------
# seeded-violation fixtures: each rule fires
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fx():
    inv = build_inventory(FIXTURES)
    graph = build_graph(inv, root=FIXTURES)
    return inv, graph


def test_fixture_inversion_cycle_detected(fx):
    inv, graph = fx
    pairs = graph.edge_pairs()
    a = "fixture_inversion.py:Inverted._a"
    b = "fixture_inversion.py:Inverted._b"
    assert (a, b) in pairs and (b, a) in pairs
    cycles = find_cycles(pairs)
    assert any(a in c and b in c for c in cycles)
    findings, _ = check_graph_against_manifest(graph, Manifest([]))
    rules = {f.rule for f in findings}
    assert "lock-order-cycle" in rules
    assert "lock-order-new-edge" in rules


def test_fixture_blocking_under_lock_fires(fx):
    _, graph = fx
    keys = {f.key for f in graph.findings if f.rule == "blocking-under-lock"}
    assert any("sleepy:sleep" in k for k in keys), keys
    assert any("sendy:write" in k for k in keys), keys
    assert any("foreign_wait:wait_for" in k for k in keys), keys
    # waiting on the held lock's OWN condition is the one legal blocking
    # shape — it releases the lock
    assert not any("ok_wait" in k for k in keys), keys


def test_fixture_callback_under_lock_fires(fx):
    _, graph = fx
    cb = [f for f in graph.findings if f.rule == "callback-under-lock"]
    assert any("finish:done" in f.key for f in cb), [f.key for f in cb]
    # a done() STATUS CHECK in a condition is not a callback invocation
    assert not any("status_check_is_fine" in f.key for f in cb)


def test_fixture_tls_restore_fires():
    out = invariants.run_tls_lint(FIXTURES)
    keys = {f.key for f in out}
    assert "fixture_tls.py:leaky:ctx" in keys, keys
    assert not any("balanced" in k for k in keys), keys


def test_fixture_except_swallow_fires():
    out = invariants.run_except_lint(
        os.path.dirname(FIXTURES), dirs=(os.path.basename(FIXTURES),)
    )
    assert any("swallows" in f.key for f in out), [f.key for f in out]
    assert not any("surfaced" in f.key for f in out)


def test_fixture_completion_guard_fires():
    guards = (
        {"module": "fixture_completion.py", "qualname": "BadScatter.__call__",
         "type": "flag-guard", "attr": "called"},
        {"module": "fixture_completion.py", "qualname": "BadScatter.__call__",
         "type": "fanout-try", "leaf": "done"},
        {"module": "fixture_completion.py", "qualname": "GoodScatter.__call__",
         "type": "flag-guard", "attr": "called"},
        {"module": "fixture_completion.py", "qualname": "GoodScatter.__call__",
         "type": "fanout-try", "leaf": "done"},
    )
    out = invariants.run_completion_lint(FIXTURES, guards=guards)
    keys = {f.key for f in out}
    assert "fixture_completion.py:BadScatter.__call__:flag-guard" in keys
    assert "fixture_completion.py:BadScatter.__call__:fanout-try" in keys
    assert not any("GoodScatter" in k for k in keys), keys


def test_fixture_unregistered_chaos_site_fires():
    sites = {"socket.write": "real", "made.up_site": "unregistered"}
    docs = "| `socket.write` | transport | drop |"
    tests = "FaultSpec('socket.write', 'drop')"
    out = invariants.check_chaos_sites(sites, docs, tests)
    rules = {(f.rule, f.key) for f in out}
    assert ("chaos-site-doc", "made.up_site") in rules
    assert ("chaos-site-test", "made.up_site") in rules
    assert not any(k == "socket.write" for _, k in rules)


# ---------------------------------------------------------------------------
# the project invariants hold on the tree
# ---------------------------------------------------------------------------

def test_every_chaos_site_documented_and_tested():
    assert invariants.run_chaos_site_lint(REPO_ROOT) == []


def test_completion_guards_hold_on_tree():
    assert invariants.run_completion_lint(PKG_ROOT) == []


# ---------------------------------------------------------------------------
# runtime lock witness
# ---------------------------------------------------------------------------

# These unit tests call witness.reset()/disable(), which would wipe the
# edges (and unpatch threading!) accumulated by a SESSION-WIDE witness
# run — turning `make witness`'s end-of-session cross-check vacuous.
# In that lane the witness is the thing under test already; skip them.
not_in_witness_session = pytest.mark.skipif(
    bool(os.environ.get("BRPC_TORCH_LOCK_WITNESS")),
    reason="mutates global witness state; unsafe inside a witness session",
)


# ---------------------------------------------------------------------------
# sanitizer-hardened native build
# ---------------------------------------------------------------------------

def _sanitizer_toolchain_ok():
    from incubator_brpc_tpu_torch import native

    if not native.available():
        return False
    # single source of truth: every required runtime existence-checked
    return native.sanitizer_preload("asan") or False


def test_asan_ubsan_engine_smoke():
    """Build engine.cpp + fastcall.c under ASan+UBSan and prove a real
    echo round trip through the sanitized engine (the tier-1 face of
    tools/sanitize.sh; the full lane is `make sanitize`)."""
    preload = _sanitizer_toolchain_ok()
    if not preload:
        pytest.skip("native engine or asan/ubsan runtime unavailable")
    env = dict(os.environ)
    env["BRPC_NATIVE_SANITIZE"] = "asan"
    env["LD_PRELOAD"] = preload
    env["ASAN_OPTIONS"] = "detect_leaks=0:abort_on_error=1"
    env["UBSAN_OPTIONS"] = "print_stacktrace=1:halt_on_error=1"
    env["JAX_PLATFORMS"] = "cpu"
    script = """
from incubator_brpc_tpu_torch import native
assert native.SANITIZE == "asan"
assert native.available(), native._lib_err
from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
srv = Server(ServerOptions(native_engine=True))
srv.add_service(EchoService())
assert srv.start(0) == 0
ch = Channel(ChannelOptions(timeout_ms=5000, connection_type="native"))
ch.init(f"127.0.0.1:{srv.port}")
stub = echo_stub(ch)
for i in range(32):
    c = Controller()
    r = stub.Echo(c, EchoRequest(message=f"san{i}" * 40))
    assert not c.failed(), c.error_text()
    assert r.message.startswith("san")
ch.close()
srv.stop()
print("ASAN_SMOKE_OK")
"""
    proc = subprocess.run(
        [sys.executable, "-c", script],
        capture_output=True, text=True, timeout=240, cwd=REPO_ROOT, env=env,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "ASAN_SMOKE_OK" in proc.stdout
    assert "ERROR: AddressSanitizer" not in proc.stderr
    assert "runtime error:" not in proc.stderr  # UBSan diagnostic


def test_witness_subset_run_consistent_with_manifest(tmp_path):
    """Drive a real slice of the suite under BRPC_TORCH_LOCK_WITNESS=1 (the
    port's plugin) in a subprocess: the witnessed acquisition orders must
    not contradict the checked-in manifest (the analyzer validated by
    execution).  The slice is the port's: the carried runtime suite and
    the batching suite."""
    # a report of its own: the JAX file's run writes .pytest_cache_witness_report.json
    report = str(tmp_path / "lock_witness_report.json")
    if os.path.exists(report):
        os.remove(report)
    env = dict(os.environ)
    env["BRPC_TORCH_LOCK_WITNESS"] = "1"
    env["BRPC_TORCH_LOCK_WITNESS_REPORT"] = report
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-m", "pytest",
         "tests/test_torch_runtime.py", "tests/test_torch_batching.py",
         "-q", "-m", "not slow", "-p", "no:cacheprovider",
         "-p", "incubator_brpc_tpu_torch.analysis.pytest_plugin"],
        capture_output=True, text=True, timeout=300, cwd=REPO_ROOT, env=env,
    )
    try:
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-2000:]
        with open(report, "r", encoding="utf-8") as f:
            result = json.load(f)
        assert result["witnessed_sites"] > 10, result
        assert result["checked"] > 0, result
        assert result["contradictions"] == [], result["contradictions"]
    finally:
        if os.path.exists(report):
            os.remove(report)
