"""The port's analysis toolchain (incubator_brpc_tpu_torch/analysis/ and
``python -m incubator_brpc_tpu_torch.tools.check``) held against the JAX
package's on the same inputs.

- The lock and invariant fixtures (tests/analysis_fixtures/, read and
  never edited) go through both packages' inventory, lock graph and
  invariant lints: the ``(rule, key)`` sets are equal.
- The device rules run on a torch-spelled twin of the JAX device
  fixtures, written to ``tmp_path``: every rule fires on the function
  names the JAX rules fire on, and the clean twin trips nothing.
- On the port's own tree the census floor holds, every census kind is
  seen (no ``torch.compile`` yet), the three CUDA launch wrappers are
  the three ``kernel-launch`` sites, and ``--all`` exits 0.
- The runtime witnesses: the lock witness's cases, the transfer guard's
  teeth on seeded pulls, and the armed witness lane over the echo, PS,
  cache, decode and TLS paths on the CPU (tests/torch_witness_paths.py).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from incubator_brpc_tpu.analysis import invariants as j_invariants
from incubator_brpc_tpu.analysis import devicegraph as j_devicegraph
from incubator_brpc_tpu.analysis.inventory import build_inventory as j_build_inventory
from incubator_brpc_tpu.analysis.lockgraph import build_graph as j_build_graph
from incubator_brpc_tpu.analysis.manifest import Manifest as JManifest
from incubator_brpc_tpu.analysis.manifest import (
    check_graph_against_manifest as j_check_manifest,
)
from incubator_brpc_tpu.analysis.manifest import load_manifest as j_load_manifest
from incubator_brpc_tpu_torch.analysis import device_witness
from incubator_brpc_tpu_torch.analysis import devicegraph
from incubator_brpc_tpu_torch.analysis import invariants
from incubator_brpc_tpu_torch.analysis.devicegraph import (
    DeviceManifest,
    build_device_census,
    load_device_manifest,
    run_device_rules,
    run_dispatch_under_lock,
)
from incubator_brpc_tpu_torch.analysis.findings import (
    Allowlist,
    load_allowlist,
    todo_review_findings,
)
from incubator_brpc_tpu_torch.analysis.inventory import build_inventory
from incubator_brpc_tpu_torch.analysis.lockgraph import build_graph, find_cycles
from incubator_brpc_tpu_torch.analysis.manifest import (
    Manifest,
    check_graph_against_manifest,
    load_manifest,
)
from incubator_brpc_tpu_torch.tools import check as port_check

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_ROOT = os.path.join(REPO_ROOT, "incubator_brpc_tpu_torch")
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "analysis_fixtures")
DEVICE_FIXTURES = ("fixture_device_hot.py", "fixture_device_clean.py")
HOT = ("fixture_device_hot", "fixture_device_clean")
FIXTURE_MANIFEST = [{"key": "fixture.known-key", "why": "clean-twin justification"}]
CENSUS_KINDS = ("jit", "fused-kernel", "device-put", "collective", "kernel-launch",
                "donation", "slot-acquire", "slot-release", "host-sync", "allow-scope")


def _run(*args, env_extra=None, timeout=180):
    return subprocess.run(
        [sys.executable, *args], capture_output=True, text=True,
        timeout=timeout, cwd=REPO_ROOT, env={**os.environ, **(env_extra or {})},
    )


def _check_cli(*flags):
    return _run("-m", "incubator_brpc_tpu_torch.tools.check", *flags, "-q")


# ---------------------------------------------------------------------------
# the lock and invariant fixtures: both packages, equal (rule, key) sets
# ---------------------------------------------------------------------------

COMPLETION_FIXTURE_GUARDS = (
    {"module": "fixture_completion.py", "qualname": "BadScatter.__call__",
     "type": "flag-guard", "attr": "called"},
    {"module": "fixture_completion.py", "qualname": "BadScatter.__call__",
     "type": "fanout-try", "leaf": "done"},
    {"module": "fixture_completion.py", "qualname": "GoodScatter.__call__",
     "type": "flag-guard", "attr": "called"},
    {"module": "fixture_completion.py", "qualname": "GoodScatter.__call__",
     "type": "fanout-try", "leaf": "done"},
)


def _pairs(findings):
    return {(f.rule, f.key) for f in findings}


def _lens(pkg, lens):
    """One view of the fixtures through one package's toolchain."""
    if pkg == "jax":
        inv_fn, graph_fn, mcheck, M, lints = (
            j_build_inventory, j_build_graph, j_check_manifest, JManifest, j_invariants)
    else:
        inv_fn, graph_fn, mcheck, M, lints = (
            build_inventory, build_graph, check_graph_against_manifest, Manifest, invariants)
    if lens == "inventory":
        return {(s.kind, s.name, s.base()) for s in inv_fn(FIXTURES).sites}
    graph = graph_fn(inv_fn(FIXTURES), root=FIXTURES)
    if lens == "edges":
        return graph.edge_pairs()
    if lens == "lock-rules":
        return _pairs(graph.findings)
    if lens == "manifest":
        return _pairs(mcheck(graph, M([]))[0])
    if lens == "tls-restore":
        return _pairs(lints.run_tls_lint(FIXTURES))
    if lens == "except-swallow":
        return _pairs(lints.run_except_lint(
            os.path.dirname(FIXTURES), dirs=(os.path.basename(FIXTURES),)))
    if lens == "completion-guard":
        return _pairs(lints.run_completion_lint(FIXTURES, guards=COMPLETION_FIXTURE_GUARDS))
    if lens == "chaos-sites":
        return _pairs(lints.check_chaos_sites(
            {"socket.write": "real", "made.up_site": "unregistered"},
            "| `socket.write` | transport | drop |", "FaultSpec('socket.write', 'drop')"))
    raise ValueError(lens)


@pytest.mark.parametrize("lens", ["inventory", "edges", "lock-rules", "manifest",
                                  "tls-restore", "except-swallow", "completion-guard",
                                  "chaos-sites"])
def test_fixture_findings_equal_the_jax_toolchain(lens):
    port, ref = _lens("port", lens), _lens("jax", lens)
    assert port == ref
    assert port, f"{lens}: the fixtures produced nothing to compare"


def test_fixture_rules_fire_as_the_jax_tests_require():
    """tests/test_analysis.py's fixture cases, on the port's toolchain."""
    inv = build_inventory(FIXTURES)
    graph = build_graph(inv, root=FIXTURES)
    a, b = "fixture_inversion.py:Inverted._a", "fixture_inversion.py:Inverted._b"
    assert (a, b) in graph.edge_pairs() and (b, a) in graph.edge_pairs()
    assert any(a in c and b in c for c in find_cycles(graph.edge_pairs()))
    keys = {f.key for f in graph.findings if f.rule == "blocking-under-lock"}
    for want in ("sleepy:sleep", "sendy:write", "foreign_wait:wait_for"):
        assert any(want in k for k in keys), keys
    assert not any("ok_wait" in k for k in keys)
    cb = {f.key for f in graph.findings if f.rule == "callback-under-lock"}
    assert any("finish:done" in k for k in cb) and not any("status_check_is_fine" in k for k in cb)
    assert "fixture_tls.py:leaky:ctx" in {f.key for f in invariants.run_tls_lint(FIXTURES)}
    drained = build_inventory(PKG_ROOT).by_owner[
        ("runtime/execution_queue.py", "ExecutionQueue", "_drained")]
    assert drained.base() == "runtime/execution_queue.py:ExecutionQueue._lock"


# ---------------------------------------------------------------------------
# the device rules: a torch-spelled twin of the JAX device fixtures
# ---------------------------------------------------------------------------

TWIN_HOT = '''\
"""Seeded device-plane violations in torch spellings: every device rule
must fire here, on the function names it fires on in the JAX fixture."""

import functools
import threading

import numpy as np
import torch

from incubator_brpc_tpu_torch.analysis.device_witness import allowed_transfer
from incubator_brpc_tpu_torch.batching.fused import FusedKernel
from incubator_brpc_tpu_torch.ops.transfer import device_copy_with_checksum_chunk_into

# raw-jit-retrace: a compile in a hot module, outside FusedKernel
raw_step = torch.compile(lambda v: v * 2)


@functools.partial(torch.compile, dynamic=False)
def decorated_donor(buf):
    return buf * 2


def hot_pull(x):
    return np.asarray(x)


def hot_coerce(x):
    return float(x.sum())


def hot_item(x):
    return x.item()


def hot_block(x):
    torch.cuda.synchronize()
    return x


def unknown_scope(x):
    with allowed_transfer("fixture.unknown-key"):
        return x.cpu()


def leaky_slot(ring, x):
    slot = ring.acquire((4, 128), torch.float32)
    del slot
    return x


def read_after_donate(x, carry, ring):
    buf = ring.acquire((4, 128), torch.float32)
    out, acc = device_copy_with_checksum_chunk_into(x, carry, buf, 4)
    ring.release(buf)
    return out, acc, buf[0]  # the slot went back to its ring


class LockedDispatch:
    def __init__(self):
        self._lock = threading.Lock()
        self._kernel = FusedKernel(lambda v: v + 1)
        self._out = None

    def dispatch(self, x):
        with self._lock:
            self._out = self._kernel(x)
        return self._out
'''

TWIN_CLEAN = '''\
"""Clean twin: the same shapes done right; no device rule may fire."""

import threading

import torch

from incubator_brpc_tpu_torch.analysis.device_witness import allowed_transfer
from incubator_brpc_tpu_torch.batching.fused import FusedKernel

step = FusedKernel(lambda v: v * 2, label="fixture.step", batch_buckets=(1, 2, 4))


def scoped_pull(x):
    with allowed_transfer("fixture.known-key"):
        return x.cpu().numpy()


def benign_coerce(timeout):
    return float(timeout or 0.0)


def explicit_place(w, dev):
    return w.to(dev)


def dtype_only(w):
    return w.to(torch.float64)


def balanced_slot(ring, x):
    slot = ring.acquire((4, 128), torch.float32)
    if slot is None:
        return x
    ring.release(slot)
    return x


def donate_then_hands_off(x, donor_fn, ring):
    buf = ring.acquire((4, 128), torch.float32)
    return donor_fn(x, buf)


class UnlockedDispatch:
    def __init__(self):
        self._lock = threading.Lock()
        self._out = None

    def dispatch(self, x):
        out = step(x)
        with self._lock:
            self._out = out
        return out
'''

TWIN_SPELLINGS = '''\
"""Every torch spelling the census must see (never imported)."""

import functools

import numpy as np
import torch
from torch import compile as tc

from incubator_brpc_tpu_torch.ops.transfer import _kernels


@torch.compile
def compiled(v):
    return v


scripted = torch.jit.script(compiled)
traced = torch.jit.trace(compiled, torch.ones(1))
aliased = tc(compiled)
partial = functools.partial(torch.compile, mode="max-autotune")


def launches(x, out):
    lib = _kernels()
    lib.copy_blocks(x.data_ptr(), out.data_ptr(), x.nbytes, 8, 0)
    lib.copy_csum_blocks(0, 0, 0, 0, 0, 0, 1, 128, 1, 0, 0)
    _kernels().copy_csum_staged(0, 0, 0, 0, 0, 1, 128, 1, 1, 0, 1, 0)
    lib.transfer_error_string(0)


def uploads(x, dev):
    a = x.to(dev)
    b = x.cuda()
    c = torch.tensor([1.0], device=dev)
    d = torch.as_tensor([1.0], device="cuda:0")
    e = torch.tensor([1.0], device="cpu")
    f = x.to(torch.float16)
    buf = torch.empty(x.shape, device=dev)
    buf.copy_(x)
    host = torch.empty(x.shape, pin_memory=True)
    host.copy_(x, non_blocking=True)
    return a, b, c, d, e, f, buf, host


def pulls(x, ev, stream):
    return (x.item(), x.tolist(), x.numpy(), x.cpu(), x.to("cpu"),
            x.to(torch.device("cpu")), x.to(device="cpu"), np.asarray(x),
            np.array(x), np.ascontiguousarray(x), int(x.max()),
            torch.cuda.synchronize(), ev.synchronize(), stream.synchronize())


def into(x, carry, slot):
    return fill(x, carry, out=slot)
'''


@pytest.fixture(scope="module")
def twin_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("device_twin")
    (d / "fixture_device_hot.py").write_text(TWIN_HOT)
    (d / "fixture_device_clean.py").write_text(TWIN_CLEAN)
    (d / "fixture_device_spellings.py").write_text(TWIN_SPELLINGS)
    return str(d)


def _rule_funcs(findings):
    """(rule, module, function) of each finding: the key's first two parts."""
    return {(f.rule, *f.key.split(":")[:2]) for f in findings
            if f.key.split(":")[0] in DEVICE_FIXTURES}


@pytest.fixture(scope="module")
def jax_device_rules():
    census = j_devicegraph.build_device_census(FIXTURES)
    out = j_devicegraph.run_device_rules(
        census, j_devicegraph.DeviceManifest(FIXTURE_MANIFEST, path="<test>"),
        hot_prefixes=HOT)
    graph = j_build_graph(j_build_inventory(FIXTURES), root=FIXTURES)
    return _rule_funcs(out + j_devicegraph.run_dispatch_under_lock(graph))


@pytest.fixture(scope="module")
def port_device_rules(twin_dir):
    census = build_device_census(twin_dir)
    out = run_device_rules(census, DeviceManifest(FIXTURE_MANIFEST, path="<test>"),
                           hot_prefixes=HOT)
    graph = build_graph(build_inventory(twin_dir), root=twin_dir)
    return _rule_funcs(out + run_dispatch_under_lock(graph)), out


@pytest.mark.parametrize("rule", ["host-sync-on-hot-path", "transfer-manifest",
                                  "raw-jit-retrace", "slot-lifecycle",
                                  "read-after-donate", "device-dispatch-under-lock"])
def test_twin_rule_fires_on_the_jax_function_names(rule, jax_device_rules,
                                                   port_device_rules):
    want = {r for r in jax_device_rules if r[0] == rule}
    got = {r for r in port_device_rules[0] if r[0] == rule}
    assert want, f"the JAX fixture never fires {rule}"
    assert got == want


def test_clean_twin_trips_nothing(port_device_rules):
    noise = [f for f in port_device_rules[1] if "fixture_device_clean" in f.key]
    assert noise == [], [f.format() for f in noise]


def test_twin_host_sync_keys_carry_their_torch_labels(port_device_rules):
    keys = {f.key for f in port_device_rules[1] if f.rule == "host-sync-on-hot-path"}
    assert keys == {"fixture_device_hot.py:hot_pull:asarray:0",
                    "fixture_device_hot.py:hot_coerce:coerce:0",
                    "fixture_device_hot.py:hot_item:item:0",
                    "fixture_device_hot.py:hot_block:synchronize:0"}


def test_twin_spellings_all_censused(twin_dir):
    census = build_device_census(twin_dir)
    mine = [s for s in census.sites if s.module == "fixture_device_spellings.py"]
    jits = [s for s in mine if s.kind == "jit"]
    assert len(jits) == 5, jits  # decorator, script, trace, from-import, partial
    launches = [s for s in mine if s.kind == "kernel-launch"]
    assert sorted(s.detail.split(" ")[0] for s in launches) == [
        "copy_blocks", "copy_csum_blocks", "copy_csum_staged"]
    puts = [s for s in mine if s.kind == "device-put"]
    assert sorted(s.detail for s in puts) == [
        ".copy_()", ".cuda()", ".to(device)", "as_tensor", "tensor"]
    syncs = [s.sync for s in mine if s.kind == "host-sync"]
    assert sorted(syncs) == sorted(
        ["item", "tolist", "numpy", "cpu", "to_cpu", "to_cpu", "to_cpu", "asarray",
         "asarray", "asarray", "coerce", "synchronize", "synchronize", "synchronize"])
    assert census.donating.get("into") == (2,)


# ---------------------------------------------------------------------------
# the port's own tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree_census():
    return build_device_census(PKG_ROOT)


def test_census_floor_and_kinds_on_the_tree(tree_census):
    assert len(tree_census.sites) >= port_check.MIN_DEVICE_SITES
    assert len(build_inventory(PKG_ROOT).sites) >= port_check.MIN_LOCK_SITES
    kinds = {s.kind for s in tree_census.sites}
    assert kinds == set(CENSUS_KINDS) - {"jit"}, kinds
    assert not tree_census.by_kind("jit")  # the port compiles nothing per shape
    assert any("chunk_into" in n for n in tree_census.donating)
    assert any("dma_into" in n for n in tree_census.donating)


def test_kernel_launch_census_is_the_three_wrappers(tree_census):
    sites = {s.func: s.detail for s in tree_census.by_kind("kernel-launch")}
    assert set(sites) == {"_launch_copy_csum_blocks", "_launch_copy_csum_staged",
                          "_launch_copy_blocks"}
    assert all(s.module == "ops/transfer.py" for s in tree_census.by_kind("kernel-launch"))
    assert ":68" in sites["_launch_copy_blocks"]
    assert ":112" in sites["_launch_copy_csum_blocks"]
    assert ":176" in sites["_launch_copy_csum_blocks"]
    assert ":202" in sites["_launch_copy_csum_blocks"]
    assert ":388" in sites["_launch_copy_csum_staged"]
    # every launch wrapper is a dispatch leaf of the under-lock rule
    for name in sites:
        assert name in devicegraph.DEVICE_DISPATCH_LEAFS


def test_every_unscoped_hot_sync_on_the_tree_is_allowlisted(tree_census):
    findings = run_device_rules(tree_census)
    allow = load_allowlist(os.path.join(PKG_ROOT, "analysis", "allowlist.json"))
    violations, allowed, _ = allow.split(findings)
    assert violations == [], [f.format() for f in violations]
    # the scoped pulls the census knows, each under its manifest key
    scoped = {s.scope_key for s in tree_census.by_kind("host-sync") if s.scope_key}
    assert scoped == {"decode.token-sums", "cache.host-spill", "dcn.wire", "ps.forward-pull",
                      "ps.client-merge", "iobuf.host-view", "profiler.capture-sync"}


@pytest.mark.parametrize("flags", [("--all",), ("--device",), ("--locks",),
                                   ("--invariants",)])
def test_check_cli_exits_zero_on_the_tree(flags):
    proc = _check_cli(*flags)
    assert proc.returncode == 0, f"{flags}: {proc.stdout}\n{proc.stderr}"
    assert "stale-allowlist-entry" not in proc.stdout + proc.stderr


def test_check_json_reports_the_census(tmp_path):
    out = tmp_path / "check.json"
    proc = _check_cli("--all", "--json", str(out))
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    payload = json.loads(out.read_text())
    assert payload["device_sites"] >= port_check.MIN_DEVICE_SITES
    assert payload["lock_sites"] >= port_check.MIN_LOCK_SITES
    assert payload["violations"] == []


def test_smoke_guard_fails_on_impossible_site_floor():
    with pytest.raises(RuntimeError, match="scanner is broken"):
        port_check.run_check(min_sites=100_000)
    with pytest.raises(RuntimeError, match="scanner is broken"):
        port_check.run_check(locks=False, invariants=False, min_device_sites=100_000)


def test_static_edges_include_the_jax_manifest_edges_over_copied_locks():
    """Every static edge of the JAX manifest whose two locks exist in the
    port is a static edge of the port's graph, and the port's manifest
    gives it the JAX manifest's why."""
    names = {s.name for s in build_inventory(PKG_ROOT).sites}
    port_edges = build_graph(build_inventory(PKG_ROOT)).edge_pairs()
    jax_static = [e for e in j_load_manifest().edges if e.get("source") != "witness"]
    shared = [e for e in jax_static if e["from"] in names and e["to"] in names]
    assert shared
    whys = {(e["from"], e["to"]): e["why"] for e in load_manifest().edges}
    for e in shared:
        assert (e["from"], e["to"]) in port_edges, e
        assert whys[(e["from"], e["to"])] == e["why"]


# ---------------------------------------------------------------------------
# manifests and allowlist
# ---------------------------------------------------------------------------

def test_checked_in_manifests_all_justified():
    for e in load_manifest().edges:
        assert e["why"].strip() and "TODO" not in e["why"], e
    for e in load_device_manifest().entries:
        assert e["why"].strip() and "TODO" not in e["why"], e
    allow = load_allowlist(os.path.join(PKG_ROOT, "analysis", "allowlist.json"))
    for e in allow.entries:
        assert e["why"].strip() and "TODO" not in e["why"], e
    assert todo_review_findings(allow) == []
    # the six keys the port opens, the profiler's stop, and chip_smoke's
    assert load_device_manifest().internal_keys() == {
        "decode.token-sums", "cache.host-spill", "dcn.wire", "ps.forward-pull",
        "ps.client-merge", "iobuf.host-view", "profiler.capture-sync"}
    assert load_device_manifest().keys() - load_device_manifest().internal_keys() == {
        "smoke.witness"}


@pytest.mark.parametrize("make", [
    lambda: DeviceManifest([{"key": "k", "why": "   "}]),
    lambda: DeviceManifest([{"key": "k", "why": "a"}, {"key": "k", "why": "b"}]),
    lambda: DeviceManifest([{"key": " ", "why": "a"}]),
    lambda: Manifest([{"from": "a", "to": "b", "why": ""}]),
    lambda: Allowlist([{"rule": "x", "key": "y", "why": "  "}]),
])
def test_manifest_rules_refuse_blank_whys_and_duplicate_keys(make):
    with pytest.raises(ValueError, match="justification|duplicated|empty key"):
        make()


def test_stale_entries_are_violations(twin_dir):
    al = Allowlist([{"rule": "ghost-rule", "key": "nope*", "why": "stale on purpose"}])
    violations, allowed, unused = al.split([])
    assert unused and not allowed and not violations
    census = build_device_census(twin_dir)
    out = run_device_rules(census, DeviceManifest(
        FIXTURE_MANIFEST + [{"key": "fixture.gone", "why": "stale on purpose"},
                            {"key": "fixture.external", "why": "outside", "external": True}],
        path="<test>"), hot_prefixes=HOT)
    stale = {f.key for f in out if f.rule == "transfer-manifest-stale"}
    assert stale == {"fixture.gone"}


def test_todo_review_placeholder_is_a_violation(monkeypatch):
    from incubator_brpc_tpu_torch.analysis import findings as findings_mod
    from incubator_brpc_tpu_torch.analysis.manifest import (
        todo_review_findings as manifest_todo,
    )

    m = Manifest(edges=[{"from": "x", "to": "y", "why": "TODO review: first seen x:1"}],
                 path="seeded.json")
    assert [f.key for f in manifest_todo(m)] == ["lock-order/x->y"]
    real = findings_mod.load_allowlist(os.path.join(PKG_ROOT, "analysis", "allowlist.json"))
    seeded = Allowlist(real.entries + [{"rule": "blocking-under-lock", "key": "seeded/*",
                                        "why": "TODO review: never edited"}], path=real.path)
    monkeypatch.setattr(findings_mod, "load_allowlist", lambda path: seeded)
    out = port_check.run_check(locks=True, invariants=False, device=False)
    assert any(f.rule == "todo-review-why" and "seeded/*" in f.key
               for f in out["violations"])


# ---------------------------------------------------------------------------
# project invariants on the port's tree
# ---------------------------------------------------------------------------

def test_every_port_chaos_site_is_documented_and_tested_by_a_port_test():
    """chaos-site-test counts only tests/test_torch_*.py: a JAX test
    arms the JAX package's injector, never the port's."""
    from incubator_brpc_tpu_torch.chaos import injector

    out = invariants.run_chaos_site_lint(REPO_ROOT)
    allow = load_allowlist(os.path.join(PKG_ROOT, "analysis", "allowlist.json"))
    violations, _, _ = allow.split(out)
    assert violations == [], [f.format() for f in violations]
    # every site has a port test now, the native engine's and its
    # submission ring's among them (tests/test_torch_chaos.py)
    assert [f.key for f in out] == []
    assert {s for s in injector.SITES if s.split(".")[0] in ("native", "ring")} == {
        "native.srv_read", "native.srv_write", "ring.submit"}
    # a site named only by a JAX test does not count for the port
    assert invariants.check_chaos_sites(
        {"socket.write": "x"}, "`socket.write`", "") != []


def test_completion_guards_and_metrics_hold_on_the_tree():
    assert invariants.run_completion_lint(PKG_ROOT) == []
    assert invariants.run_metrics_lint() == []


def test_metrics_lint_flags_string_variable():
    from incubator_brpc_tpu_torch.metrics.passive_status import PassiveStatus

    var = PassiveStatus(lambda: "not-a-number").expose("torch_analysis_probe_string")
    try:
        assert any(f.key == "torch_analysis_probe_string" for f in invariants.run_metrics_lint())
    finally:
        var.hide()
    assert not any(f.key == "torch_analysis_probe_string" for f in invariants.run_metrics_lint())


# ---------------------------------------------------------------------------
# the lock witness
# ---------------------------------------------------------------------------

not_in_witness_session = pytest.mark.skipif(
    bool(os.environ.get("BRPC_TORCH_LOCK_WITNESS")),
    reason="mutates global witness state; unsafe inside a witness session",
)


@not_in_witness_session
def test_witness_detects_runtime_inversion():
    from incubator_brpc_tpu_torch.analysis import witness

    inv = build_inventory(FIXTURES)
    a_site = inv.by_owner[("fixture_inversion.py", "Inverted", "_a")]
    b_site = inv.by_owner[("fixture_inversion.py", "Inverted", "_b")]
    a = witness.make_lock(f"fixture_inversion.py:{a_site.line}")
    b = witness.make_lock(f"fixture_inversion.py:{b_site.line}")
    witness.reset()
    try:
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        result = witness.cross_check(pkg_root=FIXTURES,
                                     manifest_pairs={(a_site.name, b_site.name)})
        assert result["checked"] >= 2
        assert any(c["witnessed"] == f"{b_site.name} -> {a_site.name}"
                   for c in result["contradictions"]), result
    finally:
        witness.reset()


@not_in_witness_session
def test_witness_folds_reentrant_and_alias_acquisitions():
    from incubator_brpc_tpu_torch.analysis import witness

    witness.reset()
    try:
        r = witness.make_rlock("x.py:1")
        with r:
            with r:
                pass
        cond = witness.make_condition("x.py:2")
        with cond:
            cond.wait_for(lambda: True, 0.01)
        assert ("x.py:1", "x.py:1") not in witness.edges()
        assert witness.sites_seen().get("x.py:1") == 1
    finally:
        witness.reset()


def test_witness_global_patch_wraps_only_scoped_creations():
    code = textwrap.dedent(f"""\
        import sys, threading
        sys.path.insert(0, {REPO_ROOT!r})
        from incubator_brpc_tpu_torch.analysis import witness
        witness.enable(extra_scopes=[{FIXTURES!r}])
        sys.path.insert(0, {FIXTURES!r})
        import fixture_inversion
        obj = fixture_inversion.Inverted()
        assert isinstance(obj._a, witness._WitnessLock)
        obj.forward(); obj.backward()
        assert not isinstance(threading.Lock(), witness._WitnessBase)
        pairs = set(witness.edges())
        assert (obj._a.site, obj._b.site) in pairs and (obj._b.site, obj._a.site) in pairs
        witness.disable()
        assert threading.Lock is witness._REAL_LOCK
        print("LOCK-WITNESS-OK")
    """)
    proc = _run("-c", code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOCK-WITNESS-OK" in proc.stdout


# ---------------------------------------------------------------------------
# the transfer guard
# ---------------------------------------------------------------------------

SEEDED = textwrap.dedent("""\
    import numpy as np
    import torch

    from incubator_brpc_tpu_torch.analysis.device_witness import allowed_transfer


    def pull(kind, x):
        if kind == "item":
            return x.item()
        if kind == "numpy":
            return x.numpy()
        if kind == "asarray":
            return np.asarray(x)
        if kind == "tolist":
            return x.tolist()
        if kind == "cpu":
            return x.cpu()
        if kind == "to_cpu":
            return x.to("cpu")
        if kind == "synchronize":
            return torch.cuda.synchronize()
        raise ValueError(kind)


    def host_only(a):
        return np.asarray(a)


    def pull_scoped(x):
        with allowed_transfer("decode.token-sums"):
            return x.numpy()
""")

SPELLINGS = ["item", "numpy", "asarray", "tolist", "cpu", "to_cpu", "synchronize"]


@pytest.fixture(scope="module")
def seeded_guard(tmp_path_factory):
    """One child interpreter arms the guard with a seeded module under
    an extra scope and tries each spelling; returns its report."""
    d = tmp_path_factory.mktemp("seeded_transfer")
    (d / "seeded_transfer.py").write_text(SEEDED)
    code = textwrap.dedent(f"""\
        import json, sys
        sys.path.insert(0, {REPO_ROOT!r})
        from incubator_brpc_tpu_torch.analysis import device_witness as dw
        dw.enable(extra_scopes=[{str(d)!r}])
        sys.path.insert(0, {str(d)!r})
        import numpy as np, torch
        import seeded_transfer as st
        x = torch.ones(1)
        out = {{"raised": {{}}}}
        for kind in {SPELLINGS!r}:
            try:
                st.pull(kind, x)
                out["raised"][kind] = False
            except dw.TransferWitnessError:
                out["raised"][kind] = True
        out["host_only"] = st.host_only([1.0, 2.0]).tolist()
        out["scoped"] = st.pull_scoped(x).tolist()
        out["test_site"] = x.item()  # a pull outside the package: never guarded
        try:
            with dw.allowed_transfer("no-such-manifest-key"):
                pass
            out["unknown_key"] = False
        except dw.TransferWitnessError:
            out["unknown_key"] = True
        out["report"] = dw.cross_check()
        dw.disable()
        out["restored"] = (torch.Tensor.item is torch._C.TensorBase.item
                           and "item" not in vars(torch.Tensor)
                           and not hasattr(np.asarray, "__wrapped__"))
        print("REPORT " + json.dumps(out, default=repr))
    """)
    proc = _run("-c", code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("REPORT ")]
    return json.loads(line[-1][len("REPORT "):])


@pytest.mark.parametrize("kind", SPELLINGS)
def test_guard_refuses_a_seeded_unmanifested_pull(seeded_guard, kind):
    assert seeded_guard["raised"][kind] is True
    sites = [v for v in seeded_guard["report"]["violations"] if v["kind"] == "transfer"]
    assert any(v["site"].startswith("seeded_transfer.py:") for v in sites)


def test_guard_passes_host_data_scoped_pulls_and_test_sites(seeded_guard):
    assert seeded_guard["host_only"] == [1.0, 2.0]
    assert seeded_guard["scoped"] == [1.0]
    assert seeded_guard["test_site"] == 1.0
    assert seeded_guard["report"]["scope_uses"].get("decode.token-sums") == 1
    transfers = [v for v in seeded_guard["report"]["violations"] if v["kind"] == "transfer"]
    assert len(transfers) == len(SPELLINGS)


def test_guard_refuses_an_unknown_scope_key_and_disarms_cleanly(seeded_guard):
    assert seeded_guard["unknown_key"] is True
    assert any(v["kind"] == "unknown-scope-key"
               for v in seeded_guard["report"]["violations"])
    assert seeded_guard["restored"] is True


@pytest.mark.skipif(bool(os.environ.get("BRPC_TORCH_TRANSFER_WITNESS")),
                    reason="the witness is armed for the whole session")
def test_allowed_transfer_is_a_counter_when_disarmed():
    assert not device_witness.enabled()
    before = device_witness.transfer_counts().get("no-such-key", 0)
    with device_witness.allowed_transfer("no-such-key"):  # not validated disarmed
        pass
    assert device_witness.transfer_counts()["no-such-key"] == before + 1


def test_retrace_witness_flags_bound_violation():
    import torch

    from incubator_brpc_tpu_torch.batching.fused import FusedKernel

    ok = FusedKernel(lambda x: x + 1, label="torch.analysis.ok", batch_buckets=(1, 2))
    for n in (1, 2):
        ok(torch.zeros((n, 4)))
    bad = FusedKernel(lambda x: x * 2, label="torch.analysis.bad", batch_buckets=(1, 2))
    for n in (1, 2, 3):
        bad(torch.zeros((n, 4)))
    con = [c for c in device_witness.retrace_contradictions()
           if c["kernel"].startswith("torch.analysis.")]
    assert len(con) == 1 and con[0]["kernel"] == "torch.analysis.bad", con
    assert con[0]["count"] == 3 and con[0]["bound"] == 2


# ---------------------------------------------------------------------------
# the armed witness lane: the port's paths on the CPU, both witnesses on
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def witness_lane(tmp_path_factory):
    d = tmp_path_factory.mktemp("witness_lane")
    lock_report, transfer_report = d / "lock.json", d / "transfer.json"
    proc = _run("-m", "pytest", "tests/torch_witness_paths.py", "-q",
                "-p", "no:cacheprovider", "-p", "no:xdist", "-p", "no:randomly",
                "-p", "incubator_brpc_tpu_torch.analysis.pytest_plugin",
                env_extra={"BRPC_TORCH_LOCK_WITNESS": "1",
                           "BRPC_TORCH_TRANSFER_WITNESS": "1",
                           "BRPC_TORCH_LOCK_WITNESS_REPORT": str(lock_report),
                           "BRPC_TORCH_TRANSFER_WITNESS_REPORT": str(transfer_report),
                           "JAX_PLATFORMS": "cpu"},
                timeout=120)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
    return {"stdout": proc.stdout,
            "lock": json.loads(lock_report.read_text()),
            "transfer": json.loads(transfer_report.read_text())}


def test_witness_lane_runs_every_path(witness_lane):
    out = witness_lane["stdout"]
    assert " passed" in out and "failed" not in out and "error" not in out.lower(), out
    # the TLS hop needs openssl, like tests/test_ssl.py; every other path
    # ran, the native engine's Forward among them
    assert "8 passed" in out or ("7 passed" in out and "1 skipped" in out), out


def test_witness_lane_has_no_violation(witness_lane):
    t = witness_lane["transfer"]
    assert t["enabled"] is True
    assert t["violations"] == [] and t["retrace_contradictions"] == []


def test_witness_lane_has_no_lock_contradiction(witness_lane):
    lock = witness_lane["lock"]
    assert lock["contradictions"] == []
    assert lock["witnessed_sites"] > 20 and lock["checked"] > 0


def test_witness_lane_scope_counts(witness_lane):
    uses = witness_lane["transfer"]["scope_uses"]
    # ICI hops and cache hits pull nothing; each of 8 decode steps pulls
    # its token sums once; the PS pulls once a batch; TLS views a frame
    assert "cache.host-spill" not in uses
    assert uses["decode.token-sums"] == 8
    assert uses["ps.forward-pull"] >= 1
    assert set(uses) <= {"decode.token-sums", "ps.forward-pull", "iobuf.host-view"}


# ---------------------------------------------------------------------------
# repairs the toolchain found in the port
# ---------------------------------------------------------------------------

def test_dcn_wire_pull_sits_inside_its_scope():
    """The census found the DCN bridge's outbound ``host.numpy()`` one
    line past its ``dcn.wire`` scope (parallel/dcn.py, _plan_frame's
    producer): armed, a frame with a device segment failed to encode."""
    code = textwrap.dedent(f"""\
        import sys
        sys.path.insert(0, {REPO_ROOT!r})
        from incubator_brpc_tpu_torch.analysis import device_witness as dw
        dw.enable()
        import torch
        from incubator_brpc_tpu_torch.parallel import dcn
        from incubator_brpc_tpu_torch.utils.iobuf import IOBuf
        frame = IOBuf()
        frame.append(b"head")
        frame.append_device(torch.arange(256, dtype=torch.float32))
        header, producers, total = dcn._plan_frame(frame, (1, 0), (1, 1))
        body = b"".join(bytes(c) for p in producers for c in p())
        assert body == b"head" + torch.arange(256, dtype=torch.float32).numpy().tobytes()
        assert dw.cross_check()["violations"] == []
        assert dw.transfer_counts()["dcn.wire"] == 1
        print("DCN-WIRE-OK")
    """)
    proc = _run("-c", code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "DCN-WIRE-OK" in proc.stdout


def test_witness_survives_a_finalizer_inside_its_own_critical_section():
    """A GC finalizer that takes a witnessed lock while its thread holds
    another can run inside the witness's own ``_state_lock`` section (a
    metrics Variable's ``__del__`` did, mid lock creation, and hung the
    armed lane in about one run in six).  Here a key's ``__hash__``
    stands in for the finalizer, deterministically: the witness's state
    lock must be reentrant."""
    code = textwrap.dedent(f"""\
        import sys
        sys.path.insert(0, {REPO_ROOT!r})
        from incubator_brpc_tpu_torch.analysis import witness
        inner = witness.make_lock("inner.py:1")
        outer = witness.make_lock("outer.py:1")

        class Site(str):
            def __hash__(self):
                with inner:
                    pass
                return str.__hash__(self)

        with outer:
            witness.make_lock(Site("x.py:1"))
        assert ("outer.py:1", "inner.py:1") in witness.edges()
        print("NO-DEADLOCK")
    """)
    proc = _run("-c", code, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO-DEADLOCK" in proc.stdout
