"""Device-plane continuous profiling (observability/profiling.py).

The three profilers end to end: HBM heap accounting exactness across
every adopting subsystem (cache values, staging ring, PS params) with
the census ``<dark>`` cross-check under an armed transfer witness,
growth diffs across a forced eviction, the three /hotspots pages over
real HTTP, a deep capture running concurrently with live serving, the
``profile.capture`` chaos site under the recovery harness, occupancy
under a spawn storm, and the rpcz ``device`` phase on a batched PS
Forward.

Carried by hand from ``tests/test_profiling.py``.  The device values are
``torch.Tensor``s, and every store, ring and PS is given the device the
case runs on (the CPU, or the card).  The two cases that read the HBM
census (the ``<dark>`` bucket under the armed witness, and the page's
``baseline=`` after a rebase) run on the card only: the port's census
reads the CUDA allocator, and on the CPU there is none to read.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from incubator_brpc_tpu_torch.chaos import FaultPlan, FaultSpec, RecoveryHarness
from incubator_brpc_tpu_torch.chaos import injector
from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.models.parameter_server import PsService, ps_stub
from incubator_brpc_tpu_torch.observability import profiling
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest, EchoResponse
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
from incubator_brpc_tpu_torch.utils.flags import set_flag

from torch_carry import card_device, torch_device  # noqa: F401  (fixtures)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _http_get(port, path):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("GET", path)
    r = conn.getresponse()
    body = r.read().decode()
    conn.close()
    return r.status, body


def _wait_for(fn, timeout=8.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(0.05)
    return fn()


@pytest.fixture(autouse=True)
def always_disarm():
    yield
    injector.disarm()


# ---------------------------------------------------------------------------
# (1) HBM heap profiler: ledger exactness per adopter
# ---------------------------------------------------------------------------


def test_hbm_account_contract_and_gate(torch_device):
    """adopt returns the bytes charged (store it; release exactly it),
    accepts ints and .nbytes carriers, charges nothing for host bytes,
    and the runtime gate turns adoption into a 0-charge no-op without
    ever unbalancing the ledger."""
    acct = profiling.hbm_account("test.contract")
    assert profiling.hbm_account("test.contract") is acct  # one handle/tag
    b0, a0 = acct.live_bytes(), acct.live_allocs()
    n = acct.adopt(4096)
    assert n == 4096
    arr = torch.ones((16, 16), dtype=torch.float32, device=torch_device)
    m = acct.adopt(arr)
    assert m == int(arr.nbytes) == 1024
    assert acct.adopt(b"host-bytes-carry-no-nbytes") == 0
    assert acct.live_bytes() - b0 == 5120
    assert acct.live_allocs() - a0 == 2
    # gate off: adopt charges 0; releasing previously-stored charges
    # still balances (the contract: release what adopt RETURNED)
    set_flag("profiler_hbm_enabled", False)
    try:
        assert acct.adopt(8192) == 0
        acct.release(n)
        acct.release(m)
    finally:
        set_flag("profiler_hbm_enabled", True)
    assert acct.live_bytes() == b0
    assert acct.live_allocs() == a0


def test_cache_store_accounting_exact_across_evict_replace_flush(torch_device):
    """cache.values tracks the store bit-exactly through SET, budget
    eviction, replacement, DELETE, and FLUSH — ledger == store's own
    hbm_used at every step, and back to baseline at the end."""
    from incubator_brpc_tpu_torch.cache.store import HBMCacheStore

    acct = profiling.hbm_account("cache.values")
    b0 = acct.live_bytes()
    store = HBMCacheStore(hbm_budget_bytes=3000, device=torch_device)
    assert store.set(b"a", b"x" * 1000)
    assert store.set(b"b", b"y" * 1000)
    assert store.set(b"c", b"z" * 1000)
    assert acct.live_bytes() - b0 == 3000 == store.hbm_used
    # budget overflow: LRU eviction releases the evicted charges
    assert store.set(b"d", b"w" * 2500)
    assert acct.live_bytes() - b0 == store.hbm_used == 2500
    # replacement releases the old charge before adopting the new
    assert store.set(b"d", b"v" * 500)
    assert acct.live_bytes() - b0 == 500 == store.hbm_used
    assert store.delete(b"d")
    assert acct.live_bytes() - b0 == 0
    assert store.set(b"e", b"q" * 800)
    store.flush()
    assert acct.live_bytes() - b0 == 0, "flush leaked cache.values charge"


def test_staging_ring_accounting_acquire_release_evict(torch_device):
    """ici.staging holds exactly the ring-RESIDENT slots: release()
    charges, acquire() un-charges (the buffer becomes the frame's),
    depth overflow drops (never charges), LRU key eviction and clear()
    release every evicted slot's charge."""
    from incubator_brpc_tpu_torch.parallel.ici import StagingRing

    acct = profiling.hbm_account("ici.staging")
    b0 = acct.live_bytes()
    ring = StagingRing(depth=2, max_keys=1)
    a = torch.zeros((64,), dtype=torch.float32, device=torch_device)  # 256 bytes
    b = torch.zeros((64,), dtype=torch.float32, device=torch_device)
    c = torch.zeros((64,), dtype=torch.float32, device=torch_device)
    ring.release(a)
    ring.release(b)
    assert acct.live_bytes() - b0 == 512
    ring.release(c)  # depth=2: dropped on the floor, never charged
    assert acct.live_bytes() - b0 == 512
    got = ring.acquire((64,), a.dtype)
    assert got is not None
    assert acct.live_bytes() - b0 == 256, "acquired slot still on ledger"
    # a new shape evicts the old key (max_keys=1) and its charges
    ring.release(torch.zeros((32,), dtype=torch.float32, device=torch_device))  # 128 bytes
    assert acct.live_bytes() - b0 == 128
    ring.clear()
    assert acct.live_bytes() - b0 == 0, "clear leaked ici.staging charge"


def test_ps_params_accounting_exact_put_replace_delete(torch_device):
    acct = profiling.hbm_account("ps.params")
    b0, a0 = acct.live_bytes(), acct.live_allocs()
    svc = PsService(device=torch_device)
    w = np.ones((64, 64), np.float32)  # 16384 bytes
    svc.put_param("w", w)
    assert acct.live_bytes() - b0 == w.nbytes
    # replace: old charge released, new adopted — never double-counted
    w2 = np.ones((32, 32), np.float32)  # 4096 bytes
    svc.put_param("w", w2)
    assert acct.live_bytes() - b0 == w2.nbytes
    svc.put_param("v", np.ones((16,), np.float32))
    PsService.Delete(svc, Controller(), EchoRequest(message="w"),
                     EchoResponse(), lambda: None)
    PsService.Delete(svc, Controller(), EchoRequest(message="v"),
                     EchoResponse(), lambda: None)
    assert acct.live_bytes() == b0
    assert acct.live_allocs() == a0
    # idempotent delete releases nothing twice
    PsService.Delete(svc, Controller(), EchoRequest(message="w"),
                     EchoResponse(), lambda: None)
    assert acct.live_bytes() == b0


@pytest.mark.cuda
def test_hbm_profile_dark_bucket_under_witness(card_device):
    """The acceptance cross-check, in a clean child process with the
    transfer witness ARMED: after rebase_census(), bytes pinned through
    the adopting subsystems are >=95% explained by the ledger (the
    <dark> bucket stays under 5%) and building the profile performed
    ZERO unmanifested device→host pulls — the census read is metadata
    only."""
    code = f"""\
import sys
sys.path.insert(0, {str(REPO_ROOT)!r})
from incubator_brpc_tpu_torch.analysis import device_witness as dw
dw.enable()
import numpy as np
import torch
from incubator_brpc_tpu_torch.cache.store import HBMCacheStore
from incubator_brpc_tpu_torch.models.parameter_server import PsService
from incubator_brpc_tpu_torch.observability import profiling

DEV = torch.device("cuda", 0)
torch.zeros(1, device=DEV)  # a CUDA context: the census reads its allocator
profiling.rebase_census()
store = HBMCacheStore(hbm_budget_bytes=1 << 20, device=DEV)
for i in range(8):
    assert store.set(b"k%d" % i, bytes([i]) * 4096)
svc = PsService(device=DEV)
svc.put_param("w", np.ones((128, 128), np.float32))
p = profiling.hbm_profile()
assert p["census"]["available"], p["census"]
assert p["tags"]["cache.values"]["bytes"] >= 8 * 4096, p["tags"]
assert p["tags"]["ps.params"]["bytes"] >= 0, p["tags"]
span = max(1, p["census"]["bytes"] - p["census_baseline"])
frac = p["dark_bytes"] / span
assert frac < 0.05, (p["dark_bytes"], span, p["tags"])
text = profiling.render_hbm(p)
assert "<dark>" in text and "cache.values" in text
rep = dw.cross_check()
assert rep["violations"] == [], rep["violations"]
print("HBM-DARK-OK %.4f" % frac)
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=REPO_ROOT,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    assert "HBM-DARK-OK" in proc.stdout


# ---------------------------------------------------------------------------
# /hotspots pages over real HTTP
# ---------------------------------------------------------------------------


@pytest.fixture
def web_server():
    srv = Server()
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    yield srv
    srv.stop()


def test_hotspots_pages_respond(web_server):
    st, body = _http_get(web_server.port, "/hotspots/hbm")
    assert st == 200 and "--- hbm" in body and "accounted_bytes:" in body
    st, body = _http_get(web_server.port, "/hotspots/device")
    assert st == 200 and "--- device" in body and "kernel_families:" in body
    st, body = _http_get(web_server.port, "/hotspots/runtime")
    assert st == 200 and "--- runtime occupancy" in body
    assert "queue_wait:" in body
    st, body = _http_get(web_server.port, "/hotspots/device?seconds=bogus")
    assert st == 400
    st, body = _http_get(web_server.port, "/index?as_more")
    assert st == 200
    for page in ("hotspots/hbm", "hotspots/device", "hotspots/runtime"):
        assert page in body, f"/index does not link {page}"


def test_hbm_growth_page_diffs_across_forced_eviction(web_server, torch_device):
    """/hotspots/hbm?growth=1 is a diff-against-last-fetch: the first
    fetch seeds the baseline, a forced eviction wave shows up in the
    second fetch as signed per-tag deltas on cache.values."""
    from incubator_brpc_tpu_torch.cache.store import HBMCacheStore

    store = HBMCacheStore(hbm_budget_bytes=4096, device=torch_device)
    assert store.set(b"g1", b"a" * 4000)
    st, body = _http_get(web_server.port, "/hotspots/hbm?growth=1")
    assert st == 200  # first fetch: baseline capture
    assert "baseline captured" in body or "growth since last fetch" in body
    # force an eviction (replacement wave shrinks the resident set)
    assert store.set(b"g2", b"b" * 1000)  # evicts g1: -4000 +1000
    st, body = _http_get(web_server.port, "/hotspots/hbm?growth=1")
    assert st == 200
    assert "growth since last fetch" in body
    assert "cache.values" in body, body
    assert "-3000" in body, body  # the signed net delta of the wave
    store.flush()


@pytest.mark.cuda
def test_hbm_page_rebase_resets_dark_horizon(web_server, card_device):
    torch.zeros(1, device=card_device)  # a CUDA context for the census
    st, body = _http_get(web_server.port, "/hotspots/hbm?rebase=1")
    assert st == 200 and "rebased" in body
    st, body = _http_get(web_server.port, "/hotspots/hbm")
    assert st == 200 and "baseline=" in body


# ---------------------------------------------------------------------------
# (2) device-time attribution
# ---------------------------------------------------------------------------


def test_kernel_section_counters_and_gate():
    snap0 = profiling.kernel_snapshot().get(
        "test.kern", {"executions": 0, "total_us": 0.0})
    with profiling.kernel_section("test.kern"):
        time.sleep(0.002)
    snap = profiling.kernel_snapshot()["test.kern"]
    assert snap["executions"] == snap0["executions"] + 1
    assert snap["total_us"] > snap0["total_us"]
    assert snap["ema_us"] > 0
    # an exception inside the window notes nothing
    with pytest.raises(RuntimeError):
        with profiling.kernel_section("test.kern"):
            raise RuntimeError("boom")
    assert profiling.kernel_snapshot()["test.kern"]["executions"] == (
        snap0["executions"] + 1)
    # disarmed: one flag load, no counters
    set_flag("profiler_device_enabled", False)
    try:
        with profiling.kernel_section("test.kern"):
            pass
    finally:
        set_flag("profiler_device_enabled", True)
    assert profiling.kernel_snapshot()["test.kern"]["executions"] == (
        snap0["executions"] + 1)
    assert "test.kern" in profiling.render_device()


def test_concurrent_capture_while_serving(web_server):
    """A deep capture window arms while echo traffic keeps flowing:
    every RPC succeeds mid-capture, a second capture is refused (one
    profiler session at a time), and no armed trace survives."""
    ch = Channel(ChannelOptions(timeout_ms=5000))
    ch.init(f"127.0.0.1:{web_server.port}")
    stub = echo_stub(ch)
    box = {}

    def capture():
        try:
            box["result"] = profiling.device_capture(0.5)
        except profiling.CaptureError as e:
            box["error"] = e

    t = threading.Thread(target=capture)
    t.start()
    time.sleep(0.05)  # let the window arm
    with pytest.raises(profiling.CaptureError, match="already in progress"):
        profiling.device_capture(0.2)
    ok = 0
    while t.is_alive():
        c = Controller()
        r = stub.Echo(c, EchoRequest(message="mid-capture"))
        assert not c.failed(), c.error_text()
        assert r.message == "mid-capture"
        ok += 1
        # kernel work INSIDE the window must land in its summary
        with profiling.kernel_section("test.in-window"):
            torch.ones((8,)).sum().item()
    t.join(5)
    assert ok > 0, "no call actually overlapped the capture window"
    assert "result" in box, box.get("error")
    assert box["result"]["seconds"] >= 0.5
    assert not profiling.capture_active(), "armed trace session leaked"
    ch.close()
    fams = box["result"]["families"]
    assert fams.get("test.in-window", {}).get("executions", 0) >= 1, fams
    text = profiling.render_capture(box["result"])
    assert "--- device capture" in text and "test.in-window" in text


def test_chaos_profile_capture_drop_then_recovery(web_server):
    """Chaos site 'profile.capture' under the recovery harness: an
    injected drop fails the page fast with a 500 (never a hang, never
    a leaked armed profiler), and once the fault budget is spent the
    very next capture on the SAME server succeeds end to end."""
    plan = FaultPlan(
        [FaultSpec("profile.capture", "drop", probability=1.0, max_hits=1)],
        seed=41,
    )

    def workload(h):
        st, body = _http_get(
            web_server.port, "/hotspots/device?seconds=0.05")
        assert st == 500, body
        assert "device capture failed" in body and "dropped" in body
        assert not profiling.capture_active()
        # budget spent: the site heals with no residue
        st, body = _http_get(
            web_server.port, "/hotspots/device?seconds=0.05")
        assert st == 200, body
        assert "--- device capture" in body
        return st

    harness = RecoveryHarness(
        plan, wall_clock_s=20.0,
        baseline_probes=[
            ("capture_active", lambda: float(profiling.capture_active())),
        ],
    )
    report = harness.run_or_raise(workload)
    assert report.workload_result == 200
    assert report.hits.get("profile.capture", {}).get("drop", 0) == 1


def test_chaos_profile_capture_delay_stretches_start():
    plan = FaultPlan(
        [FaultSpec("profile.capture", "delay_us", arg=200_000,
                   probability=1.0, max_hits=1)],
        seed=43,
    )
    injector.arm(plan)
    try:
        t0 = time.monotonic()
        result = profiling.device_capture(0.05)
        wall = time.monotonic() - t0
    finally:
        injector.disarm()
    assert wall >= 0.2, f"injected delay not applied ({wall:.3f}s)"
    assert result["seconds"] < 0.2  # the window itself stayed short
    assert not profiling.capture_active()


# ---------------------------------------------------------------------------
# (3) runtime occupancy under a spawn storm
# ---------------------------------------------------------------------------


def test_occupancy_storm_nonzero_queue_wait_and_steals():
    """A burst of nested spawns floods one worker's local run queue:
    idle workers steal, every task waits measurably in-queue, and the
    sampler surfaces both — nonzero steals and queue-wait — on the
    snapshot, the rpc_worker_* gauges, and /hotspots/runtime."""
    from incubator_brpc_tpu_torch.runtime.scheduler import get_task_control, spawn

    ctl = get_task_control()  # the storm needs the pool actually up
    qw0 = profiling.occupancy_snapshot()["queue_wait"]["count"]
    steals0 = ctl.steals_total()

    def child():
        time.sleep(0.002)

    def burst():
        # children land on THIS worker's local queue: a steal feast
        kids = [spawn(child) for _ in range(60)]
        for k in kids:
            k.join(10)

    tasks = [spawn(burst) for _ in range(3)]
    for t in tasks:
        assert t.join(30), "storm did not drain"
    snap = profiling.occupancy_snapshot()
    assert snap["workers"] > 0
    assert snap["queue_wait"]["count"] > qw0, "no queue-wait samples"
    assert snap["queue_wait"]["ema_us"] >= 0
    assert ctl.steals_total() > steals0, "storm produced zero steals"
    assert snap["steals_total"] == ctl.steals_total()
    assert len(snap["per_worker"]) == snap["workers"]
    text = profiling.render_runtime(snap)
    assert "steals_total:" in text and "queue_wait:" in text
    assert profiling.rpc_worker_count.get_value() == snap["workers"]
    assert profiling.rpc_worker_queue_waits_total.get_value() == (
        snap["queue_wait"]["count"])


def test_occupancy_gate_stops_sampling():
    from incubator_brpc_tpu_torch.runtime.scheduler import spawn

    set_flag("profiler_occupancy_enabled", False)
    try:
        before = profiling.occupancy_snapshot()["queue_wait"]["count"]
        ts = [spawn(lambda: None) for _ in range(20)]
        for t in ts:
            t.join(10)
        # rpcz's own observer may still stamp; the OCCUPANCY gate must
        # keep this sampler's aggregate frozen
        assert profiling.occupancy_snapshot()["queue_wait"]["count"] == before
    finally:
        set_flag("profiler_occupancy_enabled", True)


# ---------------------------------------------------------------------------
# rpcz: the `device` phase on a batched PS Forward
# ---------------------------------------------------------------------------


def test_latency_breakdown_renders_device_phase_for_batched_forward(torch_device):
    """Acceptance: a batched PS Forward's server span carries the
    device phase (dispatch→manifested-pull window) and
    /latency_breakdown renders a `device` column for it."""
    from incubator_brpc_tpu_torch.observability.span import span_db

    set_flag("rpcz_max_spans_per_second", 1_000_000)
    svc = PsService(device=torch_device)
    svc.put_param("w", np.random.rand(64, 64).astype(np.float32))
    srv = Server(ServerOptions(enable_batching=True))
    srv.add_service(svc)
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=30000))
    ch.init(f"127.0.0.1:{srv.port}")
    stub = ps_stub(ch)
    x = np.random.rand(64).astype(np.float32)
    try:
        for _ in range(3):
            c = Controller()
            c.request_attachment.append_user_data(x.tobytes())
            stub.Forward(c, EchoRequest(message="w"))
            assert not c.failed(), c.error_text()
        tid = c._span.trace_id

        def device_spans():
            return [
                s for s in span_db().recent(300)
                if s.trace_id == tid and s.kind == "server"
                and dict(s.phase_deltas()).get("device")
            ]

        spans = _wait_for(device_spans)
        assert spans, "no server span with a device phase"
        deltas = dict(spans[-1].phase_deltas())
        assert deltas["device"] > 0
        # the device window sits inside the callback window
        assert deltas["device"] <= deltas["callback"] + 1
        st, body = _http_get(srv.port, "/latency_breakdown")
        assert st == 200
        assert "PsService.Forward" in body
        assert "device" in body, body
        # and the always-on attribution saw the same dispatches
        snap = profiling.kernel_snapshot()
        assert snap.get("ps.forward", {}).get("executions", 0) >= 1, snap
    finally:
        set_flag("rpcz_max_spans_per_second", 500)
        srv.stop()
        ch.close()
