"""The port's submission ring and server response ring, against the
JAX package's tests of them (``tests/test_ring.py``).

Window round trips over the port's native mux (one boundary crossing a
window, burst harvests, step-log counters), per-call degradation with
the same ERPC semantics, sibling-ring routing, the ``ring.submit``
chaos site on both halves, exactly-once completion under the native
``srv_read``/``srv_write`` partial-failure plans and a
``socket.write_io`` plan, the server response ring (one writev burst a
harvested window), the windowed shard fan-out (crossings == shards), the
read burst reaching the micro-batcher as one accumulation (on a CPU
``PsService``, here also held to the JAX package's counts on the same
window), and the two-thread submit/harvest lane.  Nothing skips: the
port has no fallback for a missing engine.
"""

import itertools
import threading
import pytest
import torch
from incubator_brpc_tpu_torch import errors, native
from incubator_brpc_tpu_torch.batching.policy import BatchPolicy
from incubator_brpc_tpu_torch.chaos import (
    FaultPlan,
    FaultSpec,
    RecoveryHarness,
    controller_pool_clean,
)
from incubator_brpc_tpu_torch.chaos import injector
from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.client.ring import RingFailure, SubmissionRing
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.models.parameter_server import PsService, ps_stub
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest, EchoResponse
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
from incubator_brpc_tpu_torch.utils.iobuf import IOBuf

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# test_ring.py
# ---------------------------------------------------------------------------
_group_seq = itertools.count(1)


@pytest.fixture(autouse=True)
def always_disarm():
    yield
    injector.disarm()


@pytest.fixture
def native_echo():
    srv = Server(ServerOptions(native_engine=True))
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=5000, connection_type="native"))
    assert ch.init(f"127.0.0.1:{srv.port}") == 0
    stub = echo_stub(ch)
    yield srv, ch, stub
    srv.stop()
    ch.close()


@pytest.fixture
def pooled_echo():
    srv = Server()
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(
        timeout_ms=5000, connection_type="pooled",
        connection_group=f"ring{next(_group_seq)}",
    ))
    assert ch.init(f"127.0.0.1:{srv.port}") == 0
    stub = echo_stub(ch)
    yield srv, ch, stub
    srv.stop()
    ch.close()


def _packed(i, prefix="m"):
    return EchoRequest(message=f"{prefix}{i}").SerializeToString()


def _msg(b):
    e = EchoResponse()
    e.ParseFromString(b)
    return e.message


# ---------------------------------------------------------------------------
# vectorized window round trips
# ---------------------------------------------------------------------------


def test_window_round_trip_order_and_counters(native_echo):
    _, ch, stub = native_echo
    n = 64
    res = stub.call_many("Echo", [_packed(i) for i in range(n)])
    assert len(res) == n
    for i, r in enumerate(res):
        assert isinstance(r, bytes), (i, r)
        assert _msg(r) == f"m{i}"
    c = ch._ring_obj.counters()
    # the step-log proof: a silently-degraded ring shows windows ≈
    # submissions or fallback traffic, not just lower qps
    assert c["submissions"] == n
    assert c["windows"] == 1
    assert c["boundary_crossings"] < n / 4
    assert c["fallback_calls"] == 0
    assert c["double_resolves"] == 0
    s = ch._native_mux_obj.ring_stats()  # the C side agrees
    assert s["windows"] == 1 and s["calls"] == n
    assert s["completions"] == n


def test_pb_requests_and_app_error_semantics(native_echo):
    _, _, stub = native_echo
    # pb (unserialized) requests serialize per call, like call_method
    res = stub.call_many(
        "Echo", [EchoRequest(message=f"p{i}") for i in range(3)]
    )
    assert [_msg(r) for r in res] == ["p0", "p1", "p2"]
    # an app error maps to the SAME (code, text) the per-call path sets
    c = Controller()
    stub.Echo(c, EchoRequest(message="x", server_fail=1001))
    assert c.failed()
    res = stub.call_many(
        "Echo",
        [_packed(0), EchoRequest(message="x", server_fail=1001).SerializeToString()],
    )
    assert isinstance(res[0], bytes)
    f = res[1]
    assert isinstance(f, RingFailure)
    assert f.error_code == c.error_code == 1001
    assert f.error_text == c.error_text()


def test_timeout_maps_to_erpctimedout(native_echo):
    _, _, stub = native_echo
    res = stub.call_many(
        "Echo",
        [EchoRequest(message="s", sleep_us=600_000).SerializeToString()],
        timeout_ms=60,
    )
    assert isinstance(res[0], RingFailure)
    assert res[0].error_code == errors.ERPCTIMEDOUT
    assert res[0].error_text == "reached timeout"


def test_submit_harvest_pipelined_pair(native_echo):
    """The async half of the API: stage windows as work arrives,
    harvest completions in bursts, overlap with application work."""
    _, ch, stub = native_echo
    spec = stub.method_spec("Echo")
    ring = ch.submission_ring(depth=8)
    slots = [ring.submit(spec, _packed(i, "a")) for i in range(20)]
    got = dict(ring.drain())
    assert len(got) == 20
    for i, slot in enumerate(slots):
        assert _msg(got[slot]) == f"a{i}"
    c = ring.counters()
    assert c["windows"] >= 3  # depth-8 auto-flush: 20 calls, ≥3 windows
    assert c["double_resolves"] == 0


def test_sibling_rings_share_completion_lane(native_echo):
    """Two rings on one channel share the mux's single C-side
    completion lane: whichever harvests first must ROUTE the other's
    completions (mux stash), never drop them."""
    _, ch, stub = native_echo
    spec = stub.method_spec("Echo")
    ra, rb = ch.submission_ring(), ch.submission_ring()
    sa = [ra.submit(spec, _packed(i, "ra")) for i in range(8)]
    sb = [rb.submit(spec, _packed(i, "rb")) for i in range(8)]
    # ra drains fully first — it will harvest (and must stash) rb's
    # completions, which arrive on the same lane
    got_a = dict(ra.drain())
    got_b = dict(rb.drain())
    assert [_msg(got_a[s]) for s in sa] == [f"ra{i}" for i in range(8)]
    assert [_msg(got_b[s]) for s in sb] == [f"rb{i}" for i in range(8)]
    assert ra.counters()["double_resolves"] == 0
    assert rb.counters()["double_resolves"] == 0


# ---------------------------------------------------------------------------
# degradation: byte-for-byte the per-call path
# ---------------------------------------------------------------------------


def test_interleaved_native_and_fallback_one_window(native_echo):
    """One window mixing ring-eligible calls with tenant-tagged ones:
    tenant rows must take the Python path per call (the tenant quota rule
    rides RpcRequestMeta.tenant, which the C mux does not pack), with
    results still in order and the pooled controllers wiped."""
    _, ch, stub = native_echo
    n = 9
    ctrls = [None] * n
    for i in (2, 5):
        ctrls[i] = Controller()
        ctrls[i].tenant = "gold"
    res = stub.call_many(
        "Echo", [_packed(i, "x") for i in range(n)], controllers=ctrls
    )
    for i, r in enumerate(res):
        assert isinstance(r, bytes), (i, r)
        assert _msg(r) == f"x{i}"
    c = ch._ring_obj.counters()
    assert c["fallback_calls"] == 2
    assert c["double_resolves"] == 0
    # a failing fallback call carries the same ERPC semantics
    bad = Controller()
    bad.tenant = "gold"
    res = stub.call_many(
        "Echo",
        [_packed(0), EchoRequest(message="x", server_fail=1001).SerializeToString()],
        controllers=[None, bad],
    )
    assert isinstance(res[0], bytes)
    assert isinstance(res[1], RingFailure) and res[1].error_code == 1001
    assert controller_pool_clean()


def test_non_native_channel_degrades_per_call(pooled_echo):
    """call_many on a pooled channel: every call runs through
    call_method with a pooled wiped-on-recycle controller — the
    existing path, same results, same error mapping."""
    _, ch, stub = pooled_echo
    n = 6
    reqs = [EchoRequest(message=f"d{i}") for i in range(n)]
    reqs[3] = EchoRequest(message="bad", server_fail=1002)
    res = stub.call_many("Echo", reqs)
    for i, r in enumerate(res):
        if i == 3:
            assert isinstance(r, RingFailure) and r.error_code == 1002
        else:
            assert isinstance(r, bytes)
            assert _msg(r) == f"d{i}"
    c = ch._ring_obj.counters()
    assert c["fallback_calls"] == n
    assert c["windows"] == 0  # no vectorized crossing ever happened
    assert controller_pool_clean()


# ---------------------------------------------------------------------------
# chaos: ring.submit site + exactly-once under partial failure
# ---------------------------------------------------------------------------


def test_ring_submit_drop_fails_whole_window_exactly_once(native_echo):
    """`ring.submit` drop loses the window BEFORE the C mux sees it:
    every slot completes exactly once with EFAILEDSOCKET (no stranded
    waiter, no registered-but-never-completed cid), and the next window
    after the budget is spent goes through clean."""
    _, ch, stub = native_echo
    plan = FaultPlan(
        [FaultSpec("ring.submit", "drop", probability=1.0, max_hits=1,
                   match={"direction": "submit"})],
        seed=5,
    )
    injector.arm(plan)
    res = stub.call_many("Echo", [_packed(i) for i in range(8)])
    assert len(res) == 8
    for r in res:
        assert isinstance(r, RingFailure)
        assert r.error_code == errors.EFAILEDSOCKET
        assert "chaos" in r.error_text
    # budget spent: the ring recovers with no residue from the drop
    res = stub.call_many("Echo", [_packed(i) for i in range(8)])
    assert all(isinstance(r, bytes) for r in res)
    assert injector.site_hits().get("ring.submit", {}).get("drop", 0) == 1
    assert ch._ring_obj.counters()["double_resolves"] == 0


def test_ring_submit_replay_is_deterministic(native_echo):
    """Same seeded plan, same call sequence → identical hit logs (the
    chaos subsystem's replay contract, extended to the new site)."""
    _, _, stub = native_echo
    # pinned to the client half: the server response-ring flush also
    # traverses this site, from server dispatch threads whose
    # interleaving with the client is not deterministic — an unpinned
    # every_nth spec would make the hit log racy by construction
    plan = FaultPlan(
        [FaultSpec("ring.submit", "delay_us", arg=200, every_nth=2,
                   match={"direction": "submit"})],
        seed=17,
    )

    def run_once():
        injector.arm(plan)
        for _ in range(6):
            res = stub.call_many("Echo", [_packed(i) for i in range(4)])
            assert all(isinstance(r, bytes) for r in res)
        log = injector.hit_log()
        injector.disarm()
        return log

    log1 = run_once()
    log2 = run_once()
    assert log1 == log2
    assert len(log1) == 3  # every 2nd of 6 window submissions


def test_exactly_once_under_native_partial_faults(native_echo):
    """Windows under seeded srv_read/srv_write faults (short + reset):
    some slots fail, some survive retries — every slot resolves exactly
    once, ERPC-coded, and the harness sees a clean recovery."""
    _, ch, stub = native_echo
    plan = FaultPlan(
        [
            FaultSpec("native.srv_read", "short_read", arg=256,
                      probability=1.0, max_hits=100000),
            FaultSpec("native.srv_write", "reset", probability=0.05,
                      max_hits=3),
        ],
        seed=23,
    )

    def workload(h):
        seen = 0
        for round_i in range(6):
            reqs = [_packed(i, f"w{round_i}-") for i in range(16)]
            res = stub.call_many("Echo", reqs, timeout_ms=4000)
            assert len(res) == 16  # exactly one result per slot
            for i, r in enumerate(res):
                if isinstance(r, RingFailure):
                    h.record_error(r.error_code)
                    assert r.error_code in (
                        errors.ERPCTIMEDOUT, errors.EFAILEDSOCKET,
                    ), r
                else:
                    h.record_error(0)
                    assert _msg(r) == f"w{round_i}-{i}"
                    seen += 1
        return seen

    report = RecoveryHarness(plan, wall_clock_s=60.0).run_or_raise(workload)
    assert report.workload_result > 0  # the plan didn't kill everything
    c = ch._ring_obj.counters()
    assert c["double_resolves"] == 0
    # every ring submission produced at least one harvested completion
    # (a retried slot harvests one per attempt, so >= not ==)
    assert c["completions"] >= c["submissions"] - c["fallback_calls"]
    # after disarm: a clean window proves no stranded ring state
    res = stub.call_many("Echo", [_packed(i) for i in range(8)])
    assert all(isinstance(r, bytes) for r in res)
    assert controller_pool_clean()


def test_ring_fallback_under_socket_write_io_plan(pooled_echo):
    """The degraded lane under a `socket.write_io` short-write plan:
    per-call fallbacks ride the Python transport's KeepWrite remainder
    machinery and still complete every slot exactly once."""
    srv, ch, stub = pooled_echo
    plan = FaultPlan(
        [
            FaultSpec("socket.write_io", "short_write", arg=9,
                      probability=1.0, max_hits=256,
                      match={"peer": f"127.0.0.1:{srv.port}"}),
        ],
        seed=31,
    )
    injector.arm(plan)
    res = stub.call_many(
        "Echo", [EchoRequest(message="w" * 300 + str(i)) for i in range(8)]
    )
    assert len(res) == 8
    for r in res:
        assert isinstance(r, bytes)
        assert _msg(r).startswith("w")
    assert injector.site_hits().get("socket.write_io", {}).get(
        "short_write", 0
    ) >= 1
    assert ch._ring_obj.counters()["double_resolves"] == 0


# ---------------------------------------------------------------------------
# server side: the response ring (one writev burst per harvested window)
# ---------------------------------------------------------------------------


def _srv_ring_stats(srv):
    s = srv._engine_op(lambda eng: eng.ring_stats())
    return s or {"windows": 0, "responses": 0, "flush_bursts": 0}


class _PyEchoService(EchoService):
    """Echo with the native fast path disabled: every frame dispatches
    to Python, so replies ride the server response ring
    (resp_ring_flush → ns_send_burst) instead of the C-lane burst."""

    SERVICE_NAME = "EchoService"

    def native_fastpaths(self):
        return {}

    def native_http_fastpaths(self):
        return []


@pytest.fixture
def py_echo():
    srv = Server(ServerOptions(native_engine=True))
    srv.add_service(_PyEchoService())
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=5000, connection_type="native"))
    assert ch.init(f"127.0.0.1:{srv.port}") == 0
    stub = echo_stub(ch)
    yield srv, ch, stub
    srv.stop()
    ch.close()


def test_server_ring_one_burst_per_harvested_window(native_echo):
    """A call_many window's replies leave the server as ring windows
    (ns_send_burst), not per-call sends: the engine step log shows the
    frames carried by a handful of bursts — windows ≪ responses — which
    is the flush contract bench timing alone could never prove."""
    srv, ch, stub = native_echo
    n = 32
    before = _srv_ring_stats(srv)
    res = stub.call_many("Echo", [_packed(i, "sr") for i in range(n)])
    assert [_msg(r) for r in res] == [f"sr{i}" for i in range(n)]
    after = _srv_ring_stats(srv)
    resp_d = after["responses"] - before["responses"]
    win_d = after["windows"] - before["windows"]
    # the kernel may split the client's writev across read bursts, so
    # allow a few windows — but a degraded (per-call) reply path would
    # show resp_d ≈ 0 here, never a fused burst
    assert resp_d >= n * 3 // 4, (before, after)
    assert 1 <= win_d <= max(2, resp_d // 8), (before, after)
    assert after["flush_bursts"] >= before["flush_bursts"] + win_d


def test_server_ring_pipelined_windows_keep_reply_order(native_echo):
    """Three windows staged before any harvest: the server rings each
    harvested window back as its own burst and every reply still lands
    on its own slot (correlation ids, not arrival position)."""
    srv, ch, stub = native_echo
    spec = stub.method_spec("Echo")
    ring = ch.submission_ring(depth=16)
    before = _srv_ring_stats(srv)
    slots = []
    for w in range(3):
        slots.extend(
            ring.submit(spec, _packed(i, f"pw{w}-")) for i in range(16)
        )
        ring.flush()
    got = dict(ring.drain())
    assert len(got) == 48
    k = 0
    for w in range(3):
        for i in range(16):
            assert _msg(got[slots[k]]) == f"pw{w}-{i}"
            k += 1
    after = _srv_ring_stats(srv)
    resp_d = after["responses"] - before["responses"]
    win_d = after["windows"] - before["windows"]
    assert resp_d >= 36
    # one burst per HARVESTED window: a slow server may coalesce the
    # three staged windows into fewer read cycles (that's the contract
    # working harder, not failing), but never per-call replies
    assert 1 <= win_d <= max(4, resp_d // 8), (before, after)
    assert ring.counters()["double_resolves"] == 0


def test_server_ring_python_lane_rides_send_burst(py_echo):
    """With the native fast path disabled, a window's frames dispatch
    to Python in one burst and the staged replies leave through
    resp_ring_flush → ns_send_burst: the engine step log grows on the
    SAME counters as the C lane — one flush contract end to end."""
    srv, ch, stub = py_echo
    n = 32
    before = _srv_ring_stats(srv)
    res = stub.call_many("Echo", [_packed(i, "py") for i in range(n)])
    assert [_msg(r) for r in res] == [f"py{i}" for i in range(n)]
    after = _srv_ring_stats(srv)
    resp_d = after["responses"] - before["responses"]
    win_d = after["windows"] - before["windows"]
    assert resp_d >= n * 3 // 4, (before, after)
    assert 1 <= win_d <= max(2, resp_d // 8), (before, after)
    assert ch._ring_obj.counters()["fallback_calls"] == 0


def test_ring_metrics_and_status_surfaces(py_echo):
    """The ring step log is operator-visible: /metrics exports the
    rpc_ring_{crossings,windows,flush_bursts} adders (the module rides
    METRIC_MODULES so the render lint owns the names) and /status grows
    a ``ring:`` section carrying the server engine's ns_ring_stats once
    ring traffic exists."""
    from incubator_brpc_tpu_torch.tools.rpc_view import fetch_page

    srv, ch, stub = py_echo
    spec = stub.method_spec("Echo")
    ring = ch.submission_ring(depth=8)
    ring.submit_all(spec, [_packed(i, "mv") for i in range(8)])
    assert sum(1 for _s, r in ring.drain() if isinstance(r, bytes)) == 8
    body = fetch_page(f"127.0.0.1:{srv.port}", "metrics")
    for name in (
        "rpc_ring_crossings", "rpc_ring_windows", "rpc_ring_flush_bursts"
    ):
        assert name in body, body[:400]
    status = fetch_page(f"127.0.0.1:{srv.port}", "status")
    assert "ring:" in status, status[:400]
    assert "flush_bursts=" in status and "crossings=" in status


def test_server_ring_flush_drop_times_out_exactly_once(py_echo):
    """direction=flush drop loses a window's replies AFTER dispatch:
    the staged frames never reach the engine, so the client resolves
    every slot exactly once by its timeout budget — and the next
    window's replies flush through clean (no stuck ring slots, no
    late double resolution for the lost cids)."""
    _, ch, stub = py_echo
    plan = FaultPlan(
        [FaultSpec("ring.submit", "drop", probability=1.0, max_hits=1,
                   match={"direction": "flush"})],
        seed=7,
    )
    injector.arm(plan)
    res = stub.call_many(
        "Echo", [_packed(i) for i in range(16)], timeout_ms=700
    )
    assert len(res) == 16  # exactly one result per slot
    lost = 0
    for r in res:
        if isinstance(r, RingFailure):
            assert r.error_code == errors.ERPCTIMEDOUT, r
            lost += 1
    assert lost >= 1  # the dropped flush lost at least one window
    assert injector.site_hits().get("ring.submit", {}).get("drop", 0) == 1
    # budget spent: the server ring recovers with no residue
    res = stub.call_many("Echo", [_packed(i) for i in range(16)])
    assert all(isinstance(r, bytes) for r in res)
    assert ch._ring_obj.counters()["double_resolves"] == 0
    assert ch._ring_obj.outstanding() == 0


def test_server_ring_recovery_under_flush_faults(py_echo):
    """RecoveryHarness over a plan mixing server-flush drops with
    native short-writev mid-burst (conn_write_parts' srv_write fault,
    inherited by ns_send_burst): pipelined windows keep exactly-once
    completions and per-window reply order, and leave no stuck ring
    slots behind."""
    _, ch, stub = py_echo
    plan = FaultPlan(
        [
            FaultSpec("ring.submit", "drop", probability=0.2, max_hits=2,
                      match={"direction": "flush"}),
            FaultSpec("native.srv_write", "short_write", arg=64,
                      probability=0.5, max_hits=100000),
        ],
        seed=41,
    )

    def workload(h):
        spec = stub.method_spec("Echo")
        ring = ch.submission_ring(depth=16)
        ok = 0
        for round_i in range(6):
            slots = [
                ring.submit(spec, _packed(i, f"f{round_i}-"), 1500)
                for i in range(16)
            ]
            got = dict(ring.drain())
            assert len(got) == len(slots)  # exactly once per slot
            for i, slot in enumerate(slots):
                r = got[slot]
                if isinstance(r, RingFailure):
                    h.record_error(r.error_code)
                    assert r.error_code in (
                        errors.ERPCTIMEDOUT, errors.EFAILEDSOCKET,
                    ), r
                else:
                    h.record_error(0)
                    assert _msg(r) == f"f{round_i}-{i}"
                    ok += 1
        assert ring.outstanding() == 0  # no stuck ring slots
        assert ring.counters()["double_resolves"] == 0
        return ok

    report = RecoveryHarness(plan, wall_clock_s=90.0).run_or_raise(workload)
    assert report.workload_result > 0  # short writes alone never kill
    # after disarm: a clean window proves no server-side residue
    res = stub.call_many("Echo", [_packed(i) for i in range(8)])
    assert all(isinstance(r, bytes) for r in res)
    assert controller_pool_clean()


# ---------------------------------------------------------------------------
# windowed shard fan-out: crossings == shards, never keys
# ---------------------------------------------------------------------------


def _native_cluster(n):
    servers, eps = [], []
    for _ in range(n):
        srv = Server(ServerOptions(native_engine=True))
        srv.add_service(EchoService())
        assert srv.start(0) == 0
        servers.append(srv)
        eps.append(f"127.0.0.1:{srv.port}")
    return servers, eps


def test_shard_call_many_crosses_once_per_shard():
    from incubator_brpc_tpu_torch.client.combo import ShardRoutedChannel
    from incubator_brpc_tpu_torch.client.ring import fanout_log

    servers, eps = _native_cluster(3)
    ch = ShardRoutedChannel.from_endpoints(
        eps,
        channel_options=ChannelOptions(
            timeout_ms=5000, connection_type="native"
        ),
    )
    stub = echo_stub(ch)
    try:
        n = 64
        reqs = [EchoRequest(message=f"k{i}") for i in range(n)]
        shards = {ch.shard_of(f"k{i}", 3) for i in range(n)}
        assert len(shards) == 3  # 64 keys spread over every shard
        before = fanout_log.counters()
        res = stub.call_many("Echo", reqs)
        assert [_msg(r) for r in res] == [f"k{i}" for i in range(n)]
        after = fanout_log.counters()
        # the proof: the C boundary was crossed once per
        # SHARD for the whole 64-key window, with zero per-call
        # fallbacks — counts, not timing
        assert after["crossings"] - before["crossings"] == len(shards)
        assert after["keys"] - before["keys"] == n
        assert after["fallback_calls"] == before["fallback_calls"]
        assert after["windows"] - before["windows"] == 1
        for sub in ch.partitions():
            c = sub._ring_obj.counters()
            assert c["windows"] >= 1
            assert c["fallback_calls"] == 0
            assert c["double_resolves"] == 0
    finally:
        for srv in servers:
            srv.stop()


def test_shard_call_many_controller_degrades_that_call_only():
    """A caller-provided controller degrades ITS call to the routed
    per-call path (keeping every controller override) while the rest
    of the window still rides the shard sub-windows — byte-identical
    ERPC semantics either way."""
    from incubator_brpc_tpu_torch.client.combo import ShardRoutedChannel

    servers, eps = _native_cluster(2)
    ch = ShardRoutedChannel.from_endpoints(
        eps,
        channel_options=ChannelOptions(
            timeout_ms=5000, connection_type="native"
        ),
    )
    stub = echo_stub(ch)
    try:
        n = 8
        reqs = [EchoRequest(message=f"c{i}") for i in range(n)]
        ctrls = [None] * n
        ctrls[3] = Controller()
        reqs[5] = EchoRequest(message="c5", server_fail=1001)
        res = stub.call_many("Echo", reqs, controllers=ctrls)
        for i, r in enumerate(res):
            if i == 5:
                assert isinstance(r, RingFailure) and r.error_code == 1001
            else:
                assert isinstance(r, bytes), (i, r)
                assert _msg(r) == f"c{i}"
        assert ctrls[3].shard_index == ch.shard_of("c3", 2)
    finally:
        for srv in servers:
            srv.stop()


def test_parallel_call_many_one_subwindow_per_leg():
    """ParallelChannel.call_many: N requests fan to every sub channel
    as ONE ring sub-window per leg; per-request merge results come
    back in order with call_method's fail_limit semantics."""
    from incubator_brpc_tpu_torch.client.combo import ParallelChannel
    from incubator_brpc_tpu_torch.client.ring import fanout_log

    servers, eps = _native_cluster(2)
    pch = ParallelChannel()
    subs = []
    for ep in eps:
        sub = Channel(ChannelOptions(
            timeout_ms=5000, connection_type="native"
        ))
        assert sub.init(ep) == 0
        subs.append(sub)
        pch.add_channel(sub)
    stub = echo_stub(pch)
    try:
        n = 8
        before = fanout_log.counters()
        res = stub.call_many(
            "Echo", [EchoRequest(message=f"p{i}") for i in range(n)]
        )
        assert [_msg(r) for r in res] == [f"p{i}" for i in range(n)]
        after = fanout_log.counters()
        assert after["crossings"] - before["crossings"] == 2  # one per leg
        # every leg carries the whole window: keys counts carried rows
        assert after["keys"] - before["keys"] == n * 2
        assert after["fallback_calls"] == before["fallback_calls"]
        # an app error on one leg counts against fail_limit (0): the
        # request maps to ETOOMANYFAILS exactly like call_method
        res = stub.call_many(
            "Echo",
            [EchoRequest(message="x", server_fail=1001),
             EchoRequest(message="ok")],
        )
        assert isinstance(res[0], RingFailure)
        assert res[0].error_code == errors.ETOOMANYFAILS
        assert isinstance(res[1], bytes) and _msg(res[1]) == "ok"
    finally:
        for srv in servers:
            srv.stop()


# ---------------------------------------------------------------------------
# server side: a window lands in the micro-batcher whole
# ---------------------------------------------------------------------------


def test_window_reaches_micro_batcher_as_one_accumulation():
    """A call_many window of batched-method RPCs arrives in one read
    burst, dispatches as one scheduler task, and lands in the
    micro-batcher as ONE accumulation: observed batch size ≥ window/2
    (the floor; in practice the whole window fuses)."""
    srv = Server(ServerOptions(
        native_engine=True,
        enable_batching=True,
        batch_policies={
            "PsService.Get": BatchPolicy(
                max_batch_size=32, max_wait_us=100_000
            ),
        },
    ))
    svc = PsService(device=CPU)
    srv.add_service(svc)
    assert srv.start(0) == 0
    svc._store["k"] = b"v" * 64
    ch = Channel(ChannelOptions(timeout_ms=5000, connection_type="native"))
    assert ch.init(f"127.0.0.1:{srv.port}") == 0
    stub = ps_stub(ch)
    try:
        w = 16
        res = stub.call_many(
            "Get", [EchoRequest(message="k").SerializeToString()] * w
        )
        assert all(isinstance(r, bytes) for r in res), res
        b = srv.batcher("PsService.Get")
        assert b.rows == w
        assert b.max_batch_seen >= w // 2, b.describe()
        assert b.batches <= 2, b.describe()  # ~one fused execution
    finally:
        srv.stop()
        ch.close()


# ---------------------------------------------------------------------------
# concurrency: the sanitizer lane (tools/sanitize.sh)
# ---------------------------------------------------------------------------


def test_two_thread_concurrent_submit_harvest(native_echo):
    """Two threads drive mux_submit_many/mux_harvest concurrently on
    one mux handle (each with its own ring).  Under the ASan/TSan
    builds this is the lane that proves the ring path keeps the
    MuxWaiter use-after-free class dead and the ring queue race-free;
    unsanitized it is still a correctness check on sibling routing
    under true concurrency."""
    _, ch, stub = native_echo
    spec = stub.method_spec("Echo")
    failures = []

    def worker(tid):
        try:
            ring = ch.submission_ring(depth=16)
            for round_i in range(10):
                slots = [
                    ring.submit(spec, _packed(i, f"t{tid}r{round_i}-"))
                    for i in range(16)
                ]
                got = dict(ring.drain())
                assert len(got) == 16
                for i, slot in enumerate(slots):
                    v = got[slot]
                    assert isinstance(v, bytes), v
                    assert _msg(v) == f"t{tid}r{round_i}-{i}"
            assert ring.counters()["double_resolves"] == 0
        except Exception as e:  # noqa: BLE001
            failures.append(repr(e))

    ts = [threading.Thread(target=worker, args=(t,)) for t in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    assert not failures, failures


def _window_counts(pkg, w=16):
    """The same call_many window of `w` PsService.Get rows on one
    package's native server: the Batcher's (rows, batches,
    max_batch_seen) and the replies."""
    if pkg == "port":
        S, SO, C, CO, svc, stub_fn, req = (
            Server, ServerOptions, Channel, ChannelOptions, PsService(device=CPU), ps_stub,
            EchoRequest)
        policy = BatchPolicy(max_batch_size=32, max_wait_us=100_000)
    else:
        from incubator_brpc_tpu.batching.policy import BatchPolicy as JBatchPolicy
        from incubator_brpc_tpu.client.channel import Channel as S_C
        from incubator_brpc_tpu.client.channel import ChannelOptions as S_CO
        from incubator_brpc_tpu.models.parameter_server import PsService as JPs
        from incubator_brpc_tpu.models.parameter_server import ps_stub as j_ps_stub
        from incubator_brpc_tpu.protos.echo_pb2 import EchoRequest as JReq
        from incubator_brpc_tpu.server.server import Server as JS
        from incubator_brpc_tpu.server.server import ServerOptions as JSO

        S, SO, C, CO, svc, stub_fn, req = JS, JSO, S_C, S_CO, JPs(), j_ps_stub, JReq
        policy = JBatchPolicy(max_batch_size=32, max_wait_us=100_000)
    srv = S(SO(native_engine=True, enable_batching=True,
               batch_policies={"PsService.Get": policy}))
    srv.add_service(svc)
    assert srv.start(0) == 0
    svc._store["k"] = b"v" * 64
    ch = C(CO(timeout_ms=5000, connection_type="native"))
    try:
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        res = stub_fn(ch).call_many("Get", [req(message="k").SerializeToString()] * w)
        b = srv.batcher("PsService.Get")
        return (b.rows, b.batches, b.max_batch_seen), res
    finally:
        srv.stop()
        ch.close()


def test_window_accumulation_counts_equal_the_jax_packages():
    """tests/test_ring.py:750's window on both packages: the port's
    Batcher takes the read burst as the JAX package's does, rows for
    rows, one accumulation (max_batch_seen >= window/2, at most 2
    batches), and the replies are byte-equal."""
    import incubator_brpc_tpu.native as jax_native

    if not jax_native.available():
        # a fresh checkout's racing workers can leave this one without
        # the JAX package's engine (its shared build temporary); the
        # winner's library is in place now (tests/test_torch_native.py's
        # jax_engine fixture)
        jax_native._lib_err = None
        jax_native._load()
    assert jax_native.available(), jax_native.unavailable_reason()
    w = 16
    port, port_res = _window_counts("port", w)
    ref, ref_res = _window_counts("jax", w)
    assert port[0] == ref[0] == w
    for rows, batches, seen in (port, ref):
        assert seen >= w // 2 and batches <= 2, (port, ref)
    assert port_res == ref_res and all(isinstance(r, bytes) for r in port_res)


# ---------------------------------------------------------------------------
# the JAX package's tests/test_bench_smoke.py ring structure guards
# (step logs, never qps), on the port's engine
# ---------------------------------------------------------------------------


def test_ring_bench_structure_guard(native_echo):
    """Structure guard for the pyapi_ring_curve bench lane (NOT
    absolute qps — the ≥2x-sync / within-~2x-native bounds come
    from the full bench on a quiet host): a short batched drive on the
    native lane must prove the ring is actually vectorized by step
    log — boundary_crossings ≪ calls (a silently-degraded ring crosses
    per call and reads ≈ 2*calls), harvest_batches ≥ 2, ZERO fallback
    calls, zero double resolves — and the C-side mux counters must
    agree that whole windows crossed."""
    echo_server, _, _ = native_echo
    ch = Channel(ChannelOptions(timeout_ms=5000, connection_type="native"))
    ch.init(f"127.0.0.1:{echo_server.port}")
    stub = echo_stub(ch)
    packed = EchoRequest(message="x" * 4096).SerializeToString()
    window, nwin = 32, 40
    calls = window * nwin
    try:
        spec = stub.method_spec("Echo")
        ring = ch.submission_ring(depth=window)
        reqs = [packed] * window
        ok = 0
        for _ in range(nwin):
            ring.submit_all(spec, reqs)
            for _slot, res in ring.drain():
                if isinstance(res, bytes):
                    ok += 1
        assert ok == calls
        c = ring.counters()
        assert c["submissions"] == calls
        assert c["fallback_calls"] == 0, c
        assert c["double_resolves"] == 0, c
        assert c["harvest_batches"] >= 2, c
        # vectorization floor: ≤ 1 submit + ~1 harvest crossing per
        # window plus slack, nowhere near the 2-per-call degraded shape
        assert c["boundary_crossings"] <= calls / 4, c
        stats = ch._native_mux().ring_stats()
        assert stats["calls"] >= calls
        assert stats["windows"] <= stats["calls"] / 4, stats
    finally:
        ch.close()


def test_server_ring_bench_structure_guard(native_echo):
    """Structure guard for the server-ring flavor of pyapi_ring_curve:
    a batched window driven at the native server must advance the
    engine's reply step log with windows ≪ responses (one writev burst
    per harvested window — a per-call reply path reports windows ≈
    responses) and flush_bursts tracking windows."""
    echo_server, _, _ = native_echo

    def srv_stats():
        return echo_server._engine_op(lambda eng: dict(eng.ring_stats()))

    ch = Channel(ChannelOptions(timeout_ms=5000, connection_type="native"))
    assert ch.init(f"127.0.0.1:{echo_server.port}") == 0
    stub = echo_stub(ch)
    packed = EchoRequest(message="x" * 1024).SerializeToString()
    window, nwin = 32, 4
    try:
        spec = stub.method_spec("Echo")
        ring = ch.submission_ring(depth=window)
        before = srv_stats()
        ok = 0
        for _ in range(nwin):
            ring.submit_all(spec, [packed] * window)
            for _slot, res in ring.drain():
                if isinstance(res, bytes):
                    ok += 1
        after = srv_stats()
        assert ok == window * nwin
        resp_d = after["responses"] - before["responses"]
        win_d = after["windows"] - before["windows"]
        burst_d = after["flush_bursts"] - before["flush_bursts"]
        assert resp_d >= window * nwin * 3 // 4, (before, after)
        assert 1 <= win_d <= max(2 * nwin, resp_d // 4), (before, after)
        assert burst_d >= win_d, (before, after)
    finally:
        ch.close()


# ---------------------------------------------------------------------------
# replies with an attachment (the port keeps it; the JAX package drops it)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("connection_type", ["native", "pooled"])
def test_get_window_returns_each_stored_value(connection_type):
    """A call_many window of PsService.Gets resolves each slot to a
    RingReply: the message a per-call Get returns, with the stored value
    as its attachment (the ring takes it off the pooled controller before
    the pool wipes it).  Missing keys still fail their slot alone."""
    import numpy as np

    srv = Server(ServerOptions(native_engine=connection_type == "native",
                               enable_batching=True))
    srv.add_service(PsService(device=CPU))
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=10000, connection_type=connection_type,
                                connection_group=f"ring{next(_group_seq)}"))
    try:
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        stub = ps_stub(ch)
        rng = np.random.RandomState(11)
        keys = [f"v{i}" for i in range(12)]
        vals = {k: rng.randn(3, 8 + i).astype(np.float32).tobytes()
                for i, k in enumerate(keys)}
        for k in keys:
            c = Controller()
            c.request_attachment.append(vals[k])
            stub.Put(c, EchoRequest(message=k))
            assert not c.failed(), c.error_text()
        per_call = {}
        for k in keys:
            c = Controller()
            r = stub.Get(c, EchoRequest(message=k))
            assert not c.failed(), c.error_text()
            per_call[k] = (r.SerializeToString(), c.response_attachment.to_bytes())
        res = stub.call_many("Get", [EchoRequest(message=k) for k in keys + ["absent"]])
        got = [(bytes(r), getattr(r, "attachment", IOBuf()).to_bytes()) for r in res[:-1]]
        assert got == [per_call[k] for k in keys]
        assert [att for _, att in got] == [vals[k] for k in keys]
        for k, r in zip(keys, res):
            assert type(r).__name__ == "RingReply" and r.message == r
            assert _msg(r) == k
        assert isinstance(res[-1], RingFailure) and res[-1].error_code == errors.EREQUEST
        assert controller_pool_clean()
    finally:
        ch.close()
        srv.stop()


@pytest.mark.parametrize("fixture", ["native_echo", "pooled_echo"])
def test_attachment_free_window_stays_plain_bytes(fixture, request):
    """Replies without an attachment keep the fast path's shape: plain
    ``bytes``, not a RingReply."""
    _, _, stub = request.getfixturevalue(fixture)
    res = stub.call_many("Echo", [_packed(i, "pb") for i in range(16)])
    assert [type(r) for r in res] == [bytes] * 16
    assert [_msg(r) for r in res] == [f"pb{i}" for i in range(16)]
