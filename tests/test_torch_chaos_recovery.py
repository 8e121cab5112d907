"""Recovery paths under injected faults: retry backoff spacing, pooled
Controller hygiene, circuit-breaker half-open, ClusterRecoverPolicy
under >70% isolation, ParallelChannel leg degradation, and ICI window
accounting under injected mid-batch closes.

Carried by hand from ``tests/test_chaos_recovery.py``.  The ICI leg drop
case is held by ``tests/test_torch_chaos.py``; the rest run with the port's
package name and nothing else changed.
"""

import collections
import itertools
import time

import pytest

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.chaos import FaultPlan, FaultSpec, RecoveryHarness
from incubator_brpc_tpu_torch.chaos import injector
from incubator_brpc_tpu_torch.chaos.harness import wait_until
from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.circuit_breaker import (
    CircuitBreaker,
    ClusterRecoverPolicy,
)
from incubator_brpc_tpu_torch.client.controller import (
    Controller,
    acquire_controller,
    release_controller,
)
from incubator_brpc_tpu_torch.client.retry import RetryPolicyWithBackoff
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server

_group_seq = itertools.count(1)


def fresh_options(**kw):
    kw.setdefault("timeout_ms", 3000)
    return ChannelOptions(connection_group=f"rec{next(_group_seq)}", **kw)


@pytest.fixture(autouse=True)
def always_disarm():
    yield
    injector.disarm()


class TaggedEcho(EchoService):
    SERVICE_NAME = "EchoService"

    def __init__(self, tag):
        super().__init__()
        self.tag = tag

    def Echo(self, controller, request, response, done):
        response.message = self.tag
        done()


@pytest.fixture
def echo_server():
    srv = Server()
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    yield srv
    srv.stop()


@pytest.fixture
def cluster4():
    servers = []
    for i in range(4):
        srv = Server()
        srv.add_service(TaggedEcho(f"s{i}"))
        assert srv.start(0) == 0
        servers.append(srv)
    yield servers
    for s in servers:
        s.stop()


def _reset_plan(ports, max_hits=100000, seed=1):
    return FaultPlan(
        [
            FaultSpec("socket.write", "reset", probability=1.0,
                      max_hits=max_hits, match={"peer": f"127.0.0.1:{p}"})
            for p in ports
        ],
        seed=seed,
    )


# ---------------------------------------------------------------------------
# retry backoff (seeded exponential + jitter)
# ---------------------------------------------------------------------------

def test_backoff_schedule_is_seeded_and_deterministic():
    a = RetryPolicyWithBackoff(base_ms=10, max_ms=200, jitter=0.5, seed=77)
    b = RetryPolicyWithBackoff(base_ms=10, max_ms=200, jitter=0.5, seed=77)
    other = RetryPolicyWithBackoff(base_ms=10, max_ms=200, jitter=0.5, seed=78)
    assert a.expected_backoffs(6) == b.expected_backoffs(6)
    assert a.expected_backoffs(6) != other.expected_backoffs(6)
    sched = a.expected_backoffs(6)
    # exponential shape under the jitter envelope, capped at max_ms
    for k, ms in enumerate(sched, start=1):
        raw = min(10 * 2 ** (k - 1), 200)
        assert raw * 0.5 <= ms <= raw
    assert sched[-1] <= 200


def test_backoff_skipped_when_budget_nearly_gone():
    pol = RetryPolicyWithBackoff(
        base_ms=50, jitter=0.0, seed=1, no_backoff_remaining_ms=10_000
    )
    c = Controller()
    c.retry_count = 1
    c.timeout_ms = 100
    c._start_ns = time.monotonic_ns()
    assert pol.backoff_ms(c) == 0.0  # 100ms budget < 10s floor: no sleep
    c.timeout_ms = 60_000
    assert pol.backoff_ms(c) == 50.0


def test_retry_backoff_spacing_under_injected_resets(echo_server):
    """Two injected write resets force two retries; the attempt stamps
    must be spaced by the policy's deterministic schedule (within
    timer-thread granularity)."""
    policy = RetryPolicyWithBackoff(
        base_ms=80, multiplier=2.0, max_ms=1000, jitter=0.5, seed=7
    )
    expected = policy.expected_backoffs(2)
    plan = _reset_plan([echo_server.port], max_hits=2, seed=9)
    ch = Channel(fresh_options(retry_policy=policy, max_retry=3,
                               timeout_ms=8000))
    ch.init(f"127.0.0.1:{echo_server.port}")
    stub = echo_stub(ch)
    injector.arm(plan)
    try:
        c = Controller()
        r = stub.Echo(c, EchoRequest(message="backoff"))
        assert not c.failed(), c.error_text()
        assert r.message == "backoff"
        stamps = c.attempt_times_ns()
        assert len(stamps) == 3  # first try + 2 backed-off retries
        spacing_ms = [
            (b - a) / 1e6 for a, b in zip(stamps, stamps[1:])
        ]
        for got, want in zip(spacing_ms, expected):
            # never earlier than the schedule (minus clock fuzz); the
            # upper bound absorbs timer granularity + reconnect cost
            assert got >= want - 5, (spacing_ms, expected)
            assert got <= want + 500, (spacing_ms, expected)
    finally:
        injector.disarm()
        ch.close()


# ---------------------------------------------------------------------------
# pooled Controller wipe-on-release after FAILED calls
# ---------------------------------------------------------------------------

def test_pooled_controller_carries_nothing_across_failed_call(echo_server):
    plan = _reset_plan([echo_server.port], max_hits=100000, seed=3)
    ch = Channel(fresh_options(max_retry=0, timeout_ms=1500))
    ch.init(f"127.0.0.1:{echo_server.port}")
    stub = echo_stub(ch)
    injector.arm(plan)
    c = acquire_controller()
    c.log_id = 424242
    stub.Echo(c, EchoRequest(message="doomed"))
    assert c.failed()
    assert c.error_code == errors.EFAILEDSOCKET, (
        c.error_code, c.error_text())
    injector.disarm()
    release_controller(c)
    c2 = acquire_controller()
    # LIFO freelist: the wiped object comes straight back
    assert c2 is c
    assert not c2.__dict__, f"state leaked through the pool: {c2.__dict__}"
    assert c2.error_code == 0
    assert c2.error_text() == ""
    assert c2.response_bytes is None
    assert c2.log_id == 0
    assert c2.retry_count == 0
    # and it is immediately reusable for a SUCCESSFUL call
    r = stub.Echo(c2, EchoRequest(message="clean"))
    assert not c2.failed(), c2.error_text()
    assert r.message == "clean"
    release_controller(c2)
    ch.close()


def test_pooled_controller_wipe_after_reset_mid_call_native(echo_server):
    """Native path variant: the reset arrives from the C engine (mux
    conn reset) — the pooled Controller and the fastcall result tuple
    must carry no error/response bytes into the next acquire."""
    from incubator_brpc_tpu_torch import native
    from incubator_brpc_tpu_torch.server.server import ServerOptions

    if not native.available():
        pytest.skip("native engine not built")
    srv = Server(ServerOptions(native_engine=True))
    srv.add_service(EchoService(attach_echo=False))
    assert srv.start(0) == 0
    plan = FaultPlan(
        [FaultSpec("native.srv_read", "reset", probability=1.0, max_hits=1)],
        seed=6,
    )
    injector.arm(plan)
    ch = Channel(ChannelOptions(timeout_ms=2000, connection_type="native",
                                max_retry=0))
    ch.init(f"127.0.0.1:{srv.port}")
    stub = echo_stub(ch)
    try:
        c = acquire_controller()
        stub.Echo(c, EchoRequest(message="boom"))
        assert c.failed()
        release_controller(c)
        c2 = acquire_controller()
        assert c2 is c and not c2.__dict__
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            r = stub.Echo(c2, EchoRequest(message="after"))
            if not c2.error_code:
                break
            release_controller(c2)
            c2 = acquire_controller()
        assert not c2.error_code, (c2.error_code, c2.error_text())
        assert r.message == "after"
        release_controller(c2)
    finally:
        injector.disarm()
        ch.close()
        srv.stop()


# ---------------------------------------------------------------------------
# circuit breaker: trip → half-open → recovery
# ---------------------------------------------------------------------------

def test_circuit_breaker_half_open_cycle():
    br = CircuitBreaker(base_isolation_s=0.05, max_isolation_s=1.0)
    br.mark_failed_hard()
    assert br.is_isolated()
    assert wait_until(lambda: not br.is_isolated(), timeout_s=2.0)
    # half-open: a failure while the EMA is still hot re-isolates with
    # a DOUBLED duration (repeat-offender escalation)
    t0 = time.monotonic()
    br.on_call(failed=True)
    assert br.is_isolated()
    iso2 = br._isolated_until - t0
    assert iso2 >= 0.08  # 2nd offence: ~2x the 0.05s base
    # a health-check revival resets the breaker and decays the count
    br.reset()
    assert not br.is_isolated()
    br.on_call(failed=False)
    assert not br.is_isolated()


def test_cluster_recover_policy_ratio():
    pol = ClusterRecoverPolicy(threshold=0.7)
    # below threshold: never leak traffic to isolated nodes
    assert not any(pol.should_try_isolated(1, 4) for _ in range(200))
    # >70% isolated: let ~ratio of traffic through so the cluster can
    # recover (anti-avalanche); statistical but with wide bounds
    allowed = sum(pol.should_try_isolated(3, 4) for _ in range(2000))
    assert 0.55 * 2000 < allowed < 0.95 * 2000, allowed


def test_cluster_survives_75pct_injected_isolation(cluster4):
    """3 of 4 nodes get every write reset: the LB isolates them, the
    healthy node carries the traffic (retries route around the chaos),
    ClusterRecoverPolicy keeps probing the isolated majority, and once
    the plan disarms every node rejoins."""
    ports = [s.port for s in cluster4]
    faulty = ports[:3]
    url = "list://" + ",".join(f"127.0.0.1:{p}" for p in ports)
    ch = Channel(fresh_options(timeout_ms=4000, max_retry=4))
    assert ch.init(url, "rr") == 0
    stub = echo_stub(ch)
    # warm: all four answer before the chaos starts
    seen = set()
    deadline = time.monotonic() + 5
    while len(seen) < 4 and time.monotonic() < deadline:
        c = Controller()
        r = stub.Echo(c, EchoRequest())
        if not c.failed():
            seen.add(r.message)
    assert len(seen) == 4, seen

    injector.arm(_reset_plan(faulty, seed=13))
    tags = collections.Counter()
    failures = 0
    for _ in range(30):
        c = Controller()
        r = stub.Echo(c, EchoRequest())
        if c.failed():
            assert c.error_code in (
                errors.EFAILEDSOCKET, errors.ERPCTIMEDOUT,
            ), (c.error_code, c.error_text())
            failures += 1
        else:
            tags[r.message] += 1
    # graceful degradation, not collapse: the healthy node serves the
    # overwhelming majority (a handful of calls may burn their retry
    # budget while the breakers learn)
    assert tags.get("s3", 0) >= 24, (tags, failures)
    injector.disarm()
    # recovery: health checks + breaker reset bring every node back
    seen = set()
    deadline = time.monotonic() + 10
    while len(seen) < 4 and time.monotonic() < deadline:
        c = Controller()
        r = stub.Echo(c, EchoRequest())
        if not c.failed():
            seen.add(r.message)
    assert len(seen) == 4, f"nodes never rejoined after disarm: {seen}"
    ch.close()


def test_parallel_channel_legs_degrade_gracefully(cluster4):
    """>70% of a ParallelChannel's legs reset mid-call: with a
    tolerant fail_limit the fan-out still completes from the healthy
    leg; with fail_limit=0 it fails FAST with ETOOMANYFAILS (bounded,
    ERPC-family) — and recovers fully once the plan disarms."""
    from incubator_brpc_tpu_torch.client.combo import (
        ParallelChannel,
        ParallelChannelOptions,
    )
    from incubator_brpc_tpu_torch.models.echo import EchoService as _ES  # noqa: F401
    from incubator_brpc_tpu_torch.server.service import MethodSpec
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoResponse

    ports = [s.port for s in cluster4]
    subs = []
    for p in ports:
        sub = Channel(fresh_options(timeout_ms=2000, max_retry=1))
        assert sub.init(f"127.0.0.1:{p}") == 0
        subs.append(sub)
    spec = MethodSpec("EchoService", "Echo", EchoRequest, EchoResponse)

    def fan_call(fail_limit):
        pc = ParallelChannel(
            ParallelChannelOptions(fail_limit=fail_limit, timeout_ms=2500)
        )
        for sub in subs:
            pc.add_channel(sub)
        c = Controller()
        resp = EchoResponse()
        t0 = time.monotonic()
        pc.call_method(spec, c, EchoRequest(), resp, None)
        return c, resp, time.monotonic() - t0

    injector.arm(_reset_plan(ports[:3], seed=21))
    c, resp, wall = fan_call(fail_limit=3)
    assert not c.failed(), c.error_text()
    assert resp.message == "s3"  # merged from the one healthy leg
    c, _, wall = fan_call(fail_limit=0)
    assert c.error_code == errors.ETOOMANYFAILS, (
        c.error_code, c.error_text())
    assert wall < 10, f"fan-out failed slowly ({wall:.1f}s), not fast"
    injector.disarm()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        c, resp, _ = fan_call(fail_limit=0)
        if not c.failed():
            break
    assert not c.failed(), c.error_text()
    for sub in subs:
        sub.close()


# ---------------------------------------------------------------------------
# ICI: leg drop + injected mid-batch port close (window accounting)
# ---------------------------------------------------------------------------

def test_ici_close_mid_batch_releases_receive_window():
    """Injected close_mid_batch closes the destination port right
    after delivery: the completion-queue drain observes the close
    MID-BATCH and must release the window bytes of every undrained
    frame (the round-6 regression path, now driven by chaos)."""
    from incubator_brpc_tpu_torch.parallel.ici import get_fabric
    from incubator_brpc_tpu_torch.utils.iobuf import IOBuf

    fabric = get_fabric()
    port = fabric.register((7, 972), server=object())
    plan = FaultPlan(
        [FaultSpec("ici.send", "close_mid_batch", probability=1.0,
                   max_hits=1, match={"peer": "slice7/chip972"})],
        seed=23,
    )
    injector.arm(plan)
    try:
        rc = fabric.send(IOBuf(b"z" * 4096), (7, 972), (7, 973))
        assert rc == 0
        assert wait_until(lambda: port.closed, timeout_s=5.0)
        assert wait_until(
            lambda: port._queued_bytes == 0, timeout_s=5.0
        ), f"receive window leaked {port._queued_bytes} bytes"
        # a port re-registered at the same coords starts with a clean
        # window (the leak this invariant exists to catch)
        port2 = fabric.register((7, 972), server=object())
        assert port2._queued_bytes == 0
        fabric.unregister((7, 972))
    finally:
        injector.disarm()
        fabric.unregister((7, 972))


def test_harness_end_to_end_with_recovery_invariants(echo_server):
    """The full harness contract over a real workload: bounded wall
    clock, ERPC-only codes, pooled-Controller hygiene, and the
    channel's inflight bookkeeping back to baseline."""
    plan = FaultPlan(
        [
            FaultSpec("socket.write", "reset", probability=0.3,
                      max_hits=6, match={"peer": f":{echo_server.port}"}),
            FaultSpec("socket.read", "delay_us", arg=2000, probability=0.3),
        ],
        seed=31,
    )
    ch = Channel(fresh_options(timeout_ms=2500, max_retry=3))
    ch.init(f"127.0.0.1:{echo_server.port}")
    stub = echo_stub(ch)

    def workload(h):
        ok = 0
        for i in range(25):
            c = acquire_controller()
            stub.Echo(c, EchoRequest(message=f"w{i}"))
            h.record_error(c.error_code)
            ok += not c.error_code
            release_controller(c)
        return ok

    harness = RecoveryHarness(plan, wall_clock_s=25.0)
    report = harness.run_or_raise(workload)
    # resets are retriable: the vast majority of calls must succeed
    assert report.workload_result >= 20, (
        report.workload_result, report.error_codes)
    assert report.hits.get("socket.write", {}).get("reset", 0) >= 1
    ch.close()
