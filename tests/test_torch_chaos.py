"""The port's chaos sites under the port's own injector: each site the
invariant lint counts (``chaos-site-test``) is armed here against a
real port server and shown to fire, and the calls recover as they do
in the JAX package's tests (tests/test_chaos.py, test_chaos_recovery.py,
test_admission.py, test_serving.py, test_streaming_subsystem.py).
"""

import itertools
import socket as _socket
import time

import pytest
import torch

from incubator_brpc_tpu_torch import errors, native
from incubator_brpc_tpu_torch.chaos import FaultPlan, FaultSpec, controller_pool_clean, injector
from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest, EchoResponse
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

CPU = torch.device("cpu")
_group_seq = itertools.count(1)


def fresh_options(**kw):
    kw.setdefault("timeout_ms", 3000)
    return ChannelOptions(connection_group=f"tchaos{next(_group_seq)}", **kw)


@pytest.fixture(autouse=True)
def always_disarm():
    yield
    injector.disarm()


@pytest.fixture
def echo_server():
    srv = Server()
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    yield srv
    srv.stop()


def _echo_n(port, n, msg="m", **kw):
    ch = Channel(fresh_options(**kw))
    assert ch.init(f"127.0.0.1:{port}") == 0
    stub = echo_stub(ch)
    try:
        for i in range(n):
            c = Controller()
            r = stub.Echo(c, EchoRequest(message=f"{msg}{i}"))
            assert not c.failed(), (c.error_code, c.error_text())
            assert r.message == f"{msg}{i}"
    finally:
        ch.close()


def test_socket_write_corrupt_recovers_via_retry(echo_server):
    """'socket.write' corrupt flips the frame's magic: the server drops
    the connection and the client's retry reissues an intact frame."""
    plan = FaultPlan(
        [FaultSpec("socket.write", "corrupt", arg=0, max_hits=1,
                   match={"peer": f"127.0.0.1:{echo_server.port}"})],
        seed=61,
    )
    ch = Channel(fresh_options(timeout_ms=4000, max_retry=3))
    ch.init(f"127.0.0.1:{echo_server.port}")
    injector.arm(plan)
    try:
        c = Controller()
        r = echo_stub(ch).Echo(c, EchoRequest(message="immaculate"))
        assert not c.failed(), (c.error_code, c.error_text())
        assert r.message == "immaculate"
        assert len(c.attempt_times_ns()) >= 2
        assert injector.site_hits()["socket.write"]["corrupt"] == 1
    finally:
        injector.disarm()
        ch.close()


@pytest.mark.parametrize("site, spec", [
    ("socket.write_io", {"action": "short_write", "arg": 7, "max_hits": 64}),
    ("socket.read", {"action": "delay_us", "arg": 2000, "max_hits": 8}),
])
def test_socket_io_site_fires_and_calls_complete(echo_server, site, spec):
    """Short writes force the remainder path per chunk, read delays
    stall the reader: every call still completes, and the site counts
    its hits."""
    plan = FaultPlan([FaultSpec(site, probability=1.0, **spec)], seed=11)
    injector.arm(plan)
    try:
        _echo_n(echo_server.port, 6, msg="w" * 200)
        assert injector.site_hits().get(site, {}).get(spec["action"], 0) >= 1
    finally:
        injector.disarm()


def test_runtime_hook_sites_fire_and_detach(echo_server):
    """'scheduler.callback' and 'dispatcher.dispatch' ride hook slots
    the injector fills only while a plan targets them."""
    from incubator_brpc_tpu_torch.runtime import scheduler as sched_mod
    from incubator_brpc_tpu_torch.transport import event_dispatcher as disp_mod

    assert sched_mod._chaos_hook is None and disp_mod._chaos_hook is None
    injector.arm(FaultPlan(
        [FaultSpec("scheduler.callback", "delay_us", arg=100, max_hits=50),
         FaultSpec("dispatcher.dispatch", "delay_us", arg=100, max_hits=50)],
        seed=19,
    ))
    assert sched_mod._chaos_hook is not None and disp_mod._chaos_hook is not None
    _echo_n(echo_server.port, 5, msg="hooked")
    hits = injector.site_hits()
    assert hits.get("scheduler.callback", {}).get("delay_us", 0) >= 1
    assert hits.get("dispatcher.dispatch", {}).get("delay_us", 0) >= 1
    injector.disarm()
    assert sched_mod._chaos_hook is None and disp_mod._chaos_hook is None


def test_ici_leg_drop_times_out_then_recovers():
    """'ici.send' drop loses one leg: the call times out, the next one
    passes with no residue."""
    srv = Server()
    srv.add_service(EchoService())
    assert srv.start_ici(7, 981, device=CPU) == 0
    injector.arm(FaultPlan(
        [FaultSpec("ici.send", "drop", probability=1.0, max_hits=1)], seed=17,
    ))
    ch = Channel(ChannelOptions(timeout_ms=1200))
    assert ch.init("ici://slice7/chip981") == 0
    stub = echo_stub(ch)
    try:
        c = Controller()
        stub.Echo(c, EchoRequest(message="lost-leg"))
        assert c.error_code == errors.ERPCTIMEDOUT, (c.error_code, c.error_text())
        c = Controller()
        r = stub.Echo(c, EchoRequest(message="back"))
        assert not c.failed(), c.error_text()
        assert r.message == "back"
    finally:
        injector.disarm()
        ch.close()
        srv.stop()


def test_admission_decide_rejects_deterministically():
    """'admission.decide' reject sheds every third call with
    EOVERCROWDED, and a replay of the plan fires on the same calls."""
    from incubator_brpc_tpu_torch.server.admission import AdmissionPolicy

    srv = Server(ServerOptions(
        admission_policy=AdmissionPolicy(tenant_tiers={"b": "bulk"})))
    srv.add_service(EchoService(attach_echo=False))
    assert srv.start(0) == 0
    ch = Channel(fresh_options(max_retry=0))
    ch.init(f"127.0.0.1:{srv.port}")
    stub = echo_stub(ch)
    plan = FaultPlan([FaultSpec("admission.decide", "reject", every_nth=3)], seed=7)
    try:
        logs = []
        for _ in range(2):
            injector.arm(plan)
            codes = []
            for _ in range(6):
                c = Controller()
                stub.Echo(c, EchoRequest(message="x"))
                codes.append(c.error_code)
            logs.append(injector.hit_log())
            injector.disarm()
            assert codes.count(errors.EOVERCROWDED) == 2, codes
            assert codes.count(0) == 4, codes
        assert logs[0] == logs[1] != []
    finally:
        injector.disarm()
        ch.close()
        srv.stop()


def test_session_migrate_seeded_replay_identical_decisions():
    """'session.migrate' decisions are pure in (seed, spec, traversal)."""
    plan = FaultPlan([FaultSpec("session.migrate", "drop", probability=0.5)],
                     seed=99, name="migrate-replay")
    runs = []
    for _ in range(2):
        injector.arm(plan)
        fired = [injector.check("session.migrate", method=f"sess-{i}") is not None
                 for i in range(24)]
        runs.append((fired, injector.hit_log()))
        injector.disarm()
    assert runs[0] == runs[1]
    assert any(runs[0][0]) and not all(runs[0][0])


def test_stream_frame_drop_replay_is_deterministic():
    """'stream.frame' drop on the client's DATA frames fires on the
    same frames in two runs of one plan."""
    from incubator_brpc_tpu_torch.models.streaming_echo import StreamingEchoService
    from incubator_brpc_tpu_torch.server.service import ServiceStub
    from incubator_brpc_tpu_torch.streaming.stream import Stream, StreamHandler

    class Sink(StreamHandler):
        def __init__(self):
            self.chunks = []

        def on_received_messages(self, stream, messages):
            self.chunks.extend(m.to_bytes() for m in messages)

    logs = []
    for _ in range(2):
        srv = Server()
        srv.add_service(StreamingEchoService())
        assert srv.start(0) == 0
        ch = Channel(ChannelOptions(timeout_ms=5000))
        try:
            assert ch.init(f"127.0.0.1:{srv.port}") == 0
            ctrl = Controller()
            stream = Stream.create(ctrl, Sink(), None)
            ServiceStub(ch, StreamingEchoService).StartStream(
                ctrl, EchoRequest(message="start"))
            assert not ctrl.failed(), ctrl.error_text()
            assert stream.wait_established(5)
            injector.arm(FaultPlan.from_dict({
                "name": "det", "seed": 99,
                "specs": [{"site": "stream.frame", "action": "drop", "every_nth": 4,
                           "match": {"direction": "data",
                                     "peer": f"127.0.0.1:{srv.port}"}}],
            }))
            try:
                for i in range(12):
                    stream.write(f"d{i}".encode())
                time.sleep(0.2)
            finally:
                logs.append(injector.hit_log())
                injector.disarm()
            stream.close()
        finally:
            ch.close()
            srv.stop()
    assert logs[0] == logs[1] and logs[0], logs


# ---------------------------------------------------------------------------
# native sites and ring.submit: the JAX package's tests/test_chaos.py
# native section, on the port's engine (the port's injector arms the
# port's engine, whose fault knobs are its own library's)
# ---------------------------------------------------------------------------


def test_native_sites_arm_the_ports_engine_not_the_jax_packages():
    """ns_set_fault state is per library: arming the port's injector
    programs the port's engine, and the JAX package's engine (a separate
    library loaded beside it) sees no knob."""
    import incubator_brpc_tpu.native as jax_native

    from incubator_brpc_tpu_torch import native

    srv = Server(ServerOptions(native_engine=True))
    srv.add_service(EchoService(attach_echo=False))
    assert srv.start(0) == 0
    injector.arm(FaultPlan(
        [FaultSpec("native.srv_read", "short_read", arg=512,
                   probability=1.0, max_hits=1000)], seed=7))
    ch = Channel(ChannelOptions(timeout_ms=5000, connection_type="native"))
    try:
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        c = Controller()
        r = echo_stub(ch).Echo(c, EchoRequest(message="k" * 8000))
        assert not c.failed(), c.error_text()
        assert r.message == "k" * 8000
        assert native.fault_hits(0) > 0
        assert jax_native.fault_hits(0) == 0
    finally:
        injector.disarm()
        ch.close()
        srv.stop()


@pytest.mark.parametrize("direction", ["submit", "flush"])
def test_ring_submit_drop_fails_each_call_once(direction):
    """ring.submit on both ring halves, one result per slot: a dropped
    client window fails each of its calls once with EFAILEDSOCKET
    (direction=submit); a dropped server response-ring flush leaves its
    window's calls to time out, each once (direction=flush).  The next
    window answers whole."""
    from incubator_brpc_tpu_torch.client.ring import RingFailure

    srv = Server(ServerOptions(native_engine=True))
    srv.add_service(_PyEchoForRing())
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=5000, connection_type="native"))
    try:
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        stub = echo_stub(ch)
        injector.arm(FaultPlan([FaultSpec(
            "ring.submit", "drop", probability=1.0, max_hits=1,
            match={"direction": direction})], seed=3))
        reqs = [EchoRequest(message=f"d{i}").SerializeToString() for i in range(8)]
        res = stub.call_many("Echo", reqs, timeout_ms=700)
        assert len(res) == 8
        failed = [r for r in res if isinstance(r, RingFailure)]
        want = errors.EFAILEDSOCKET if direction == "submit" else errors.ERPCTIMEDOUT
        assert failed and {r.error_code for r in failed} == {want}, res
        if direction == "submit":
            assert len(failed) == 8
        assert injector.site_hits().get("ring.submit", {}).get("drop", 0) == 1
        res = stub.call_many("Echo", reqs)
        assert all(isinstance(r, bytes) for r in res), res
        assert ch._ring_obj.counters()["double_resolves"] == 0
        assert ch._ring_obj.outstanding() == 0
    finally:
        injector.disarm()
        ch.close()
        srv.stop()


class _PyEchoForRing(EchoService):
    """Echo answered by the Python handler (no C fast path), so its
    replies ride the server's response ring."""

    SERVICE_NAME = "EchoService"

    def native_fastpaths(self):
        return {}


def test_arm_rejects_native_match_and_ttl():
    with pytest.raises(ValueError):
        injector.arm(FaultPlan([
            FaultSpec("native.srv_read", "short_read", arg=8,
                      match={"peer": "10.0.0.5"}),
        ]))
    with pytest.raises(ValueError):
        injector.arm(FaultPlan([
            FaultSpec("native.srv_read", "short_read", arg=8, ttl_s=5),
        ]))
    assert injector.armed is False


def test_native_short_read_completes_frames_in_place():
    """srv_read short reads slice a 70KB request into ~1KB chunks: the
    frame must complete IN PLACE across dozens of partial reads (the
    ByteBuf tail-read path) and still echo byte-identically."""
    srv = Server(ServerOptions(native_engine=True))
    srv.add_service(EchoService(attach_echo=False))
    assert srv.start(0) == 0
    plan = FaultPlan(
        [
            FaultSpec("native.srv_read", "short_read", arg=1024,
                      probability=1.0, max_hits=100000),
            FaultSpec("native.srv_write", "short_write", arg=1024,
                      probability=1.0, max_hits=100000),
        ],
        seed=99,
    )
    injector.arm(plan)
    ch = Channel(
        ChannelOptions(timeout_ms=10000, connection_type="native")
    )
    ch.init(f"127.0.0.1:{srv.port}")
    stub = echo_stub(ch)
    msg = "y" * 70000
    try:
        for _ in range(4):
            c = Controller()
            resp = EchoResponse()
            stub.Echo(c, EchoRequest(message=msg), response=resp)
            assert not c.error_code, (c.error_code, c.error_text())
            assert resp.message == msg
        hits = injector.site_hits()
        assert hits.get("native.srv_read", {}).get("short_read", 0) > 100
        assert hits.get("native.srv_write", {}).get("short_write", 0) > 100
    finally:
        injector.disarm()
        ch.close()
        srv.stop()


def test_native_http_reply_order_under_partial_writes():
    """Pipelined HTTP/1.1 on the native port under injected short
    writes: the burst-flush ordering invariant — responses come back
    in request order, byte-correct, however the kernel writes split."""
    srv = Server(ServerOptions(native_engine=True))
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    plan = FaultPlan(
        [FaultSpec("native.srv_write", "short_write", arg=4096,
                   probability=0.7, max_hits=100000)],
        seed=4242,
    )
    injector.arm(plan)
    bodies = [bytes([65 + i]) * (20000 + i) for i in range(8)]
    try:
        s = _socket.create_connection(("127.0.0.1", srv.port), timeout=10)
        req = b"".join(
            b"POST /EchoService/Echo.raw HTTP/1.1\r\nHost: c\r\n"
            b"Content-Length: %d\r\n\r\n" % len(b) + b
            for b in bodies
        )
        s.sendall(req)  # all 8 requests pipelined in one burst
        data = b""
        deadline = time.monotonic() + 20
        got = []
        while len(got) < len(bodies) and time.monotonic() < deadline:
            chunk = s.recv(1 << 16)
            if not chunk:
                break
            data += chunk
            while True:
                he = data.find(b"\r\n\r\n")
                if he < 0:
                    break
                head = data[:he].decode("latin1")
                clen = 0
                for line in head.split("\r\n"):
                    if line.lower().startswith("content-length:"):
                        clen = int(line.split(":")[1])
                if len(data) < he + 4 + clen:
                    break
                assert head.startswith("HTTP/1.1 200"), head.splitlines()[0]
                got.append(data[he + 4:he + 4 + clen])
                data = data[he + 4 + clen:]
        s.close()
        assert got == bodies, (
            f"reply order/content broke under partial writes: got "
            f"{[ (g[:1], len(g)) for g in got ]}"
        )
        hits = injector.site_hits()
        assert hits.get("native.srv_write", {}).get("short_write", 0) > 0
    finally:
        injector.disarm()
        srv.stop()


def test_arm_is_all_or_nothing():
    """A plan that fails validation must change NOTHING: no native
    knob programmed (a half-armed engine reporting disarmed is the
    worst state), and a previously armed plan stays armed."""
    good = FaultPlan([FaultSpec("socket.write", "drop", max_hits=1)], seed=1)
    injector.arm(good)
    bad = FaultPlan(
        [
            FaultSpec("native.srv_read", "short_read", arg=8),
            FaultSpec("native.srv_write", "drop"),  # unsupported natively
        ],
        seed=2,
    )
    with pytest.raises(ValueError):
        injector.arm(bad)
    # the good plan survived the failed arm untouched
    assert injector.armed is True
    assert injector.active_plan() is good
    injector.disarm()
    # and the bad plan's first (valid-looking) native spec was never
    # programmed: traffic on a native server fires no srv_read fault
    srv = Server(ServerOptions(native_engine=True))
    srv.add_service(EchoService(attach_echo=False))
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=3000, connection_type="native"))
    ch.init(f"127.0.0.1:{srv.port}")
    stub = echo_stub(ch)
    try:
        for _ in range(3):
            c = Controller()
            stub.Echo(c, EchoRequest(message="calm"))
            assert not c.error_code, c.error_text()
        assert native.fault_hits(0) == 0
    finally:
        ch.close()
        srv.stop()


def test_site_hits_consistent_after_disarm():
    """Post-disarm, site_hits() keeps BOTH python and native counts of
    the finished plan (native counters are harvested into
    chaos_injected_total before the knobs clear)."""
    srv = Server(ServerOptions(native_engine=True))
    srv.add_service(EchoService(attach_echo=False))
    assert srv.start(0) == 0
    plan = FaultPlan(
        [FaultSpec("native.srv_read", "short_read", arg=2048,
                   probability=1.0, max_hits=1000)],
        seed=44,
    )
    injector.arm(plan)
    ch = Channel(ChannelOptions(timeout_ms=5000, connection_type="native"))
    ch.init(f"127.0.0.1:{srv.port}")
    stub = echo_stub(ch)
    try:
        c = Controller()
        stub.Echo(c, EchoRequest(message="n" * 10000))
        assert not c.error_code, c.error_text()
        injector.disarm()
        hits = injector.site_hits()
        assert hits.get("native.srv_read", {}).get("short_read", 0) > 0
    finally:
        injector.disarm()
        ch.close()
        srv.stop()


def test_native_reset_surfaces_as_failed_socket():
    """srv_read reset kills the connection: the native client must see
    a transport error mapped to EFAILEDSOCKET/ERPCTIMEDOUT — never a
    hang, never garbage."""
    srv = Server(ServerOptions(native_engine=True))
    srv.add_service(EchoService(attach_echo=False))
    assert srv.start(0) == 0
    plan = FaultPlan(
        [FaultSpec("native.srv_read", "reset", probability=1.0, max_hits=2)],
        seed=5,
    )
    injector.arm(plan)
    ch = Channel(
        ChannelOptions(timeout_ms=2000, connection_type="native",
                       max_retry=0)
    )
    ch.init(f"127.0.0.1:{srv.port}")
    stub = echo_stub(ch)
    try:
        c = Controller()
        stub.Echo(c, EchoRequest(message="x"))
        assert c.error_code in (errors.EFAILEDSOCKET, errors.ERPCTIMEDOUT), (
            c.error_code, c.error_text())
        # budget exhausted (max_hits=2): the path heals
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            c = Controller()
            stub.Echo(c, EchoRequest(message="heal"))
            if not c.error_code:
                break
        assert not c.error_code, (c.error_code, c.error_text())
        assert controller_pool_clean()
    finally:
        injector.disarm()
        ch.close()
        srv.stop()
