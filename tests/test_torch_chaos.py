"""The port's chaos sites under the port's own injector: each site the
invariant lint counts (``chaos-site-test``) is armed here against a
real port server and shown to fire, and the calls recover as they do
in the JAX package's tests (tests/test_chaos.py, test_chaos_recovery.py,
test_admission.py, test_serving.py, test_streaming_subsystem.py).
"""

import itertools
import time

import pytest
import torch

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.chaos import FaultPlan, FaultSpec, injector
from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
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
