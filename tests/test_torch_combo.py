"""The port's combo channels and cluster observability plane held
against the JAX package's, on the CPU.

The scenarios are those of tests/test_streaming_combo.py:146-325
(``ParallelChannel`` fan-out merge, call-mapper skip and ``fail_limit``;
``SelectiveChannel`` retry across groups and avoidance of a failing
group; ``PartitionChannel`` from naming-service tags) and of
tests/test_cluster_observability.py:135-225 and :551-600 (mergeable
latency state, the straggler tracker's report, the server time a leg
carries back).  Each runs on BOTH packages in the same test over their
own servers, and the two results must be equal.  The remote-fetch paths
of ``observability/cluster.py`` read a peer's builtin pages
(tests/test_torch_builtin.py).

The stream tests hold the port to what its copy of ``streaming/stream.py``
changed: a stream's close and failure notices reach the handler behind
every DATA batch received before them.
"""

import threading
import time
import types

import numpy as np
import pytest

PKGS = ["jax", "port"]


def pk(pkg):
    """One package's combo surface (servers, channels, models)."""
    if pkg == "port":
        from incubator_brpc_tpu_torch import errors
        from incubator_brpc_tpu_torch.client import combo
        from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
        from incubator_brpc_tpu_torch.client.controller import Controller
        from incubator_brpc_tpu_torch.metrics import latency_recorder
        from incubator_brpc_tpu_torch.metrics.multi_dimension import MultiDimension
        from incubator_brpc_tpu_torch.metrics.recorder import IntRecorder
        from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
        from incubator_brpc_tpu_torch.observability import cluster
        from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest, EchoResponse
        from incubator_brpc_tpu_torch.server.server import Server
        from incubator_brpc_tpu_torch.server.service import (
            MethodSpec,
            ServiceStub,
            rpc_method,
        )
    else:
        from incubator_brpc_tpu import errors
        from incubator_brpc_tpu.client import combo
        from incubator_brpc_tpu.client.channel import Channel, ChannelOptions
        from incubator_brpc_tpu.client.controller import Controller
        from incubator_brpc_tpu.metrics import latency_recorder
        from incubator_brpc_tpu.metrics.multi_dimension import MultiDimension
        from incubator_brpc_tpu.metrics.recorder import IntRecorder
        from incubator_brpc_tpu.models.echo import EchoService, echo_stub
        from incubator_brpc_tpu.observability import cluster
        from incubator_brpc_tpu.protos.echo_pb2 import EchoRequest, EchoResponse
        from incubator_brpc_tpu.server.server import Server
        from incubator_brpc_tpu.server.service import (
            MethodSpec,
            ServiceStub,
            rpc_method,
        )

    class TaggedEcho(EchoService):
        SERVICE_NAME = "EchoService"

        def __init__(self, tag):
            super().__init__()
            self.tag = tag

        def Echo(self, controller, request, response, done):
            response.message = self.tag
            response.code = request.code
            done()

    class AlwaysFailEcho(EchoService):
        """Same service name as EchoService; every call fails."""

        @rpc_method(EchoRequest, EchoResponse)
        def Echo(self, controller, request, response, done):
            controller.set_failed(errors.EINTERNAL, "group down")
            done()

    def start_server(service):
        srv = Server()
        srv.add_service(service)
        assert srv.start(0) == 0
        return srv

    def make_channel(port, **kw):
        kw.setdefault("timeout_ms", 3000)
        ch = Channel(ChannelOptions(**kw))
        assert ch.init(f"127.0.0.1:{port}") == 0
        return ch

    def dead_channel(timeout_ms):
        ch = Channel(ChannelOptions(timeout_ms=timeout_ms, max_retry=0))
        ch.init("127.0.0.1:1")
        return ch

    return types.SimpleNamespace(
        pkg=pkg, errors=errors, combo=combo, Channel=Channel,
        ChannelOptions=ChannelOptions, Controller=Controller,
        latency_recorder=latency_recorder, MultiDimension=MultiDimension,
        IntRecorder=IntRecorder, EchoService=EchoService, echo_stub=echo_stub,
        cluster=cluster, EchoRequest=EchoRequest, EchoResponse=EchoResponse,
        MethodSpec=MethodSpec, ServiceStub=ServiceStub, TaggedEcho=TaggedEcho,
        AlwaysFailEcho=AlwaysFailEcho, start_server=start_server,
        make_channel=make_channel, dead_channel=dead_channel,
    )


def both(scenario, *args):
    """Run ``scenario`` on each package; their results must be equal."""
    results = {pkg: scenario(pk(pkg), *args) for pkg in PKGS}
    assert results["port"] == results["jax"], results
    return results["port"]


# ---------------------------------------------------------------------------
# ParallelChannel
# ---------------------------------------------------------------------------


def _fanout_merge(P, n):
    servers = [P.start_server(P.TaggedEcho(f"s{i}")) for i in range(n)]
    try:
        pc = P.combo.ParallelChannel(P.combo.ParallelChannelOptions(timeout_ms=3000))
        for s in servers:
            pc.add_channel(
                P.make_channel(s.port),
                response_merger=lambda res, sub, i: setattr(
                    res, "message", res.message + sub.message
                ),
            )
        ctrl = P.Controller()
        r = P.echo_stub(pc).Echo(ctrl, P.EchoRequest(message="x"))
        assert not ctrl.failed(), ctrl.error_text()
        return sorted(r.message[i:i + 2] for i in range(0, 2 * n, 2))
    finally:
        for s in servers:
            s.stop()


@pytest.mark.parametrize("n", [2, 3, 5])
def test_parallel_channel_fanout_merge(n):
    assert both(_fanout_merge, n) == [f"s{i}" for i in range(n)]


def _call_mapper_skip(P, skip):
    servers = [P.start_server(P.TaggedEcho(f"s{i}")) for i in range(3)]
    try:
        pc = P.combo.ParallelChannel()
        seen = []
        for s in servers:
            pc.add_channel(
                P.make_channel(s.port),
                call_mapper=lambda i, n, req: None if i in skip else req,
                response_merger=lambda res, sub, i: seen.append(sub.message),
            )
        ctrl = P.Controller()
        P.echo_stub(pc).Echo(ctrl, P.EchoRequest(message="x"))
        assert not ctrl.failed(), ctrl.error_text()
        return sorted(seen)
    finally:
        for s in servers:
            s.stop()


@pytest.mark.parametrize("skip", [(1,), (0, 2)])
def test_parallel_channel_call_mapper_skip(skip):
    assert both(_call_mapper_skip, skip) == [
        f"s{i}" for i in range(3) if i not in skip
    ]


def _fail_limit(P, n_dead, fail_limit):
    good = P.start_server(P.TaggedEcho("ok"))
    try:
        pc = P.combo.ParallelChannel(
            P.combo.ParallelChannelOptions(fail_limit=fail_limit, timeout_ms=1500)
        )
        pc.add_channel(P.make_channel(good.port))
        for _ in range(n_dead):
            pc.add_channel(P.dead_channel(500))
        ctrl = P.Controller()
        r = P.echo_stub(pc).Echo(ctrl, P.EchoRequest(message="x"))
        if ctrl.failed():
            return ("failed", ctrl.error_code == P.errors.ETOOMANYFAILS)
        return ("ok", r.message)
    finally:
        good.stop()


@pytest.mark.parametrize(
    "n_dead,fail_limit,expect",
    [(1, 0, ("failed", True)), (1, 1, ("ok", "ok")),
     (2, 1, ("failed", True)), (2, 2, ("ok", "ok"))],
)
def test_parallel_channel_fail_limit(n_dead, fail_limit, expect):
    assert both(_fail_limit, n_dead, fail_limit) == expect


# ---------------------------------------------------------------------------
# SelectiveChannel
# ---------------------------------------------------------------------------


def _selective_retry(P, n_dead):
    good = P.start_server(P.TaggedEcho("group-b"))
    try:
        sc = P.combo.SelectiveChannel(
            P.combo.SelectiveChannelOptions(max_retry=n_dead + 1, timeout_ms=1000)
        )
        for _ in range(n_dead):
            sc.add_channel(P.dead_channel(300))
        sc.add_channel(P.make_channel(good.port))
        ctrl = P.Controller()
        r = P.echo_stub(sc).Echo(ctrl, P.EchoRequest(message="x"))
        assert not ctrl.failed(), ctrl.error_text()
        return r.message
    finally:
        good.stop()


@pytest.mark.parametrize("n_dead", [1, 2])
def test_selective_channel_retries_across_groups(n_dead):
    assert both(_selective_retry, n_dead) == "group-b"


def _selective_avoids(P):
    good = P.start_server(P.EchoService())
    bad = P.start_server(P.AlwaysFailEcho())
    try:
        ch_good = P.make_channel(good.port)
        ch_bad = P.make_channel(bad.port)
        sel = P.combo.SelectiveChannel(P.combo.SelectiveChannelOptions(max_retry=2))
        sel.add_channel(ch_bad)   # group 0: always fails
        sel.add_channel(ch_good)  # group 1: healthy
        stub = P.echo_stub(sel)
        for i in range(12):
            c = P.Controller()
            r = stub.Echo(c, P.EchoRequest(message=f"m{i}"))
            # the retry layer hides the bad group on every call
            assert not c.failed(), c.error_text()
            assert r.message == f"m{i}"
        out = (
            sel._stats[0].error_ema >= P.combo._GroupStats.UNHEALTHY,
            sel._stats[1].error_ema,
            sel._select(set()),
        )
        ch_good.close()
        ch_bad.close()
        return out
    finally:
        good.stop()
        bad.stop()


def test_selective_channel_avoids_failing_group():
    # feedback marked the failing group unhealthy, so selection now
    # avoids it outright
    assert both(_selective_avoids) == (True, 0.0, 1)


# ---------------------------------------------------------------------------
# PartitionChannel
# ---------------------------------------------------------------------------


def _wait_for(fn, timeout=8.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(0.02)
    return fn()


def _partition_from_tags(P, tmp_path):
    servers = [P.start_server(P.TaggedEcho(f"p{i}")) for i in range(3)]
    try:
        f = tmp_path / f"partitioned-{P.pkg}"
        f.write_text(
            "".join(f"127.0.0.1:{s.port} 1 {i}/3\n" for i, s in enumerate(servers))
        )
        pc = P.combo.PartitionChannel()
        assert pc.init(f"file://{f}", "rr") == 0
        assert _wait_for(lambda: pc.partition_count() == 3)
        seen = []
        ctrl = P.Controller()
        ctrl.timeout_ms = 3000
        r = P.EchoResponse()
        spec = P.MethodSpec("EchoService", "Echo", P.EchoRequest, P.EchoResponse)
        pc.call_method(spec, ctrl, P.EchoRequest(message="x"), r, None)
        assert not ctrl.failed(), ctrl.error_text()
        seen.append(pc.partition_count())
        # dynamic re-partition: shrink to 2 partitions
        f.write_text(
            f"127.0.0.1:{servers[0].port} 1 0/2\n"
            f"127.0.0.1:{servers[1].port} 1 1/2\n"
        )
        assert _wait_for(lambda: pc.partition_count() == 2)
        seen.append(pc.partition_count())
        return seen
    finally:
        for s in servers:
            s.stop()


def test_partition_channel_from_ns_tags(tmp_path):
    assert both(_partition_from_tags, tmp_path) == [3, 2]


# ---------------------------------------------------------------------------
# observability/cluster.py: mergeable state, stragglers, server time
# ---------------------------------------------------------------------------


def _merged_percentiles(P, seed):
    lr = P.latency_recorder
    rng = np.random.default_rng(seed)
    samples_a = [int(v) for v in 100 + rng.integers(0, 1500, 200)]
    samples_b = [int(v) for v in 20_000 + rng.integers(0, 6000, 50)]
    rec_a, rec_b, pooled = lr.LatencyRecorder(), lr.LatencyRecorder(), lr.LatencyRecorder()
    for v in samples_a:
        rec_a.update(v)
        pooled.update(v)
    for v in samples_b:
        rec_b.update(v)
        pooled.update(v)
    merged = lr.merge_latency_snapshots(
        [rec_a.mergeable_snapshot(), rec_b.mergeable_snapshot()]
    )
    out = []
    for ratio in (0.5, 0.9, 0.99, 0.999):
        got = lr.percentile_from_buckets(merged["buckets"], ratio)
        # merged state gives exactly the pooled percentile
        assert got == pooled.latency_percentile(ratio), ratio
        out.append(got)
    stats = lr.snapshot_stats(merged)
    assert stats["max_us"] == pooled.max_latency()
    return out, merged["count"], stats["count"]


@pytest.mark.parametrize("seed", [0, 1])
def test_merged_percentiles_exactly_equal_pooled(seed):
    _, count, stat_count = both(_merged_percentiles, seed)
    assert count == stat_count == 250


def _dim_merge(P):
    r1, r2 = P.IntRecorder(), P.IntRecorder()
    for v in (10, 20, 30):
        r1 << v
    r2 << 40
    merged = P.cluster.merge_dim_snapshots(
        [
            {"labels": ["k"], "stats": {"x": r1.mergeable_snapshot()}},
            {"labels": ["k"], "stats": {"x": r2.mergeable_snapshot()}},
        ]
    )
    md = P.MultiDimension(P.IntRecorder, ["method"])
    md.get_stats(["Echo"]) << 5
    return merged["stats"]["x"], md.mergeable_snapshot()


def test_intrecorder_and_multidimension_mergeable_state():
    merged, snap = both(_dim_merge)
    assert merged == {"sum": 100, "num": 4}
    assert snap["labels"] == ["method"] and snap["stats"]["Echo"] == {"sum": 5, "num": 1}


def _straggler_report(P, legs, reps):
    t = P.cluster.StragglerTracker(window_s=300)
    # one leg: no siblings, nothing to rank against
    t.note_fanout("Svc.M", [("a:1", 100, 50, False)])
    assert t.report()["fanouts"] == 0
    for _ in range(reps):
        t.note_fanout("Svc.M", legs)
    rep = t.report()
    return rep["fanouts"], rep["peers"]


STRAGGLER_LEGS = [
    [("a:1", 1_000, 900, False), ("b:2", 9_000, 1_000, False),
     ("c:3", 1_200, 950, True)],
    [("a:1", 2_500, 2_000, False), ("b:2", 700, 600, False),
     ("c:3", 800, 100, False), ("d:4", 12_000, 11_000, False)],
]


@pytest.mark.parametrize("case", [0, 1])
def test_straggler_tracker_report_math(case):
    legs = STRAGGLER_LEGS[case]
    fanouts, peers = both(_straggler_report, legs, 3)
    assert fanouts == 3
    slowest = max(legs, key=lambda leg: leg[1])
    top = peers[0]
    assert top["peer"] == slowest[0] and top["slowest"] == 3
    median = sorted(leg[1] for leg in legs)[len(legs) // 2]
    drag = slowest[1] - median
    assert top["drag_us"] == 3 * drag
    assert top["drag_server_us"] == 3 * (drag * slowest[2] // slowest[1])
    assert top["drag_wire_us"] == top["drag_us"] - top["drag_server_us"]


def _legs_carry_server_time(P):
    srv = P.start_server(P.EchoService())
    ch = P.make_channel(srv.port, timeout_ms=5000)
    try:
        c = P.Controller()
        P.echo_stub(ch).Echo(c, P.EchoRequest(message="timed"))
        assert not c.failed()
        return 0 < c.server_time_us <= c.latency_us
    finally:
        srv.stop()
        ch.close()


def test_fanout_legs_carry_server_time():
    assert both(_legs_carry_server_time) is True


def _fanout_notes_stragglers(P):
    """A ShardRoutedChannel fan-out records each leg with the combo
    plane's tracker (``note_fanout``): one fan-out of 3 legs."""
    servers = [P.start_server(P.TaggedEcho(f"t{i}")) for i in range(3)]
    try:
        ch = P.combo.ShardRoutedChannel(
            options=P.combo.ParallelChannelOptions(timeout_ms=5000)
        )
        ch.set_partitions([P.make_channel(s.port) for s in servers])
        ch.set_fanout("Echo", lambda i, n, req, pc, sc: req,
                      lambda pc, pr, scs, srs: setattr(pr, "message", str(len(scs))))
        tracker = P.cluster.fanout_tracker()
        before = tracker.report()["fanouts"]
        c = P.Controller()
        r = P.echo_stub(ch).Echo(c, P.EchoRequest(message="fan"))
        assert not c.failed(), c.error_text()
        return r.message, tracker.report()["fanouts"] - before
    finally:
        for s in servers:
            s.stop()


def test_shard_fanout_feeds_the_straggler_tracker():
    assert both(_fanout_notes_stragglers) == ("3", 1)


# ---------------------------------------------------------------------------
# streams: close and failure notices come after the last DATA batch
# ---------------------------------------------------------------------------


class _SlowSink:
    """Counts messages; the batch that holds ``last`` sleeps before it
    counts, so a close notice that overtakes it sees fewer messages."""

    def __init__(self, last, delay_s=0.3):
        self.last = last
        self.delay_s = delay_s
        self.got = []
        self.at_close = None
        self.at_failure = None
        self.order = []
        self.closed = threading.Event()

    def on_received_messages(self, stream, messages):
        data = [m.to_bytes() for m in messages]
        if self.last in data:
            time.sleep(self.delay_s)
        self.got.extend(data)
        self.order.append("data")

    def on_closed(self, stream):
        self.at_close = len(self.got)
        self.order.append("closed")
        self.closed.set()

    def on_failed(self, stream, error_code, error_text):
        self.at_failure = len(self.got)
        self.order.append("failed")


def _sink_server(sink):
    from incubator_brpc_tpu_torch.client.stream import Stream, StreamHandler
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest, EchoResponse
    from incubator_brpc_tpu_torch.server.server import Server
    from incubator_brpc_tpu_torch.server.service import Service, rpc_method

    class Handler(StreamHandler):
        def on_received_messages(self, stream, messages):
            sink.on_received_messages(stream, messages)

        def on_closed(self, stream):
            sink.on_closed(stream)

        def on_failed(self, stream, code, text):
            sink.on_failed(stream, code, text)

    class SinkService(Service):
        SERVICE_NAME = "StreamingEchoService"

        @rpc_method(EchoRequest, EchoResponse)
        def StartStream(self, controller, request, response, done):
            Stream.accept(controller, Handler())
            response.message = "stream-accepted"
            done()

    srv = Server()
    srv.add_service(SinkService())
    assert srv.start(0) == 0
    return srv


def _open_stream(port):
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.client.stream import Stream, StreamHandler
    from incubator_brpc_tpu_torch.models.streaming_echo import StreamingEchoService
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.service import ServiceStub

    ch = Channel(ChannelOptions(timeout_ms=5000))
    assert ch.init(f"127.0.0.1:{port}") == 0
    ctrl = Controller()
    stream = Stream.create(ctrl, StreamHandler())
    r = ServiceStub(ch, StreamingEchoService).StartStream(ctrl, EchoRequest(message="s"))
    assert not ctrl.failed(), ctrl.error_text()
    assert r.message == "stream-accepted"
    assert stream.wait_established(5)
    return ch, stream


@pytest.mark.parametrize("n", [1, 10])
def test_stream_close_does_not_overtake_the_last_batch(n):
    """The peer writes n messages and closes at once; the handler of the
    batch with the last message is slow.  on_closed must still see all
    n, as a sink that waits for on_closed and then counts expects."""
    last = f"m{n - 1}".encode()
    sink = _SlowSink(last)
    srv = _sink_server(sink)
    try:
        ch, stream = _open_stream(srv.port)
        for i in range(n):
            assert stream.write(f"m{i}".encode()) == 0
        stream.close()
        assert sink.closed.wait(10)
        assert sink.at_close == n, sink.order
        assert sink.got == [f"m{i}".encode() for i in range(n)]
        assert sink.order[-1] == "closed"
        ch.close()
    finally:
        srv.stop()


def test_stream_failure_notice_follows_the_last_batch():
    """A peer that resets its stream right after its last write: the
    failure and close notices both come after that write's batch."""
    sink = _SlowSink(b"m4")
    srv = _sink_server(sink)
    try:
        ch, stream = _open_stream(srv.port)
        for i in range(5):
            assert stream.write(f"m{i}".encode()) == 0
        from incubator_brpc_tpu_torch.protocols import streaming as wire

        stream._send_raw(wire.FRAME_RST)  # the peer's reset, as a failed side sends it
        assert sink.closed.wait(10)
        assert sink.at_failure == 5 and sink.at_close == 5, sink.order
        assert sink.order[-2:] == ["failed", "closed"]
        ch.close()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# the copies: the JAX package's files but for imports and listed comments
# ---------------------------------------------------------------------------

# copied module -> the lines (1-based) whose comment was reworded
COPIED = {
    "analysis/__init__.py": {3, 5, 6, 30},
    "analysis/findings.py": set(),
    "analysis/inventory.py": set(),
    "analysis/lockgraph.py": set(),
    "analysis/manifest.py": {143},
    "builtin/__init__.py": {917},
    "builtin/flamegraph.py": {5},
    "client/combo.py": {15, 165, 779},
    "client/auth.py": set(),
    "client/naming_remote.py": set(),
    "native/engine.cpp": set(),
    "native/fastcall.c": set(),
    "observability/cluster.py": {4},
    "observability/trace.py": set(),
    "observability/trackme.py": set(),
    "protocols/flv.py": set(),
    "protocols/h2.py": set(),
    "protocols/hpack.py": set(),
    "protocols/legacy.py": set(),
    "protocols/media_gateway.py": set(),
    "protocols/mongo.py": set(),
    "protocols/rtmp.py": set(),
    "protocols/thrift.py": set(),
    "protocols/ts.py": set(),
    # :16 is the serialized descriptor, which keeps the proto package
    # "incubator_brpc_tpu.test" of the JAX package's file: its bytes are
    # length-prefixed, and the default pool takes an identical file twice
    "protos/json_test_pb2.py": {16},
    "protos/legacy_meta_pb2.py": set(),
    "protos/trackme_pb2.py": set(),
    "runtime/fd.py": set(),
    "serialization/__init__.py": set(),
    "serialization/json2pb.py": set(),
    "serialization/mcpack.py": set(),
    "tools/__init__.py": set(),
    "tools/parallel_http.py": set(),
    "tools/rpc_press.py": set(),
    "tools/rpc_view.py": set(),
    "tools/task_stacks.py": set(),
    "utils/timeio.py": set(),
}

# copied modules that carry a fix the JAX package lacks (ROADMAP.md queue
# 3): the difflib opcodes of the port's lines against the JAX package's
# (imports rewritten), pinned so that nothing but the fixes drifts.
# http.py: a progressive body closes its connection at its end (and the
# comment at JAX :799 reworded); tpu_std.py, rpc_dump.py, rpc_replay.py:
# a dump sample keeps its frame's attachment size, and a replay sends it.
# analysis/invariants.py: chaos-site-test counts only tests/test_torch_*.py
# (and the comment at JAX :17 reworded); analysis/witness.py: the state
# lock is reentrant (and the docstring at JAX :21-22 names the plugin).
# native/__init__.py: the engine and the extension build into a hash-named
# directory with a per-process temporary, a missing engine raises
# NativeEngineError where the JAX package degrades, the extension loads
# under a dotted name, and call_boundary() says which boundary runs.
# client/ring.py: a reply's attachment leaves with its message as a
# RingReply instead of being wiped with the pooled controller (and the
# comments at JAX :5-6, :39, :284, :308 reworded).
DIVERGED = {
    "analysis/invariants.py": [("replace", 16, 17, 16, 17), ("replace", 83, 84, 83, 87)],
    "analysis/witness.py": [("replace", 20, 22, 20, 22), ("replace", 44, 45, 44, 47)],
    "protocols/http.py": [("insert", 242, 242, 242, 243), ("insert", 255, 255, 256, 257),
                          ("insert", 257, 257, 259, 269), ("insert", 267, 267, 279, 286),
                          ("insert", 726, 726, 745, 754), ("replace", 798, 799, 826, 827)],
    "protocols/tpu_std.py": [("replace", 237, 238, 237, 238)],
    "observability/rpc_dump.py": [("replace", 50, 52, 50, 54), ("insert", 59, 59, 61, 62)],
    "native/__init__.py": [('replace', 2, 7, 2, 10), ('replace', 8, 11, 11, 33), ('insert', 16, 16, 38, 39), ('insert', 17, 17, 40, 41),
                          ('insert', 18, 18, 42, 43), ('replace', 21, 24, 46, 50), ('replace', 25, 31, 51, 56), ('replace', 50, 53, 75, 84),
                          ('replace', 61, 64, 92, 93), ('insert', 86, 86, 115, 116), ('replace', 177, 180, 207, 208), ('replace', 207, 210, 235, 236),
                          ('replace', 232, 235, 258, 259), ('replace', 247, 271, 271, 277), ('replace', 273, 277, 279, 291), ('replace', 278, 283, 292, 305),
                          ('insert', 284, 284, 306, 333), ('replace', 285, 302, 334, 336), ('replace', 305, 310, 339, 344), ('insert', 311, 311, 345, 346),
                          ('replace', 313, 314, 348, 353), ('replace', 325, 326, 364, 365), ('insert', 327, 327, 366, 377), ('replace', 336, 339, 386, 390),
                          ('delete', 340, 342, 391, 391), ('replace', 493, 496, 542, 543), ('replace', 521, 524, 568, 569), ('replace', 720, 723, 765, 766),
                          ('replace', 789, 792, 832, 833)],
    "tools/rpc_replay.py": [("insert", 55, 55, 55, 56)],
    "client/ring.py": [("replace", 4, 6, 4, 6), ("replace", 38, 39, 38, 39), ("insert", 139, 139, 139, 156),
                       ("insert", 144, 144, 161, 166), ("replace", 283, 284, 305, 306), ("insert", 305, 305, 327, 330),
                       ("replace", 307, 308, 332, 333), ("replace", 527, 528, 552, 555), ("replace", 539, 540, 566, 569),
                       ("replace", 616, 617, 645, 647)],
}


@pytest.mark.parametrize("path", sorted(COPIED))
def test_copied_module_equals_the_jax_package(path):
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    ref = (root / "incubator_brpc_tpu" / path).read_text().splitlines()
    port = (root / "incubator_brpc_tpu_torch" / path).read_text().splitlines()
    assert len(port) == len(ref)
    differ = {
        i + 1 for i, (a, b) in enumerate(zip(ref, port))
        if a.replace("incubator_brpc_tpu", "incubator_brpc_tpu_torch") != b
    }
    assert differ == COPIED[path]
    for line in differ:  # a reworded line is a comment or docstring line
        assert not port[line - 1].strip().startswith(("import", "from", "def", "class"))


@pytest.mark.parametrize("path", sorted(DIVERGED))
def test_diverged_module_differs_only_by_its_fix(path):
    import difflib
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    ref = (root / "incubator_brpc_tpu" / path).read_text().replace(
        "incubator_brpc_tpu", "incubator_brpc_tpu_torch").splitlines()
    port = (root / "incubator_brpc_tpu_torch" / path).read_text().splitlines()
    ops = [op for op in difflib.SequenceMatcher(None, ref, port, autojunk=False).get_opcodes()
           if op[0] != "equal"]
    assert ops == DIVERGED[path]
