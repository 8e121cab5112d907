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
    # the .proto sources the _pb2 files were generated from, byte for
    # byte: json_test.proto's :5 is the same proto package line
    "protos/echo.proto": set(),
    "protos/json_test.proto": {5},
    "protos/legacy_meta.proto": set(),
    "protos/rpc_meta.proto": set(),
    "protos/trackme.proto": set(),
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
# metrics/window.py: a windowed Maxer/Miner counts the value recorded since
# the sampler's last tick, read before the ticks' samples so that a tick
# between the two reads cannot hide it, and the tick's reset and append and
# the samples' read share the sampler's lock; client/naming_service.py: a naming thread
# signals its first server list, and a periodic service that fails its first
# lookup delivers an empty one (tests/test_torch_repairs.py).
# client/combo.py: ShardRoutedChannel.call_many's per-call fallback (a shard
# channel without a ring surface, as in a combo of combos) returns a reply
# that carried an attachment as a RingReply, as Channel.call_many does, where
# the JAX package returns the message alone (and the comments at JAX :15,
# :165, :779 reworded).  metrics/latency_recorder.py: stats() reads count,
# average and percentiles after one fold of the batched writes (sharing
# latency()'s window average), and mergeable_snapshot() reads its state
# after one fold instead of four; a tick and a read of the window (buckets,
# ticked sums, live sum) share the recorder's _window_lock, and Percentile
# keeps a running total of its ring under its own lock, so bucket_totals()
# is one pass and neither read loses the live second to a tick;
# observability/latency_breakdown.py: the /metrics family and the
# /latency_breakdown snapshot read each recorder through stats(), one fold a
# recorder a page instead of five (tests/test_torch_repairs.py).
# transport/acceptor.py: a connection counts from its accept on, while its
# socket is being created, since the dispatcher can hand its first request to
# a handler before Socket.create returns (tests/test_torch_repairs.py).
# streaming/stream.py: the close and failure notices queue behind the DATA
# batches already queued (the stream tests above; and the comment at JAX :23
# reworded), and a stream writes only to the life of the pooled Socket object
# it was established on, holding the object across the write
# (tests/test_torch_repairs.py).
DIVERGED = {
    "analysis/invariants.py": [("replace", 16, 17, 16, 17), ("replace", 83, 84, 83, 87)],
    "analysis/witness.py": [("replace", 20, 22, 20, 22), ("replace", 44, 45, 44, 47)],
    "protocols/http.py": [("insert", 242, 242, 242, 243), ("insert", 255, 255, 256, 257),
                          ("insert", 257, 257, 259, 269), ("insert", 267, 267, 279, 286),
                          ("insert", 726, 726, 745, 754), ("replace", 798, 799, 826, 827)],
    "protocols/tpu_std.py": [("replace", 237, 238, 237, 238)],
    "observability/rpc_dump.py": [("replace", 50, 52, 50, 54), ("insert", 59, 59, 61, 62)],
    # the sanitizer flag table lives in utils/sanitize_flags.py, shared with murmur3's build
    "native/__init__.py": [('replace', 2, 7, 2, 10), ('replace', 8, 11, 11, 33), ('insert', 16, 16, 38, 39), ('insert', 17, 17, 40, 41),
                          ('insert', 18, 18, 42, 43), ('replace', 21, 24, 46, 47), ('replace', 25, 53, 48, 69),
                          ('replace', 61, 64, 77, 78), ('insert', 86, 86, 100, 101), ('replace', 177, 180, 192, 193), ('replace', 207, 210, 220, 221),
                          ('replace', 232, 235, 243, 244), ('replace', 247, 271, 256, 262), ('replace', 273, 277, 264, 276), ('replace', 278, 283, 277, 290),
                          ('insert', 284, 284, 291, 318), ('replace', 285, 302, 319, 321), ('replace', 305, 310, 324, 329), ('insert', 311, 311, 330, 331),
                          ('replace', 313, 314, 333, 338), ('replace', 325, 326, 349, 350), ('insert', 327, 327, 351, 362), ('replace', 336, 339, 371, 375),
                          ('delete', 340, 342, 376, 376), ('replace', 493, 496, 527, 528), ('replace', 521, 524, 553, 554), ('replace', 720, 723, 750, 751),
                          ('replace', 789, 792, 817, 818)],
    "tools/rpc_replay.py": [("insert", 55, 55, 55, 56)],
    "metrics/window.py": [("replace", 104, 105, 104, 106), ("replace", 108, 111, 109, 123)],
    "client/naming_service.py": [("insert", 84, 84, 84, 90), ("insert", 173, 173, 179, 180),
                                 ("insert", 191, 191, 198, 199), ("insert", 207, 207, 215, 220)],
    "client/ring.py": [("replace", 4, 6, 4, 6), ("replace", 38, 39, 38, 39), ("insert", 139, 139, 139, 156),
                       ("insert", 144, 144, 161, 166), ("replace", 283, 284, 305, 306), ("insert", 305, 305, 327, 330),
                       ("replace", 307, 308, 332, 333), ("replace", 527, 528, 552, 555), ("replace", 539, 540, 566, 569),
                       ("replace", 616, 617, 645, 647)],
    "client/combo.py": [("replace", 14, 15, 14, 15), ("replace", 164, 165, 164, 165),
                        ("replace", 778, 779, 778, 779), ("insert", 969, 969, 969, 975),
                        ("replace", 970, 972, 976, 978)],
    "metrics/latency_recorder.py": [("insert", 16, 16, 16, 17), ("replace", 138, 139, 139, 142),
                                    ("insert", 145, 145, 148, 149), ("insert", 171, 171, 175, 178),
                                    ("replace", 172, 173, 179, 180), ("replace", 174, 175, 181, 187),
                                    ("delete", 179, 180, 191, 191), ("replace", 181, 188, 192, 193),
                                    ("insert", 204, 204, 209, 213), ("replace", 374, 377, 383, 399),
                                    ("replace", 378, 379, 400, 401), ("insert", 388, 388, 410, 424),
                                    ("replace", 408, 413, 444, 447), ("replace", 414, 415, 448, 449),
                                    ("replace", 417, 419, 451, 453), ("replace", 461, 464, 495, 500)],
    "observability/latency_breakdown.py": [("replace", 100, 101, 100, 101),
                                           ("replace", 105, 109, 105, 109),
                                           ("replace", 188, 196, 188, 191),
                                           ("replace", 205, 206, 200, 202),
                                           ("replace", 207, 209, 203, 205)],
    "transport/acceptor.py": [("insert", 28, 28, 28, 32), ("replace", 109, 115, 113, 124),
                              ("replace", 116, 119, 125, 130), ("replace", 122, 123, 133, 135)],
    "streaming/stream.py": [("replace", 22, 23, 22, 23), ("insert", 120, 120, 120, 124),
                            ("replace", 153, 154, 157, 159), ("insert", 227, 227, 232, 233),
                            ("replace", 278, 279, 284, 287), ("replace", 280, 281, 288, 294),
                            ("replace", 454, 456, 467, 483), ("delete", 457, 458, 484, 484),
                            ("replace", 465, 466, 491, 492), ("replace", 609, 610, 635, 636),
                            ("replace", 615, 616, 641, 642), ("replace", 619, 622, 645, 648),
                            ("replace", 628, 629, 654, 655), ("replace", 636, 639, 662, 663),
                            ("replace", 645, 646, 669, 670)],
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


# proto scalar type → FieldDescriptor.TYPE_* name
_PROTO_SCALARS = {
    "double": "TYPE_DOUBLE", "float": "TYPE_FLOAT", "int32": "TYPE_INT32",
    "int64": "TYPE_INT64", "uint32": "TYPE_UINT32", "uint64": "TYPE_UINT64",
    "sint32": "TYPE_SINT32", "sint64": "TYPE_SINT64", "bool": "TYPE_BOOL",
    "string": "TYPE_STRING", "bytes": "TYPE_BYTES",
}


def _parse_proto(text):
    """(package, {message or enum full name: its members}) of a .proto
    source: a message's members are (name, number, label, type) per field
    (a map<K, V> field as the repeated entry message protoc makes, the
    type a message's or an enum's full name), an enum's (name, number)
    per value."""
    import re

    text = re.sub(r"//[^\n]*", "", text)
    package = re.search(r"^package ([\w.]+);", text, re.M)[1]
    tokens = re.findall(r"[{};]|map\s*<[^>]*>|[^\s{};]+", text)
    found, scopes, stack, words = {}, {}, [package], []
    for tok in tokens:
        if tok == "{":
            kind, name = words[-2], words[-1]
            stack.append(f"{stack[-1]}.{name}")
            found[stack[-1]], scopes[stack[-1]], words = [], kind, []
        elif tok == "}":
            stack.pop()
            words = []
        elif tok == ";":
            line, words = " ".join(words), []
            if len(stack) == 1:
                continue  # syntax, package
            if scopes[stack[-1]] == "enum":
                name, number = re.fullmatch(r"(\w+) = (\d+)", line).groups()
                found[stack[-1]].append((name, int(number)))
                continue
            label, ftype, name, number = re.fullmatch(
                r"(?:(required|optional|repeated) )?(map\s*<[^>]*>|[\w.]+) (\w+) = (\d+)",
                line).groups()
            if ftype.startswith("map"):
                entry = "".join(w.capitalize() for w in name.split("_")) + "Entry"
                ftype, label = f"{stack[-1]}.{entry}", "repeated"
            found[stack[-1]].append([name, int(number), label or "optional", ftype,
                                     stack[-1]])
        else:
            words.append(tok)
    for fields in (v for k, v in found.items() if scopes[k] == "message"):
        for i, (name, number, label, ftype, scope) in enumerate(fields):
            if ftype not in _PROTO_SCALARS and not ftype.startswith(package + "."):
                # the innermost enclosing scope that declares it
                while f"{scope}.{ftype}" not in found:
                    scope = scope.rpartition(".")[0]
                ftype = f"{scope}.{ftype}"
            fields[i] = (name, number, label, ftype)
    return package, found


def _descriptor_members(file_desc):
    """The same shape as _parse_proto's, read from a _pb2 FileDescriptor."""
    from google.protobuf.descriptor import FieldDescriptor

    types = {getattr(FieldDescriptor, v): k for k, v in _PROTO_SCALARS.items()}
    found = {}

    def enum(e):
        found[e.full_name] = [(v.name, v.number) for v in e.values]

    def message(m):
        fields = []
        for f in m.fields:
            ftype = (f.message_type.full_name if f.message_type is not None
                     else f.enum_type.full_name if f.enum_type is not None
                     else types[f.type])
            label = ("repeated" if f.is_repeated else "required" if f.is_required
                     else "optional")
            fields.append((f.name, f.number, label, ftype))
        if not m.GetOptions().map_entry:
            found[m.full_name] = fields
        for e in m.enum_types:
            enum(e)
        for n in m.nested_types:
            message(n)

    for e in file_desc.enum_types_by_name.values():
        enum(e)
    for m in file_desc.message_types_by_name.values():
        message(m)
    return found


@pytest.mark.parametrize("name", ["echo", "json_test", "legacy_meta", "rpc_meta", "trackme"])
def test_proto_source_matches_the_ports_pb2(name):
    """Every message, enum, field (name, number, label, type) and enum
    value of protos/<name>.proto, parsed from the source, is what the
    port's generated <name>_pb2 describes, and nothing more."""
    import importlib
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    package, parsed = _parse_proto(
        (root / "incubator_brpc_tpu_torch" / "protos" / f"{name}.proto").read_text())
    desc = importlib.import_module(f"incubator_brpc_tpu_torch.protos.{name}_pb2").DESCRIPTOR
    assert desc.package == package
    members = _descriptor_members(desc)
    assert parsed == members
    assert len(members) >= 2


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
