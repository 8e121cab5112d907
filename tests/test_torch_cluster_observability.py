"""Cluster observability plane (observability/cluster.py, /cluster
builtin family): cross-process trace stitching with per-leg wire+queue
residuals, exact mergeable metric aggregation, shard straggler
attribution, and the canonical trace-id form across every surface.

Carried by hand from ``tests/test_cluster_observability.py``: the cases run
with the port's package name, but for the straggler regression, whose
ranking asserts are timing on a loaded CPU (the injured shard's leg must be
the slowest of most fan-outs; ``tests/test_torch_parity.py`` maps them
``timing``).  Its structure is kept: the page counts every fan-out, lists
every shard, and the injured shard's wire time carries the injected delay.
The stitched-trace case also waits for the fan-out's root span to drain
before it reads the tree: the JAX case waits for the legs only, and renders
two roots when the root drains last.
The mergeable-state, tracker-math and server-time cases are held by
``tests/test_torch_combo.py``.
"""

import http.client
import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.combo import (
    ParallelChannelOptions,
    ShardRoutedChannel,
)
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server
from incubator_brpc_tpu_torch.utils.flags import set_flag


def _http_get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    conn.request("GET", path)
    r = conn.getresponse()
    body = r.read().decode()
    conn.close()
    return r.status, body


def _http_post(port, path, body=b""):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    conn.request("POST", path, body=body)
    r = conn.getresponse()
    out = r.read().decode()
    conn.close()
    return r.status, out


def _wait_for(predicate, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = predicate()
        if v:
            return v
        time.sleep(0.05)
    return predicate()


def _spawn_child(body: str) -> subprocess.Popen:
    """Run `body` (which must print 'PORT <n>' once ready) in a fresh
    interpreter — a real separate process with its own SpanDB and
    metric registry, the thing the cluster plane exists to cross."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(body)],
        stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL,
        text=True,
        env=env,
    )


def _child_port(proc: subprocess.Popen) -> int:
    line = proc.stdout.readline()
    assert line.startswith("PORT "), f"child said {line!r}"
    return int(line.split()[1])


# ---------------------------------------------------------------------------
# trace-id representation (satellite): ONE printable form everywhere
# ---------------------------------------------------------------------------

def test_trace_id_round_trip_across_surfaces():
    from incubator_brpc_tpu_torch.observability.cluster import (
        span_from_dict,
        span_to_dict,
    )
    from incubator_brpc_tpu_torch.observability.span import (
        Span,
        format_trace_id,
        parse_trace_id,
    )
    from incubator_brpc_tpu_torch.protocols.http import _trace_header_ids

    # the canonical pair inverts over the full id range
    for tid in (1, 0xdeadbeef, 2**63 - 1, 2**64 - 1):
        assert parse_trace_id(format_trace_id(tid)) == tid
    with pytest.raises(ValueError):
        parse_trace_id("not-hex!")

    # HTTP carriage: x-trace-id/x-span-id headers round-trip through
    # the same pair (protocols/http.py emits format, parses via parse)
    tid, sid = 0xabc123, 0x77
    headers = {
        "x-trace-id": format_trace_id(tid),
        "x-span-id": format_trace_id(sid),
    }

    class _Msg:
        def header(self, name, default=None):
            return headers.get(name, default)

    assert _trace_header_ids(_Msg()) == (tid, sid)

    # /rpcz/export JSON carriage: span dicts carry hex ids and invert
    s = Span("server", "Svc", "M")
    s.trace_id, s.span_id, s.parent_span_id = tid, 5, 9
    d = span_to_dict(s)
    assert d["trace_id"] == format_trace_id(tid)
    back = span_from_dict(d)
    assert (back.trace_id, back.span_id, back.parent_span_id) == (tid, 5, 9)

    # tpu_std carriage is the raw int64 in RpcMeta: the same ints the
    # printable form wraps, so no separate representation exists
    from incubator_brpc_tpu_torch.protos import rpc_meta_pb2 as pb

    meta = pb.RpcMeta()
    meta.request.trace_id = tid
    parsed = pb.RpcMeta()
    parsed.ParseFromString(meta.SerializeToString())
    assert format_trace_id(parsed.request.trace_id) == format_trace_id(tid)


# ---------------------------------------------------------------------------
# mergeable metric aggregation: merged == pooled, exactly
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# ACCEPTANCE: one stitched tree across real shard server processes
# ---------------------------------------------------------------------------

_SHARD_CHILD = """
    import time
    from incubator_brpc_tpu_torch.models.echo import EchoService
    from incubator_brpc_tpu_torch.server.server import Server
    from incubator_brpc_tpu_torch.utils.flags import set_flag

    set_flag("rpcz_enabled", "true")
    set_flag("rpcz_max_spans_per_second", 1_000_000)
    srv = Server()
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    print(f"PORT {srv.port}", flush=True)
    time.sleep(600)
"""


def test_stitched_trace_across_shard_processes():
    """Acceptance: a fan-out Echo across 2 shard server PROCESSES
    renders ONE /rpcz?trace=N&stitch=1 tree on the client — client
    root, per-leg client spans, each remote server's phase-stamped
    span pulled over /rpcz/export, and a per-leg wire+queue residual
    (client leg latency minus the server's own elapsed time)."""
    from incubator_brpc_tpu_torch.observability.span import format_trace_id, span_db

    set_flag("rpcz_enabled", "true")
    set_flag("rpcz_max_spans_per_second", 1_000_000)
    children = [_spawn_child(_SHARD_CHILD) for _ in range(2)]
    web = Server()
    web.add_service(EchoService())
    assert web.start(0) == 0
    ch = None
    try:
        ports = [_child_port(p) for p in children]
        eps = [f"127.0.0.1:{p}" for p in ports]
        ch = ShardRoutedChannel.from_endpoints(
            eps,
            options=ParallelChannelOptions(timeout_ms=8000),
            channel_options=ChannelOptions(timeout_ms=8000),
        )
        ch.set_fanout("Echo")
        c = Controller()
        echo_stub(ch).Echo(c, EchoRequest(message="stitch-me"))
        assert not c.failed(), c.error_text()

        # the local SpanDB holds only the CLIENT side of the trace —
        # the fan-out root and one client span per leg (drained async;
        # the root ends, and drains, after its legs: wait for it too, or
        # the tree below renders each leg as a root)
        def local_legs():
            recent = span_db().recent(300)
            legs = [
                s
                for s in recent
                if s.kind == "client"
                and s.method == "Echo"
                and str(s.remote_side) in eps
            ]
            if len(legs) < 2:
                return None
            if not any(s.trace_id == legs[-1].trace_id and s.parent_span_id == 0
                       for s in recent):
                return None
            return legs

        legs = _wait_for(local_legs)
        assert legs, "client leg spans never drained"
        tid = legs[-1].trace_id
        assert all(leg.trace_id == tid for leg in legs)
        assert not any(
            s.kind == "server" and s.trace_id == tid
            for s in span_db().recent(300)
        ), "server spans must live only in the shard processes"

        # the stitcher pulls each shard's server spans over its builtin
        # surface; children drain asynchronously, so poll the page
        def stitched():
            status, body = _http_get(
                web.port, f"/rpcz?trace={format_trace_id(tid)}&stitch=1"
            )
            assert status == 200
            ok = (
                all(ep in body for ep in eps)
                and body.count("server EchoService.Echo") >= 2
                and body.count("wire+queue residual=") >= 2
            )
            return body if ok else None

        body = _wait_for(stitched, timeout=10)
        assert body, "stitched tree incomplete"
        lines = body.splitlines()
        assert lines[0].startswith(f"stitched trace {format_trace_id(tid)}")
        # ONE tree, depth >= 3: root at indent 0, client legs at indent
        # 2, remote server spans nested at indent 4
        assert sum(1 for l in lines if l.startswith("+")) == 1
        assert sum(1 for l in lines if l.startswith("  +")) >= 2
        assert sum(1 for l in lines if l.startswith("    +")) >= 2
        # remote spans are phase-stamped and origin-tagged
        for ep in eps:
            assert f"@{ep}" in body
        assert "callback=" in body and "queue=" in body
        # each residual line restates the client/server split it came from
        for l in lines:
            if "wire+queue residual=" in l:
                assert "client" in l and "- server" in l
    finally:
        if ch is not None:
            for sub in ch.partitions():
                sub.close()
        web.stop()
        for p in children:
            p.terminate()
        for p in children:
            p.wait(timeout=10)


# ---------------------------------------------------------------------------
# ACCEPTANCE: /cluster/latency_breakdown merges 2 replicas exactly
# ---------------------------------------------------------------------------

_BREAKDOWN_CHILD = """
    import sys, time
    from incubator_brpc_tpu_torch.models.echo import EchoService
    from incubator_brpc_tpu_torch.observability import latency_breakdown
    from incubator_brpc_tpu_torch.server.server import Server

    samples = [int(v) for v in sys.argv[1].split(",")]
    for v in samples:
        latency_breakdown.recorder("Echo.Echo", "callback").update(v)
    srv = Server()
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    print(f"PORT {srv.port}", flush=True)
    time.sleep(600)
"""


def test_cluster_latency_breakdown_merges_replicas_exactly():
    """Acceptance: percentiles /cluster/latency_breakdown serves over 2
    replica processes exactly equal percentiles computed from the
    pooled raw samples — the replicas export bucket STATE, never
    computed percentiles."""
    from incubator_brpc_tpu_torch.metrics.latency_recorder import (
        LatencyRecorder,
        percentile_from_buckets,
    )
    from incubator_brpc_tpu_torch.metrics.multi_dimension import MultiDimension
    from incubator_brpc_tpu_torch.observability import cluster

    samples_a = [50 + 11 * i for i in range(120)]
    samples_b = [30_000 + 401 * i for i in range(30)]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    children = [
        subprocess.Popen(
            [
                sys.executable,
                "-c",
                textwrap.dedent(_BREAKDOWN_CHILD),
                ",".join(str(v) for v in samples),
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            text=True,
            env=env,
        )
        for samples in (samples_a, samples_b)
    ]
    web = Server()
    web.add_service(EchoService())
    assert web.start(0) == 0
    try:
        ports = [_child_port(p) for p in children]
        replicas = ",".join(f"127.0.0.1:{p}" for p in ports)

        pooled = LatencyRecorder()
        for v in samples_a + samples_b:
            pooled.update(v)

        # exact merge at the state level: scrape both exports, merge,
        # and the merged buckets reproduce the pooled walk bit-for-bit
        payloads, errors = cluster.scrape_exports(
            [f"127.0.0.1:{p}" for p in ports]
        )
        assert not errors, errors
        merged = cluster.merge_exports(payloads)
        key = MultiDimension._KEY_SEP.join(("Echo.Echo", "callback"))
        state = merged["dims"]["rpc_phase_latency_us"]["stats"][key]
        assert state["count"] == len(samples_a) + len(samples_b)
        for ratio in (0.5, 0.9, 0.99):
            assert percentile_from_buckets(state["buckets"], ratio) == (
                pooled.latency_percentile(ratio)
            ), f"merged != pooled at p{ratio}"

        # and the page a replica would serve renders those exact values
        status, body = _http_get(
            web.port, f"/cluster/latency_breakdown?replicas={replicas}"
        )
        assert status == 200
        assert "merged over 2 replicas" in body
        assert "Echo.Echo:" in body
        row = next(
            l for l in body.splitlines() if l.strip().startswith("callback")
        )
        assert f"count={len(samples_a) + len(samples_b)}" in row
        assert f"p50={pooled.latency_percentile(0.5):.0f}" in row
        assert f"p99={pooled.latency_percentile(0.99):.0f}" in row

        # /cluster/metrics over the same pod agrees
        status, body = _http_get(
            web.port, f"/cluster/metrics?replicas={replicas}"
        )
        assert status == 200
        assert 'rpc_phase_latency_us{method="Echo.Echo",phase="callback"' in body
    finally:
        web.stop()
        for p in children:
            p.terminate()
        for p in children:
            p.wait(timeout=10)


def test_cluster_pages_reject_bad_input():
    web = Server()
    web.add_service(EchoService())
    assert web.start(0) == 0
    try:
        status, body = _http_get(web.port, "/cluster/metrics")
        assert status == 400 and "replicas" in body
        status, body = _http_get(
            web.port, "/cluster/metrics?replicas=bogus://x"
        )
        assert status == 400
        status, body = _http_get(web.port, "/rpcz/export")
        assert status == 400 and "trace" in body
        status, body = _http_get(web.port, "/rpcz/export?trace=zzz")
        assert status == 400
        # unknown trace: valid request, empty span set
        status, body = _http_get(web.port, "/rpcz/export?trace=abcdef")
        assert status == 200
        assert json.loads(body)["spans"] == []
        status, body = _http_get(
            web.port, "/cluster/stragglers?window_s=nope"
        )
        assert status == 400
    finally:
        web.stop()


def test_resolve_replicas_forms():
    from incubator_brpc_tpu_torch.observability.cluster import resolve_replicas

    assert resolve_replicas("") == []
    assert resolve_replicas("a:1, b:2") == ["a:1", "b:2"]
    assert resolve_replicas("list://x:1,y:2") == ["x:1", "y:2"]
    with pytest.raises(ValueError):
        resolve_replicas("bogus://whatever")


# ---------------------------------------------------------------------------
# straggler attribution + chaos regression
# ---------------------------------------------------------------------------

def test_straggler_chaos_regression_names_the_slow_shard():
    """Regression: a seeded socket.read delay on ONE shard of a 4-shard
    fan-out shows on /cluster/stragglers as that shard's wire time.  (The
    JAX case also asserts the shard's rank and drag split, which CPU load
    decides: mapped ``timing``.)"""
    from incubator_brpc_tpu_torch.chaos import injector as chaos_injector
    from incubator_brpc_tpu_torch.chaos.plan import FaultPlan, FaultSpec
    from incubator_brpc_tpu_torch.observability import cluster

    shards = []
    for _ in range(4):
        s = Server()
        s.add_service(EchoService())
        assert s.start(0) == 0
        shards.append(s)
    eps = [f"127.0.0.1:{s.port}" for s in shards]
    # inject on the LAST shard: client read tasks run in leg order on
    # the (possibly single-worker) runtime, so a delay on an earlier
    # shard's socket would also stall the reads queued behind it and
    # smear the injury across innocent legs
    slow_ep = eps[3]

    # fresh tracker: this process's earlier fan-outs must not pollute
    # the ranking (restored below — the module global backs the page)
    old_tracker = cluster._tracker
    cluster._tracker = cluster.StragglerTracker()
    ch = None
    try:
        # delay every response READ from the slow shard in the client:
        # pure wire-side injury, the shard's server time stays honest
        plan = FaultPlan(
            [
                FaultSpec(
                    site="socket.read",
                    action="delay_us",
                    arg=30_000,
                    match={"peer": slow_ep},
                )
            ],
            seed=7,
            name="slow-shard",
        )
        chaos_injector.arm(plan)
        ch = ShardRoutedChannel.from_endpoints(
            eps,
            options=ParallelChannelOptions(timeout_ms=8000),
            channel_options=ChannelOptions(timeout_ms=8000),
        )
        ch.set_fanout("Echo")
        stub = echo_stub(ch)
        for i in range(5):
            c = Controller()
            stub.Echo(c, EchoRequest(message=f"storm-{i}"))
            assert not c.failed(), c.error_text()
        chaos_injector.disarm()

        status, body = _http_get(shards[0].port, "/cluster/stragglers")
        assert status == 200
        report = json.loads(body)
        assert report["fanouts"] == 5
        ranked = report["peers"]
        assert sorted(p["peer"] for p in ranked) == sorted(eps)
        slow = next(p for p in ranked if p["peer"] == slow_ep)
        assert slow["mean_wire_us"] > 20_000  # ≥ the injected delay

        # ?window_s= bounds the window: everything is fresh, so a tiny
        # look-back drops it all
        status, body = _http_get(
            shards[0].port, "/cluster/stragglers?window_s=0"
        )
        assert json.loads(body)["fanouts"] == 0
    finally:
        chaos_injector.disarm()
        cluster._tracker = old_tracker
        if ch is not None:
            for sub in ch.partitions():
                sub.close()
        for s in shards:
            s.stop()


# ---------------------------------------------------------------------------
# /rpc_dump builtin (satellite): enable at runtime, capture, read back
# ---------------------------------------------------------------------------

def test_rpc_dump_builtin_capture_and_read_back(tmp_path):
    from incubator_brpc_tpu_torch.observability.rpc_dump import read_samples

    srv = Server()
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=5000))
    ch.init(f"127.0.0.1:{srv.port}")
    stub = echo_stub(ch)
    dump_dir = str(tmp_path / "dump")
    try:
        status, body = _http_get(srv.port, "/rpc_dump")
        assert status == 200 and json.loads(body) == {"enabled": False}
        # bad enables are rejected before touching server state
        status, _ = _http_post(srv.port, "/rpc_dump?ratio=1")
        assert status == 400
        status, _ = _http_post(srv.port, f"/rpc_dump?dir={dump_dir}&ratio=2")
        assert status == 400

        status, body = _http_post(
            srv.port, f"/rpc_dump?dir={dump_dir}&ratio=1"
        )
        assert status == 200
        assert json.loads(body) == {
            "enabled": True, "dir": dump_dir, "ratio": 1.0,
        }
        for i in range(4):
            c = Controller()
            stub.Echo(c, EchoRequest(message=f"capture-{i}"))
            assert not c.failed()

        status, body = _http_get(srv.port, "/rpc_dump")
        state = json.loads(body)
        assert state["enabled"] and state["sampled"] >= 4
        assert state["files"], "capture produced no dump files"

        # read back: every captured sample is a replayable Echo request
        seen = []
        for path in state["files"]:
            for meta, payload in read_samples(path):
                assert meta["service"] == "EchoService"
                assert meta["method"] == "Echo"
                req = EchoRequest()
                req.ParseFromString(payload)
                seen.append(req.message)
        assert set(seen) >= {f"capture-{i}" for i in range(4)}

        status, body = _http_post(srv.port, "/rpc_dump?disable=1")
        assert status == 200 and json.loads(body) == {"enabled": False}
        status, body = _http_get(srv.port, "/rpc_dump")
        assert json.loads(body) == {"enabled": False}
    finally:
        srv.stop()
        ch.close()
