"""Contention profiler + rpcz persistence + heap pages (reference:
bthread/mutex.cpp:106-180 contention sampling, span.cpp
SpanDB persistence, builtin/hotspots_service.cpp).

Carried by hand from ``tests/test_observability_depth.py``.  Besides the
package name, the fan-out trace case gives its ICI server ports and channels
the device the case runs on (the CPU, or the card).
"""

import threading
import time

import pytest

from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server

from torch_carry import torch_device  # noqa: F401  (fixture)


def _http_get(port, path):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    conn.request("GET", path)
    r = conn.getresponse()
    body = r.read().decode()
    conn.close()
    return r.status, body


def test_contention_profile_nonempty_under_contention():
    from incubator_brpc_tpu_torch.observability import contention
    from incubator_brpc_tpu_torch.runtime.sync import TaskMutex

    contention.profiler().reset()
    # deterministic sampling for the test: capture every contended wait
    old_base = contention.SAMPLING_BASE
    contention.SAMPLING_BASE = 1
    try:
        mu = TaskMutex()
        stop = time.monotonic() + 1.0

        def fighter():
            while time.monotonic() < stop:
                with mu:
                    time.sleep(0.002)

        ts = [threading.Thread(target=fighter) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        # collector drains asynchronously
        deadline = time.monotonic() + 3
        while time.monotonic() < deadline:
            if contention.profiler().total_samples:
                break
            time.sleep(0.05)
        assert contention.profiler().total_samples > 0
        text = contention.profiler().render()
        assert "--- contention" in text
        assert "fighter" in text  # the contending frame is attributed
    finally:
        contention.SAMPLING_BASE = old_base


def test_hotspots_contention_page():
    srv = Server()
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    try:
        status, body = _http_get(srv.port, "/hotspots/contention")
        assert status == 200
        assert "--- contention" in body
        status, body = _http_get(srv.port, "/hotspots/contention?reset=1")
        assert status == 200 and "reset" in body
    finally:
        srv.stop()


def test_hotspots_heap_growth_pages():
    srv = Server()
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    try:
        _http_get(srv.port, "/hotspots/heap")  # starts tracing
        status, body = _http_get(srv.port, "/hotspots/heap")
        assert status == 200 and "--- heap" in body
        _http_get(srv.port, "/hotspots/growth")
        blob = [b"x" * 200_000]  # allocate between growth fetches
        status, body = _http_get(srv.port, "/hotspots/growth")
        assert status == 200
        del blob
    finally:
        srv.stop()
        import tracemalloc

        tracemalloc.stop()


def test_rpcz_sqlite_persistence(tmp_path):
    from incubator_brpc_tpu_torch.observability.span import Span, span_db
    from incubator_brpc_tpu_torch.utils.flags import set_flag

    db_file = str(tmp_path / "rpcz.sqlite")
    assert set_flag("rpcz_db_path", db_file)
    try:
        span = Span.create_client("TestSvc", "M")
        assert span is not None
        trace_id = span.trace_id
        span.end(0)
        # collector drain is async; poll for the persisted row
        deadline = time.monotonic() + 3
        rows = []
        while time.monotonic() < deadline:
            rows = span_db().persisted_by_trace(trace_id)
            if rows:
                break
            time.sleep(0.05)
        assert rows, "span never reached sqlite"
        assert "TestSvc.M" in rows[0]

        # a FRESH SpanDB (new process analog) still sees it
        from incubator_brpc_tpu_torch.observability.span import SpanDB

        fresh = SpanDB()
        assert any("TestSvc.M" in d for d in fresh.persisted_by_trace(trace_id))
    finally:
        set_flag("rpcz_db_path", "")


def _wait_for(predicate, timeout=3.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = predicate()
        if v:
            return v
        time.sleep(0.05)
    return predicate()


def test_server_span_phase_stamps_and_response_size():
    """Tentpole: the server span carries non-zero phase deltas (parse/
    queue/callback/write/send), a response_size, and closes at write
    completion (sent_us stamped)."""
    from incubator_brpc_tpu_torch.observability.span import span_db
    from incubator_brpc_tpu_torch.utils.flags import set_flag

    # lift the trace-creation sampling budget: earlier tests' traffic
    # in the same 1s window must not starve this test's spans
    set_flag("rpcz_max_spans_per_second", 1_000_000)
    srv = Server()
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=5000))
    ch.init(f"127.0.0.1:{srv.port}")
    stub = echo_stub(ch)
    try:
        for _ in range(2):  # warm call + measured call
            c = Controller()
            stub.Echo(c, EchoRequest(message="phase-me"))
            assert not c.failed()
        assert c._span is not None
        tid = c._span.trace_id  # key on THIS call's trace: the ring
        # also holds stale Echo spans from earlier tests in the session

        def server_spans():
            return [
                s
                for s in span_db().recent(300)
                if s.trace_id == tid
                and s.kind == "server"
                and s.phase("sent_us")
            ]

        spans = _wait_for(server_spans)
        assert spans, "no completed server span collected"
        s = spans[-1]
        deltas = dict(s.phase_deltas())
        for phase in ("parse", "queue", "callback", "write", "send"):
            assert phase in deltas, (phase, deltas)
        assert s.response_size > 0  # stamped at response build, not 0
        assert s.request_size > 0
        # closed at write completion: end >= sent >= response_write
        assert (
            s.end_us >= s.phase("sent_us") >= s.phase("response_write_us") > 0
        )
        # the server span is parented under this call's client span
        assert s.parent_span_id == c._span.span_id
    finally:
        set_flag("rpcz_max_spans_per_second", 500)
        srv.stop()
        ch.close()


def test_fanout_trace_tree_and_latency_breakdown(torch_device):
    """Acceptance: a fan-out echo over the parallel channel (ICI legs)
    produces ONE trace whose /rpcz?trace= tree shows client span →
    collective sub-spans → server spans, and /latency_breakdown
    reports per-method phase percentiles."""
    from incubator_brpc_tpu_torch.client.combo import (
        ParallelChannel,
        ParallelChannelOptions,
    )
    from incubator_brpc_tpu_torch.observability.span import span_db
    from incubator_brpc_tpu_torch.utils.flags import set_flag

    set_flag("rpcz_max_spans_per_second", 1_000_000)
    # TCP server for the builtin pages; ICI servers for the fan-out
    web = Server()
    web.add_service(EchoService())
    assert web.start(0) == 0
    ici_servers = []
    chans = []
    pc = ParallelChannel(ParallelChannelOptions(timeout_ms=8000))
    for chip in range(11, 13):  # coords clear of other tests' ports
        srv = Server()
        srv.add_service(EchoService())
        assert srv.start_ici(7, chip, device=torch_device) == 0
        ici_servers.append(srv)
        ch = Channel(ChannelOptions(timeout_ms=8000, ici_device=torch_device))
        ch.init(f"ici://slice7/chip{chip}")
        chans.append(ch)
        pc.add_channel(ch)
    try:
        c = Controller()
        echo_stub(pc).Echo(c, EchoRequest(message="fanout"))
        assert not c.failed(), c.error_text()

        def trace_spans():
            spans = [
                s
                for s in span_db().recent(300)
                if s.method == "Echo" and "slice7" in str(s.remote_side)
            ]
            if not spans:
                return None
            tid = spans[-1].trace_id
            full = [
                s for s in span_db().recent(300) if s.trace_id == tid
            ]
            kinds = {s.kind for s in full}
            # root + 2 sub clients + 2 servers + ici legs, one trace
            if {"client", "server", "collective"} <= kinds and len(full) >= 7:
                return full
            return None

        full = _wait_for(trace_spans)
        assert full, "fan-out trace incomplete"
        tid = full[0].trace_id
        assert all(s.trace_id == tid for s in full)
        status, body = _http_get(web.port, f"/rpcz?trace={tid:x}")
        assert status == 200
        # indented tree: server spans nest two levels under the root
        assert "  +" in body
        assert "collective ici" in body
        assert "server EchoService.Echo" in body
        assert "queue=" in body and "callback=" in body and "send=" in body
        # per-method per-phase percentiles on /latency_breakdown
        status, body = _http_get(web.port, "/latency_breakdown")
        assert status == 200
        assert "EchoService.Echo" in body
        assert "p99=" in body and "callback" in body
        # Prometheus labeled series on /metrics
        status, body = _http_get(web.port, "/metrics")
        assert status == 200
        assert 'rpc_phase_latency_us{method="EchoService.Echo"' in body
        assert 'stat="p99"' in body
    finally:
        set_flag("rpcz_max_spans_per_second", 500)
        for srv in ici_servers:
            srv.stop()
        web.stop()
        for ch in chans:
            ch.close()


def test_http_trace_propagation():
    """Satellite: x-trace-id/x-span-id request headers join the HTTP
    server span into the caller's trace (same trace as tpu_std)."""
    from incubator_brpc_tpu_torch.observability.span import span_db
    from incubator_brpc_tpu_torch.utils.flags import set_flag

    set_flag("rpcz_max_spans_per_second", 1_000_000)
    srv = Server()
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(protocol="http", timeout_ms=5000))
    ch.init(f"127.0.0.1:{srv.port}")
    stub = echo_stub(ch)
    try:
        c = Controller()
        stub.Echo(c, EchoRequest(message="over-http"))
        assert not c.failed(), c.error_text()
        assert c._span is not None
        tid = c._span.trace_id

        def joined():
            return [
                s
                for s in span_db().recent(200)
                if s.trace_id == tid and s.kind == "server"
            ]

        servers = _wait_for(joined)
        assert servers, "http server span did not join the client trace"
        s = servers[-1]
        assert s.parent_span_id == c._span.span_id
        assert s.method == "Echo"
        # http server spans carry callback + write phases too
        deltas = dict(s.phase_deltas())
        assert "callback" in deltas
    finally:
        set_flag("rpcz_max_spans_per_second", 500)
        srv.stop()
        ch.close()


def test_latency_breakdown_method_cap_collapses_to_other():
    """Past the method cap new names collapse into _other instead of
    growing (or deadlocking on) the recorder table; collective spans
    aggregate under their bounded service name, never per-pair."""
    from incubator_brpc_tpu_torch.observability import latency_breakdown as lb
    from incubator_brpc_tpu_torch.observability.span import Span

    with lb._lock:
        saved_recorders = dict(lb._recorders)
        saved_methods = set(lb._methods)
    try:
        for i in range(lb._MAX_METHODS + 20):
            rec = lb.recorder(f"CapSvc{i:04d}.M", "parse")
            assert rec is not None
        assert lb.recorder("CapSvcOverflow.M", "parse") is lb.recorder(
            "_other", "parse"
        )
    finally:
        with lb._lock:
            lb._recorders.clear()
            lb._recorders.update(saved_recorders)
            lb._methods.clear()
            lb._methods.update(saved_methods)
    # collective legs with per-pair method names key by service
    s = Span("collective", "ici", "slice0/chip1->slice0/chip2")
    assert lb._method_key(s) == "ici"


def test_spandb_persistence_evicted_in_start_order(tmp_path):
    """Satellite: spans survive a fresh SpanDB instance, and
    persisted_by_trace returns ring-evicted spans in start_us order."""
    from incubator_brpc_tpu_torch.observability.span import Span, SpanDB
    from incubator_brpc_tpu_torch.utils.flags import set_flag

    db_file = str(tmp_path / "rpcz_evict.sqlite")
    assert set_flag("rpcz_db_path", db_file)
    try:
        db = SpanDB(capacity=4)
        trace_id = 0x7E57E71C
        base = time.time_ns() // 1000
        for i in range(10):
            span = Span("client", "EvictSvc", f"M{i:02d}")
            span.trace_id = trace_id
            span.start_us = base + i  # strictly increasing
            span.end_us = base + i + 5
            db.add(span)  # direct add: the collector path is async
        # ring kept only the last 4...
        assert len(db.by_trace(trace_id)) == 4
        # ...but sqlite has all 10, ordered by start_us
        rows = db.persisted_by_trace(trace_id)
        assert len(rows) == 10
        methods = [r.split("EvictSvc.")[1].split(" ")[0] for r in rows]
        assert methods == [f"M{i:02d}" for i in range(10)]
        # a FRESH SpanDB (new-process analog) still sees every span
        fresh = SpanDB()
        rows2 = fresh.persisted_by_trace(trace_id)
        assert len(rows2) == 10
        assert rows2 == rows
    finally:
        set_flag("rpcz_db_path", "")


def test_rpcz_page_merges_persisted(tmp_path):
    from incubator_brpc_tpu_torch.utils.flags import set_flag

    db_file = str(tmp_path / "rpcz2.sqlite")
    assert set_flag("rpcz_db_path", db_file)
    try:
        srv = Server()
        srv.add_service(EchoService())
        assert srv.start(0) == 0
        ch = Channel(ChannelOptions(timeout_ms=5000))
        ch.init(f"127.0.0.1:{srv.port}")
        stub = echo_stub(ch)
        c = Controller()
        stub.Echo(c, EchoRequest(message="traced"))
        assert not c.failed()
        # find the trace id from the recent ring
        from incubator_brpc_tpu_torch.observability.span import span_db

        deadline = time.monotonic() + 3
        trace = None
        while time.monotonic() < deadline:
            spans = [
                s for s in span_db().recent(50) if s.method == "Echo"
            ]
            if spans:
                trace = spans[-1].trace_id
                break
            time.sleep(0.05)
        assert trace is not None
        status, body = _http_get(srv.port, f"/rpcz?trace={trace:x}")
        assert status == 200
        assert "Echo" in body
        srv.stop()
        ch.close()
    finally:
        set_flag("rpcz_db_path", "")
