"""The port's native C++ engine against the JAX package's tests of it.

The JAX package's ``tests/test_native_engine.py``,
``test_fastpath_pool.py``, ``test_connection_types.py`` and
``test_native_multiproto.py``, run on the port's engine
(``incubator_brpc_tpu_torch/native/``): the server's fast path and its
Python fallback, the client pool, the mux reactor's sync and async
paths, the pooled zero-Python-per-call controllers, the connection
types, and one port speaking tpu_std, HTTP and redis.  Every call
carries a timeout and every server stops in a ``finally`` or a fixture,
so a wedged engine fails instead of hanging.  Nothing here skips: the
port has no fallback for a missing engine (``NativeEngineError``).

Then what the port adds: a port client against a JAX server and the
reverse, a PS ``Forward`` through the engine held to the JAX package's
``PsService``, the build (race-free, hash-named) and the raise in place
of the fallback.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import incubator_brpc_tpu.native as jax_native
from incubator_brpc_tpu.client.channel import Channel as JChannel
from incubator_brpc_tpu.client.channel import ChannelOptions as JChannelOptions
from incubator_brpc_tpu.client.combo import ShardRoutedChannel as JShardRoutedChannel
from incubator_brpc_tpu.client.controller import Controller as JController
from incubator_brpc_tpu.client.ring import fanout_log as j_fanout_log
from incubator_brpc_tpu.models.echo import EchoService as JEchoService
from incubator_brpc_tpu.models.echo import echo_stub as j_echo_stub
from incubator_brpc_tpu.models.parameter_server import PsService as JPsService
from incubator_brpc_tpu.models.parameter_server import ps_stub as j_ps_stub
from incubator_brpc_tpu.protos.echo_pb2 import EchoRequest as JEchoRequest
from incubator_brpc_tpu.server.server import Server as JServer
from incubator_brpc_tpu.server.server import ServerOptions as JServerOptions
from incubator_brpc_tpu_torch import errors, native
from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.combo import ShardRoutedChannel
from incubator_brpc_tpu_torch.client.controller import (
    Controller,
    acquire_controller,
    release_controller,
)
from incubator_brpc_tpu_torch.client.ring import fanout_log
from incubator_brpc_tpu_torch.models import parameter_server as port_ps
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.models.parameter_server import PsService, ps_stub
from incubator_brpc_tpu_torch.protocols.redis import KVRedisService
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest, EchoResponse
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
from incubator_brpc_tpu_torch.server.service import RAW_RESPONSE, rpc_method
from incubator_brpc_tpu_torch.transport.socket_map import get_socket_map
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint



# ---------------------------------------------------------------------------
# test_native_engine.py
# ---------------------------------------------------------------------------
@pytest.fixture
def native_server():
    srv = Server(ServerOptions(native_engine=True))
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    assert srv._native_engine is not None, "engine did not come up"
    yield srv
    srv.stop()


def _channel(port, **kw):
    opts = ChannelOptions(connection_type="native", timeout_ms=5000, **kw)
    ch = Channel(opts)
    assert ch.init(f"127.0.0.1:{port}") == 0
    assert ch.options.connection_type == "native"
    return ch


@pytest.mark.parametrize("client,server", [
    ("native", "native"),  # the C fast path at both ends
    ("single", "native"),  # the pure-Python channel against the engine
    ("native", "python"),  # the C client against the Python transport
])
def test_echo_between_client_and_server_transports(client, server):
    """The same tpu_std wire at every pairing: replies, codes and a
    measured latency."""
    srv = Server(ServerOptions(native_engine=server == "native"))
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    assert (srv._native_engine is not None) == (server == "native")
    ch = Channel(ChannelOptions(connection_type=client, timeout_ms=5000))
    try:
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        assert ch.options.connection_type == client
        stub = echo_stub(ch)
        for i in range(5):
            c = Controller()
            r = stub.Echo(c, EchoRequest(message=f"{client}-{server}-{i}", code=i))
            assert not c.failed(), c.error_text()
            assert r.message == f"{client}-{server}-{i}" and r.code == i
            assert c.latency_us > 0
    finally:
        ch.close()
        srv.stop()


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_native_timeout(native_server, mode):
    """sleep_us beyond the deadline → ERPCTIMEDOUT via the Python
    fallback path (sleep is a fault-injection field), on the sync path
    and on the mux reactor's async path."""
    ch = _channel(native_server.port)
    stub = echo_stub(ch)
    c = Controller()
    if mode == "sync":
        c.timeout_ms = 200
        stub.Echo(c, EchoRequest(message="slow", sleep_us=800_000))
    else:
        ev = threading.Event()
        c.timeout_ms = 150
        stub.Echo(c, EchoRequest(message="slow", sleep_us=900_000), done=ev.set)
        assert ev.wait(5)
    assert c.failed()
    assert c.error_code == errors.ERPCTIMEDOUT
    ch.close()


def test_native_attachment_roundtrip(native_server):
    ch = _channel(native_server.port)
    stub = echo_stub(ch)
    c = Controller()
    c.request_attachment.append(b"A" * 70000)
    r = stub.Echo(c, EchoRequest(message="att"))
    assert not c.failed(), c.error_text()
    assert r.message == "att"
    assert c.response_attachment.to_bytes() == b"A" * 70000
    ch.close()


def test_native_fallback_fault_injection(native_server):
    """server_fail forces the C++ engine off the fast path and through
    the Python handler, which must still answer on the same conn."""
    ch = _channel(native_server.port)
    stub = echo_stub(ch)
    c = Controller()
    stub.Echo(c, EchoRequest(message="x", server_fail=errors.EINTERNAL))
    assert c.failed()
    assert c.error_code == errors.EINTERNAL
    # connection still usable for fast-path calls afterwards
    c2 = Controller()
    r2 = stub.Echo(c2, EchoRequest(message="after-fallback"))
    assert not c2.failed(), c2.error_text()
    assert r2.message == "after-fallback"
    ch.close()


def test_native_fallback_unknown_method(native_server):
    """Unknown service name → Python fallback → ENOSERVICE surfaces."""
    from incubator_brpc_tpu_torch.server.service import MethodSpec
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoResponse

    ch = _channel(native_server.port)
    spec = MethodSpec("NoSuchService", "Echo", EchoRequest, EchoResponse)
    c = Controller()
    resp = EchoResponse()
    ch.call_method(spec, c, EchoRequest(message="x"), resp)
    assert c.failed()
    assert c.error_code == errors.ENOSERVICE
    ch.close()


def test_native_concurrent_threads(native_server):
    ch = _channel(native_server.port)
    stub = echo_stub(ch)
    fails = []
    N, T = 800, 8

    def worker(tid):
        for i in range(N // T):
            c = Controller()
            r = stub.Echo(c, EchoRequest(message=f"t{tid}-{i}"))
            if c.failed() or r.message != f"t{tid}-{i}":
                fails.append((tid, i, c.error_text()))

    ts = [threading.Thread(target=worker, args=(t,)) for t in range(T)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not fails, fails[:3]
    ch.close()


def test_native_server_stop_frees_port(free_port):
    srv = Server(ServerOptions(native_engine=True))
    srv.add_service(EchoService())
    assert srv.start(free_port) == 0
    assert srv.port == free_port
    srv.stop()
    # port reusable after stop
    srv2 = Server(ServerOptions(native_engine=True))
    srv2.add_service(EchoService())
    assert srv2.start(free_port) == 0
    srv2.stop()


def test_native_client_compressed_response(native_server):
    """Handler-compressed responses decompress on the native client
    (the C layer surfaces meta.compress_type, Python decompresses)."""
    from incubator_brpc_tpu_torch.protocols.compress import COMPRESS_TYPE_GZIP
    from incubator_brpc_tpu_torch.server.service import Service, rpc_method
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoResponse

    class GzEcho(Service):
        SERVICE_NAME = "GzEchoService"

        @rpc_method(EchoRequest, EchoResponse)
        def Echo(self, controller, request, response, done):
            response.message = request.message
            controller.response_compress_type = COMPRESS_TYPE_GZIP
            done()

    assert native_server.add_service(GzEcho()) == 0
    ch = _channel(native_server.port)
    from incubator_brpc_tpu_torch.server.service import ServiceStub

    stub = ServiceStub(ch, GzEcho)
    c = Controller()
    r = stub.Echo(c, EchoRequest(message="compress-me " * 50))
    assert not c.failed(), c.error_text()
    assert r.message == "compress-me " * 50
    ch.close()


def test_native_async_done_callback(native_server):
    """Async RPC over the mux reactor: done runs, response filled."""
    ch = _channel(native_server.port)
    stub = echo_stub(ch)
    evs = []
    ctrls = []
    for i in range(20):
        ev = threading.Event()
        c = Controller()
        r = stub.Echo(c, EchoRequest(message=f"async-{i}"), done=ev.set)
        evs.append((ev, c, r, f"async-{i}"))
        ctrls.append(c)
    for ev, c, r, want in evs:
        assert ev.wait(5), "done never ran"
        assert not c.failed(), c.error_text()
        assert r.message == want
        assert c.latency_us > 0
    ch.close()


def test_native_press_tool(native_server):
    """tools/rpc_press --native path: native load gen vs native server."""
    from incubator_brpc_tpu_torch.tools.rpc_press import press_native

    out = []
    r = press_native(
        f"127.0.0.1:{native_server.port}", concurrency=2,
        duration_s=0.5, payload_len=512, report=out.append,
    )
    assert r is not None and r["ok"] > 0 and r["failed"] == 0, (r, out)
    assert r["p50_us"] > 0


def test_rpc_press_paced_mode_against_the_engine(native_server):
    """tests/test_http_builtin.py's rpc_press case, the Python (paced)
    mode of the copied tool, against a native server."""
    from incubator_brpc_tpu_torch.tools.rpc_press import press

    out = []
    result = press(f"127.0.0.1:{native_server.port}", "EchoService", "Echo",
                   '{"message": "press"}', qps=200, duration_s=1.0, threads=2,
                   report=out.append)
    assert result is not None and result["errors"] == 0 and result["sent"] > 50, out


def test_parallel_http_fetches_the_engines_builtin_pages(native_server, tmp_path):
    """tests/test_http_builtin.py's parallel_http case against a native
    server: the builtin pages ride the engine's HTTP fallback."""
    from incubator_brpc_tpu_torch.tools.parallel_http import fetch_all

    port = native_server.port
    urls = [f"127.0.0.1:{port}/{p}" for p in ["health", "version", "vars"]]
    urls.append("127.0.0.1:1/health")  # refused: failure accounting
    results, stats = fetch_all(urls, concurrency=2, output_dir=str(tmp_path / "out"),
                               report=lambda *_: None)
    assert all(ok for url, (ok, _) in results.items() if ":1/" not in url)
    assert results["127.0.0.1:1/health"][0] is False
    assert stats.ok == 3 and stats.failed == 1 and stats.status_counts.get(200) == 3
    assert stats.percentile(0.5) > 0 and stats.bytes > 0
    assert len(list((tmp_path / "out").iterdir())) == 3


def test_native_engine_over_uds(tmp_path):
    """Native engine on a unix-domain socket (UDS is first-class in the
    reference's EndPoint); ~2x loopback TCP on this box."""
    from incubator_brpc_tpu_torch.utils.endpoint import EndPoint

    path = str(tmp_path / "native.sock")
    srv = Server(ServerOptions(native_engine=True))
    srv.add_service(EchoService())
    assert srv.start(EndPoint.uds(path)) == 0
    assert srv._native_engine is not None
    try:
        pool = native.NativeClientPool(path, 0)
        req = EchoRequest(message="uds").SerializeToString()
        rc, body, att, ec, et, ct = pool.call(
            "EchoService", "Echo", req, timeout_ms=3000
        )
        assert rc == 0 and ec == 0
        from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoResponse

        resp = EchoResponse()
        resp.ParseFromString(body)
        assert resp.message == "uds"
        pool.destroy()
    finally:
        srv.stop()


def test_native_generic_method_dispatch(tmp_path):
    """The native dispatch is generic (engine.cpp NativeMethod): any
    registered handler — here a ctypes callback — answers on the C++
    frame cycle via the same registry as the built-in echo, and
    unregistered methods on the same service still fall back to the
    full Python stack."""
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoResponse
    from incubator_brpc_tpu_torch.server.service import Service, ServiceStub, rpc_method

    import ctypes

    calls = []

    def reverse_handler(user_data, req, req_len, att, att_len, resp_ctx):
        # parse EchoRequest, answer with the reversed message
        data = ctypes.string_at(req, req_len)
        r = EchoRequest()
        r.ParseFromString(data)
        if r.sleep_us:  # decline: exercise handler-driven fallback
            return -1
        calls.append(r.message)
        out = EchoResponse(message=r.message[::-1]).SerializeToString()
        native.NativeServerEngine.resp_append_payload(resp_ctx, out)
        if att_len:
            native.NativeServerEngine.resp_append_attachment(
                resp_ctx, ctypes.string_at(att, att_len)
            )
        return 0

    class ReverseService(Service):
        SERVICE_NAME = "ReverseService"

        def native_fastpaths(self):
            return {"Echo": ("method", reverse_handler)}

        @rpc_method(EchoRequest, EchoResponse)
        def Echo(self, controller, request, response, done):
            # Python fallback (handler declines when sleep_us set)
            response.message = "py:" + request.message[::-1]
            done()

    srv = Server(ServerOptions(native_engine=True))
    srv.add_service(ReverseService())
    assert srv.start(0) == 0
    assert srv._native_engine is not None
    try:
        ch = _channel(srv.port)
        stub = ServiceStub(ch, ReverseService)
        c = Controller()
        c.request_attachment.append(b"ATT")
        r = stub.Echo(c, EchoRequest(message="generic"))
        assert not c.failed(), c.error_text()
        assert r.message == "cireneg"
        assert c.response_attachment.to_bytes() == b"ATT"
        assert calls == ["generic"]
        # handler declines → Python handler answers
        c2 = Controller()
        r2 = stub.Echo(c2, EchoRequest(message="fall", sleep_us=1))
        assert not c2.failed(), c2.error_text()
        assert r2.message == "py:llaf"
        ch.close()
    finally:
        srv.stop()


def test_native_fastpath_overload_shed_and_stats_harvest():
    """ServerOptions.method_max_concurrency is enforced ON the fast
    path (C++ gate → EOVERCROWDED, the admission code mapping's
    "retry elsewhere" shed — server/admission.py), and fast-path
    completions fold into MethodStatus via harvest_native_stats so
    /status sees the traffic."""
    import time as _t

    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoResponse
    from incubator_brpc_tpu_torch.server.service import Service, ServiceStub, rpc_method

    def slow_handler(user_data, req, req_len, att, att_len, resp_ctx):
        _t.sleep(0.4)  # releases the GIL: a second worker can reject in C++
        native.NativeServerEngine.resp_append_payload(
            resp_ctx, EchoResponse(message="slow").SerializeToString()
        )
        return 0

    class SlowService(Service):
        SERVICE_NAME = "SlowService"

        def native_fastpaths(self):
            return {"Echo": ("method", slow_handler)}

        @rpc_method(EchoRequest, EchoResponse)
        def Echo(self, controller, request, response, done):
            response.message = "py"
            done()

    srv = Server(
        ServerOptions(
            native_engine=True, method_max_concurrency=1, num_threads=2
        )
    )
    srv.add_service(SlowService())
    assert srv.start(0) == 0
    assert srv._native_engine is not None
    try:
        results = []

        def call(delay):
            _t.sleep(delay)
            ch = _channel(srv.port)  # own channel → own connection
            stub = ServiceStub(ch, SlowService)
            c = Controller()
            stub.Echo(c, EchoRequest(message="x"))
            results.append(c.error_code if c.failed() else 0)
            ch.close()

        ts = [
            threading.Thread(target=call, args=(d,)) for d in (0.0, 0.15)
        ]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert sorted(results) == [0, errors.EOVERCROWDED], results
        # harvest: MethodStatus now carries the fast-path completion +
        # the rejection as an error
        srv.harvest_native_stats()
        status = srv.method_status("SlowService.Echo")
        assert status.latency_rec.count() == 1
        assert status.errors.get_value() == 1
        # avg latency reflects the 400ms handler
        assert status.latency_rec.latency() > 100_000
    finally:
        srv.stop()


def test_native_channel_over_uds(tmp_path):
    """connection_type=native over a UDS endpoint uses the C engine's
    UDS pool/mux instead of silently degrading."""
    from incubator_brpc_tpu_torch.utils.endpoint import EndPoint

    path = str(tmp_path / "nch.sock")
    srv = Server(ServerOptions(native_engine=True))
    srv.add_service(EchoService())
    assert srv.start(EndPoint.uds(path)) == 0
    try:
        ch = Channel(ChannelOptions(connection_type="native", timeout_ms=5000))
        assert ch.init(f"unix:{path}") == 0
        assert ch.options.connection_type == "native"
        stub = echo_stub(ch)
        # sync path (multiplexed over the C mux reactor: nc_mux_call
        # parks the caller on a per-call waiter, no exclusive pooled fd)
        c = Controller()
        r = stub.Echo(c, EchoRequest(message="uds-native"))
        assert not c.failed(), c.error_text()
        assert r.message == "uds-native"
        assert ch._native_mux_obj is not None, "degraded off the C mux"
        # async (mux) path
        ev = threading.Event()
        c2 = Controller()
        r2 = stub.Echo(c2, EchoRequest(message="uds-async"), done=ev.set)
        assert ev.wait(5)
        assert not c2.failed(), c2.error_text()
        assert r2.message == "uds-async"
        assert ch._native_mux_obj is not None
        ch.close()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# test_fastpath_pool.py
# ---------------------------------------------------------------------------
@pytest.fixture()
def native_echo():
    srv = Server(ServerOptions(native_engine=True))
    srv.add_service(EchoService(attach_echo=True))
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=5000, connection_type="native"))
    ch.init(f"127.0.0.1:{srv.port}")
    stub = echo_stub(ch)
    yield srv, ch, stub
    srv.stop()
    ch.close()


def test_pool_reuse_no_bleed_success_then_success(native_echo):
    _, _, stub = native_echo
    c = acquire_controller()
    r1 = stub.Echo(c, EchoRequest(message="first"))
    assert not c.failed() and r1.message == "first"
    lat1 = c.latency_us
    assert lat1 >= 0
    release_controller(c)
    c2 = acquire_controller()
    # the pool is LIFO: c2 IS c, wiped
    assert c2 is c
    assert not c2.failed()
    assert c2.latency_us == 0  # class default restored
    assert c2.retry_count == 0
    assert c2.response_bytes is None
    r2 = stub.Echo(c2, EchoRequest(message="second"))
    assert not c2.failed() and r2.message == "second"
    release_controller(c2)


def test_pool_reuse_after_app_error(native_echo):
    _, _, stub = native_echo
    c = acquire_controller()
    stub.Echo(c, EchoRequest(message="boom", server_fail=1001))
    assert c.failed() and c.error_code == 1001
    assert "injected" in c.error_text()
    release_controller(c)
    c2 = acquire_controller()
    assert c2 is c
    assert not c2.failed() and c2.error_text() == ""
    r = stub.Echo(c2, EchoRequest(message="clean"))
    assert not c2.failed() and r.message == "clean"
    release_controller(c2)


def test_pool_reuse_after_timeout(native_echo):
    _, _, stub = native_echo
    c = acquire_controller()
    c.timeout_ms = 60  # server sleeps 10x longer → ERPCTIMEDOUT
    c.max_retry = 0
    stub.Echo(c, EchoRequest(message="slow", sleep_us=600_000))
    assert c.failed()
    from incubator_brpc_tpu_torch import errors

    assert c.error_code == errors.ERPCTIMEDOUT
    release_controller(c)
    c2 = acquire_controller()
    assert c2 is c
    # the per-call timeout/max_retry overrides must NOT survive reuse
    assert c2.timeout_ms is None and c2.max_retry is None
    r = stub.Echo(c2, EchoRequest(message="after-timeout"))
    assert not c2.failed() and r.message == "after-timeout"
    release_controller(c2)


def test_pool_reuse_attachment_does_not_bleed(native_echo):
    _, _, stub = native_echo
    c = acquire_controller()
    c.request_attachment.append(b"ATTACH")
    r = stub.Echo(c, EchoRequest(message="with-att"))
    assert not c.failed() and r.message == "with-att"
    assert c.response_attachment.to_bytes() == b"ATTACH"
    release_controller(c)
    c2 = acquire_controller()
    assert c2 is c
    # lazily-materialized IOBufs were wiped with the rest of the state
    assert "request_attachment" not in c2.__dict__
    assert "response_attachment" not in c2.__dict__
    r = stub.Echo(c2, EchoRequest(message="no-att"))
    assert not c2.failed()
    assert len(c2.response_attachment) == 0
    release_controller(c2)


def test_bytes_mode_round_trip(native_echo):
    _, _, stub = native_echo
    packed = EchoRequest(message="bytes-mode").SerializeToString()
    c = acquire_controller()
    stub.Echo(c, packed, response=RAW_RESPONSE)
    assert not c.failed()
    resp = EchoResponse()
    resp.ParseFromString(c.response_bytes)
    assert resp.message == "bytes-mode"
    release_controller(c)
    # response_bytes does not bleed into the next pooled call
    c2 = acquire_controller()
    assert c2.response_bytes is None
    release_controller(c2)


def test_bytes_mode_matches_pb_mode(native_echo):
    _, _, stub = native_echo
    msg = "parity" * 100
    packed = EchoRequest(message=msg).SerializeToString()
    c1 = Controller()
    r1 = stub.Echo(c1, EchoRequest(message=msg))
    c2 = Controller()
    stub.Echo(c2, packed, response=RAW_RESPONSE)
    assert not c1.failed() and not c2.failed()
    r2 = EchoResponse()
    r2.ParseFromString(c2.response_bytes)
    assert r1.message == r2.message == msg


def test_pooled_response_object_fully_replaced(native_echo):
    _, _, stub = native_echo
    resp = EchoResponse()
    c = Controller()
    stub.Echo(c, EchoRequest(message="long-first-message"), response=resp)
    assert resp.message == "long-first-message"
    c2 = Controller()
    stub.Echo(c2, EchoRequest(message="2nd"), response=resp)
    # ParseFromString clears before parsing: no residue of the longer
    # first message survives in the reused object
    assert resp.message == "2nd"


def test_recorder_counts_native_sync_calls_lazily(native_echo):
    _, ch, stub = native_echo
    rec = ch.latency_recorder()
    base = rec.count()
    n = 25
    for i in range(n):
        c = acquire_controller()
        stub.Echo(c, EchoRequest(message=f"m{i}"))
        assert not c.failed()
        release_controller(c)
    # no per-call Python recorder work happened; the read triggers the
    # lazy pull from the C mux atomics
    assert rec.count() >= base + n
    assert rec.latency() >= 0


def test_async_done_with_pooled_controller(native_echo):
    _, _, stub = native_echo
    fin = threading.Event()
    got = {}

    c = acquire_controller()

    def d():
        got["failed"] = c.failed()
        got["lat"] = c.latency_us
        release_controller(c)
        fin.set()

    stub.Echo(c, EchoRequest(message="async-pooled"), done=d)
    assert fin.wait(10)
    assert got["failed"] is False
    assert got["lat"] >= 0


def test_pool_concurrent_churn(native_echo):
    """Many threads acquiring/releasing concurrently never observe
    another call's state (the release wipe happens before pooling)."""
    _, _, stub = native_echo
    errors_seen = []

    def worker(tid):
        try:
            for i in range(40):
                c = acquire_controller()
                assert not c.failed() and c.latency_us == 0
                msg = f"t{tid}-{i}"
                r = stub.Echo(c, EchoRequest(message=msg))
                assert not c.failed(), c.error_text()
                assert r.message == msg
                release_controller(c)
        except Exception as e:  # noqa: BLE001
            errors_seen.append(repr(e))

    ts = [threading.Thread(target=worker, args=(t,)) for t in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not errors_seen, errors_seen


# ---------------------------------------------------------------------------
# test_connection_types.py
# ---------------------------------------------------------------------------
def start_server(**opts):
    srv = Server(ServerOptions(**opts)) if opts else Server()
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    return srv


class _GatedEchoService(EchoService):
    """Echo that parks each request's done() until release().

    Lets the pooled-connection test read connection_count() while all N
    RPCs are *provably* in flight, instead of racing a wall-clock sleep
    against server-side sleeps (the old flake).
    """

    SERVICE_NAME = "EchoService"

    def __init__(self, expected: int):
        super().__init__()
        self._expected = expected
        self._lock = threading.Lock()
        self._parked = []
        self._open = False  # after release(), requests answer at once
        self.all_in = threading.Event()

    def native_fastpaths(self):
        return {}  # the gate only exists on the Python handler path

    @rpc_method(EchoRequest, EchoResponse)
    def Echo(self, controller, request, response, done):
        response.message = request.message
        with self._lock:
            if self._open:
                done()
                return
            self._parked.append(done)
            if len(self._parked) >= self._expected:
                self.all_in.set()
        # done() runs later, from release() — async completion is part
        # of the handler contract (server/service.py)

    def release(self):
        with self._lock:
            self._open = True
            parked, self._parked = self._parked, []
        for done in parked:
            done()


def test_http_defaults_to_pooled_and_uses_distinct_connections():
    n = 4
    gate = _GatedEchoService(n)
    srv = Server()
    srv.add_service(gate)
    assert srv.start(0) == 0
    try:
        ch = Channel(ChannelOptions(protocol="http", timeout_ms=8000))
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        assert ch.options.connection_type == "pooled"  # adaptive default
        stub = echo_stub(ch)
        results = [None] * n

        def call(i):
            c = Controller()
            r = stub.Echo(c, EchoRequest(message=f"p{i}"))
            results[i] = (c.failed(), getattr(r, "message", None))

        ts = [threading.Thread(target=call, args=(i,)) for i in range(n)]
        for t in ts:
            t.start()
        # deterministic rendezvous: the server holds every request until
        # all n are simultaneously in the handler
        assert gate.all_in.wait(10), "requests never all arrived"
        concurrent_conns = srv.connection_count()
        gate.release()
        for t in ts:
            t.join(10)
        for i, (failed, msg) in enumerate(results):
            assert (failed, msg) == (False, f"p{i}"), results
        # N concurrent pooled RPCs => N concurrent server connections
        assert concurrent_conns >= n, concurrent_conns
        # clean sockets went back to the free list for reuse
        ep = EndPoint.tcp("127.0.0.1", srv.port)
        assert get_socket_map().pooled_count(ep, ch._signature()) >= n - 1
        # reuse: next RPC should not grow the pool
        before = get_socket_map().pooled_count(ep, ch._signature())
        c = Controller()
        assert stub.Echo(c, EchoRequest(message="again")).message == "again"
        after = get_socket_map().pooled_count(ep, ch._signature())
        assert after == before  # borrowed and returned, no new connect
    finally:
        srv.stop()


def test_short_connection_closes_after_rpc():
    srv = start_server()
    try:
        ch = Channel(
            ChannelOptions(timeout_ms=5000, connection_type="short")
        )
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        stub = echo_stub(ch)
        for i in range(3):
            c = Controller()
            r = stub.Echo(c, EchoRequest(message=f"s{i}"))
            assert not c.failed(), c.error_text()
            assert r.message == f"s{i}"
        time.sleep(0.3)  # server notices the closes
        assert srv.connection_count() == 0
    finally:
        srv.stop()


def test_connect_timeout_ms_is_honored():
    # RFC 5737 TEST-NET address: guaranteed unroutable
    ch = Channel(ChannelOptions(timeout_ms=10_000, connect_timeout_ms=300,
                                max_retry=0))
    assert ch.init("192.0.2.1:80") == 0
    stub = echo_stub(ch)
    c = Controller()
    t0 = time.monotonic()
    stub.Echo(c, EchoRequest(message="x"))
    elapsed = time.monotonic() - t0
    assert c.failed()
    assert c.error_code == errors.EFAILEDSOCKET, c.error_code
    assert elapsed < 3.0, f"connect_timeout_ms ignored: {elapsed:.1f}s"


def test_internal_port_serves_builtins_public_denies():
    srv = start_server(internal_port=0)
    try:
        assert srv.internal_port > 0
        # builtin page on the internal port: OK
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.internal_port}/vars", timeout=5
        ).read()
        assert body
        # same page on the public port: denied
        try:
            resp = urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/vars", timeout=5
            )
            status = resp.status
        except urllib.error.HTTPError as e:
            status = e.code
        assert status == 403, status
        # pb services stay on the public port only
        ch = Channel(ChannelOptions(timeout_ms=5000))
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        c = Controller()
        assert echo_stub(ch).Echo(c, EchoRequest(message="pub")).message == "pub"
    finally:
        srv.stop()


def test_idle_connection_reaper():
    srv = start_server(idle_timeout_sec=1)
    try:
        ch = Channel(ChannelOptions(timeout_ms=5000))
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        c = Controller()
        assert echo_stub(ch).Echo(c, EchoRequest(message="hi")).message == "hi"
        # under suite load >1s can stall between the echo and this read,
        # in which case the reaper has ALREADY fired — the behavior under
        # test, just early; only a count that never drains is a failure
        assert srv.connection_count() <= 1
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and srv.connection_count() > 0:
            time.sleep(0.1)
        assert srv.connection_count() == 0, "idle connection never reaped"
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# test_native_multiproto.py
# ---------------------------------------------------------------------------
@pytest.fixture()
def multiproto_server():
    srv = Server(
        ServerOptions(native_engine=True, redis_service=KVRedisService())
    )
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    yield srv
    srv.stop()


@pytest.fixture()
def multiproto_server_inline():
    """usercode_in_dispatcher=True: Python fallback frames are handled
    INLINE in the engine's dispatch callback, so the fallback reply is
    written before the dispatch returns — the worst possible ordering
    pressure against natively-answered neighbours, deterministically."""
    srv = Server(
        ServerOptions(
            native_engine=True,
            redis_service=KVRedisService(),
            usercode_in_dispatcher=True,
        )
    )
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    yield srv
    srv.stop()


def _redis_conn(port):
    s = socket.create_connection(("127.0.0.1", port), timeout=5)

    def cmd(*parts):
        out = b"*%d\r\n" % len(parts)
        for p in parts:
            out += b"$%d\r\n%s\r\n" % (len(p), p)
        s.sendall(out)
        deadline = time.monotonic() + 5
        data = b""
        while time.monotonic() < deadline:
            data += s.recv(65536)
            if data.endswith(b"\r\n"):
                return data
        raise TimeoutError(data)

    return s, cmd


def test_native_http_echo_and_python_fallback(multiproto_server):
    port = multiproto_server.port
    # native raw echo (C framer + C handler)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/EchoService/Echo.raw",
        data=b"raw-body-echo",
        method="POST",
    )
    assert urllib.request.urlopen(req, timeout=5).read() == b"raw-body-echo"
    # pb/JSON semantic route falls back to the Python http stack
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/EchoService/Echo",
        data=json.dumps({"message": "py-route"}).encode(),
        headers={"Content-Type": "application/json"},
    )
    r = json.loads(urllib.request.urlopen(req, timeout=5).read())
    assert r.get("message") == "py-route"
    # builtin observability pages are reachable on the same port
    page = urllib.request.urlopen(
        f"http://127.0.0.1:{port}/status", timeout=5
    ).read().decode()
    assert "server:" in page


def test_native_redis_kv_and_fallback(multiproto_server):
    s, cmd = _redis_conn(multiproto_server.port)
    try:
        assert cmd(b"PING") == b"+PONG\r\n"
        assert cmd(b"SET", b"k", b"v") == b"+OK\r\n"
        assert cmd(b"GET", b"k") == b"$1\r\nv\r\n"
        assert cmd(b"INCR", b"n") == b":1\r\n"
        assert cmd(b"INCR", b"n") == b":2\r\n"
        assert cmd(b"EXISTS", b"k") == b":1\r\n"
        assert cmd(b"DEL", b"k") == b":1\r\n"
        assert cmd(b"GET", b"k") == b"$-1\r\n"
        # unknown command reaches the Python RedisService (which
        # answers -ERR for commands it doesn't implement)
        assert cmd(b"ECHO", b"x").startswith(b"-ERR")
    finally:
        s.close()


def test_redis_pipelined_batch(multiproto_server):
    """A burst of pipelined commands cuts and answers in order."""
    s = socket.create_connection(
        ("127.0.0.1", multiproto_server.port), timeout=5
    )
    try:
        batch = b""
        for i in range(50):
            k = b"pk%d" % i
            batch += b"*3\r\n$3\r\nSET\r\n$%d\r\n%s\r\n$2\r\nvv\r\n" % (
                len(k), k,
            )
        s.sendall(batch)
        want = b"+OK\r\n" * 50
        got = b""
        deadline = time.monotonic() + 5
        while len(got) < len(want) and time.monotonic() < deadline:
            got += s.recv(65536)
        assert got == want
    finally:
        s.close()


def test_tpu_std_coexists_on_multiproto_port(multiproto_server):
    ch = Channel(ChannelOptions(timeout_ms=3000, connection_type="native"))
    ch.init(f"127.0.0.1:{multiproto_server.port}")
    stub = echo_stub(ch)
    c = Controller()
    r = stub.Echo(c, EchoRequest(message="tpu-std"))
    assert not c.failed() and r.message == "tpu-std"
    ch.close()


def test_http_connection_close_honored_on_native_path(multiproto_server):
    """Connection: close on a natively-answered request closes after
    the response has fully left."""
    s = socket.create_connection(
        ("127.0.0.1", multiproto_server.port), timeout=5
    )
    try:
        s.sendall(
            b"POST /EchoService/Echo.raw HTTP/1.1\r\nHost: x\r\n"
            b"Connection: close\r\nContent-Length: 3\r\n\r\nabc"
        )
        data = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
        assert b"HTTP/1.1 200" in data and data.endswith(b"abc")
    finally:
        s.close()


def test_garbage_on_multiproto_port_is_dropped(multiproto_server):
    s = socket.create_connection(
        ("127.0.0.1", multiproto_server.port), timeout=5
    )
    try:
        s.sendall(b"NONSENSE\x00\x01\x02 protocol bytes\r\n\r\n")
        s.settimeout(5)
        assert s.recv(4096) == b""  # engine closes the connection
    finally:
        s.close()


def test_native_http_bench_generator(multiproto_server):
    h = native.bench_http(
        "127.0.0.1", multiproto_server.port, "/EchoService/Echo.raw",
        1024, concurrency=1, duration_ms=400, depth=8,
    )
    assert h["failed"] == 0 and h["ok"] > 100


def test_native_redis_bench_generator(multiproto_server):
    r = native.bench_redis(
        "127.0.0.1", multiproto_server.port, 32, concurrency=1,
        duration_ms=400, depth=8,
    )
    assert r["failed"] == 0 and r["ok"] > 100


def test_redis_reply_order_native_and_fallback_interleaved(
    multiproto_server_inline,
):
    """RESP replies must arrive in command order even when a command
    answered by the Python fallback is pipelined between natively-
    answered ones — the engine flushes the accumulated native burst
    BEFORE dispatching (engine.cpp flush_pending_burst) and pauses
    cutting until Python replies (ns_py_done).

    Deterministic: the inline-dispatcher server answers
    the fallback command synchronously INSIDE the dispatch callback,
    so with the pre-dispatch flush missing, the fallback reply would
    ALWAYS overtake the unflushed native +OK — no timing luck."""
    s = socket.create_connection(
        ("127.0.0.1", multiproto_server_inline.port), timeout=5
    )
    try:
        def enc(*parts):
            out = b"*%d\r\n" % len(parts)
            for p in parts:
                out += b"$%d\r\n%s\r\n" % (len(p), p)
            return out

        # native SET, fallback (unknown opt → python errors or handles),
        # native GET — one write, strictly ordered replies expected
        batch = (
            enc(b"SET", b"ok1", b"a")          # native +OK
            + enc(b"ECHO", b"mid")             # python fallback -ERR
            + enc(b"SET", b"ok2", b"b")        # native +OK
            + enc(b"GET", b"ok1")              # native $1 a
        )
        s.sendall(batch)
        got = b""
        deadline = time.monotonic() + 8
        while got.count(b"\r\n") < 4 and time.monotonic() < deadline:
            got += s.recv(65536)
        lines = got.split(b"\r\n")
        assert lines[0] == b"+OK", got
        assert lines[1].startswith(b"-ERR"), got
        assert lines[2] == b"+OK", got
        assert lines[3] == b"$1" and lines[4] == b"a", got
    finally:
        s.close()


def test_mixed_protocol_churn_stress(multiproto_server):
    """Concurrency/lifetime stress: several threads churn short-lived
    HTTP (native + Python-fallback routes), pipelined redis, and
    tpu_std connections against one port.  Guards the pause/resume and
    close paths that produced a use-after-free when a resumed
    connection's close raced a same-batch epoll event."""
    import threading

    port = multiproto_server.port
    errors_seen = []

    def http_churn():
        try:
            for k in range(25):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/EchoService/Echo.raw",
                    data=b"x" * 512, method="POST",
                )
                assert urllib.request.urlopen(req, timeout=10).read() == b"x" * 512
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/EchoService/Echo",
                    data=json.dumps({"message": f"c{k}"}).encode(),
                    headers={"Content-Type": "application/json"},
                )
                urllib.request.urlopen(req, timeout=10).read()
        except Exception as e:  # noqa: BLE001
            errors_seen.append(repr(e))

    def redis_churn():
        try:
            for _ in range(10):
                s = socket.create_connection(("127.0.0.1", port), timeout=10)
                batch = b""
                for i in range(20):
                    k = b"sk%d" % i
                    batch += b"*3\r\n$3\r\nSET\r\n$%d\r\n%s\r\n$1\r\nv\r\n" % (
                        len(k), k,
                    )
                s.sendall(batch)
                want = 20 * len(b"+OK\r\n")
                got = b""
                while len(got) < want:
                    chunk = s.recv(65536)
                    if not chunk:
                        raise ConnectionError("redis conn died")
                    got += chunk
                s.close()
        except Exception as e:  # noqa: BLE001
            errors_seen.append(repr(e))

    def tpu_churn():
        try:
            ch = Channel(
                ChannelOptions(timeout_ms=10000, connection_type="native")
            )
            ch.init(f"127.0.0.1:{port}")
            stub = echo_stub(ch)
            for k in range(100):
                c = Controller()
                r = stub.Echo(c, EchoRequest(message=f"s{k}"))
                assert not c.failed() and r.message == f"s{k}", c.error_text()
            ch.close()
        except Exception as e:  # noqa: BLE001
            errors_seen.append(repr(e))

    threads = [
        threading.Thread(target=f)
        for f in (http_churn, http_churn, redis_churn, tpu_churn)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    # a DEADLOCK regression would leave a thread alive with no error —
    # that must fail here, not wedge pytest at exit
    assert not any(t.is_alive() for t in threads), "churn thread hung"
    assert not errors_seen, errors_seen


@pytest.mark.parametrize(
    "payload",
    [
        # HTTP-ish garbage
        b"POST / HTTP/1.1\r\nContent-Length: 18446744073709551626\r\n\r\n",
        b"POST / HTTP/1.1\r\nContent-Length: -5\r\n\r\n",
        b"POST / HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\nZZ\r\n",
        b"POST / HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n"
        b"ffffffffffffffff\r\n",
        b"GET  HTTP/1.1\r\n\r\n",  # malformed request line
        b"POST " + b"/" * 70000,  # oversized header, no terminator
        # HTTP/1.0 corpus (keep-alive semantics must not confuse the
        # framer whatever the version token looks like)
        b"POST / HTTP/1.0\r\nContent-Length: 18446744073709551626\r\n\r\n",
        b"GET / HTTP/1.0\r\nConnection: keep-alive\r\nConnection: close\r\n\r\n",
        b"GET / HTTP/9.9\r\n\r\n",
        b"GET / HTTP/1.0",  # truncated before CRLF, then closed
        # RESP garbage
        b"*abc\r\n",
        b"*2\r\n$3\r\nGET\r\n:5\r\n",  # non-bulk element
        b"*1\r\n$99999999999999999\r\n",  # absurd bulk length
        b"*2\r\n$3\r\nGET\r\n$3\r\nxy",  # truncated then closed
        # sniff confusion
        b"TRP",  # tpu_std magic prefix, then nothing
        b"\x00\x01\x02\x03garbage",
    ],
)
def test_native_framers_survive_hostile_bytes(multiproto_server, payload):
    """The C framers must kill (or starve) a hostile connection without
    crashing the engine; the port must keep serving afterwards.  Reuses
    test_robustness's hardened blast helper — the engine closing (even
    mid-send) IS a valid response to garbage."""
    from tests.test_robustness import _blast

    port = multiproto_server.port
    _blast(port, payload)
    # engine alive: a clean request on a NEW connection still answers
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/EchoService/Echo.raw",
        data=b"still-alive", method="POST",
    )
    assert urllib.request.urlopen(req, timeout=5).read() == b"still-alive"


def _http10_exchange(port, request: bytes, expect_close: bool):
    """Send one raw request; read one full response; return (response,
    connection_closed_after)."""
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    try:
        s.sendall(request)
        s.settimeout(5)
        data = b""
        # read until the full body (responses here are tiny echoes)
        while b"\r\n\r\n" not in data:
            chunk = s.recv(65536)
            if not chunk:
                return data, True
            data += chunk
        head, _, body = data.partition(b"\r\n\r\n")
        cl = 0
        for line in head.split(b"\r\n"):
            if line.lower().startswith(b"content-length:"):
                cl = int(line.split(b":", 1)[1])
        while len(body) < cl:
            chunk = s.recv(65536)
            if not chunk:
                return data, True
            body += chunk
        # now probe whether the server closes: on keep-alive this recv
        # times out; on close it returns b""
        s.settimeout(1.5)
        try:
            closed = s.recv(4096) == b""
        except socket.timeout:
            closed = False
        return head + b"\r\n\r\n" + body, closed
    finally:
        s.close()


def test_http10_defaults_to_close_on_native_path(multiproto_server):
    """HTTP/1.0 without Connection: keep-alive must close after the
    response (RFC 1945: 1.0 clients detect end-of-body by EOF)."""
    resp, closed = _http10_exchange(
        multiproto_server.port,
        b"POST /EchoService/Echo.raw HTTP/1.0\r\nHost: x\r\n"
        b"Content-Length: 5\r\n\r\nhello",
        expect_close=True,
    )
    assert resp.startswith(b"HTTP/1.1 200") and resp.endswith(b"hello")
    assert b"Connection: close" in resp
    assert closed, "HTTP/1.0 connection stayed open without keep-alive"


def test_http10_keep_alive_optin_honored(multiproto_server):
    """HTTP/1.0 + Connection: keep-alive keeps the connection open and
    serves a second pipelined request."""
    s = socket.create_connection(
        ("127.0.0.1", multiproto_server.port), timeout=5
    )
    try:
        req = (
            b"POST /EchoService/Echo.raw HTTP/1.0\r\nHost: x\r\n"
            b"Connection: keep-alive\r\nContent-Length: 3\r\n\r\nabc"
        )
        s.sendall(req + req)  # two requests, one connection
        s.settimeout(5)
        data = b""
        deadline = time.monotonic() + 5
        while data.count(b"HTTP/1.1 200") < 2 and time.monotonic() < deadline:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
        assert data.count(b"HTTP/1.1 200") == 2, data
        assert data.endswith(b"abc")
    finally:
        s.close()


def test_http11_default_keep_alive_unchanged(multiproto_server):
    """HTTP/1.1 without a Connection header still keeps alive."""
    _, closed = _http10_exchange(
        multiproto_server.port,
        b"POST /EchoService/Echo.raw HTTP/1.1\r\nHost: x\r\n"
        b"Content-Length: 2\r\n\r\nok",
        expect_close=False,
    )
    assert not closed, "HTTP/1.1 default keep-alive regressed"


def test_http_reply_order_native_and_fallback_interleaved(
    multiproto_server_inline,
):
    """Pipelined HTTP: a natively-answered request followed by a
    Python-fallback request (and another native one) must reply in
    request order — the engine flushes the native burst before
    dispatching and pauses the connection until ns_py_done.  The
    inline dispatcher makes the would-be race deterministic."""
    port = multiproto_server_inline.port
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        native_req = (
            b"POST /EchoService/Echo.raw HTTP/1.1\r\nHost: x\r\n"
            b"Content-Length: 4\r\n\r\nNAT1"
        )
        py_req = (
            b"POST /EchoService/Echo HTTP/1.1\r\nHost: x\r\n"
            b"Content-Type: application/json\r\n"
            b"Content-Length: 17\r\n\r\n" + b'{"message":"PY1"}'
        )
        native_req2 = (
            b"POST /EchoService/Echo.raw HTTP/1.1\r\nHost: x\r\n"
            b"Content-Length: 4\r\n\r\nNAT2"
        )
        s.sendall(native_req + py_req + native_req2)
        s.settimeout(10)
        data = b""
        deadline = time.monotonic() + 10
        while data.count(b"HTTP/1.1 200") < 3 and time.monotonic() < deadline:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
        assert data.count(b"HTTP/1.1 200") == 3, data
        # strict order: NAT1's body precedes PY1's, which precedes NAT2's
        i_nat1 = data.find(b"NAT1")
        i_py = data.find(b'"message": "PY1"') 
        if i_py < 0:
            i_py = data.find(b"PY1")
        i_nat2 = data.find(b"NAT2")
        assert 0 <= i_nat1 < i_py < i_nat2, data
    finally:
        s.close()


# ---------------------------------------------------------------------------
# what the port adds: the two packages' engines side by side, a PS
# Forward through the engine, the build and the raise
# ---------------------------------------------------------------------------

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_torch_batching.py's f32 Forward tolerance: |y - ref| <=
# FWD_RTOL * (|x| @ |W|) + FWD_ATOL, the reference the JAX package's y
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6

PKGS = {
    "port": dict(Server=Server, ServerOptions=ServerOptions, Channel=Channel,
                 ChannelOptions=ChannelOptions, Controller=Controller,
                 EchoService=EchoService, echo_stub=echo_stub, EchoRequest=EchoRequest,
                 ShardRoutedChannel=ShardRoutedChannel, fanout_log=fanout_log),
    "jax": dict(Server=JServer, ServerOptions=JServerOptions, Channel=JChannel,
                ChannelOptions=JChannelOptions, Controller=JController,
                EchoService=JEchoService, echo_stub=j_echo_stub, EchoRequest=JEchoRequest,
                ShardRoutedChannel=JShardRoutedChannel, fanout_log=j_fanout_log),
}


@pytest.fixture
def jax_engine():
    """The JAX package's engine, loaded in this process.  Its loader
    builds ``_engine.so`` through one shared temporary (its
    ``native/__init__.py:255``), so on a fresh checkout test workers
    that build at once can leave one worker without it, failed for the
    session; by the time a test here runs the winner's library is in
    place, and a second load of it is what the JAX loader itself would
    do in a new process."""
    if not jax_native.available():
        jax_native._lib_err = None
        jax_native._load()
    assert jax_native.available(), jax_native.unavailable_reason()
    return jax_native


def test_the_two_packages_load_their_own_engines(jax_engine):
    """One process holds both engines: separate libraries (ctypes loads
    each RTLD_LOCAL), separate extensions, never one sys.modules name."""
    assert native.available() and jax_native.available()
    port_lib, jax_lib = native._lib, jax_native._lib
    assert port_lib is not jax_lib and port_lib._name != jax_lib._name
    assert str(native.BUILD_DIR) in port_lib._name
    assert native.call_boundary() == ("fastcall", None)
    assert native._fastcall is not jax_native._fastcall
    assert sys.modules["incubator_brpc_tpu_torch.native._fastcall"] is native._fastcall
    assert sys.modules.get("_fastcall") is not native._fastcall
    for src in ("engine.cpp", "fastcall.c"):
        with open(os.path.join(ROOT, "incubator_brpc_tpu_torch", "native", src), "rb") as a, \
                open(os.path.join(ROOT, "incubator_brpc_tpu", "native", src), "rb") as b:
            assert a.read() == b.read(), src


def _interop_run(client, server):
    """One sync echo with an attachment, one call_many window of 24 and
    one 48-key shard window of two servers, client package `client`
    against server package `server`, all over their engines."""
    c_pkg, s_pkg = PKGS[client], PKGS[server]
    servers = []
    try:
        for _ in range(2):
            srv = s_pkg["Server"](s_pkg["ServerOptions"](native_engine=True))
            srv.add_service(s_pkg["EchoService"](attach_echo=True))
            assert srv.start(0) == 0 and srv._native_engine is not None
            servers.append(srv)
        ch = c_pkg["Channel"](c_pkg["ChannelOptions"](timeout_ms=5000, connection_type="native"))
        assert ch.init(f"127.0.0.1:{servers[0].port}") == 0
        stub = c_pkg["echo_stub"](ch)
        cntl = c_pkg["Controller"]()
        cntl.request_attachment.append(bytes(range(256)) * 64)
        r = stub.Echo(cntl, c_pkg["EchoRequest"](message="interop", code=7))
        assert not cntl.failed(), cntl.error_text()
        out = {"sync": r.SerializeToString(), "att": cntl.response_attachment.to_bytes()}
        reqs = [c_pkg["EchoRequest"](message=f"w{i}" * (i + 1)).SerializeToString()
                for i in range(24)]
        out["window"] = stub.call_many("Echo", reqs)
        ring = ch._ring_obj.counters()
        mux = ch._native_mux().ring_stats()
        out["ring"] = {k: ring[k] for k in ("submissions", "fallback_calls", "double_resolves")}
        out["mux"] = {k: mux[k] for k in ("windows", "calls", "completions")}
        ch.close()
        sh = c_pkg["ShardRoutedChannel"].from_endpoints(
            [f"127.0.0.1:{s.port}" for s in servers],
            channel_options=c_pkg["ChannelOptions"](timeout_ms=5000, connection_type="native"))
        log = c_pkg["fanout_log"]
        before = log.counters()
        out["shard"] = c_pkg["echo_stub"](sh).call_many(
            "Echo", [c_pkg["EchoRequest"](message=f"k{i}") for i in range(48)])
        after = log.counters()
        out["fanout"] = {k: after[k] - before[k] for k in ("windows", "crossings", "keys", "fallback_calls")}
        return out
    finally:
        for srv in servers:
            srv.stop()


@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port")])
def test_native_client_and_server_interoperate_across_packages(client, server, jax_engine):
    """A port native client against a JAX native server, and the reverse:
    replies byte-equal to the same-package pair's, the attachment round
    trip, and the client's ring and fan-out step logs equal for the same
    windows."""
    cross = _interop_run(client, server)
    same = _interop_run(client, client)
    assert cross["sync"] == same["sync"]
    assert cross["att"] == bytes(range(256)) * 64 == same["att"]
    assert all(isinstance(r, bytes) for r in cross["window"])
    assert cross["window"] == same["window"]
    assert cross["shard"] == same["shard"]
    assert cross["ring"] == same["ring"] == {"submissions": 24, "fallback_calls": 0,
                                             "double_resolves": 0}
    assert cross["mux"] == same["mux"] and cross["mux"]["calls"] == 24
    assert cross["mux"]["windows"] == 1 and cross["mux"]["completions"] == 24
    assert cross["fanout"] == same["fanout"] == {"windows": 1, "crossings": 2, "keys": 48,
                                                 "fallback_calls": 0}


class _CountingTorch:
    """Stands in for ``torch`` inside models/parameter_server.py: counts
    ``from_numpy`` (the Forward's one host stack handed to the device,
    so one upload a key-group) and delegates everything else."""

    def __init__(self):
        self.uploads = 0

    def from_numpy(self, a):
        self.uploads += 1
        return torch.from_numpy(a)

    def __getattr__(self, name):
        return getattr(torch, name)


def test_forward_through_the_engine_batches_and_equals_the_jax_package(monkeypatch, jax_engine):
    """Concurrent async Forwards over one native channel land in read
    bursts whose rows reach the Batcher as one submit_many each: every
    batch runs one upload, one product and one ps.forward-pull, and
    each y equals the JAX package's PsService on the same seeded x and W
    (the JAX server on its own engine) within the f32 tolerance."""
    from incubator_brpc_tpu_torch.analysis.device_witness import transfer_counts
    from incubator_brpc_tpu_torch.observability.profiling import kernel_snapshot

    d, n = 64, 24
    rng = np.random.RandomState(5)
    w = (rng.randn(d, d) / np.sqrt(d)).astype(np.float32)
    xs = rng.randn(n, d).astype(np.float32)
    counting = _CountingTorch()
    monkeypatch.setattr(port_ps, "torch", counting)
    bursts = []
    srv = Server(ServerOptions(native_engine=True, enable_batching=True))
    orig_end = srv._burst_end

    def recording_end():
        bursts.append(len(srv._burst_tls.rows or ()))
        orig_end()

    srv._burst_end = recording_end
    svc = PsService(device=CPU)
    svc.put_param("w", w)
    srv.add_service(svc)
    jsrv = JServer(JServerOptions(native_engine=True))
    jsvc = JPsService()
    jsvc.put_param("w", w)
    jsrv.add_service(jsvc)
    assert srv.start(0) == 0 and jsrv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=10000, connection_type="native"))
    jch = JChannel(JChannelOptions(timeout_ms=10000, connection_type="native"))
    try:
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        assert jch.init(f"127.0.0.1:{jsrv.port}") == 0
        b = srv.batcher("PsService.Forward")
        pulls0 = transfer_counts().get("ps.forward-pull", 0)
        execs0 = kernel_snapshot().get("ps.forward", {}).get("executions", 0)
        uploads0 = counting.uploads
        done = [threading.Event() for _ in range(n)]
        ctrls = []
        for i in range(n):
            c = Controller()
            c.timeout_ms = 10000
            c.request_attachment.append_user_data(xs[i].tobytes())
            ps_stub(ch).Forward(c, EchoRequest(message="w"), done=done[i].set)
            ctrls.append(c)
        assert all(e.wait(15) for e in done)
        ys = []
        for c in ctrls:
            assert not c.failed(), c.error_text()
            ys.append(np.frombuffer(c.response_attachment.to_bytes(), np.float32))
        ys = np.stack(ys)
        batches = b.batches
        assert b.rows == n and 1 <= batches < n, b.describe()
        assert counting.uploads - uploads0 == batches
        assert kernel_snapshot()["ps.forward"]["executions"] - execs0 == batches
        assert transfer_counts()["ps.forward-pull"] - pulls0 == batches
        # at least one read burst carried several rows into one submit_many
        assert bursts and max(bursts) > 1, bursts
        jys = []
        for i in range(n):
            c = JController()
            c.timeout_ms = 10000
            c.request_attachment.append_user_data(xs[i].tobytes())
            j_ps_stub(jch).Forward(c, JEchoRequest(message="w"))
            assert not c.failed(), c.error_text()
            jys.append(np.frombuffer(c.response_attachment.to_bytes(), np.float32))
        jys = np.stack(jys)
        scale = np.abs(xs) @ np.abs(w)
        assert np.all(np.abs(ys - jys) <= FWD_RTOL * scale + FWD_ATOL)
        assert np.all(np.abs(ys - xs.astype(np.float64) @ w) <= FWD_RTOL * scale + FWD_ATOL)
    finally:
        ch.close()
        jch.close()
        srv.stop()
        jsrv.stop()


def test_sharded_ps_keyed_get_window_crosses_once_per_shard():
    """sharded_ps_channel over native sub-channels: a call_many window
    of 32 keyed Gets crosses into C once per shard with no per-call
    fallback, and every reply carries the bytes its key's Put stored."""
    from incubator_brpc_tpu_torch.models.parameter_server import sharded_ps_channel

    servers, eps = [], []
    for _ in range(3):
        srv = Server(ServerOptions(native_engine=True, enable_batching=True))
        srv.add_service(PsService(device=CPU))
        assert srv.start(0) == 0
        servers.append(srv)
        eps.append(f"127.0.0.1:{srv.port}")
    try:
        sh = sharded_ps_channel(endpoints=eps, channel_options=ChannelOptions(
            timeout_ms=30000, connection_type="native"))
        stub = ps_stub(sh)
        keys = [f"key{i}" for i in range(32)]
        vals = {k: np.random.RandomState(i).randn(4, 16).astype(np.float32).tobytes()
                for i, k in enumerate(keys)}
        for k in keys:
            c = Controller()
            c.request_attachment.append(vals[k])
            stub.Put(c, EchoRequest(message=k))
            assert not c.failed(), c.error_text()
        before = fanout_log.counters()
        res = stub.call_many("Get", [EchoRequest(message=k) for k in keys])
        after = fanout_log.counters()
        shards = {sh.shard_of(k, len(eps)) for k in keys}
        assert after["crossings"] - before["crossings"] == len(shards) == 3
        assert after["fallback_calls"] == before["fallback_calls"]
        assert after["keys"] - before["keys"] == len(keys)
        assert [_msg_of(r) for r in res] == keys
        assert [r.attachment.to_bytes() for r in res] == [vals[k] for k in keys]
    finally:
        for srv in servers:
            srv.stop()


def _msg_of(b):
    r = EchoResponse()
    r.ParseFromString(b)
    return r.message


_NO_COMPILER = """
import sys
from incubator_brpc_tpu_torch import native
from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.models.echo import EchoService
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
srv = Server(ServerOptions(native_engine=True)); srv.add_service(EchoService())
try:
    srv.start(0)
except native.NativeEngineError as e:
    print("SERVER RAISED", str(e)[:200].replace("\\n", " "))
print("SERVING", srv.is_running())
try:
    Channel(ChannelOptions(connection_type="native")).init("127.0.0.1:1")
except native.NativeEngineError as e:
    print("CHANNEL RAISED", type(e).__name__)
print("AVAILABLE", native.available())
"""


def _fresh_package(tmp_path):
    """A copy of the port's package with no native build in it, for child
    interpreters that must build (or fail to build) from nothing."""
    dst = tmp_path / "fresh"
    shutil.copytree(os.path.join(ROOT, "incubator_brpc_tpu_torch"),
                    dst / "incubator_brpc_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    return dst


def test_no_compiler_raises_instead_of_serving_on_python(tmp_path):
    """With no compiler on PATH and nothing built, a native server and a
    native channel raise NativeEngineError naming the compiler's
    failure; neither serves on the Python transport."""
    root = _fresh_package(tmp_path)
    env = dict(os.environ, PATH="", PYTHONPATH=str(root))
    res = subprocess.run([sys.executable, "-c", _NO_COMPILER], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    out = res.stdout
    assert "SERVER RAISED native engine unavailable: g++ could not run" in out, out
    assert "SERVING False" in out and "CHANNEL RAISED NativeEngineError" in out, out
    assert "AVAILABLE False" in out, out


_BUILDER = """
import sys
from incubator_brpc_tpu_torch import native
from incubator_brpc_tpu_torch.models.echo import EchoService
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
native.require()
srv = Server(ServerOptions(native_engine=True)); srv.add_service(EchoService())
assert srv.start(0) == 0
r = native.bench_echo("127.0.0.1", srv.port, 256, concurrency=1, duration_ms=100)
srv.stop()
print("LOADED", native.engine_path().name, native.call_boundary()[0], r["ok"] > 0, r["failed"])
"""


def test_concurrent_first_builds_into_one_directory_all_load(tmp_path):
    """Four interpreters build the engine into one empty directory at
    once: each compiles into its own temporary and renames it into the
    hash-named target, so every one loads a whole library and serves;
    no temporary is left behind."""
    root = _fresh_package(tmp_path)
    build = root / "incubator_brpc_tpu_torch" / "native" / "_build"
    assert not build.exists()
    env = dict(os.environ, PYTHONPATH=str(root))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-2000:]
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    want = f"LOADED {native.engine_path().name} fastcall True 0"
    assert all(want in o for o in outs), outs
    names = sorted(f.name for f in build.iterdir())
    assert [n for n in names if n.endswith(".so")] == sorted(
        [native.engine_path().name, native.fastcall_path().name])
    assert not [n for n in names if n.endswith(".tmp")], names
