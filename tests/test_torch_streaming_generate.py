"""GenerateService / DecodeLoop — continuous-batched token streaming
(the streaming subsystem's flagship workload; mirrors the
_Scatter per-row invariants at the decode-step level).

Carried by hand from ``tests/test_streaming_generate.py``: each decode
loop is given the device the case runs on (the CPU, or the card), as the
port has no default device.  The cases ``tests/test_torch_serving.py``
already holds are not repeated here.
"""

import threading
import time

import pytest

from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.client.stream import Stream, StreamHandler
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server
from incubator_brpc_tpu_torch.streaming.generate import (
    DecodeLoop,
    GenerateService,
    generate_stub,
)

from torch_carry import torch_device  # noqa: F401  (fixture)


class TokenSink(StreamHandler):
    def __init__(self):
        self.tokens = []
        self.stamps = []
        self.closed = threading.Event()
        self.cv = threading.Condition()

    def on_received_messages(self, stream, messages):
        now = time.monotonic()
        with self.cv:
            for m in messages:
                self.tokens.append(m.to_bytes().decode())
                self.stamps.append(now)
            self.cv.notify_all()

    def on_closed(self, stream):
        self.closed.set()

    def wait_tokens(self, n, timeout=20):
        with self.cv:
            return self.cv.wait_for(lambda: len(self.tokens) >= n, timeout)


def _server(svc):
    srv = Server()
    srv.add_service(svc)
    assert srv.start(0) == 0
    return srv


def _channel(port):
    ch = Channel(ChannelOptions(timeout_ms=10000))
    assert ch.init(f"127.0.0.1:{port}") == 0
    return ch


def _start_stream(stub, prompt, n_tokens, sink=None):
    sink = sink or TokenSink()
    c = Controller()
    stream = Stream.create(c, sink)
    r = stub.Generate(c, EchoRequest(message=prompt, code=n_tokens))
    assert not c.failed(), c.error_text()
    assert r.message == "streaming"
    assert stream.wait_established(5)
    return stream, sink


# ---- RPC level --------------------------------------------------------------


@pytest.fixture
def gen_server(torch_device):
    svc = GenerateService(loop=DecodeLoop(device=torch_device, dim=8, step_delay_s=0.005))
    srv = _server(svc)
    yield srv, svc
    srv.stop()
    svc.close()


def test_slow_consumer_evicted_not_blocking_loop(gen_server):
    """A consumer that stops reading cannot stall the decode loop:
    once its outbox overflows the row is evicted, and a healthy mate
    generates at full speed throughout."""
    srv, svc = gen_server
    svc.outbox_max_tokens = 8

    class _Stuck(TokenSink):
        def on_received_messages(self, stream, messages):
            time.sleep(30)  # never consumes in time

    ch = _channel(srv.port)
    try:
        stub = generate_stub(ch)
        # tiny window: the server's writer blocks almost immediately
        svc._stream_options = None
        from incubator_brpc_tpu_torch.streaming.stream import StreamOptions

        svc._stream_options = StreamOptions(max_buf_size=64)
        stuck_stream, stuck_sink = _start_stream(stub, "stuck", 100000, sink=_Stuck())
        svc._stream_options = None
        mate_stream, mate_sink = _start_stream(stub, "healthy", 40)
        assert mate_sink.closed.wait(30), svc.loop.describe()
        assert len(mate_sink.tokens) == 40
        # the stuck row was evicted (cancelled), not left live forever
        deadline = time.monotonic() + 20
        while svc.loop.live_rows() > 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert svc.loop.live_rows() == 0, svc.loop.describe()
        assert svc.loop.rows_cancelled >= 1
    finally:
        ch.close()


# ---- SSE / HTTP progressive -------------------------------------------------


def test_sse_tokens_observed_progressively(gen_server):
    """The browser-shaped path: chunked text/event-stream, first token
    readable well before the stream completes."""
    srv, svc = gen_server
    ch = Channel(ChannelOptions(protocol="http", timeout_ms=20000))
    assert ch.init(f"127.0.0.1:{srv.port}") == 0
    try:
        stub = generate_stub(ch)
        c = Controller()
        c.response_will_be_read_progressively()
        stub.GenerateSSE(c, EchoRequest(message="sse", code=6))
        assert not c.failed(), c.error_text()
        parts, stamps = [], []
        end = threading.Event()

        def reader(part):
            if part is None:
                end.set()
            else:
                parts.append(part)
                stamps.append(time.monotonic())

        assert c.read_progressive_attachment(reader) == 0
        assert end.wait(20), "SSE stream never finished"
        body = b"".join(parts).decode()
        events = [l[6:] for l in body.split("\n") if l.startswith("data: ")]
        assert events[-1] == "[DONE]"
        assert len(events) == 7  # 6 tokens + terminator
        # progressive, not one buffered blob: the arrivals are spread
        # across the generation (loop paces at 5ms/step)
        assert stamps[-1] - stamps[0] > 0.005
        assert svc.sse_rows == 1
    finally:
        ch.close()


def test_sse_wire_content_type(torch_device):
    svc = GenerateService(loop=DecodeLoop(device=torch_device, dim=8))
    srv = _server(svc)
    try:
        import socket as pysock

        body = b'{"message":"wire","code":3}'
        s = pysock.create_connection(("127.0.0.1", srv.port), timeout=5)
        s.sendall(
            b"POST /GenerateService/GenerateSSE HTTP/1.1\r\nHost: x\r\n"
            b"Content-Length: %d\r\n\r\n" % len(body) + body
        )
        s.settimeout(10)
        data = b""
        while b"0\r\n\r\n" not in data:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
        s.close()
        head, _, rest = data.partition(b"\r\n\r\n")
        assert b"200" in head.split(b"\r\n")[0]
        assert b"text/event-stream" in head.lower()
        assert b"transfer-encoding: chunked" in head.lower()
        assert rest.count(b"data: ") == 4  # 3 tokens + [DONE]
    finally:
        srv.stop()
        svc.close()


def test_aborted_generation_surfaces_as_stream_failure(torch_device):
    """A truncated generation (loop stopped mid-row) must reach the
    streamed client as an ERROR (RST → on_failed), never as a clean
    CLOSE indistinguishable from successful completion."""
    svc = GenerateService(loop=DecodeLoop(device=torch_device, dim=8, step_delay_s=0.01))
    srv = _server(svc)
    ch = _channel(srv.port)
    try:
        failures = []

        class _Sink(TokenSink):
            def on_failed(self, stream, code, text):
                failures.append((code, text))

        stub = generate_stub(ch)
        stream, sink = _start_stream(stub, "doomed", 100000, sink=_Sink())
        assert sink.wait_tokens(3)
        svc.loop.stop()  # aborts the in-flight row
        assert sink.closed.wait(15)
        assert failures, "truncated generation looked like a clean close"
        assert len(sink.tokens) < 100000
    finally:
        ch.close()
        srv.stop()
        svc.close()
