"""Streaming RPC — reference example/streaming_echo_c++.

An RPC negotiates a stream; the client then writes ordered chunks
outside the request/response cycle and the server's StreamHandler
receives them (flow control via consumed-bytes feedback).

    python examples_torch/streaming_echo.py
"""

import os
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.client.stream import Stream, StreamHandler
from incubator_brpc_tpu_torch.models.streaming_echo import StreamingEchoService
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server
from incubator_brpc_tpu_torch.server.service import ServiceStub


class Printer(StreamHandler):
    def __init__(self):
        self.n = 0
        self.closed = threading.Event()

    def on_received_messages(self, stream, messages):
        for m in messages:
            self.n += 1
            print(f"  <- echoed back: {m.to_bytes().decode()!r}")

    def on_closed(self, stream):
        self.closed.set()


def main():
    srv = Server()
    srv.add_service(StreamingEchoService())
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=3000))
    assert ch.init(f"127.0.0.1:{srv.port}") == 0
    try:
        stub = ServiceStub(ch, StreamingEchoService)
        ctrl = Controller()
        printer = Printer()
        stream = Stream.create(ctrl, printer)
        r = stub.StartStream(ctrl, EchoRequest(message="start"))
        assert not ctrl.failed(), ctrl.error_text()
        print(f"stream negotiated: {r.message!r}")
        assert stream.wait_established(5)
        for i in range(5):
            print(f"  -> chunk-{i}")
            assert stream.write(f"chunk-{i}".encode()) == 0
        import time

        deadline = time.monotonic() + 10
        while printer.n < 5 and time.monotonic() < deadline:
            time.sleep(0.05)
        stream.close()
        printer.closed.wait(5)
        print(f"stream closed; {printer.n} chunks echoed")
    finally:
        ch.close()
        srv.stop()


if __name__ == "__main__":
    main()
