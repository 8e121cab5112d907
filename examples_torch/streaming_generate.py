"""Token-streaming generation with continuous batching — the
streaming subsystem's flagship workload (docs/streaming.md).

Four clients ask for generations of different lengths; the server's
ONE decode loop fuses every live row into a single padded device
execution per step and pushes one token frame per row onto its
stream.  Clients join mid-stream (continuous batching), tokens arrive
progressively, and an SSE client consumes the same loop over plain
HTTP chunked transfer.

    python examples_torch/streaming_generate.py                # on the card
    python examples_torch/streaming_generate.py --device cpu   # the plain versions
"""

import os
import socket
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.client.stream import Stream, StreamHandler
from incubator_brpc_tpu_torch.parallel.mesh import device_for_chip
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server
from incubator_brpc_tpu_torch.streaming.generate import (
    DecodeLoop,
    GenerateService,
    generate_stub,
)


class TokenPrinter(StreamHandler):
    def __init__(self, name):
        self.name = name
        self.tokens = []
        self.closed = threading.Event()

    def on_received_messages(self, stream, messages):
        for m in messages:
            self.tokens.append(m.to_bytes().decode())
        print(f"  [{self.name}] {len(self.tokens)} tokens so far")

    def on_closed(self, stream):
        self.closed.set()


def main():
    # the card of chip 0 unless --device names another; raises without one
    device = device_for_chip(0, sys.argv[sys.argv.index("--device") + 1]
                             if "--device" in sys.argv else None)
    loop = DecodeLoop(dim=16, step_delay_s=0.01, device=device)
    svc = GenerateService(loop=loop)
    srv = Server()
    srv.add_service(svc)
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=30000))
    assert ch.init(f"127.0.0.1:{srv.port}") == 0
    try:
        stub = generate_stub(ch)
        printers = []
        lengths = [24, 12, 18, 6]
        for i, n in enumerate(lengths):
            printer = TokenPrinter(f"client-{i}")
            c = Controller()
            Stream.create(c, printer)
            r = stub.Generate(c, EchoRequest(message=f"prompt-{i}", code=n))
            assert not c.failed(), c.error_text()
            assert r.message == "streaming"
            printers.append(printer)
            time.sleep(0.05)  # stagger: later rows JOIN mid-generation
        for p in printers:
            assert p.closed.wait(30)
        total = sum(len(p.tokens) for p in printers)
        assert [len(p.tokens) for p in printers] == lengths
        print(f"{total} tokens streamed across {len(printers)} "
              f"continuously-batched streams")
        print(f"decode loop: {loop.describe()}")
        assert loop.mid_stream_joins >= 1, "no row joined mid-stream"

        # the same loop over HTTP SSE (browser-shaped consumption)
        body = b'{"message":"sse-prompt","code":5}'
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
        s.sendall(
            b"POST /GenerateService/GenerateSSE HTTP/1.1\r\nHost: x\r\n"
            b"Content-Length: %d\r\n\r\n" % len(body) + body
        )
        s.settimeout(15)
        data = b""
        while b"0\r\n\r\n" not in data:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
        s.close()
        assert b"text/event-stream" in data.lower()
        events = data.count(b"data: ")
        print(f"SSE client consumed {events} events over chunked HTTP")
        assert events == 6  # 5 tokens + [DONE]
    finally:
        ch.close()
        srv.stop()
        svc.close()


if __name__ == "__main__":
    main()
