"""Multi-threaded echo client (reference example/multi_threaded_echo_c++):
N threads share ONE channel and hammer the same server with sync RPCs;
the channel's sync fast path multiplexes them over the native mux
reactor.

    python examples_torch/multi_threaded_echo.py
"""

import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

THREADS = 4
PER_THREAD = 200

if __name__ == "__main__":
    srv = Server(ServerOptions(native_engine=True))
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=5000, connection_type="native"))
    assert ch.init(f"127.0.0.1:{srv.port}") == 0
    stub = echo_stub(ch)

    ok = [0] * THREADS

    def worker(t):
        for i in range(PER_THREAD):
            c = Controller()
            r = stub.Echo(c, EchoRequest(message=f"t{t}-{i}"))
            if not c.failed() and r.message == f"t{t}-{i}":
                ok[t] += 1

    ts = [threading.Thread(target=worker, args=(t,)) for t in range(THREADS)]
    t0 = time.monotonic()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.monotonic() - t0
    total = sum(ok)
    assert total == THREADS * PER_THREAD, ok
    print(f"{total} echoes from {THREADS} threads over one channel "
          f"({total / wall:.0f} qps)")
    ch.close()
    srv.stop()
