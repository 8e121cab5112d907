"""Backup request (hedging) — reference example/backup_request_c++.

One replica answers slowly (1.5s); with ``backup_request_ms=100`` the
channel fires a second attempt at another replica after 100ms and takes
whichever answers first, so the caller sees ~100ms instead of 1.5s.

    python examples_torch/backup_request.py     # self-contained demo
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import echo_stub
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest, EchoResponse
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
from incubator_brpc_tpu_torch.server.service import Service, rpc_method


class ReplicaEcho(Service):
    SERVICE_NAME = "EchoService"

    def __init__(self, tag: str, delay_s: float = 0.0):
        self._tag = tag
        self._delay = delay_s

    @rpc_method(EchoRequest, EchoResponse)
    def Echo(self, controller, request, response, done):
        if self._delay:
            time.sleep(self._delay)
        response.message = f"{self._tag}: {request.message}"
        done()


def main():
    replicas = []
    for tag, delay in (("slow", 1.5), ("fast-1", 0.0), ("fast-2", 0.0)):
        srv = Server(ServerOptions(usercode_in_dispatcher=False))
        srv.add_service(ReplicaEcho(tag, delay))
        assert srv.start(0) == 0
        replicas.append(srv)
    url = "list://" + ",".join(f"127.0.0.1:{s.port}" for s in replicas)
    ch = Channel(ChannelOptions(timeout_ms=5000, backup_request_ms=100))
    assert ch.init(url, "rr") == 0
    stub = echo_stub(ch)
    try:
        for i in range(6):  # rr rotates through the slow replica too
            c = Controller()
            t0 = time.monotonic()
            r = stub.Echo(c, EchoRequest(message=f"req-{i}"))
            ms = (time.monotonic() - t0) * 1e3
            assert not c.failed(), c.error_text()
            hedged = " (hedged away from the slow replica)" if ms < 1000 else ""
            print(f"req-{i}: {r.message!r} in {ms:.0f}ms{hedged}")
    finally:
        ch.close()
        for s in replicas:
            s.stop()


if __name__ == "__main__":
    main()
