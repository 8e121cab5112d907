"""ParallelChannel fan-out (reference example/parallel_echo_c++):
one logical RPC broadcast to N sub-channels, responses merged.

    python examples_torch/parallel_echo.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.combo import ParallelChannel, ParallelChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server

if __name__ == "__main__":
    servers = []
    pc = ParallelChannel(ParallelChannelOptions(fail_limit=1))
    for i in range(3):
        srv = Server()
        srv.add_service(EchoService())
        assert srv.start(0) == 0
        servers.append(srv)
        sub = Channel(ChannelOptions(timeout_ms=3000))
        assert sub.init(f"127.0.0.1:{srv.port}") == 0
        pc.add_channel(sub)
    c = Controller()
    reply = echo_stub(pc).Echo(c, EchoRequest(message="fan-out"))
    print("failed:", c.failed(), "merged reply:", reply.message)
    for srv in servers:
        srv.stop()
