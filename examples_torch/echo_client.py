"""Echo client (reference example/echo_c++/client.cpp analog).

    python examples_torch/echo_client.py [host:port] [message]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import echo_stub
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest

if __name__ == "__main__":
    addr = sys.argv[1] if len(sys.argv) > 1 else "127.0.0.1:8000"
    msg = sys.argv[2] if len(sys.argv) > 2 else "hello tpu-brpc"
    ch = Channel(ChannelOptions(timeout_ms=3000, connection_type="native"))
    assert ch.init(addr) == 0
    c = Controller()
    reply = echo_stub(ch).Echo(c, EchoRequest(message=msg))
    if c.failed():
        print(f"RPC failed: [{c.error_code}] {c.error_text()}")
        sys.exit(1)
    print(f"reply: {reply.message!r}  ({c.latency_us}us)")
    ch.close()
