"""SelectiveChannel — reference example/selective_echo_c++.

A SelectiveChannel load-balances across whole sub-channels (each of
which may itself be a cluster) and retries a failed group on another:
here one sub-channel points at a dead address and one at a live server;
every call still succeeds.

    python examples_torch/selective_echo.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.combo import (
    SelectiveChannel,
    SelectiveChannelOptions,
)
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server


def main():
    srv = Server()
    srv.add_service(EchoService())
    assert srv.start(0) == 0

    sc = SelectiveChannel(SelectiveChannelOptions(max_retry=2, timeout_ms=1000))
    dead = Channel(ChannelOptions(timeout_ms=300, max_retry=0))
    dead.init("127.0.0.1:1")  # nobody listens here
    live = Channel(ChannelOptions(timeout_ms=1000))
    live.init(f"127.0.0.1:{srv.port}")
    sc.add_channel(dead)
    sc.add_channel(live)

    stub = echo_stub(sc)
    try:
        ok = 0
        for i in range(8):
            c = Controller()
            r = stub.Echo(c, EchoRequest(message=f"sel-{i}"))
            assert not c.failed(), c.error_text()
            ok += 1
            print(f"sel-{i}: {r.message!r}")
        print(f"{ok}/8 succeeded despite one dead sub-channel "
              "(health-aware selection + cross-group retry)")
    finally:
        srv.stop()


if __name__ == "__main__":
    main()
