"""Echo over the ICI fabric with an HBM-resident payload (the
rdma_performance analog): the attachment is a device array that moves
through the copy+checksum transmit kernel (K1, one launch a hop),
never detouring through host bytes in zero-copy mode.

    python examples_torch/ici_echo.py                # on the card
    python examples_torch/ici_echo.py --device cpu   # the plain versions
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

import torch

from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.parallel.mesh import device_for_chip
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server

if __name__ == "__main__":
    # the card of chip 0 unless --device names another; raises without one
    device = device_for_chip(0, sys.argv[sys.argv.index("--device") + 1]
                             if "--device" in sys.argv else None)
    srv = Server()
    srv.add_service(EchoService())
    assert srv.start_ici(0, 0, device=device) == 0
    ch = Channel(ChannelOptions(timeout_ms=30000))
    assert ch.init("ici://slice0/chip0") == 0
    c = Controller()
    c.request_attachment.append_device(torch.arange(1 << 20, dtype=torch.float32,
                                                      device=device))
    reply = echo_stub(ch).Echo(c, EchoRequest(message="hbm"))
    print("failed:", c.failed(), "| attachment bytes:", len(c.response_attachment),
          "| device-resident:", len(c.response_attachment.device_arrays()) == 1)
    ch.close()
    srv.stop()
    time.sleep(1.0)  # let fabric/queue tasks drain before teardown
