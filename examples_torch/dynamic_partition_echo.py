"""Dynamic partition echo (reference example/dynamic_partition_echo_c++):
TWO partition schemes (2-way and 3-way) serve at once while a fleet
migrates; each request picks a scheme weighted by its live server
count (the DynPart load balancer) and fans out across its partitions.

    python examples_torch/dynamic_partition_echo.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from incubator_brpc_tpu_torch.client.combo import (
    DynamicPartitionChannel,
    ParallelChannelOptions,
)
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.client.naming_service import ServerNode
from incubator_brpc_tpu_torch.models.echo import EchoService
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server
from incubator_brpc_tpu_torch.server.service import ServiceStub
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint

if __name__ == "__main__":
    servers, nodes = [], []
    for scheme in (2, 3):
        for i in range(scheme):
            srv = Server()
            srv.add_service(EchoService())
            assert srv.start(0) == 0
            servers.append(srv)
            nodes.append(
                ServerNode(
                    EndPoint.tcp("127.0.0.1", srv.port), tag=f"{i}/{scheme}"
                )
            )

    ch = DynamicPartitionChannel(ParallelChannelOptions(timeout_ms=5000))
    # feed membership directly (a naming service would call this watcher
    # hook itself after ch.init("file://...", "rr"))
    ch.on_servers_changed(nodes)
    print("live schemes (partitions -> servers):", ch.scheme_counts())

    stub = ServiceStub(ch, EchoService)
    ok = 0
    for i in range(20):
        c = Controller()
        r = stub.Echo(c, EchoRequest(message=f"dyn-{i}"))
        if not c.failed() and r.message == f"dyn-{i}":
            ok += 1
    assert ok == 20, ok
    print(f"{ok}/20 echoes across coexisting 2-way and 3-way schemes")
    for srv in servers:
        srv.stop()
