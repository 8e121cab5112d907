"""PartitionChannel — reference example/partition_echo_c++ and
dynamic_partition_echo_c++.

Each server owns one partition of the data; the naming service tags
every address with ``n/N``; the PartitionChannel sends a sub-request to
EVERY partition and merges. Rewriting the naming file re-partitions
live (the dynamic_partition example's point).

    python examples_torch/partition_echo.py
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from incubator_brpc_tpu_torch.client.combo import PartitionChannel
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import EchoService
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest, EchoResponse
from incubator_brpc_tpu_torch.server.server import Server
from incubator_brpc_tpu_torch.server.service import MethodSpec, Service, rpc_method


class PartitionEcho(Service):
    SERVICE_NAME = "EchoService"

    def __init__(self, tag):
        self._tag = tag

    @rpc_method(EchoRequest, EchoResponse)
    def Echo(self, controller, request, response, done):
        response.message = self._tag
        done()


def main():
    servers = [Server() for _ in range(3)]
    for i, s in enumerate(servers):
        s.add_service(PartitionEcho(f"partition-{i}"))
        assert s.start(0) == 0
    with tempfile.NamedTemporaryFile("w", suffix=".ns", delete=False) as f:
        path = f.name
        f.write(
            "".join(
                f"127.0.0.1:{s.port} 1 {i}/3\n" for i, s in enumerate(servers)
            )
        )
    pc = PartitionChannel()
    assert pc.init(f"file://{path}", "rr") == 0
    try:
        deadline = time.monotonic() + 5
        while pc.partition_count() != 3 and time.monotonic() < deadline:
            time.sleep(0.1)
        print(f"partitions resolved: {pc.partition_count()}")
        spec = MethodSpec("EchoService", "Echo", EchoRequest, EchoResponse)
        c = Controller()
        c.timeout_ms = 3000
        r = EchoResponse()
        pc.call_method(spec, c, EchoRequest(message="fan"), r, None)
        assert not c.failed(), c.error_text()
        print(f"fan-out across all partitions ok (merged reply: {r.message!r})")

        # live re-partition: shrink 3 → 2
        with open(path, "w") as f:
            f.write(
                f"127.0.0.1:{servers[0].port} 1 0/2\n"
                f"127.0.0.1:{servers[1].port} 1 1/2\n"
            )
        deadline = time.monotonic() + 5
        while pc.partition_count() != 2 and time.monotonic() < deadline:
            time.sleep(0.1)
        print(f"re-partitioned live: {pc.partition_count()} partitions")
    finally:
        os.unlink(path)
        for s in servers:
            s.stop()


if __name__ == "__main__":
    main()
