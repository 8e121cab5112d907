"""Micro-batched parameter server (docs/batching.md): concurrent Gets
of one stored tensor coalesce server-side into fused batched
executions — N callers, far fewer handler invocations.

    python examples_torch/batched_ps.py                # on the card
    python examples_torch/batched_ps.py --device cpu   # the plain versions
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import threading

from incubator_brpc_tpu_torch.batching import BatchPolicy
from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.parameter_server import PsService, ps_stub
from incubator_brpc_tpu_torch.parallel.mesh import device_for_chip
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

if __name__ == "__main__":
    import torch

    # the card of chip 0 unless --device names another; raises without one
    device = device_for_chip(0, sys.argv[sys.argv.index("--device") + 1]
                             if "--device" in sys.argv else None)

    srv = Server(ServerOptions(
        enable_batching=True,
        batch_policies={
            "PsService.Get": BatchPolicy(
                max_batch_size=8,
                max_wait_us=100_000,  # generous: this demo favors fusion
                padding_buckets=(1, 2, 4, 8),
            ),
        },
    ))
    srv.add_service(PsService(device=device))
    assert srv.start(0) == 0

    # publish a parameter shard
    ch = Channel(ChannelOptions(timeout_ms=10000))
    assert ch.init(f"127.0.0.1:{srv.port}") == 0
    c = Controller()
    c.request_attachment.append_device(torch.full((64, 64), 3.0, dtype=torch.float32,
                                                  device=device))
    ps_stub(ch).Put(c, EchoRequest(message="layer0/w"))
    assert not c.failed(), c.error_text()

    # 8 workers fetch it concurrently: a barrier lines them up so the
    # batcher's wait window reliably coalesces them
    nthreads, per_thread = 8, 4
    barrier = threading.Barrier(nthreads, timeout=30)
    ok = []
    lock = threading.Lock()

    def worker():
        wch = Channel(ChannelOptions(timeout_ms=10000))
        assert wch.init(f"127.0.0.1:{srv.port}") == 0
        stub = ps_stub(wch)
        barrier.wait()
        n = 0
        for _ in range(per_thread):
            cc = Controller()
            stub.Get(cc, EchoRequest(message="layer0/w"))
            if not cc.failed() and len(cc.response_attachment):
                n += 1
        wch.close()
        with lock:
            ok.append(n)

    threads = [threading.Thread(target=worker) for _ in range(nthreads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    batcher = srv.batcher("PsService.Get")
    total = nthreads * per_thread
    assert sum(ok) == total, f"only {sum(ok)}/{total} gets succeeded"
    assert batcher.batches < total, "nothing coalesced"
    print(
        f"{sum(ok)}/{total} batched gets coalesced into "
        f"{batcher.batches} fused executions "
        f"(max batch {batcher.max_batch_seen}, "
        f"occupancy {batcher.occupancy():.2f}, shed {batcher.shed.get_value()})"
    )
    ch.close()
    srv.stop()
