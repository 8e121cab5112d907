"""Pod-scale sharded parameter server (docs/sharded_ps.md): four ICI
shard servers each own a row-slice of W plus a slice of the keyspace;
Get/Put route to the owning shard only, and one Forward fans out
across all shards in a single burst, merging the per-shard partial
results into the full y = x @ W.

    python examples_torch/sharded_ps.py                # on the card
    python examples_torch/sharded_ps.py --device cpu   # the plain versions
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.parameter_server import (
    PsService,
    ps_stub,
    scatter_param,
    sharded_ps_channel,
)
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server

if __name__ == "__main__":
    # each shard on the card of its chip unless --device names another;
    # without a card the example raises
    device = sys.argv[sys.argv.index("--device") + 1] \
        if "--device" in sys.argv else None
    # one PsService per mesh coordinate — the shard map IS the topology
    servers, endpoints = [], []
    for chip in range(4):
        srv = Server()
        srv.add_service(PsService(device=device))
        assert srv.start_ici(0, 40 + chip, device=device) == 0
        servers.append(srv)
        endpoints.append(f"ici://slice0/chip{40 + chip}")

    ch = sharded_ps_channel(endpoints=endpoints, fail_limit=0)
    stub = ps_stub(ch)

    # row-scatter a (64, 64) parameter: shard k holds rows [16k, 16k+16)
    d = 64
    W = np.random.RandomState(3).rand(d, d).astype(np.float32)
    scatter_param(ch, "layer0/w", W)

    # keyed routing: each key lands on exactly one owning shard,
    # consistently — a rebuilt channel maps it identically
    for key in ("user:alice", "user:bob", "user:carol"):
        c = Controller()
        c.request_attachment.append(key.encode())
        stub.Put(c, EchoRequest(message=key))
        assert not c.failed(), c.error_text()
        print(f"Put {key!r} -> shard {c.shard_index}/{len(endpoints)}")

    # one fan-out Forward: every shard contracts its rows against its
    # slice of x, the client sums the partials (one fused device op)
    x = np.random.RandomState(4).rand(d).astype(np.float32)
    c = Controller()
    c.request_attachment.append_user_data(x.tobytes())
    stub.Forward(c, EchoRequest(message="layer0/w"))
    assert not c.failed(), c.error_text()
    y = np.frombuffer(c.response_attachment.to_bytes(), np.float32)
    assert np.allclose(y, x @ W, atol=1e-3)
    print(
        f"sharded forward merged {len(endpoints)} partial results "
        f"into y ({len(y)} floats, max err "
        f"{np.abs(y - x @ W).max():.2e})"
    )

    for srv in servers:
        srv.stop()
