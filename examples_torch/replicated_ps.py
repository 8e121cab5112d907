"""Replicated HA parameter server (docs/replication.md): two shard
groups of three PS replicas each behind one ReplicatedShardChannel —
Puts are quorum writes through each group's lease-holding leader,
reads hedge across serving replicas, and killing a leader mid-stream
fails the group over within the lease TTL with every acknowledged
write still readable.

    python examples_torch/replicated_ps.py                # on the card
    python examples_torch/replicated_ps.py --device cpu   # the plain versions
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.parameter_server import PsService, ps_stub
from incubator_brpc_tpu_torch.parallel.mesh import device_for_chip
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.replication import replicated_ps_channel
from incubator_brpc_tpu_torch.server.server import Server

if __name__ == "__main__":
    # the card of chip 0 unless --device names another; raises without one
    device = device_for_chip(0, sys.argv[sys.argv.index("--device") + 1]
                             if "--device" in sys.argv else None)
    # 2 shard groups x 3 replicas: six PsService servers on TCP
    servers = [[], []]
    group_endpoints = [[], []]
    for g in range(2):
        for r in range(3):
            srv = Server()
            srv.add_service(PsService(device=device))
            assert srv.start(0) == 0
            servers[g].append(srv)
            group_endpoints[g].append(f"127.0.0.1:{srv.port}")

    ch = replicated_ps_channel(group_endpoints, lease_ttl_s=2.0,
                               name_prefix="demo")
    stub = ps_stub(ch)

    # quorum writes: each Put routes to its key's group, goes through
    # that group's leader, and acks only after 2/3 replicas confirm
    keys = [f"user:{i}" for i in range(8)]
    for key in keys:
        c = Controller()
        c.request_attachment.append(f"value-of-{key}".encode())
        stub.Put(c, EchoRequest(message=key))
        assert not c.failed(), c.error_text()
    writes = sum(g.counters["quorum_writes"] for g in ch.groups)
    print(f"{len(keys)} puts -> {writes} quorum writes across "
          f"{len(ch.groups)} replica groups "
          f"(leaders: {[g.leader().endpoint for g in ch.groups]})")

    # kill group 0's LEADER: the group re-elects within the lease TTL
    # and every acknowledged write stays readable from the survivors
    g0 = ch.groups[0]
    leader_ep = g0.leader().endpoint
    victim = next(s for s in servers[0] if f"127.0.0.1:{s.port}" == leader_ep)
    victim.stop()
    g0.mark_dead(g0.leader().name)
    g0.step_down()

    c = Controller()
    c.request_attachment.append(b"post-failover")
    stub.Put(c, EchoRequest(message="after:kill"))
    assert not c.failed(), c.error_text()

    ok = 0
    for key in keys + ["after:kill"]:
        c = Controller()
        stub.Get(c, EchoRequest(message=key))
        if not c.failed():
            ok += 1
    changes = sum(g.counters["leader_changes"] for g in ch.groups)
    print(f"killed a leader: {changes} leader change(s), "
          f"{ok}/{len(keys) + 1} acknowledged writes still readable")
    assert ok == len(keys) + 1

    for grp in servers:
        for srv in grp:
            srv.stop()
