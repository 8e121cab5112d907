"""Pod-scale sharded parameter server (docs/sharded_ps.md).

Two cooperating halves under test:

* server side — the mesh-sharded store + the shard_map/pjit lowering of
  the batched Forward GEMM (batching/sharded.ShardedFusedKernel): one
  fused sharded execution per batch, ONE collective merge, asserted by
  step-log counts (never timing);
* client side — ShardRoutedChannel: consistent key→shard mapping
  (stable across channel rebuilds/restarts), Get/Put landing exactly
  one RPC on the owning shard, and fan-out Forward degrading per the
  combo-channel contract when a shard dies.

Carried by hand from ``tests/test_sharded_ps.py``.  Every shard server,
PS and sub-channel is given the device the case runs on (the CPU, or the
card), and the mesh is eight virtual chips on it.  The sub-channels keep
the JAX file's default timeout of 1 s: the JAX package's first Put of a
shape compiles and overruns it on the CPU, the port has no compile step.
Inputs come from seeded numpy generators.  The cases
``tests/test_torch_sharded_ps.py`` already holds are not repeated here.
"""


import numpy as np
import pytest

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.client.channel import ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.parameter_server import (
    PsService,
    ps_stub,
    scatter_param,
    sharded_ps_channel,
)
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server

from torch_carry import torch_device  # noqa: F401  (fixture)

_coords = [300]


def fresh_coords():
    _coords[0] += 1
    return (8, _coords[0])


@pytest.fixture
def mesh8(torch_device):
    from incubator_brpc_tpu_torch.parallel.mesh import create_mesh

    return create_mesh((1, 8), devices=[torch_device] * 8)


# ---------------------------------------------------------------------------
# server side: the sharded store + fused sharded Forward
# ---------------------------------------------------------------------------


def test_sharded_forward_matches_unsharded_bit_for_bit_semantics(mesh8, torch_device):
    """Same key, same x: the sharded lowering and the single-chip
    kernel agree numerically (fp32 tolerance: the psum reorders the
    contraction)."""
    rng = np.random.RandomState(64)
    svc_sharded = PsService(mesh=mesh8)
    svc_plain = PsService(device=torch_device)
    W = rng.rand(64, 64).astype(np.float32)
    svc_sharded.put_param("w", W)
    svc_plain.put_param("w", W)

    def forward(svc, x):
        from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoResponse

        c = Controller()
        c.request_attachment.append_user_data(x.tobytes())
        # call the single-request adapter directly (no server needed)
        PsService.Forward(
            svc, c, EchoRequest(message="w"), EchoResponse(), lambda: None
        )
        assert not c.failed(), c.error_text()
        return np.frombuffer(c.response_attachment.to_bytes(), np.float32)

    x = rng.rand(64).astype(np.float32)
    np.testing.assert_allclose(
        forward(svc_sharded, x), forward(svc_plain, x), atol=1e-3
    )


# ---------------------------------------------------------------------------
# client side: shard routing
# ---------------------------------------------------------------------------


class CountingPs(PsService):
    """PsService that counts per-server Get/Put arrivals (the
    exactly-one-RPC-on-the-owning-shard assertions)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.get_calls = 0
        self.put_calls = 0
        self.forward_calls = 0

    def Get(self, controller, request, response, done):
        self.get_calls += 1
        return PsService.Get(self, controller, request, response, done)

    def Put(self, controller, request, response, done):
        self.put_calls += 1
        return PsService.Put(self, controller, request, response, done)

    def Forward(self, controller, request, response, done):
        self.forward_calls += 1
        return PsService.Forward(self, controller, request, response, done)


def _sub_options(device):
    # the default sub-channel timeout (1 s), as the JAX file has it
    return ChannelOptions(ici_device=device)


@pytest.fixture
def shard_cluster(torch_device):
    """4 ICI shard servers + a wired ShardRoutedChannel."""
    svcs, servers, eps = [], [], []
    for _ in range(4):
        svc = CountingPs(device=torch_device)
        srv = Server()
        srv.add_service(svc)
        s, c = fresh_coords()
        assert srv.start_ici(s, c, device=torch_device) == 0
        svcs.append(svc)
        servers.append(srv)
        eps.append(f"ici://slice{s}/chip{c}")
    ch = sharded_ps_channel(endpoints=eps, fail_limit=0, timeout_ms=30000,
                            channel_options=_sub_options(torch_device))
    ch._test_device = torch_device
    yield svcs, servers, eps, ch
    for srv in servers:
        srv.stop()


def test_shard_mapping_consistent_across_restarts(shard_cluster):
    """shard_of is pure in (seed, key, n): a rebuilt channel (the
    restart analog) maps every key to the same shard, and a golden
    pin catches accidental hash-function drift between versions."""
    svcs, servers, eps, ch = shard_cluster
    keys = [f"key{i}" for i in range(64)]
    first = [ch.shard_of(k) for k in keys]
    rebuilt = sharded_ps_channel(endpoints=eps, timeout_ms=30000,
                                 channel_options=_sub_options(ch._test_device))
    assert [rebuilt.shard_of(k) for k in keys] == first
    # seeded: a different seed remaps (the mapping is not accidental)
    other = sharded_ps_channel(endpoints=eps, seed=1, timeout_ms=30000,
                               channel_options=_sub_options(ch._test_device))
    assert [other.shard_of(k) for k in keys] != first
    # golden pin (murmur3_32, seed 0, 4 shards)
    assert ch.shard_of("key0", 4) == first[0]
    all_shards = set(first)
    assert len(all_shards) > 1, "every key mapped to one shard"


def test_fanout_forward_merges_partials_in_one_burst(shard_cluster):
    svcs, servers, eps, ch = shard_cluster
    d = 64
    rng = np.random.RandomState(d)
    W = rng.rand(d, d).astype(np.float32)
    scatter_param(ch, "w", W)
    # every shard holds exactly its rows
    for i, svc in enumerate(svcs):
        assert tuple(svc._store["w"].shape) == (d // 4, d)
    stub = ps_stub(ch)
    x = rng.rand(d).astype(np.float32)
    before = [s.forward_calls for s in svcs]
    c = Controller()
    c.request_attachment.append_user_data(x.tobytes())
    r = stub.Forward(c, EchoRequest(message="w"))
    assert not c.failed(), c.error_text()
    y = np.frombuffer(c.response_attachment.to_bytes(), np.float32)
    np.testing.assert_allclose(y, x @ W, atol=1e-3)
    assert r.message == "w"
    # one leg per shard, issued as one fan-out
    assert [a - b for a, b in zip((s.forward_calls for s in svcs), before)] \
        == [1, 1, 1, 1]


def test_dead_shard_degrades_per_combo_channel_contract(shard_cluster):
    """Combo-channel semantics: a dead shard fails only its leg.  fail_limit=0
    ⇒ the fan-out fails with an ERPC code (never hangs); fail_limit=1
    ⇒ the merge proceeds over the surviving partials.  Routed Get to
    a LIVE shard is unaffected; routed Get to the dead shard fails
    with an ERPC code."""
    svcs, servers, eps, ch = shard_cluster
    d = 64
    W = np.random.RandomState(d + 1).rand(d, d).astype(np.float32)
    scatter_param(ch, "w", W)
    stub = ps_stub(ch)
    # seed a key on a live shard and one on the to-be-dead shard
    dead = 2
    live_key = next(
        k for k in ("k0", "k1", "k2", "k3", "k4", "k5")
        if ch.shard_of(k) != dead
    )
    dead_key = next(
        k for k in ("k0", "k1", "k2", "k3", "k4", "k5")
        if ch.shard_of(k) == dead
    )
    c = Controller()
    c.request_attachment.append(b"v")
    stub.Put(c, EchoRequest(message=live_key))
    assert not c.failed()

    servers[dead].stop()

    # fan-out with fail_limit=0: fails loudly, ERPC-only
    c = Controller()
    c.max_retry = 0
    c.request_attachment.append_user_data(np.ones(d, np.float32).tobytes())
    stub.Forward(c, EchoRequest(message="w"))
    assert c.failed()
    assert c.error_code in (
        errors.ETOOMANYFAILS, errors.EFAILEDSOCKET, errors.ERPCTIMEDOUT,
    )

    # fail_limit=1: degraded merge over the 3 surviving legs
    tolerant = sharded_ps_channel(
        sub_channels=ch.partitions(), fail_limit=1, timeout_ms=30000
    )
    tstub = ps_stub(tolerant)
    c = Controller()
    c.max_retry = 0
    c.request_attachment.append_user_data(np.ones(d, np.float32).tobytes())
    tstub.Forward(c, EchoRequest(message="w"))
    assert not c.failed(), c.error_text()
    y = np.frombuffer(c.response_attachment.to_bytes(), np.float32)
    # partial: the dead shard's contribution is missing, the rest agree
    rows = d // 4
    expect = np.ones(d, np.float32) @ W
    expect -= np.ones(rows, np.float32) @ np.asarray(
        W[dead * rows:(dead + 1) * rows]
    )
    np.testing.assert_allclose(y, expect, atol=1e-3)

    # routed isolation: live-shard Get still fine, dead-shard Get ERPC
    c = Controller()
    stub.Get(c, EchoRequest(message=live_key))
    assert not c.failed(), c.error_text()
    c = Controller()
    c.max_retry = 0
    stub.Get(c, EchoRequest(message=dead_key))
    assert c.failed()
    assert c.error_code in (errors.EFAILEDSOCKET, errors.ERPCTIMEDOUT)


def test_stable_shard_lb_is_deterministic_across_instances():
    """The 'shard' LB: request_code % n over the endpoint-SORTED
    member list — two instances fed the same membership in different
    orders agree, and exclusion fails over deterministically."""
    from incubator_brpc_tpu_torch.client.load_balancer import (
        SelectIn,
        create_load_balancer,
    )
    from incubator_brpc_tpu_torch.client.naming_service import ServerNode
    from incubator_brpc_tpu_torch.utils.endpoint import EndPoint

    nodes = [ServerNode(EndPoint("10.0.0.%d" % i, 80)) for i in range(1, 6)]
    a = create_load_balancer("shard")
    b = create_load_balancer("shard")
    for n in nodes:
        a.add_server(n)
    for n in reversed(nodes):  # learned in a different order
        b.add_server(n)
    for code in range(32):
        sa = a.select_server(SelectIn(request_code=code))
        sb = b.select_server(SelectIn(request_code=code))
        assert sa == sb
    owner = a.select_server(SelectIn(request_code=7))
    failover = a.select_server(
        SelectIn(request_code=7, excluded=frozenset({owner}))
    )
    assert failover != owner
    assert failover == b.select_server(
        SelectIn(request_code=7, excluded=frozenset({owner}))
    )
