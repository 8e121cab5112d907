"""The port's sharded, replicated and live-resharded parameter server
held against the JAX package's, on the CPU.

The scenarios are those of tests/test_sharded_ps.py:59-500 (the
in-mesh sharded store on a (1, 8) mesh: shards placed, one execution
and one merge per batch, the result against the unsharded one, the
collective sub-span, a chaos reset failing only its group, the
servable-dim ceiling, plus ``Get`` of a sharded key and ``remesh``;
shard mapping, keyed Get/Put on one owning shard, the fan-out Forward,
a dead shard under ``fail_limit``, ``scatter_param``), tests/test_replication.py:380-604
(RF=1, Put/Get/Delete, hedged reads, a leader killed mid-write-storm)
and tests/test_resharding.py:414-763 (a membership flap mid-fan-out,
live migration under load, an in-flight fan-out across CUTOVER, a
source killed mid-COPY).  Each runs on BOTH packages in the same test,
over each package's own servers, and the two results must be equal:
keys, owners, moved-key sets and counters exactly, Forward ``y`` within
1e-5·(|x| @ |W|) + 1e-6 per element (float32 products summed in
another order).  The port's servers and channels are given
``torch.device("cpu")``, and its mesh lists it eight times (virtual
chips) where the JAX package's runs on the conftest's eight virtual CPU
devices; inputs are numpy arrays from a seed.

The JAX package's sub-channels default to a 1000 ms timeout, which its
first Put of a new shape (a compile) can overrun, so both packages'
shard channels get ``channel_options`` with a 30 s timeout.
"""

import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

CPU = torch.device("cpu")
PKGS = ["jax", "port"]
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6

# this file's ICI coordinates (per package: the two fabrics are apart)
_chips = {"jax": [0], "port": [0]}
SLICE = 270


def pk(pkg):
    """One package's PS surface, with the port pinned to the CPU."""
    if pkg == "port":
        from incubator_brpc_tpu_torch import errors
        from incubator_brpc_tpu_torch import replication, resharding
        from incubator_brpc_tpu_torch.chaos import (
            RecoveryHarness,
            injector,
            replica_storm_plan,
            reshard_storm_plan,
        )
        from incubator_brpc_tpu_torch.client import combo
        from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
        from incubator_brpc_tpu_torch.client.controller import Controller
        from incubator_brpc_tpu_torch.client.naming_service import ServerNode
        from incubator_brpc_tpu_torch.models import parameter_server as ps
        from incubator_brpc_tpu_torch.observability.span import span_db
        from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
        from incubator_brpc_tpu_torch.server.server import Server
        from incubator_brpc_tpu_torch.utils.endpoint import str2endpoint
        from incubator_brpc_tpu_torch.utils.flags import set_flag

        dev_kw = {"device": CPU}
        ch_opts = lambda: ChannelOptions(timeout_ms=30000, ici_device=CPU)  # noqa: E731

        def host(v):
            return v.numpy() if isinstance(v, torch.Tensor) else v
    else:
        from incubator_brpc_tpu import errors
        from incubator_brpc_tpu import replication, resharding
        from incubator_brpc_tpu.chaos import (
            RecoveryHarness,
            injector,
            replica_storm_plan,
            reshard_storm_plan,
        )
        from incubator_brpc_tpu.client import combo
        from incubator_brpc_tpu.client.channel import Channel, ChannelOptions
        from incubator_brpc_tpu.client.controller import Controller
        from incubator_brpc_tpu.client.naming_service import ServerNode
        from incubator_brpc_tpu.models import parameter_server as ps
        from incubator_brpc_tpu.observability.span import span_db
        from incubator_brpc_tpu.protos.echo_pb2 import EchoRequest
        from incubator_brpc_tpu.server.server import Server
        from incubator_brpc_tpu.utils.endpoint import str2endpoint
        from incubator_brpc_tpu.utils.flags import set_flag

        dev_kw = {}
        ch_opts = lambda: ChannelOptions(timeout_ms=30000)  # noqa: E731

        def host(v):
            return np.asarray(v) if not isinstance(v, (bytes, bytearray)) else v

    class CountingPs(ps.PsService):
        """Per-server arrival counters and a gate that holds Keys open
        (the mid-fan-out flap and in-flight-cutover windows)."""

        def __init__(self):
            super().__init__(**dev_kw)
            self.get_calls = self.put_calls = self.forward_calls = 0
            self.keys_calls = 0
            self.gate = threading.Event()
            self.gate.set()

        def Get(self, controller, request, response, done):
            self.get_calls += 1
            return ps.PsService.Get(self, controller, request, response, done)

        def Put(self, controller, request, response, done):
            self.put_calls += 1
            return ps.PsService.Put(self, controller, request, response, done)

        def Forward(self, controller, request, response, done):
            self.forward_calls += 1
            return ps.PsService.Forward(self, controller, request, response, done)

        def Keys(self, controller, request, response, done):
            self.keys_calls += 1
            self.gate.wait(10.0)
            return ps.PsService.Keys(self, controller, request, response, done)

    def start_ici(n):
        """n CountingPs servers on this file's ICI coordinates."""
        svcs, servers, eps = [], [], []
        for _ in range(n):
            _chips[pkg][0] += 1
            svc = CountingPs()
            srv = Server()
            srv.add_service(svc)
            assert srv.start_ici(SLICE, _chips[pkg][0], **dev_kw) == 0
            svcs.append(svc)
            servers.append(srv)
            eps.append(f"ici://slice{SLICE}/chip{_chips[pkg][0]}")
        return svcs, servers, eps

    def start_tcp(n):
        svcs, servers, eps = [], [], []
        for _ in range(n):
            svc = ps.PsService(**dev_kw)
            srv = Server()
            srv.add_service(svc)
            assert srv.start(0) == 0
            svcs.append(svc)
            servers.append(srv)
            eps.append(f"127.0.0.1:{srv.port}")
        return svcs, servers, eps

    def shard_channel(eps, **kw):
        kw.setdefault("timeout_ms", 30000)
        return ps.sharded_ps_channel(endpoints=eps, channel_options=ch_opts(), **kw)

    def put(ch, key, value):
        c = Controller()
        if isinstance(value, bytes):
            c.request_attachment.append(value)
        else:
            c.request_attachment.append_device(value)
        r = ps.ps_stub(ch).Put(c, EchoRequest(message=key))
        return c, r

    def get(ch, key):
        c = Controller()
        r = ps.ps_stub(ch).Get(c, EchoRequest(message=key))
        return c, r

    def forward(ch, key, x):
        c = Controller()
        c.max_retry = 0
        c.request_attachment.append_user_data(np.asarray(x, np.float32).tobytes())
        r = ps.ps_stub(ch).Forward(c, EchoRequest(message=key))
        y = None if c.failed() else np.frombuffer(
            c.response_attachment.to_bytes(), np.float32).copy()
        return c, r, y

    return types.SimpleNamespace(
        pkg=pkg, errors=errors, replication=replication, resharding=resharding,
        RecoveryHarness=RecoveryHarness, injector=injector,
        replica_storm_plan=replica_storm_plan, reshard_storm_plan=reshard_storm_plan,
        combo=combo, Channel=Channel, ChannelOptions=ChannelOptions, ch_opts=ch_opts,
        Controller=Controller, ServerNode=ServerNode, ps=ps, span_db=span_db,
        EchoRequest=EchoRequest, str2endpoint=str2endpoint, set_flag=set_flag,
        start_ici=start_ici, start_tcp=start_tcp, shard_channel=shard_channel,
        put=put, get=get, forward=forward, host=host, dev_kw=dev_kw, Server=Server,
    )


@pytest.fixture(autouse=True)
def always_disarm():
    yield
    for pkg in PKGS:
        pk(pkg).injector.disarm()


def both(scenario, *args):
    """Run ``scenario`` on each package; their results must be equal."""
    results = {pkg: scenario(pk(pkg), *args) for pkg in PKGS}
    assert results["port"] == results["jax"], results
    return results["port"]


def run_both(scenario, *args):
    """Run ``scenario`` on each package and return both results."""
    return {pkg: scenario(pk(pkg), *args) for pkg in PKGS}


def stop_all(servers):
    for srv in servers:
        srv.stop()


def _wait_for(fn, timeout=8.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(0.01)
    return fn()


def assert_forward_close(y, y_ref, x, w):
    scale = np.abs(np.asarray(x, np.float64)) @ np.abs(np.asarray(w, np.float64))
    assert y.shape == y_ref.shape
    assert np.all(np.abs(y.astype(np.float64) - y_ref) <= FWD_RTOL * scale + FWD_ATOL)


# ---------------------------------------------------------------------------
# the shard-per-server PS: routing, scatter, fan-out Forward
# ---------------------------------------------------------------------------

KEYS = [f"key{i}" for i in range(64)]

# shard_of for KEYS[:16], seed 0, 4 shards (murmur3_32, pinned)
GOLDEN_SEED0_N4 = [3, 1, 0, 0, 1, 3, 3, 1, 2, 2, 1, 0, 3, 0, 3, 0]


def _mapping(P, seed, n):
    svcs, servers, eps = P.start_ici(n)
    try:
        ch = P.shard_channel(eps, seed=seed)
        first = [ch.shard_of(k) for k in KEYS]
        rebuilt = P.shard_channel(eps, seed=seed)  # the restart analog
        assert [rebuilt.shard_of(k) for k in KEYS] == first
        return first
    finally:
        stop_all(servers)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n", [2, 4])
def test_shard_mapping_equals_jax(seed, n):
    first = both(_mapping, seed, n)
    assert len(set(first)) == n, "every key mapped to too few shards"
    if (seed, n) == (0, 4):
        assert first[:16] == GOLDEN_SEED0_N4


def _one_owner(P):
    svcs, servers, eps = P.start_ici(4)
    try:
        ch = P.shard_channel(eps, fail_limit=0)
        out = []
        for key in ("alpha", "beta", "gamma", "delta", "epsilon"):
            owner = ch.shard_of(key)
            before = [s.put_calls for s in svcs]
            c, _ = P.put(ch, key, key.encode())
            assert not c.failed(), c.error_text()
            assert c.shard_index == owner
            put_d = [a - b for a, b in zip((s.put_calls for s in svcs), before)]
            holders = [i for i, s in enumerate(svcs) if key in s._store]
            before = [s.get_calls for s in svcs]
            c, _ = P.get(ch, key)
            assert not c.failed(), c.error_text()
            assert c.response_attachment.to_bytes() == key.encode()
            get_d = [a - b for a, b in zip((s.get_calls for s in svcs), before)]
            out.append((key, owner, put_d, get_d, holders))
        return out
    finally:
        stop_all(servers)


def test_get_put_land_exactly_one_rpc_on_owning_shard():
    for key, owner, put_d, get_d, holders in both(_one_owner):
        assert put_d[owner] == 1 and sum(put_d) == 1, (key, put_d)
        assert get_d[owner] == 1 and sum(get_d) == 1, (key, get_d)
        assert holders == [owner]


def _fanout_forward(P, d, seed):
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((d, d)).astype(np.float32)
    xs = rng.standard_normal((3, d)).astype(np.float32)
    svcs, servers, eps = P.start_ici(4)
    try:
        ch = P.shard_channel(eps, fail_limit=0)
        P.ps.scatter_param(ch, "w", W)
        rows = [P.host(s._store["w"]).copy() for s in svcs]
        ys, legs = [], []
        for x in xs:
            before = [s.forward_calls for s in svcs]
            c, r, y = P.forward(ch, "w", x)
            assert not c.failed(), c.error_text()
            assert r.message == "w"
            legs.append([a - b for a, b in zip((s.forward_calls for s in svcs), before)])
            ys.append(y)
        return W, xs, rows, ys, legs
    finally:
        stop_all(servers)


@pytest.mark.parametrize("d,seed", [(64, 0), (64, 1), (128, 2)])
def test_fanout_forward_equals_jax(d, seed):
    res = run_both(_fanout_forward, d, seed)
    W, xs, rows_p, ys_p, legs_p = res["port"]
    _, _, rows_j, ys_j, legs_j = res["jax"]
    # scatter: every shard holds exactly its rows, in both packages
    for i in range(4):
        assert np.array_equal(rows_p[i], W[i * d // 4:(i + 1) * d // 4])
        assert np.array_equal(rows_p[i], rows_j[i])
    # one leg per shard per Forward, issued as one fan-out
    assert legs_p == legs_j == [[1, 1, 1, 1]] * len(xs)
    for x, y_p, y_j in zip(xs, ys_p, ys_j):
        ref = x.astype(np.float64) @ W.astype(np.float64)
        assert_forward_close(y_p, ref, x, W)
        assert_forward_close(y_p, y_j.astype(np.float64), x, W)


def test_scatter_param_of_a_tensor_keeps_its_device_and_rows():
    P = pk("port")
    W = torch.arange(32 * 16, dtype=torch.float32).reshape(32, 16)
    svcs, servers, eps = P.start_ici(4)
    try:
        ch = P.shard_channel(eps)
        P.ps.scatter_param(ch, "wt", W)
        for i, s in enumerate(svcs):
            got = s._store["wt"]
            assert isinstance(got, torch.Tensor) and got.device == CPU
            assert torch.equal(got, W[8 * i:8 * (i + 1)])
            # the hop delivered a fresh buffer, not a view of W
            assert got.data_ptr() != W[8 * i:8 * (i + 1)].data_ptr()
        with pytest.raises(ValueError, match="do not scatter"):
            P.ps.scatter_param(ch, "odd", W[:30])
    finally:
        stop_all(servers)


def test_scatter_param_fails_when_a_shard_put_fails():
    """No fallback: a shard whose Put fails fails the scatter."""
    P = pk("port")
    svcs, servers, eps = P.start_ici(4)
    try:
        ch = P.shard_channel(eps)
        servers[2].stop()
        with pytest.raises(RuntimeError, match="shard 2 Put failed"):
            P.ps.scatter_param(ch, "w", np.ones((8, 8), np.float32))
        assert all("w" in s._store for i, s in enumerate(svcs) if i < 2)
    finally:
        stop_all(servers)


def test_shard_device_follows_the_server_port():
    """Rows for a local shard are made on its server port's device; a
    remote shard's on the channel's ``ici_device``; with neither a
    card nor a device the lookup raises."""
    P = pk("port")
    svcs, servers, eps = P.start_ici(1)
    try:
        ch = P.shard_channel(eps)
        assert P.ps._shard_device(ch.partitions()[0]) == CPU
        remote = P.Channel(P.ChannelOptions(ici_device=CPU))
        assert remote.init(f"ici://slice{SLICE}/chip9999") == 0
        assert P.ps._shard_device(remote) == CPU
        if not torch.cuda.is_available():
            bare = P.Channel()
            assert bare.init(f"ici://slice{SLICE}/chip9998") == 0
            with pytest.raises(RuntimeError, match="no CUDA device"):
                P.ps._shard_device(bare)
    finally:
        stop_all(servers)


def _dead_shard(P):
    rng = np.random.default_rng(7)
    d, dead = 64, 2
    W = rng.standard_normal((d, d)).astype(np.float32)
    svcs, servers, eps = P.start_ici(4)
    try:
        ch = P.shard_channel(eps, fail_limit=0)
        P.ps.scatter_param(ch, "w", W)
        live_key = next(k for k in KEYS if ch.shard_of(k) != dead)
        dead_key = next(k for k in KEYS if ch.shard_of(k) == dead)
        assert not P.put(ch, live_key, b"v")[0].failed()
        servers[dead].stop()
        # fail_limit=0: the fan-out fails loudly, with an ERPC code
        c, _, _ = P.forward(ch, "w", np.ones(d, np.float32))
        strict = c.failed() and c.error_code in (
            P.errors.ETOOMANYFAILS, P.errors.EFAILEDSOCKET, P.errors.ERPCTIMEDOUT)
        # fail_limit=1: a degraded merge over the 3 surviving legs
        tolerant = P.ps.sharded_ps_channel(
            sub_channels=ch.partitions(), fail_limit=1, timeout_ms=30000)
        c, _, y = P.forward(tolerant, "w", np.ones(d, np.float32))
        assert not c.failed(), c.error_text()
        # routed isolation: the live shard serves, the dead one fails ERPC
        live_ok = not P.get(ch, live_key)[0].failed()
        c = P.Controller()
        c.max_retry = 0
        P.ps.ps_stub(ch).Get(c, P.EchoRequest(message=dead_key))
        dead_erpc = c.failed() and c.error_code in (
            P.errors.EFAILEDSOCKET, P.errors.ERPCTIMEDOUT)
        return (strict, live_ok, dead_erpc), W, y
    finally:
        stop_all(servers)


def test_dead_shard_degrades_per_fail_limit():
    res = run_both(_dead_shard)
    assert res["port"][0] == res["jax"][0] == (True, True, True)
    W, y_p, y_j = res["port"][1], res["port"][2], res["jax"][2]
    rows = W.shape[0] // 4
    x = np.ones(W.shape[0], np.float32)
    keep = np.ones(W.shape[0], bool)
    keep[2 * rows:3 * rows] = False  # the dead shard's rows are missing
    ref = (x[keep].astype(np.float64)) @ W[keep].astype(np.float64)
    assert_forward_close(y_p, ref, x, W)
    assert_forward_close(y_p, y_j.astype(np.float64), x, W)


def _leg_spans(P):
    P.set_flag("rpcz_max_spans_per_second", 1_000_000)
    svcs, servers, eps = P.start_ici(4)
    try:
        ch = P.shard_channel(eps)
        P.ps.scatter_param(ch, "w", np.ones((16, 16), np.float32))
        c, _, y = P.forward(ch, "w", np.ones(16, np.float32))
        assert not c.failed(), c.error_text()

        def fanout_legs():
            roots = [s for s in P.span_db().recent(400)
                     if s.kind == "client" and s.method == "Forward"
                     and s.parent_span_id == 0]
            if not roots:
                return None
            legs = [s for s in P.span_db().recent(400)
                    if s.trace_id == roots[-1].trace_id and s.kind == "client"
                    and s.span_id != roots[-1].span_id]
            return legs if len(legs) >= 4 else None

        assert _wait_for(fanout_legs), "per-leg client spans never joined the trace"
        return len(fanout_legs()), y.tolist()
    finally:
        P.set_flag("rpcz_max_spans_per_second", 500)
        stop_all(servers)


def test_fanout_forward_per_leg_spans_join_one_trace():
    n, y = both(_leg_spans)
    assert n >= 4 and y == [16.0] * 16


# ---------------------------------------------------------------------------
# the replicated PS (replication/channel.py over real TCP servers)
# ---------------------------------------------------------------------------


def _rf1(P):
    svcs, servers, eps = P.start_tcp(2)
    try:
        ch = P.replication.replicated_ps_channel(
            [[eps[0]], [eps[1]]], register=False, name_prefix="rf1t")
        assert ch.rf1 is True
        assert isinstance(ch._direct, P.combo.ShardRoutedChannel)
        got = []
        for k in ("a", "b", "c"):
            c, _ = P.put(ch, k, f"v-{k}".encode())
            assert not c.failed(), c.error_text()
            c, _ = P.get(ch, k)
            got.append(c.response_attachment.to_bytes())
        counters = [dict(g.counters) for g in ch.groups]
        return got, counters, [g.leader() is None for g in ch.groups]
    finally:
        stop_all(servers)


def test_rf1_collapses_to_unreplicated_path():
    got, counters, no_leader = both(_rf1)
    assert got == [b"v-a", b"v-b", b"v-c"]
    assert all(v == 0 for cs in counters for v in cs.values())
    assert no_leader == [True, True]  # no election ever ran


def _semantics(P, value):
    svcs, servers, eps = P.start_tcp(3)
    try:
        ch = P.replication.replicated_ps_channel(
            [eps], register=False, lease_ttl_s=5.0, name_prefix="sem")
        out = []
        c, r = P.put(ch, "k1", value)
        out.append((c.failed(), r.message))
        c, _ = P.get(ch, "k1")
        out.append((c.failed(), c.response_attachment.to_bytes()))
        # durability fan: every replica individually holds the value
        for ep in eps:
            sub = P.Channel()
            assert sub.init(ep) == 0
            out.append(P.resharding.PsShardStore(sub).read("k1"))
        c, _ = P.get(ch, "never-written")
        out.append(c.failed() and c.error_code == P.errors.EREQUEST)
        for _ in range(2):
            c = P.Controller()
            r = P.ps.ps_stub(ch).Delete(c, P.EchoRequest(message="k1"))
            out.append((c.failed(), r.message))
        out.append(ch.groups[0].counters["quorum_writes"])  # put + 2 deletes
        c, _ = P.get(ch, "k1")
        out.append(c.failed() and c.error_code == P.errors.EREQUEST)
        return out
    finally:
        stop_all(servers)


@pytest.mark.parametrize("kind", ["bytes", "device"])
def test_replicated_channel_put_get_delete_semantics(kind):
    vals = np.random.default_rng(3).standard_normal((16, 8)).astype(np.float32)
    blob = vals.tobytes()
    if kind == "bytes":
        out = both(_semantics, b"hello")
        blob = b"hello"
    else:
        # a device tensor Put through the replicated channel: each
        # replica stores its bytes, as in the JAX package
        res = {
            "port": _semantics(pk("port"), torch.from_numpy(vals.copy())),
            "jax": _semantics(pk("jax"), jnp.asarray(vals)),
        }
        assert res["port"] == res["jax"], res
        out = res["port"]
    assert out == [(False, "k1"), (False, blob), blob, blob, blob, True,
                   (False, "1"), (False, "0"), 3, True]


class _SlowGet(dict):
    """A PsService store whose reads stall on the server's worker."""

    def __init__(self, base):
        super().__init__(base)
        self.delay_s = 0.0

    def get(self, k, default=None):
        if self.delay_s:
            time.sleep(self.delay_s)
        return super().get(k, default)


def _hedged(P):
    svcs, servers, eps = P.start_tcp(3)
    try:
        svc_by_ep = {f"127.0.0.1:{srv.port}": svc for svc, srv in zip(svcs, servers)}
        ch = P.replication.replicated_ps_channel(
            [eps], register=False, lease_ttl_s=5.0, hedge_ms=10,
            timeout_ms=15000, name_prefix="hedge")
        g = ch.groups[0]
        keys = [f"hk{i}" for i in range(6)]
        for k in keys:
            assert not P.put(ch, k, f"v-{k}".encode())[0].failed()
        for k in keys:  # warm the read plane before the slowdown
            assert not P.get(ch, k)[0].failed()
        leader = g.ensure_leader()
        slow = []
        for ep in eps:
            if ep != leader.endpoint:
                store = _SlowGet(svc_by_ep[ep]._store)
                store.delay_s = 0.08
                svc_by_ep[ep]._store = store
                slow.append(store)
        ok = 0
        for i in range(12):
            k = keys[i % len(keys)]
            c, _ = P.get(ch, k)
            if not c.failed() and c.response_attachment.to_bytes() == f"v-{k}".encode():
                ok += 1
            time.sleep(0.05)  # let abandoned hedged originals drain
        for store in slow:
            store.delay_s = 0.0
        return len(slow), ok, g.counters["hedged_reads"] > 0
    finally:
        stop_all(servers)


def test_hedged_read_covers_slow_replicas_and_counts():
    assert both(_hedged) == (2, 12, True)


def _leader_kill(P):
    svcs, servers, eps = P.start_tcp(3)
    try:
        ch = P.replication.replicated_ps_channel(
            [eps], register=False, lease_ttl_s=1.0, hedge_ms=20,
            timeout_ms=15000, name_prefix="kill")
        g = ch.groups[0]
        leader = g.ensure_leader()
        follower = next(n for n in g.nodes if n is not leader)
        plan = P.replica_storm_plan(
            seed=20260806, group=g.name, ack_drop_pct=0.3,
            ack_peer=follower.name, ack_max_hits=6)
        acked, timing = {}, {}

        def workload(h):
            for i in range(24):
                k = f"wk{i}"
                v = f"v-{k}".encode()
                c, _ = P.put(ch, k, v)
                h.record_error(c.error_code)
                if not c.failed():
                    acked[k] = v
                    if "killed" in timing and "recovered" not in timing:
                        timing["recovered"] = time.monotonic()
                if i == 7:  # stop the lease holder mid-storm
                    victim = next(s for s in servers
                                  if f"127.0.0.1:{s.port}" == leader.endpoint)
                    victim.stop()
                    g.mark_dead(leader.name)
                    timing["killed"] = time.monotonic()
            lost = []  # durability audit: every acked write reads back
            for k, v in acked.items():
                c, _ = P.get(ch, k)
                h.record_error(c.error_code)
                if c.failed() or c.response_attachment.to_bytes() != v:
                    lost.append(k)
            return lost

        report = P.RecoveryHarness(plan, wall_clock_s=60.0).run_or_raise(workload)
        failover_s = timing["recovered"] - timing["killed"]
        return (report.workload_result, len(acked) >= 16,
                failover_s < g.lease_ttl_s + 2.0, g.counters["leader_changes"] >= 1,
                report.hits.get("replica.ack", {}).get("drop", 0) >= 1)
    finally:
        stop_all(servers)


def test_leader_kill_mid_write_storm_zero_acked_write_loss():
    assert both(_leader_kill) == ([], True, True, True, True)


# ---------------------------------------------------------------------------
# PS migration: DynamicShardChannel + ReshardCoordinator over PsShardStore
# ---------------------------------------------------------------------------


def _dyn_channel(P, eps):
    old = P.shard_channel(eps[:2], timeout_ms=10000)
    new = P.shard_channel(eps, timeout_ms=10000)
    view = P.resharding.MigrationView()
    return P.combo.DynamicShardChannel(old, new, view), old, new, view


def _flap(P):
    svcs, servers, eps = P.start_ici(4)
    try:
        def nodes_for(pair):
            return [P.ServerNode(P.str2endpoint(ep), tag=f"{i}/2")
                    for i, ep in enumerate(pair)]

        ch = P.combo.ShardRoutedChannel(
            options=P.combo.ParallelChannelOptions(timeout_ms=15000))
        ch.on_servers_changed(nodes_for(eps[:2]))
        parts_before = ch.partitions()
        merged = []

        def keys_merge(parent_ctrl, parent_resp, sub_ctrls, sub_resps):
            oks = [sr.message for sc, sr in zip(sub_ctrls, sub_resps)
                   if sc is not None and not sc.failed()]
            merged.append(oks)
            parent_resp.message = ",".join(oks)

        ch.set_fanout("Keys", lambda i, n, req, pc, sc: req, keys_merge)
        svcs[0].gate.clear()  # hold shard 0's leg open
        box = {}

        def call():
            c = P.Controller()
            P.ps.ps_stub(ch).Keys(c, P.EchoRequest())
            box["failed"], box["err"] = c.failed(), c.error_text()

        t = threading.Thread(target=call)
        t.start()
        assert _wait_for(lambda: svcs[0].keys_calls == 1 and svcs[1].keys_calls == 1)
        # the flap, mid-fan-out: the same members re-announced
        ch.on_servers_changed(nodes_for(eps[:2]))
        same = ch.partitions() == parts_before
        svcs[0].gate.set()
        t.join(15.0)
        assert not t.is_alive()
        assert not box["failed"], box["err"]
        return same, svcs[0].keys_calls, svcs[1].keys_calls, len(merged), len(merged[0])
    finally:
        svcs[0].gate.set()
        stop_all(servers)


def test_membership_flap_mid_fanout_exactly_once():
    assert both(_flap) == (True, 1, 1, 1, 2)


def _live_migration(P, n_keys, value_kind):
    svcs, servers, eps = P.start_ici(4)
    try:
        dyn, old_ch, new_ch, view = _dyn_channel(P, eps)
        keys = [f"key{i}" for i in range(n_keys)]
        rng = np.random.default_rng(11)
        vals = {}
        for k in keys:
            if value_kind == "bytes":
                v = f"v-{k}".encode()
                c, _ = P.put(dyn, k, v)
            else:
                a = rng.standard_normal((4, 8)).astype(np.float32)
                v = a.tobytes()
                c, _ = P.put(dyn, k, torch.from_numpy(a) if P.pkg == "port"
                             else jnp.asarray(a))
            assert not c.failed(), c.error_text()
            vals[k] = v
        planned = P.resharding.moved_keys(keys, 2, 4)
        old_parts = [P.resharding.PsShardStore(p) for p in old_ch.partitions()]
        new_parts = [P.resharding.PsShardStore(p) for p in new_ch.partitions()]
        coord = P.resharding.ReshardCoordinator("ps-live", old_parts, new_parts, view=view)
        stop = threading.Event()
        op_log, wrong = [], []

        def hammer():
            i = 0
            while not stop.is_set():
                k = keys[i % len(keys)]
                if i % 3 == 2 and value_kind == "bytes":
                    c, _ = P.put(dyn, k, vals[k])
                    op_log.append(("Put", k, c.error_code))
                else:
                    c, _ = P.get(dyn, k)
                    op_log.append(("Get", k, c.error_code))
                    if not c.failed() and c.response_attachment.to_bytes() != vals[k]:
                        wrong.append(k)
                i += 1

        t = threading.Thread(target=hammer)
        t.start()
        try:
            rep = coord.run()
        finally:
            stop.set()
            t.join(15.0)
        assert not t.is_alive()
        bad = [e for e in op_log if e[2] != 0]
        at_new = []
        for k in keys:  # every key readable at its NEW owner
            c, _ = P.get(new_ch.partitions()[P.resharding.shard_of(k, 4)], k)
            at_new.append(not c.failed() and c.response_attachment.to_bytes() == vals[k])
        stale = [sorted({k for k in planned if planned[k][0] == i} & set(part.list_keys()))
                 for i, part in enumerate(old_parts)]
        return (rep["completed"], rep["phase"], rep["epoch"], view.cut_over(),
                dyn.channels()[0] is new_ch, rep["counters"]["keys_moved"],
                rep["counters"]["keys_copied"], rep["counters"]["checksum_failures"],
                sorted(planned), bad[:5], wrong[:5], len(op_log) > 0,
                all(at_new), stale)
    finally:
        stop_all(servers)


@pytest.mark.parametrize("n_keys,value_kind", [(16, "bytes"), (24, "device")])
def test_live_migration_zero_downtime_under_load(n_keys, value_kind):
    out = both(_live_migration, n_keys, value_kind)
    (completed, phase, epoch, cut_over, new_primary, moved, copied, csum_fail,
     planned, bad, wrong, any_ops, all_at_new, stale) = out
    assert completed and phase == "DONE" and epoch == 1 and cut_over and new_primary
    assert moved == copied == len(planned) > 0 and csum_fail == 0
    assert bad == [] and wrong == [] and any_ops and all_at_new
    assert stale == [[], []]


def _inflight(P):
    svcs, servers, eps = P.start_ici(4)
    try:
        dyn, old_ch, new_ch, view = _dyn_channel(P, eps)

        def keys_merge(parent_ctrl, parent_resp, sub_ctrls, sub_resps):
            parent_resp.message = str(
                sum(1 for sc in sub_ctrls if sc is not None and not sc.failed()))

        dyn.set_fanout("Keys", lambda i, n, req, pc, sc: req, keys_merge)
        svcs[0].gate.clear()
        box = {}

        def call():
            c = P.Controller()
            r = P.ps.ps_stub(dyn).Keys(c, P.EchoRequest())
            box["failed"], box["legs"] = c.failed(), r.message

        t = threading.Thread(target=call)
        t.start()
        assert _wait_for(lambda: svcs[0].keys_calls == 1)
        view.bump_epoch()  # the cutover lands while the fan-out is parked
        cut = view.cut_over()
        svcs[0].gate.set()
        t.join(15.0)
        assert not t.is_alive()
        during = (box["failed"], box["legs"], svcs[2].keys_calls, svcs[3].keys_calls)
        c = P.Controller()
        r = P.ps.ps_stub(dyn).Keys(c, P.EchoRequest())
        after = (c.failed(), r.message, svcs[2].keys_calls, svcs[3].keys_calls)
        return cut, during, after
    finally:
        svcs[0].gate.set()
        stop_all(servers)


def test_inflight_fanout_finishes_on_scheme_it_started_on():
    # 2 legs on the scheme it started on, then 4 on the new one
    assert both(_inflight) == (True, (False, "2", 0, 0), (False, "4", 1, 1))


def _kill_source(P, with_copies):
    svcs, servers, eps = P.start_ici(4)
    try:
        dyn, old_ch, new_ch, view = _dyn_channel(P, eps)
        keys = [f"key{i}" for i in range(16)]
        for k in keys:
            assert not P.put(dyn, k, f"v-{k}".encode())[0].failed()
        planned = P.resharding.moved_keys(keys, 2, 4)
        old_parts = [P.resharding.PsShardStore(p) for p in old_ch.partitions()]
        new_parts = [P.resharding.PsShardStore(p) for p in new_ch.partitions()]
        killed = threading.Event()

        def kill_src(key, src, dst):
            if not killed.is_set():
                if with_copies:
                    # dual-write every moved key first, then kill source 0
                    for k in sorted(planned):
                        P.put(dyn, k, f"v-{k}".encode())
                killed.set()
                servers[0].stop()

        shard_of = P.resharding.shard_of
        if with_copies:
            coord = P.resharding.ReshardCoordinator(
                "ps-kill", old_parts, new_parts, view=view, on_copy=kill_src)
            plan = P.reshard_storm_plan(peers=[], seed=1234, copy_drop_pct=0.3,
                                        copy_max_hits=4)

            def workload(h):
                result = coord.run()
                for k in sorted(planned):  # reads fall back to the new copies
                    c, _ = P.get(dyn, k)
                    h.record_error(c.error_code)
                return result

            report = P.RecoveryHarness(plan, wall_clock_s=60.0).run_or_raise(workload)
            rep = report.workload_result
            src0 = {k for k, (s, _) in planned.items() if s == 0}
            at_new = []
            for k in keys:
                if shard_of(k, 4) == 0:
                    continue
                c, _ = P.get(new_ch.partitions()[shard_of(k, 4)], k)
                at_new.append((k, c.failed()))
            return (rep["completed"], rep["counters"]["survivor_completions"] >= len(src0) > 0,
                    bool(report.error_codes) and all(c == 0 for c in report.error_codes),
                    dyn.reads_fell_back + dyn.dual_writes > 0,
                    report.hits.get("reshard.copy", {}).get("drop", 0) >= 1, at_new)
        coord = P.resharding.ReshardCoordinator(
            "ps-kill-rb", old_parts, new_parts, view=view, on_copy=kill_src,
            copy_rounds=2)
        rep = coord.run()
        survivors = []
        for k in keys:
            if shard_of(k, 2) == 1:
                c, _ = P.get(dyn, k)
                survivors.append((k, c.failed(), c.response_attachment.to_bytes()))
        dead_key = next(k for k in keys if shard_of(k, 2) == 0)
        c, _ = P.get(dyn, dead_key)
        dead_erpc = c.failed() and c.error_code in (
            P.errors.ETOOMANYFAILS, P.errors.EFAILEDSOCKET, P.errors.ERPCTIMEDOUT)
        return (rep["rolled_back"], rep["phase"], rep["epoch"], view.cut_over(),
                dyn.channels()[0] is old_ch, survivors, dead_erpc)
    finally:
        stop_all(servers)


def test_kill_source_mid_copy_completes_from_survivors():
    completed, survivors_ok, reads_ok, fell_back, storm_fired, at_new = both(
        _kill_source, True)
    assert completed and survivors_ok and reads_ok and fell_back and storm_fired
    assert at_new and not any(failed for _, failed in at_new)


def test_kill_source_mid_copy_without_copies_rolls_back():
    rolled_back, phase, epoch, cut_over, old_primary, survivors, dead_erpc = both(
        _kill_source, False)
    assert rolled_back and phase == "ROLLED_BACK" and epoch == 0
    assert not cut_over and old_primary and dead_erpc
    assert survivors and all(
        not failed and v == f"v-{k}".encode() for k, failed, v in survivors)


def _forward_across_reshard(P):
    """bench_resharding's Forward half: W scattered per scheme (layout
    keys left out of the census), a fan-out Forward on the channel's
    primary scheme before and after a live 2 -> 4 move of KV keys."""
    rng = np.random.default_rng(5)
    d = 64
    W = rng.standard_normal((d, d)).astype(np.float32)
    x = rng.standard_normal(d).astype(np.float32)
    svcs, servers, eps = P.start_ici(4)
    try:
        dyn, old_ch, new_ch, view = _dyn_channel(P, eps)
        P.ps.scatter_param(old_ch, "w2", W)
        P.ps.scatter_param(new_ch, "w4", W)
        keys = [f"bkey{i}" for i in range(12)]
        for k in keys:
            assert not P.put(dyn, k, f"v-{k}".encode())[0].failed()
        ys, legs = [], []
        for _ in range(2):
            primary = dyn.channels()[0]
            w_key = "w2" if primary is old_ch else "w4"
            before = [s.forward_calls for s in svcs]
            c, _, y = P.forward(primary, w_key, x)
            assert not c.failed(), c.error_text()
            ys.append(y)
            legs.append([a - b for a, b in zip((s.forward_calls for s in svcs), before)])
            if len(ys) == 1:
                rep = P.resharding.ReshardCoordinator(
                    "ps-fwd", [P.resharding.PsShardStore(p) for p in old_ch.partitions()],
                    [P.resharding.PsShardStore(p) for p in new_ch.partitions()],
                    view=view, key_filter=lambda k: not k.startswith("w")).run()
        planned = P.resharding.moved_keys(keys, 2, 4)
        return (rep["completed"], rep["counters"]["keys_moved"] == len(planned), legs,
                W, x, ys)
    finally:
        stop_all(servers)


def test_fanout_forward_across_a_live_reshard():
    res = run_both(_forward_across_reshard)
    assert res["port"][:3] == res["jax"][:3] == (True, True, [[1, 1, 0, 0], [1, 1, 1, 1]])
    W, x, ys_p = res["port"][3:]
    ref = x.astype(np.float64) @ W.astype(np.float64)
    for y_p, y_j in zip(ys_p, res["jax"][5]):
        assert_forward_close(y_p, ref, x, W)
        assert_forward_close(y_p, y_j.astype(np.float64), x, W)


# ---------------------------------------------------------------------------
# the in-mesh sharded store (batching/sharded.py over a (1, 8) mesh)
# ---------------------------------------------------------------------------


def mk(pkg):
    """One package's in-mesh PS surface: (1, n) meshes, the service and
    the single-request and batch Forward adapters."""
    if pkg == "port":
        from incubator_brpc_tpu_torch.chaos.plan import FaultPlan, FaultSpec
        from incubator_brpc_tpu_torch.observability.span import Span, swap_current_span
        from incubator_brpc_tpu_torch.parallel.mesh import create_mesh
        from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoResponse
        from incubator_brpc_tpu_torch.server.server import ServerOptions

        def mesh(n):
            return create_mesh((1, n), devices=[CPU] * n)

        def shards(val):
            return [s.numpy() for s in val.shards]
    else:
        import jax

        from incubator_brpc_tpu.chaos.plan import FaultPlan, FaultSpec
        from incubator_brpc_tpu.observability.span import Span, swap_current_span
        from incubator_brpc_tpu.parallel.mesh import create_mesh
        from incubator_brpc_tpu.protos.echo_pb2 import EchoResponse
        from incubator_brpc_tpu.server.server import ServerOptions

        def mesh(n):
            return create_mesh((1, n), devices=jax.devices("cpu")[:n])

        def shards(val):
            return [np.asarray(s.data) for s in
                    sorted(val.addressable_shards, key=lambda s: s.index[0].start or 0)]

    P = pk(pkg)

    def forward_rows(svc, keys_xs):
        """One batch of Forwards (a key and x per row) through the batch
        handler: [(failed, error_code, y)] per row."""
        ctrls, reqs, resps = [], [], []
        for key, x in keys_xs:
            c = P.Controller()
            c.request_attachment.append_user_data(np.asarray(x, np.float32).tobytes())
            ctrls.append(c)
            reqs.append(P.EchoRequest(message=key))
            resps.append(EchoResponse())
        P.ps.PsService.Forward.__batch_fn__(svc, ctrls, reqs, resps, lambda: None)
        return [(c.failed(), c.error_code, None if c.failed() else np.frombuffer(
            c.response_attachment.to_bytes(), np.float32).copy()) for c in ctrls]

    return types.SimpleNamespace(
        P=P, mesh=mesh, shards=shards, forward_rows=forward_rows,
        FaultPlan=FaultPlan, FaultSpec=FaultSpec, Span=Span,
        swap_current_span=swap_current_span, ServerOptions=ServerOptions,
        EchoResponse=EchoResponse,
    )


def _put_param_shards(pkg):
    M = mk(pkg)
    svc = M.P.ps.PsService(mesh=M.mesh(8))
    w = np.random.default_rng(4).standard_normal((64, 32)).astype(np.float32)
    out = [svc.put_param("w", w), [s.shape for s in M.shards(svc._store["w"])]]
    out += [svc.put_param("odd", np.ones((63, 32), np.float32)),
            svc.put_param("vec", np.ones((64,), np.float32))]
    plain = M.P.ps.PsService(**M.P.dev_kw)
    out += [plain.shard_kernel is None, plain.put_param("w", w)]
    return out, M.shards(svc._store["w"])


def test_put_param_shards_eligible_matrices():
    res = run_both(_put_param_shards)
    assert res["port"][0] == res["jax"][0] == [True, [(8, 32)] * 8, False, False, True, False]
    for a, b in zip(res["port"][1], res["jax"][1]):
        assert a.tobytes() == b.tobytes()


def test_sharded_shards_are_copies_on_each_chip_device():
    """Each chip's rows are a contiguous copy of their own (never a view
    that keeps the whole W alive), charged once to ``ps.params`` as the
    sum of the shards' bytes."""
    from incubator_brpc_tpu_torch.models import parameter_server as ps_mod

    M = mk("port")
    svc = M.P.ps.PsService(mesh=M.mesh(8))
    w = torch.arange(64 * 16, dtype=torch.float32).reshape(64, 16)
    before = ps_mod._PS_ACCT.live_bytes()
    assert svc.put_param("w", w) is True
    stored = svc._store["w"]
    assert svc._hbm["w"] == (w.nbytes, 1) and stored.nbytes == w.nbytes
    assert ps_mod._PS_ACCT.live_bytes() - before in (0, w.nbytes)  # 0: tracking off
    for k, shard in enumerate(stored.shards):
        assert shard.device == CPU and shard.is_contiguous()
        assert shard.untyped_storage().nbytes() == 8 * 16 * 4
        assert torch.equal(shard, w[8 * k:8 * (k + 1)])
    svc.Delete(M.P.Controller(), M.P.EchoRequest(message="w"), M.EchoResponse(), lambda: None)
    assert "w" not in svc._sharded_keys and "w" not in svc._hbm


def _one_execution_per_batch(pkg, W, x):
    M = mk(pkg)
    svc = M.P.ps.PsService(mesh=M.mesh(8))
    srv = M.P.Server(M.ServerOptions(enable_batching=True))
    srv.add_service(svc)
    assert srv.start(0) == 0
    try:
        svc.put_param("w", W)
        ch = M.P.Channel(M.P.ChannelOptions(timeout_ms=30000))
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        c, _, _ = M.P.forward(ch, "w", x)  # warm (the JAX trace) outside the window
        assert not c.failed(), c.error_text()
        kern = svc.shard_kernel
        e0, m0 = kern.executions, kern.collective_merges
        b0 = srv.batcher("PsService.Forward").batches
        res = [None] * 16
        barrier = threading.Barrier(16, timeout=30)

        def call(i):
            barrier.wait()  # arrive together, inside one batching window
            res[i] = M.P.forward(ch, "w", x)

        ts = [threading.Thread(target=call, args=(i,)) for i in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
        batcher = srv.batcher("PsService.Forward")
        batches = batcher.batches - b0
        ys = []
        for c, _, y in res:
            assert not c.failed(), c.error_text()
            ys.append(y)
        ch.close()
        return (batches, kern.executions - e0, kern.collective_merges - m0,
                batcher.max_batch_seen, ys)
    finally:
        srv.stop()


def test_sharded_forward_one_execution_one_merge_per_batch():
    rng = np.random.default_rng(5)
    W = rng.standard_normal((64, 48)).astype(np.float32)
    x = rng.standard_normal(64).astype(np.float32)
    ref = x.astype(np.float64) @ W.astype(np.float64)
    res = run_both(_one_execution_per_batch, W, x)
    for pkg, (batches, execs, merges, seen, ys) in res.items():
        assert batches >= 1 and execs == merges == batches, (pkg, batches, execs, merges)
        assert seen >= 2, f"{pkg}: nothing ever coalesced"
        for y in ys:
            assert_forward_close(y, ref, x, W)
    for y_p, y_j in zip(res["port"][4], res["jax"][4]):
        assert_forward_close(y_p, y_j.astype(np.float64), x, W)


def _sharded_vs_plain(pkg, W, xs):
    M = mk(pkg)
    sharded = M.P.ps.PsService(mesh=M.mesh(8))
    plain = M.P.ps.PsService(**M.P.dev_kw)
    sharded.put_param("w", W)
    plain.put_param("w", W)
    out = []
    for svc in (sharded, plain):
        rows = M.forward_rows(svc, [("w", x) for x in xs])
        assert not any(failed for failed, _, _ in rows)
        out.append([y for _, _, y in rows])
    return out, sharded.shard_kernel.executions


@pytest.mark.parametrize("seed", [0, 1])
def test_sharded_forward_matches_unsharded_and_jax(seed):
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((64, 64)).astype(np.float32)
    xs = rng.standard_normal((3, 64)).astype(np.float32)
    res = run_both(_sharded_vs_plain, W, xs)
    (ys_p, plain_p), execs_p = res["port"]
    (ys_j, _), execs_j = res["jax"]
    assert execs_p == execs_j == 1  # three rows, one batch, one execution
    for x, y_p, y_plain, y_j in zip(xs, ys_p, plain_p, ys_j):
        ref = x.astype(np.float64) @ W.astype(np.float64)
        assert_forward_close(y_p, ref, x, W)
        assert_forward_close(y_p, y_plain.astype(np.float64), x, W)
        assert_forward_close(y_p, y_j.astype(np.float64), x, W)


def _subspan(pkg):
    M = mk(pkg)
    M.P.set_flag("rpcz_max_spans_per_second", 1_000_000)
    try:
        svc = M.P.ps.PsService(mesh=M.mesh(8))
        svc.put_param("w", np.random.default_rng(6).standard_normal((64, 32)).astype(np.float32))
        root = M.Span.create_client("test", "shardspan")
        prev = M.swap_current_span(root)
        try:
            svc.shard_kernel(svc._store["w"],
                             np.random.default_rng(7).standard_normal((4, 64)).astype(np.float32))
        finally:
            M.swap_current_span(prev)
            root.end(0)

        def legs():
            return [s for s in M.P.span_db().recent(300)
                    if s.trace_id == root.trace_id and s.kind == "collective"]

        _wait_for(legs)
        found = legs()
        return len(found), found[0].method, found[0].parent_span_id == root.span_id
    finally:
        M.P.set_flag("rpcz_max_spans_per_second", 500)


def test_sharded_forward_leaves_collective_subspan():
    assert both(_subspan) == (1, "psum_forward@chip", True)


def _chaos_reset(pkg):
    M = mk(pkg)
    svc = M.P.ps.PsService(mesh=M.mesh(8))
    rng = np.random.default_rng(8)
    svc.put_param("w", rng.standard_normal((64, 32)).astype(np.float32))
    svc.put_param("odd", rng.standard_normal((63, 32)).astype(np.float32))
    plan = M.FaultPlan(
        [M.FaultSpec("collective.merge", "reset", probability=1.0,
                     match={"method": "PsService.Forward"})],
        seed=11, name="merge-reset",
    )
    batch = [("w", np.ones(64)), ("odd", np.ones(63)), ("w", np.ones(64))]
    M.P.injector.arm(plan)
    try:
        armed = [(failed, code) for failed, code, _ in M.forward_rows(svc, batch)]
    finally:
        M.P.injector.disarm()
    after = [(failed, code) for failed, code, _ in M.forward_rows(svc, batch)]
    return armed, after, svc.shard_kernel.executions


def test_collective_merge_chaos_reset_fails_only_that_group():
    armed, after, executions = both(_chaos_reset)
    EINTERNAL = pk("port").errors.EINTERNAL
    # the sharded group's two rows fail EINTERNAL; the single-chip group
    # in the same batch executes; disarmed traffic recovers
    assert armed == [(True, EINTERNAL), (False, 0), (True, EINTERNAL)]
    assert after == [(False, 0)] * 3
    assert executions == 1  # the reset batch never executed: no retry on one chip


def _ceiling(pkg):
    M = mk(pkg)
    budget = 1 << 20  # 1 MB per chip, synthetic
    d1 = M.P.ps.max_servable_dim(budget, 1)
    d8 = M.P.ps.max_servable_dim(budget, 8)
    svc = M.P.ps.PsService(mesh=M.mesh(8))
    W = np.zeros((d8, d8), np.float32)
    placed = svc.put_param("big", W)
    per_chip = [s.nbytes for s in M.shards(svc._store["big"])]
    return d1, d8, placed, per_chip, W.nbytes > budget


def test_max_servable_dim_hbm_ceiling():
    d1, d8, placed, per_chip, busts_one = both(_ceiling)
    assert d8 >= 2 * d1 and placed and busts_one
    assert len(per_chip) == 8 and max(per_chip) <= 1 << 20


def _sharded_get(pkg, W):
    M = mk(pkg)
    svc = M.P.ps.PsService(mesh=M.mesh(8))
    srv = M.P.Server()
    srv.add_service(svc)
    assert srv.start(0) == 0
    try:
        svc.put_param("w", W)
        ch = M.P.Channel(M.P.ChannelOptions(timeout_ms=30000))
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        c, _ = M.P.get(ch, "w")
        assert not c.failed(), c.error_text()
        ch.close()
        return c.response_attachment.to_bytes()
    finally:
        srv.stop()


def test_get_of_a_sharded_key_is_the_logical_matrix():
    W = np.random.default_rng(9).standard_normal((64, 24)).astype(np.float32)
    assert both(_sharded_get, W) == W.tobytes()


def test_put_of_a_device_tensor_over_ici_shards_it_and_get_assembles_it():
    """A W that arrives by Put over ici:// (the fabric's fresh tensor)
    is row-sharded on the mesh's chips; Get attaches the assembled W on
    the service's device."""
    M = mk("port")
    svc = M.P.ps.PsService(mesh=M.mesh(4))
    srv = M.P.Server()
    srv.add_service(svc)
    _chips["port"][0] += 1
    chip = _chips["port"][0]
    assert srv.start_ici(SLICE, chip, device=CPU) == 0
    try:
        W = torch.from_numpy(np.random.default_rng(10).standard_normal((32, 8)).astype(np.float32))
        ch = M.P.Channel(M.P.ch_opts())
        assert ch.init(f"ici://slice{SLICE}/chip{chip}") == 0
        c, _ = M.P.put(ch, "w", W)
        assert not c.failed(), c.error_text()
        assert "w" in svc._sharded_keys
        assert [tuple(s.shape) for s in svc._store["w"].shards] == [(8, 8)] * 4
        c, _ = M.P.get(ch, "w")
        assert not c.failed(), c.error_text()
        got = c.response_attachment.device_arrays()
        assert len(got) == 1 and torch.equal(got[0], W)
        ch.close()
    finally:
        srv.stop()


def _remesh(pkg, W, xs):
    M = mk(pkg)
    svc = M.P.ps.PsService(mesh=M.mesh(8))
    svc.put_param("w", W)
    svc.put_param("blob", np.ones((63, 8), np.float32))  # never sharded
    before = [y for _, _, y in M.forward_rows(svc, [("w", x) for x in xs])]
    replaced = svc.remesh(M.mesh(4))
    after = M.forward_rows(svc, [("w", x) for x in xs])
    assert not any(failed for failed, _, _ in after)
    kern = svc.shard_kernel
    return (replaced, kern.n_shards(), [s.shape for s in M.shards(svc._store["w"])],
            kern.executions, before, [y for _, _, y in after])


def test_remesh_from_8_to_4_chips_keeps_serving():
    rng = np.random.default_rng(11)
    W = rng.standard_normal((64, 32)).astype(np.float32)
    xs = rng.standard_normal((2, 64)).astype(np.float32)
    res = run_both(_remesh, W, xs)
    assert res["port"][:4] == res["jax"][:4] == (1, 4, [(16, 32)] * 4, 2)
    for pkg in PKGS:
        for ys in res[pkg][4:]:
            for x, y in zip(xs, ys):
                assert_forward_close(y, x.astype(np.float64) @ W.astype(np.float64), x, W)
    for y_p, y_j, x in zip(res["port"][5], res["jax"][5], xs):
        assert_forward_close(y_p, y_j.astype(np.float64), x, W)


def test_remesh_to_one_chip_assembles_and_an_old_placement_still_runs():
    """Down to one chip every sharded value is assembled on the
    service's device and served by the single-chip kernel; a parameter
    still placed on an older mesh runs on its own chips, never through
    the new mesh."""
    M = mk("port")
    svc = M.P.ps.PsService(mesh=M.mesh(8))
    W = np.random.default_rng(12).standard_normal((64, 16)).astype(np.float32)
    svc.put_param("w", W)
    old = svc._store["w"]
    x = np.random.default_rng(13).standard_normal((1, 64)).astype(np.float32)
    svc.shard_kernel.remesh(M.mesh(2))
    y_old = svc.shard_kernel(old, x)
    assert torch.allclose(y_old, torch.from_numpy(x @ W), rtol=1e-5, atol=1e-5)
    assert svc.remesh(None) == 0 and svc.shard_kernel is None
    assert isinstance(svc._store["w"], torch.Tensor) and not svc._sharded_keys
    assert np.array_equal(svc._store["w"].numpy(), W)
    (failed, _, y), = M.forward_rows(svc, [("w", x[0])])
    assert not failed
    assert_forward_close(y, x[0].astype(np.float64) @ W.astype(np.float64), x[0], W)
