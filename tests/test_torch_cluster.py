"""The port's clustered cache tier held against the JAX package's:
cluster channels (naming services, load balancers, ``lb_with_naming``),
``CacheChannel``, replicated cache groups and live resharding.

Each scenario runs on BOTH packages in the same test — the scenarios of
tests/test_cache_cluster.py, tests/test_replication.py:136-379 and :604,
and tests/test_resharding.py:94-299 and :763-873 (less the two that need
``client/combo.py`` or the builtin pages) — and the two runs must agree:
cache values are bytes and compare equal, counters compare equal.  The
port's servers, stores and channels are given ``torch.device("cpu")``;
inputs are numpy arrays from a seed handed to both packages.
"""

import threading
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from incubator_brpc_tpu_torch.convert import tensor_from_reference

CPU = torch.device("cpu")
PKGS = ["jax", "port"]

# this file's slices (per package: the two packages' fabrics are apart)
_slices = {"jax": [230], "port": [230]}


def fresh_slices(pkg, n=1):
    s = _slices[pkg][0]
    _slices[pkg][0] += n
    return tuple(range(s, s + n))


def pk(pkg):
    """One package's cluster surface, with the port pinned to the CPU."""
    if pkg == "port":
        from incubator_brpc_tpu_torch import errors
        from incubator_brpc_tpu_torch import replication, resharding
        from incubator_brpc_tpu_torch.cache import CacheChannel, HBMCacheService
        from incubator_brpc_tpu_torch.cache.channel import CacheError
        from incubator_brpc_tpu_torch.chaos import FaultPlan, FaultSpec, injector
        from incubator_brpc_tpu_torch.chaos import reshard_storm_plan
        from incubator_brpc_tpu_torch.chaos.harness import wait_until
        from incubator_brpc_tpu_torch.client import load_balancer, naming_service
        from incubator_brpc_tpu_torch.client.channel import ChannelOptions
        from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
        from incubator_brpc_tpu_torch.utils.endpoint import EndPoint, str2endpoint
        from incubator_brpc_tpu_torch.utils.hashes import murmur3_32
        from incubator_brpc_tpu_torch.utils.iobuf import DeviceRef

        dev_kw = {"device": CPU}
        cc_opts = lambda: ChannelOptions(timeout_ms=30000, ici_device=CPU)  # noqa: E731
        to_dev = lambda a: tensor_from_reference(a, CPU)  # noqa: E731
    else:
        from incubator_brpc_tpu import errors
        from incubator_brpc_tpu import replication, resharding
        from incubator_brpc_tpu.cache import CacheChannel, HBMCacheService
        from incubator_brpc_tpu.cache.channel import CacheError
        from incubator_brpc_tpu.chaos import FaultPlan, FaultSpec, injector
        from incubator_brpc_tpu.chaos import reshard_storm_plan
        from incubator_brpc_tpu.chaos.harness import wait_until
        from incubator_brpc_tpu.client import load_balancer, naming_service
        from incubator_brpc_tpu.client.channel import ChannelOptions
        from incubator_brpc_tpu.server.server import Server, ServerOptions
        from incubator_brpc_tpu.utils.endpoint import EndPoint, str2endpoint
        from incubator_brpc_tpu.utils.hashes import murmur3_32
        from incubator_brpc_tpu.utils.iobuf import DeviceRef

        dev_kw = {}
        cc_opts = lambda: ChannelOptions(timeout_ms=30000)  # noqa: E731
        to_dev = jnp.asarray

    def start_cache(slice_id, chip):
        srv = Server(ServerOptions(redis_service=HBMCacheService(**dev_kw)))
        assert srv.start_ici(slice_id, chip, **dev_kw) == 0
        return srv

    def cache_channel(url, **kw):
        return CacheChannel(url, options=cc_opts(), **kw)

    def host_bytes(v):
        if v is None or isinstance(v, bytes):
            return v
        return bytes(DeviceRef(v).view())

    return types.SimpleNamespace(
        pkg=pkg, errors=errors, replication=replication, resharding=resharding,
        CacheError=CacheError, FaultPlan=FaultPlan, FaultSpec=FaultSpec,
        injector=injector, reshard_storm_plan=reshard_storm_plan,
        wait_until=wait_until, load_balancer=load_balancer,
        naming_service=naming_service, EndPoint=EndPoint,
        str2endpoint=str2endpoint, murmur3_32=murmur3_32, to_dev=to_dev,
        start_cache=start_cache, cache_channel=cache_channel,
        host_bytes=host_bytes,
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


# ---------------------------------------------------------------------------
# naming services and load balancers: the same node for every key
# ---------------------------------------------------------------------------

ENDPOINTS = (
    [f"ici://slice{s}/chip{c}" for s in (1, 2) for c in range(3)]
    + [f"10.0.0.{i}:80{i}" for i in range(1, 5)]
)
KEYS = [f"key-{i}-{v}" for i, v in enumerate(np.random.default_rng(2024).integers(0, 1 << 30, 1000))]


def _resolve(P, url):
    """The first node list the naming service of ``url`` publishes."""
    got, stop = [], threading.Event()

    class Watcher(P.naming_service.NamingServiceWatcher):
        def on_servers_changed(self, nodes):
            got.append(list(nodes))
            stop.set()

    ns = P.naming_service.find_naming_service(url)
    t = threading.Thread(target=ns.run, args=(url, Watcher(), stop), daemon=True)
    t.start()
    t.join(10)
    assert not t.is_alive() and got
    return got[0]


def _picks(P, lb_name, url):
    nodes = _resolve(P, url)
    order = [str(n.endpoint) for n in nodes]
    lb = P.load_balancer.create_load_balancer(lb_name)
    lb.reset_servers(list(nodes))
    if lb_name == "mesh_locality":
        lb.set_local_coords((2, 0))
    picks = []
    for k in KEYS:
        code = 0 if lb_name == "rr" else P.murmur3_32(k.encode())
        picks.append(order.index(str(lb.select_server(P.load_balancer.SelectIn(request_code=code)).endpoint)))
    extra = (lb.picks_local, lb.picks_remote) if lb_name == "mesh_locality" else None
    return order, picks, extra


@pytest.mark.parametrize("lb_name", ["rr", "c_murmurhash", "mesh_locality"])
def test_load_balancers_pick_the_same_node_for_every_key(lb_name):
    order, picks, extra = both(_picks, lb_name, "list://" + ",".join(ENDPOINTS))
    assert order == ENDPOINTS and len(set(picks)) > 1
    if lb_name == "mesh_locality":
        # the local slice (slice 2: chips 3-5 of the list) takes every key
        assert set(picks) <= {3, 4, 5} and extra == (len(KEYS), 0)


def test_naming_services_resolve_alike(tmp_path):
    path = tmp_path / "servers"
    path.write_text("\n".join(ENDPOINTS[:4] + ["# comment", "10.0.0.9:99 2 tagged"]) + "\n")

    def resolve(P):
        return {
            url: [(str(n.endpoint), n.weight, n.tag) for n in _resolve(P, url)]
            for url in ("list://" + ",".join(ENDPOINTS) + ",10.0.0.8:98;3;t8",
                        f"file://{path}")
        }

    got = both(resolve)
    assert got[f"file://{path}"][-1] == ("10.0.0.9:99", 2, "tagged")
    assert len(got["list://" + ",".join(ENDPOINTS) + ",10.0.0.8:98;3;t8"]) == len(ENDPOINTS) + 1


# ---------------------------------------------------------------------------
# the cache cluster: failover, revival, membership, bulk calls
# ---------------------------------------------------------------------------


def _failover(P):
    """tests/test_cache_cluster.py:60: kill the local replica, spill to
    the remote one, revive by health check, win locality back."""
    local_slice, remote_slice = fresh_slices(P.pkg, 2)
    local_addr = f"ici://slice{local_slice}/chip1"
    remote_addr = f"ici://slice{remote_slice}/chip1"
    servers = {"local": P.start_cache(local_slice, 1),
               "remote": P.start_cache(remote_slice, 1)}
    cc = P.cache_channel(f"list://{local_addr},{remote_addr}",
                         local_coords=(local_slice, 9))
    payload = b"f" * 64
    local_node = P.naming_service.ServerNode(P.str2endpoint(local_addr))
    tally = {"hits": 0, "misses": 0, "errors": []}

    def guarded_get():
        try:
            v = cc.get("failover")
        except P.CacheError as e:
            tally["errors"].append(e.code)
            return None
        if v is None:
            tally["misses"] += 1
            cc.set("failover", payload)
        elif P.host_bytes(v) == payload:
            tally["hits"] += 1
        return v

    def local_isolated():
        st = cc._channel._lb._states.get(local_node)
        return st is not None and st.breaker.is_isolated()

    P.injector.arm(P.FaultPlan(
        [P.FaultSpec("cache.lookup", "delay_us", arg=5_000, probability=0.3, max_hits=5)],
        seed=29, name="cache-failover",
    ))
    out = {}
    try:
        b = cc.balancer()
        cc.set("failover", payload)
        for _ in range(5):
            guarded_get()
        out["healthy"] = dict(tally, picks_remote=b.picks_remote)
        tally.update(hits=0, misses=0)
        servers["local"].stop()
        guarded_get()
        # a connect failure isolates the node at once, for a window that
        # starts at 0.1 s: read it right after the failing GET
        isolated = local_isolated()
        for _ in range(19):
            guarded_get()
        out["failover"] = dict(tally, spilled=b.picks_remote > 0, isolated=isolated)
        tally.update(hits=0, misses=0)
        servers["local"] = P.start_cache(local_slice, 1)
        out["revived"] = P.wait_until(lambda: not local_isolated(), timeout_s=10)

        def probed():  # the health check's probe connected again
            st = cc._channel._lb._states.get(local_node)
            return st.health_task is not None and st.health_task._stopped

        out["revived_by_probe"] = P.wait_until(probed, timeout_s=10)
        for _ in range(5):
            guarded_get()  # the fresh store misses once, then refills
        out["refill"] = dict(tally)
        tally.update(hits=0, misses=0)
        b.picks_local = b.picks_remote = 0
        for _ in range(20):
            guarded_get()
        out["final"] = dict(tally, locality=cc.locality_fraction())
    finally:
        P.injector.disarm()
        cc.close()
        for srv in servers.values():
            srv.stop()
    return out


def test_kill_local_replica_failover_and_revival_match():
    out = both(_failover)
    assert out["healthy"] == {"hits": 5, "misses": 0, "errors": [], "picks_remote": 0}
    assert out["failover"]["hits"] >= 1 and out["failover"]["spilled"]
    assert out["failover"]["isolated"] and out["failover"]["errors"] == []
    assert out["revived"] and out["revived_by_probe"]
    assert out["final"]["hits"] == 20 and out["final"]["locality"] >= 0.9


def _membership_shrink(P):
    """tests/test_cache_cluster.py:152: a replica leaving the membership
    drains its keys to the survivor; returns the refills it took."""
    s, = fresh_slices(P.pkg)
    a, b_srv = P.start_cache(s, 1), P.start_cache(s, 2)
    cc = P.cache_channel(f"list://ici://slice{s}/chip1,ici://slice{s}/chip2",
                         local_coords=(s, 9))
    refills = []
    try:
        keys = [f"shrink-{i}" for i in range(8)]
        for k in keys:
            cc.set(k, b"v" * 32)
        node_a = P.naming_service.ServerNode(P.str2endpoint(f"ici://slice{s}/chip1"))
        assert cc.balancer().remove_server(node_a)
        for k in keys:
            if cc.get(k) is None:
                refills.append(k)
                cc.set(k, b"v" * 32)
        final = [P.host_bytes(cc.get(k)) for k in keys]
    finally:
        cc.close()
        a.stop()
        b_srv.stop()
    return refills, final


def test_membership_shrink_reroutes_alike():
    refills, final = both(_membership_shrink)
    assert refills and final == [b"v" * 32] * 8


def _bulk(P):
    """set_many then get_many over a two-node cluster: what is stored
    where, the lengths, the bytes, and the co-located batch's stack."""
    s, = fresh_slices(P.pkg)
    servers = [P.start_cache(s, 1), P.start_cache(s, 2)]
    eps = [f"ici://slice{s}/chip{c}" for c in (1, 2)]
    cc = P.cache_channel("list://" + ",".join(eps), local_coords=(s, 9))
    singles = [P.cache_channel(f"list://{ep}", lb="rr") for ep in eps]
    rng = np.random.default_rng(5)
    keys = [f"bulk{i}" for i in range(12)]
    values = [rng.integers(0, 256, (4096,), dtype=np.uint8) for _ in keys]
    try:
        stored = cc.set_many([(k, P.to_dev(v)) for k, v in zip(keys, values)])
        res = cc.get_many(keys + ["absent"])
        got = [res.host_bytes(i) for i in range(len(keys) + 1)]
        placement = [sorted(k.decode() for k in ch.keys()) for ch in singles]
        co = placement[0]
        res_co = cc.get_many(co)
        stacked = tuple(res_co.stacked.shape) if res_co.stacked is not None else None
        rows = [P.host_bytes(res_co.row(i)) for i in range(len(co))]
        one = P.host_bytes(cc.get(keys[0]))
    finally:
        cc.close()
        for ch in singles:
            ch.close()
        for srv in servers:
            srv.stop()
    assert got[:-1] == [v.tobytes() for v in values] and got[-1] is None
    assert one == values[0].tobytes()
    return stored, res.lengths, got, placement, stacked, rows


def test_get_many_and_set_many_match_the_jax_cache_channel():
    stored, lengths, _, placement, stacked, rows = both(_bulk)
    assert stored == 12 and lengths == [4096] * 12 + [-1]
    assert all(placement) and len(rows) == len(placement[0]) >= 2
    assert stacked[0] >= len(placement[0]) and stacked[1] == 4096


def test_port_cache_channel_returns_tensors_on_its_device():
    """A port GET over ICI is a tensor on the channel's ``ici_device``;
    a DMGET row is a view of the one stacked reply."""
    P = pk("port")
    s, = fresh_slices("port")
    srv = P.start_cache(s, 1)
    cc = P.cache_channel(f"list://ici://slice{s}/chip1", lb="rr")
    try:
        x = torch.arange(4096, dtype=torch.int32).to(torch.uint8)
        cc.set("t0", x)
        cc.set("t1", x.flip(0))
        v = cc.get("t0")
        assert isinstance(v, torch.Tensor) and v.device == CPU and torch.equal(v, x)
        res = cc.get_many(["t0", "t1"])
        assert res.stacked is not None and res.row(1).data_ptr() == res.stacked[1].data_ptr()
        assert torch.equal(res.row(1), x.flip(0))
        assert cc.get_host("t1") == x.flip(0).numpy().tobytes()
    finally:
        cc.close()
        srv.stop()


def test_cache_channel_needs_a_device_without_a_card(monkeypatch):
    from incubator_brpc_tpu_torch.cache import CacheChannel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CacheChannel("list://ici://slice1/chip1", lb="rr")


# ---------------------------------------------------------------------------
# replication (tests/test_replication.py:136-379, :604)
# ---------------------------------------------------------------------------


class MemStore:
    """In-memory replica store — the ReplicaNode contract without RPC."""

    def __init__(self):
        self.d = {}

    def list_keys(self):
        return list(self.d)

    def read(self, k):
        return self.d.get(k)

    def write(self, k, v):
        self.d[k] = bytes(v)

    def delete(self, k):
        return self.d.pop(k, None) is not None


def _mem_group(P, name, n=3, **kw):
    kw.setdefault("lease_ttl_s", 5.0)
    R = P.replication
    return R.ReplicaGroup(name, [R.ReplicaNode(f"n{i + 1}", MemStore()) for i in range(n)], **kw)


def _lease_grammar(P):
    R, ServerNode = P.replication, P.naming_service.ServerNode
    tag = R.format_lease_tag("ps.g0", 3, "ici://slice0/chip1")
    ep = P.str2endpoint("10.9.0.1:80")
    nodes = [
        ServerNode(ep, tag=R.format_lease_tag("g0", 4, "n2")),
        ServerNode(ep, tag=R.format_lease_tag("g0", 2, "n1")),
        ServerNode(ep, tag="1/4@7"),
        ServerNode(ep, tag="free-form"),
    ]
    from_group = R.group
    return (
        tag, R.parse_lease_tag(tag),
        [R.parse_lease_tag(t) for t in ("", "bogus", "g0@3", "g0@x:h", "@3:h", "1/4@7")],
        P.resharding.parse_epoch_tag(tag),
        R.max_lease_epoch(nodes, "g0"), R.max_lease_epoch(nodes, "other"),
        P.errors.ESTALEEPOCH, R.StaleEpoch("x").code, R.QuorumLost("x").code,
        from_group.NoLeader("x").code, from_group.LeaderLost("x").code,
    )


def test_lease_tag_grammar_matches():
    got = both(_lease_grammar)
    assert got[0] == "ps.g0@3:ici://slice0/chip1" and got[2] == [None] * 6


def _race(P):
    board = P.replication.LeaseBoard(default_ttl_s=1.0)
    granted = []
    for _ in range(10):
        results = [None, None]
        barrier = threading.Barrier(2)

        def race(i, who):
            barrier.wait()
            results[i] = board.acquire("race.g", who, 1.0)

        ts = [threading.Thread(target=race, args=(i, w)) for i, w in enumerate("AB")]
        for t in ts:
            t.start()
        for t in ts:
            t.join(10)
        winners = [r for r in results if r is not None]
        assert len(winners) == 1, "two leaders in one epoch"
        granted.append(winners[0].epoch)
        board.release("race.g", winners[0].holder, winners[0].epoch)
    lease = board.acquire("race.g", "C", 1.0)
    board.expire("race.g")
    taken = board.acquire("race.g", "D", 1.0)
    return granted, lease.epoch, taken.epoch, board.epoch_of("race.g")


def test_two_candidate_race_one_leader_per_epoch_matches():
    granted, c, d, now = both(_race)
    assert granted == list(range(1, 11)) and d == c + 1 == now


def _quorum_fence_lapse(P):
    g = _mem_group(P, "q.g0")
    g.put("a", b"1")
    g.put("b", b"2")
    stores = [dict(n.store.d) for n in g.nodes]
    g.delete("a")
    quorum = (dict(g.counters), stores, g.read_any("b"), g.epoch())
    f = _mem_group(P, "fence.g0")
    old_leader = f.ensure_leader()
    old_epoch = f.epoch()
    f.put("base", b"v0")
    f.board.expire(f.name)
    taken = f.board.acquire(f.name, "outsider", 5.0)
    fenced = 0
    for i in range(4):
        with pytest.raises(P.replication.StaleEpoch):
            f.write_as(old_leader, old_epoch, "put", f"fenced{i}", b"x")
        fenced += 1
    fence = (dict(f.counters), taken.epoch, [dict(n.store.d) for n in f.nodes], fenced)
    lp = _mem_group(P, "lapse.g0")
    leader = lp.ensure_leader()
    epoch = lp.epoch()
    lp.board.expire(lp.name)
    with pytest.raises(P.replication.StaleEpoch, match="lapsed"):
        lp.write_as(leader, epoch, "put", "k", b"v")
    return quorum, fence, dict(lp.counters)


def test_quorum_writes_fencing_and_lapsed_leases_match():
    quorum, fence, lapse = both(_quorum_fence_lapse)
    assert quorum[0]["quorum_writes"] == 3 and quorum[2] == b"2"
    assert fence[0]["fenced_writes"] == 4 and fence[0]["quorum_writes"] == 1
    assert lapse["fenced_writes"] == 1 and lapse["quorum_writes"] == 0


def _rejoin(P):
    g = _mem_group(P, "rep.g0")
    for i in range(6):
        g.put(f"k{i}", f"v{i}".encode())
    g.mark_dead("n3")
    serving = [n.name for n in g.serving_nodes()]
    for i in range(6, 10):
        g.put(f"k{i}", f"v{i}".encode())
    g.delete("k0")
    g.mark_alive("n3")
    n3 = g.node("n3")
    repairing = n3.repairing and n3 not in g.serving_nodes()
    copied = g.repair("n3")
    return (serving, repairing, copied, dict(g.counters), dict(n3.store.d),
            dict(g.leader().store.d), n3.applied_seq)


def test_rejoining_replica_repair_matches():
    serving, repairing, copied, counters, n3, leader, _ = both(_rejoin)
    assert serving == ["n1", "n2"] and repairing and copied == 4
    assert counters["repair_keys"] == 4 and n3 == leader and "k0" not in n3


def _ack_drop(P, seed):
    plan = P.FaultPlan(
        [P.FaultSpec("replica.ack", "drop", probability=0.6,
                     match={"peer": "n2", "method": "ackrep.g0"})],
        seed=seed,
    )
    g = _mem_group(P, "ackrep.g0")
    P.injector.arm(plan)
    try:
        for i in range(6):
            g.put(f"k{i}", f"v{i}".encode())
        hits, log = P.injector.site_hits(), P.injector.hit_log()
    finally:
        P.injector.disarm()
    return hits, log, dict(g.counters), dict(g.node("n2").store.d)


def _lease_drop(P):
    plan = P.FaultPlan(
        [P.FaultSpec("replica.lease", "drop", probability=1.0, max_hits=1,
                     match={"method": "lsrep.g0"})],
        seed=7,
    )
    g = _mem_group(P, "lsrep.g0")
    g.node("n1").applied_seq = 5
    g.node("n2").applied_seq = 3
    P.injector.arm(plan)
    try:
        leader = g.ensure_leader()
        hits, log = P.injector.site_hits(), P.injector.hit_log()
    finally:
        P.injector.disarm()
    return leader.name, g.epoch(), hits, log


@pytest.mark.parametrize("seed", [20260806, 20260807])
def test_seeded_ack_drop_replays_alike(seed):
    hits, log, counters, n2 = both(_ack_drop, seed)
    assert hits.get("replica.ack", {}).get("drop", 0) >= 1
    assert counters["quorum_writes"] == 6 and len(n2) == 6


def test_seeded_lease_drop_elects_alike():
    name, epoch, hits, _ = both(_lease_drop)
    assert name == "n2" and epoch == 1 and hits["replica.lease"]["drop"] == 1


def _cache_group(P):
    """tests/test_replication.py:604: quorum puts on every HBM replica,
    bulk repair of exactly the behind-ness, deletes stay deleted."""
    R = P.replication
    s, = fresh_slices(P.pkg)
    servers, eps = [], []
    for c in range(3):
        servers.append(P.start_cache(s, c + 1))
        eps.append(f"ici://slice{s}/chip{c + 1}")
    chans = [P.cache_channel(f"list://{ep}", lb="rr") for ep in eps]
    try:
        g = R.replicated_cache_group("t.cache", chans, endpoints=eps, register=False,
                                     lease_ttl_s=5.0)
        keys = [f"ck{i}" for i in range(8)]
        for k in keys:
            g.put(k, f"v-{k}".encode())
        everywhere = all(n.store.read(k) == f"v-{k}".encode() for n in g.nodes for k in keys)
        g.mark_dead("t.cache.2")
        extra = [f"ck{i}" for i in range(8, 12)]
        for k in extra:
            g.put(k, f"v-{k}".encode())
        g.delete("ck0")
        g.mark_alive("t.cache.2")
        node = g.node("t.cache.2")
        repairing = node.repairing and node not in g.serving_nodes()
        copied = g.repair("t.cache.2")
        serving = node in g.serving_nodes()
        contents = [{k: n.store.read(k) for k in keys + extra} for n in g.nodes]
    finally:
        for ch in chans:
            ch.close()
        for srv in servers:
            srv.stop()
    return everywhere, repairing, copied, serving, dict(g.counters), contents


def test_replicated_cache_group_quorum_and_bulk_repair_match():
    everywhere, repairing, copied, serving, counters, contents = both(_cache_group)
    assert everywhere and repairing and serving and copied == 4
    assert counters["repair_keys"] == 4
    assert all(c["ck0"] is None for c in contents)
    assert contents[0] == contents[1] == contents[2]


def test_replicated_ps_channel_raises_naming_its_item():
    """The combo channels are ported, so a replicated shard channel no
    longer raises: over the same groups it builds in both packages and
    routes every key to the same group (tests/test_torch_sharded_ps.py
    drives it over live PS servers)."""
    def build(P):
        R = P.replication
        groups = [R.ReplicaGroup(f"combo.g{i}", [R.ReplicaNode("n1", MemStore()),
                                                 R.ReplicaNode("n2", MemStore())])
                  for i in range(3)]
        ch = R.ReplicatedShardChannel(groups, seed=1)
        return ch.rf1, ch.partition_count(), [ch.shard_of(f"key{i}") for i in range(64)]

    rf1, n, owners = both(build)
    assert rf1 is False and n == 3 and set(owners) == {0, 1, 2}


# ---------------------------------------------------------------------------
# resharding (tests/test_resharding.py:94-299, :763-873)
# ---------------------------------------------------------------------------


def _planner(P):
    Rs = P.resharding
    keys = [f"key{i}" for i in range(16)]
    mv = Rs.moved_keys(keys, 2, 4)
    nodes = [P.naming_service.ServerNode(P.EndPoint("10.1.0.%d" % i, 80)) for i in range(1, 5)]
    small = P.load_balancer.create_load_balancer("c_murmurhash")
    big = P.load_balancer.create_load_balancer("c_murmurhash")
    for n in nodes[:2]:
        small.add_server(n)
    for n in nodes:
        big.add_server(n)
    moves = []
    for code in range(1, 257):
        before = small.select_server(P.load_balancer.SelectIn(request_code=code))
        after = big.select_server(P.load_balancer.SelectIn(request_code=code))
        if before != after:
            moves.append((code, str(before.endpoint), str(after.endpoint)))
    return (mv, Rs.moved_keys([b"key0"], 2, 4), [Rs.shard_of(k, 3) for k in keys],
            [Rs.parse_epoch_tag(t) for t in ("1/4@7", "0/2", "bogus", "")],
            Rs.format_epoch_tag(3, 4, 2), moves)


def test_scheme_planner_and_ring_growth_match():
    mv, b0, _, tags, fmt, moves = both(_planner)
    assert sorted(mv) == ["key0", "key12", "key14", "key5", "key6", "key8", "key9"]
    assert mv["key0"] == (1, 3) and b0 == {"key0": (1, 3)}
    assert tags == [(1, 4, 7), (0, 2, 0), None, None] and fmt == "3/4@2"
    assert moves and all(after.startswith(("10.1.0.3", "10.1.0.4")) for _, _, after in moves)


def _state_persist(P, path):
    Rs = P.resharding
    st = Rs.ReshardingState(f"persist-{P.pkg}", 2, 4, path=path)
    st.bump("keys_moved", 7)
    st.enter("COPY", epoch=0)
    resumed = Rs.ReshardingState.load(path)
    d = resumed.to_dict()
    d.pop("name")
    return d, Rs.ReshardingState.load(path + ".missing") is None, \
        f"persist-{P.pkg}" in Rs.states_snapshot()


def test_resharding_state_persists_and_resumes_alike(tmp_path):
    results = {pkg: _state_persist(pk(pkg), str(tmp_path / f"{pkg}.json")) for pkg in PKGS}
    assert results["port"] == results["jax"]
    d, missing, snap = results["port"]
    assert d["phase"] == "COPY" and d["counters"]["keys_moved"] == 7 and missing and snap


class MemShard:
    """In-memory shard adapter — the coordinator contract without RPC."""

    def __init__(self, P):
        self.d = {}
        self.dead = False
        self._unavailable = P.resharding.ShardUnavailable

    def _chk(self):
        if self.dead:
            raise self._unavailable("dead")

    def list_keys(self):
        self._chk()
        return list(self.d)

    def read(self, k):
        self._chk()
        return self.d.get(k)

    def write(self, k, v):
        self._chk()
        self.d[k] = bytes(v)

    def delete(self, k):
        self._chk()
        return self.d.pop(k, None) is not None


def _mem_cluster(P, n_keys=24):
    old = [MemShard(P) for _ in range(2)]
    new = old + [MemShard(P) for _ in range(2)]
    keys = [f"key{i}" for i in range(n_keys)]
    for k in keys:
        old[P.resharding.shard_of(k, 2)].write(k, f"v-{k}".encode())
    return old, new, keys


def _report(rep):
    rep = dict(rep)
    rep.pop("name")
    return rep


def _copy_faults(P):
    Rs = P.resharding
    old, new, keys = _mem_cluster(P)
    P.injector.arm(P.FaultPlan(
        [P.FaultSpec("reshard.copy", "drop", probability=0.5, max_hits=4),
         P.FaultSpec("reshard.copy", "corrupt", probability=0.3, max_hits=2)],
        seed=11,
    ))
    try:
        rep = Rs.ReshardCoordinator(f"mem-faults-{P.pkg}", old, new,
                                    view=Rs.MigrationView()).run()
        log = P.injector.hit_log()
    finally:
        P.injector.disarm()
    return _report(rep), log, [dict(s.d) for s in new]


def test_copy_faults_retry_and_corrupt_recopies_alike():
    rep, _, shards = both(_copy_faults)
    assert rep["completed"] and rep["counters"]["checksum_failures"] == 2
    assert rep["counters"]["copy_retries"] >= 1 and sum(len(s) for s in shards) == 24


def _cutover_drop(P):
    Rs = P.resharding
    old, new, keys = _mem_cluster(P)
    view = Rs.MigrationView()
    P.injector.arm(P.FaultPlan([P.FaultSpec("reshard.cutover", "drop", probability=1.0)],
                               seed=5))
    try:
        rep = Rs.ReshardCoordinator(f"mem-rb-{P.pkg}", old, new, view=view).run()
    finally:
        P.injector.disarm()
    return _report(rep), view.cut_over(), [dict(s.d) for s in new]


def test_cutover_drop_rolls_back_alike():
    rep, cut, shards = both(_cutover_drop)
    assert rep["rolled_back"] and not cut and not shards[2] and not shards[3]
    assert rep["counters"]["rollbacks"] == 1


def _storm_replay(P):
    Rs = P.resharding
    old, new, _ = _mem_cluster(P)
    P.injector.arm(P.reshard_storm_plan(peers=[], seed=42, copy_drop_pct=0.4,
                                        copy_max_hits=5, cutover_delay_us=100))
    try:
        rep = Rs.ReshardCoordinator("replay", old, new, view=Rs.MigrationView()).run()
        log = P.injector.hit_log()
    finally:
        P.injector.disarm()
    return _report(rep), log


def test_storm_plan_replays_alike():
    rep, log = both(_storm_replay)
    assert rep["completed"] and any(site == "reshard.copy" for site, _, _ in log)


def _cache_migration(P, bulk):
    """tests/test_resharding.py:763 (per-key, with the spilled-read
    probe) and :823 (bulk): 2 -> 4 over live cache nodes."""
    Rs = P.resharding
    s, = fresh_slices(P.pkg)
    servers, eps = [], []
    for c in range(4):
        servers.append(P.start_cache(s, c + 1))
        eps.append(f"ici://slice{s}/chip{c + 1}")
    chans = [P.cache_channel(f"list://{ep}", lb="rr") for ep in eps]
    try:
        old_parts = [Rs.CacheShardStore(c) for c in chans[:2]]
        new_parts = [Rs.CacheShardStore(c) for c in chans]
        keys = [f"{'blk' if bulk else 'key'}{i}" for i in range(24 if bulk else 12)]
        for k in keys:
            old_parts[Rs.shard_of(k, 2)].write(k, f"v-{k}".encode())
        planned = Rs.moved_keys(keys, 2, 4)
        probe = {"checked": False, "clean": None}

        def spilled_probe(key, src, dst):
            if not probe["checked"]:
                probe["checked"] = True
                probe["clean"] = chans[dst].get(key) is None

        rep = Rs.ReshardCoordinator(
            f"cache-{'bulk' if bulk else 'live'}-{P.pkg}", old_parts, new_parts,
            view=Rs.MigrationView(), on_copy=None if bulk else spilled_probe,
        ).run()
        placed = {k: chans[Rs.shard_of(k, 4)].get_host(k) for k in keys}
        left = [sorted(p.list_keys()) for p in old_parts]
    finally:
        for c in chans:
            c.close()
        for srv in servers:
            srv.stop()
    return _report(rep), planned, probe, placed, left


@pytest.mark.parametrize("bulk", [False, True], ids=["per-key", "bulk"])
def test_cache_migration_matches(bulk):
    rep, planned, probe, placed, left = both(_cache_migration, bulk)
    c = rep["counters"]
    assert rep["completed"] and c["keys_moved"] == len(planned)
    assert all(v == f"v-{k}".encode() for k, v in placed.items())
    for i, keys in enumerate(left):
        assert not {k for k, (src, _) in planned.items() if src == i} & set(keys)
    if bulk:
        assert c["bulk_ranges"] > 0 and 0 < c["collective_steps"] <= 3 * c["bulk_ranges"]
        assert c["collective_steps"] < c["keys_moved"] and c["checksum_failures"] == 0
    else:
        assert probe == {"checked": True, "clean": True} and c["collective_steps"] == 0
        assert c["keys_drained"] == len(planned)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_saved_resharding_state_resumes_in_the_other_package(tmp_path, writer, reader):
    """A ReshardingState saved mid-COPY by one package loads into the
    other's coordinator, which resumes and finishes the migration with
    the carried counters; the values cross as bytes."""
    W, R = pk(writer), pk(reader)
    path = str(tmp_path / "mig.json")
    st = W.resharding.ReshardingState(f"cross-{writer}", 2, 4, path=path, epoch=3)
    st.bump("copy_retries", 2)
    st.enter("COPY", epoch=3)
    loaded = R.resharding.ReshardingState.load(path)
    assert (loaded.phase, loaded.epoch, loaded.old_n, loaded.new_n) == ("COPY", 3, 2, 4)
    old, new, keys = _mem_cluster(R)
    rep = R.resharding.ReshardCoordinator(
        loaded.name, old, new, state=loaded, view=R.resharding.MigrationView(epoch=3),
    ).run()
    assert rep["completed"] and rep["epoch"] == 4
    assert rep["counters"]["copy_retries"] == 2
    assert rep["counters"]["keys_moved"] == len(R.resharding.moved_keys(keys, 2, 4))
    for k in keys:
        assert new[R.resharding.shard_of(k, 4)].read(k) == f"v-{k}".encode()
    # the finished state, saved by the reader, loads back in the writer
    back = W.resharding.ReshardingState.load(path)
    assert back.phase == "DONE" and back.counters == loaded.counters


def test_tpu_mesh_naming_enumerates_the_devices_given():
    """``tpu://mesh`` names one slice of chips: the port's mesh over the
    devices a caller passes yields the JAX package's endpoints for a
    mesh of as many chips; ``create_mesh`` builds the same (1, n) mesh;
    without a card and without devices both raise."""
    from incubator_brpc_tpu.parallel.mesh import ici_endpoints as j_endpoints
    from incubator_brpc_tpu_torch.parallel import mesh

    m = mesh.default_mesh([CPU, CPU, CPU])
    assert m.devices.shape == (1, 3) and m.devices[0][2] == CPU
    eps = [str(ep) for ep in mesh.ici_endpoints(m)]
    jmesh = types.SimpleNamespace(devices=np.empty((1, 3), dtype=object))
    assert eps == [str(ep) for ep in j_endpoints(jmesh)]
    assert mesh.device_of(m, mesh.ici_endpoints(m)[1]) == CPU
    cm = mesh.create_mesh(devices=[CPU, CPU, CPU])
    assert cm.devices.shape == (1, 3) and dict(cm.shape) == {"slice": 1, "chip": 3}
    assert [str(ep) for ep in mesh.ici_endpoints(cm)] == eps
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.default_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.create_mesh()
