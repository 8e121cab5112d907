"""Replicated HA tier (docs/replication.md): leader leases with epoch
fencing, quorum writes, hedged replica reads, and repair through the
resharding verified-move engine.

What's under test, by layer:

* the lease plane — the ``"group@epoch:holder"`` tag grammar coexists
  with resharding's ``"i/N@E"`` partition tags, a two-candidate
  acquire race resolves to exactly ONE leader per epoch, and epochs
  stay monotonic across expiry and release;
* the fencing invariant — a deposed leader (lapsed lease, newer epoch
  granted) can keep writing forever and never get a single write
  acknowledged: every attempt raises StaleEpoch (→ ESTALEEPOCH) with
  the stores untouched, and a lease lapsing mid-fan is never acked
  even when a quorum applied;
* quorum writes — an acked write is on every serving replica; a
  rejoining replica serves only after ``repair()`` copied exactly its
  behind-ness (deleted keys never resurrect);
* the channel — RF=1 collapses byte-for-byte to the unreplicated
  ShardRoutedChannel, Put/Get/Delete keep the PsService semantics over
  real TCP servers, and a slow replica costs one hedge
  (``hedged_reads`` counted), not a tail;
* chaos — the 'replica.lease' and 'replica.ack' sites replay
  deterministically under a fixed seed, and THE acceptance: a LEADER
  dies mid-write-storm inside RecoveryHarness with zero
  acknowledged-write loss, bounded failover, and ERPC-only codes.

Every proof is a step-log count (counters, store contents, hit logs),
never timing — except the failover bound, which the lease TTL defines.

Carried by hand from ``tests/test_replication.py``.  The PS cases are held
by ``tests/test_torch_sharded_ps.py``.  Besides the package name, the cache
group's servers and channels are given the device the case runs on (the CPU,
or the card).
"""

import threading

import pytest

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.chaos import (
    FaultPlan,
    FaultSpec,
)
from incubator_brpc_tpu_torch.chaos import injector
from incubator_brpc_tpu_torch.client.channel import ChannelOptions
from incubator_brpc_tpu_torch.client.naming_service import ServerNode
from incubator_brpc_tpu_torch.replication import (
    LeaseBoard,
    QuorumLost,
    ReplicaGroup,
    ReplicaNode,
    StaleEpoch,
    format_lease_tag,
    max_lease_epoch,
    parse_lease_tag,
    register_group,
    replicated_cache_group,
    unregister_group,
)
from incubator_brpc_tpu_torch.replication.group import LeaderLost, NoLeader
from incubator_brpc_tpu_torch.resharding import parse_epoch_tag
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
from incubator_brpc_tpu_torch.utils.endpoint import str2endpoint

from torch_carry import torch_device  # noqa: F401  (fixture)


@pytest.fixture(autouse=True)
def always_disarm():
    yield
    injector.disarm()


# ---------------------------------------------------------------------------
# helpers
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


def _mem_group(name, n=3, **kw):
    kw.setdefault("lease_ttl_s", 5.0)
    nodes = [ReplicaNode(f"n{i + 1}", MemStore()) for i in range(n)]
    return ReplicaGroup(name, nodes, **kw)


# ---------------------------------------------------------------------------
# lease plane: tag grammar + the two-candidate race
# ---------------------------------------------------------------------------


def test_lease_tag_grammar_and_coexistence_with_partition_tags():
    """"group@epoch:holder" round-trips; BOTH parsers return None for
    the other grammar, so lease and partition tags share one naming
    plane without misrouting either kind of client."""
    tag = format_lease_tag("ps.g0", 3, "ici://slice0/chip1")
    assert tag == "ps.g0@3:ici://slice0/chip1"
    assert parse_lease_tag(tag) == ("ps.g0", 3, "ici://slice0/chip1")
    # malformed shapes
    assert parse_lease_tag("") is None
    assert parse_lease_tag("bogus") is None
    assert parse_lease_tag("g0@3") is None  # no holder
    assert parse_lease_tag("g0@x:h") is None  # non-int epoch
    assert parse_lease_tag("@3:h") is None  # empty group
    # coexistence, both directions
    assert parse_lease_tag("1/4@7") is None  # partition tag ignored
    assert parse_epoch_tag(tag) is None  # lease tag ignored
    # a naming watcher adopts the highest advertised epoch per group
    ep = str2endpoint("10.9.0.1:80")
    nodes = [
        ServerNode(ep, tag=format_lease_tag("g0", 4, "n2")),
        ServerNode(ep, tag=format_lease_tag("g0", 2, "n1")),
        ServerNode(ep, tag="1/4@7"),
        ServerNode(ep, tag="free-form"),
    ]
    assert max_lease_epoch(nodes, "g0") == 4
    assert max_lease_epoch(nodes, "other") == 0
    # the replication failures map onto ERPC codes the harness accepts
    assert errors.ESTALEEPOCH == 2007
    assert StaleEpoch("x").code == errors.ESTALEEPOCH
    assert QuorumLost("x").code == errors.ETOOMANYFAILS
    assert NoLeader("x").code == errors.EINTERNAL
    assert LeaderLost("x").code == errors.EINTERNAL


def test_two_candidate_race_resolves_to_one_leader_per_epoch():
    """Grants are atomic under the board lock: two candidates racing
    acquire() get exactly one winner per round, and epochs stay
    strictly monotonic across releases AND expiry."""
    board = LeaseBoard(default_ttl_s=1.0)
    granted = []
    for _ in range(10):
        results = [None, None]
        barrier = threading.Barrier(2)

        def race(i, who):
            barrier.wait()
            results[i] = board.acquire("race.g", who, 1.0)

        ts = [
            threading.Thread(target=race, args=(i, w))
            for i, w in enumerate(("A", "B"))
        ]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        winners = [r for r in results if r is not None]
        assert len(winners) == 1, "two leaders in one epoch"
        granted.append(winners[0])
        board.release("race.g", winners[0].holder, winners[0].epoch)
    epochs = [lease.epoch for lease in granted]
    assert epochs == list(range(1, 11))  # monotonic, never reused
    # expiry (lost renewals) also moves FORWARD — fencing depends on it
    lease = board.acquire("race.g", "C", 1.0)
    board.expire("race.g")
    taken = board.acquire("race.g", "D", 1.0)
    assert taken is not None and taken.epoch == lease.epoch + 1
    assert board.epoch_of("race.g") == taken.epoch


# ---------------------------------------------------------------------------
# quorum writes + the fencing invariant (in-process groups)
# ---------------------------------------------------------------------------


def test_quorum_write_replicates_to_every_serving_store():
    g = _mem_group("q.g0")
    assert g.put("a", b"1") == 1
    assert g.put("b", b"2") == 2
    for n in g.nodes:
        assert n.store.read("a") == b"1" and n.store.read("b") == b"2"
    assert g.counters["quorum_writes"] == 2
    assert g.counters["quorum_failures"] == 0
    assert g.epoch() == 1 and g.leader() is not None
    g.delete("a")
    assert all(n.store.read("a") is None for n in g.nodes)
    assert g.counters["quorum_writes"] == 3
    assert g.read_any("b") == b"2"


def test_expired_lease_fences_every_old_leader_write():
    """THE fencing edge: the old leader's lease lapsed and an outside
    candidate took the next epoch — every write the old leader issues
    raises StaleEpoch BEFORE any store applies it (zero acks, stores
    byte-identical), counted in fenced_writes."""
    g = _mem_group("fence.g0")
    old_leader = g.ensure_leader()
    old_epoch = g.epoch()
    g.put("base", b"v0")
    snapshots = [dict(n.store.d) for n in g.nodes]
    # the partition instrument: TTL elapses with every renewal lost,
    # then an outside candidate grabs the NEXT epoch
    g.board.expire(g.name)
    taken = g.board.acquire(g.name, "outsider", 5.0)
    assert taken is not None and taken.epoch == old_epoch + 1
    for i in range(4):
        with pytest.raises(StaleEpoch):
            g.write_as(old_leader, old_epoch, "put", f"fenced{i}", b"x")
    assert g.counters["fenced_writes"] == 4
    assert g.counters["quorum_writes"] == 1  # only the base write acked
    for n, snap in zip(g.nodes, snapshots):
        assert dict(n.store.d) == snap, "a fenced write reached a store"


def test_lapsed_lease_never_acks_even_when_quorum_applied():
    """The other fencing arm: the lease lapses mid-fan with NO new
    holder.  Replicas apply (the epoch is still the newest), but the
    post-fan validate refuses the ack — an ack is only ever issued
    under a live lease."""
    g = _mem_group("lapse.g0")
    leader = g.ensure_leader()
    epoch = g.epoch()
    g.board.expire(g.name)
    with pytest.raises(StaleEpoch, match="lapsed"):
        g.write_as(leader, epoch, "put", "k", b"v")
    assert g.counters["fenced_writes"] == 1
    assert g.counters["quorum_writes"] == 0  # applied, never acked


def test_rejoining_replica_serves_only_after_repair():
    """Rejoin protocol: a replica that missed writes is alive-but-
    repairing (serves nothing) until repair() copies EXACTLY its
    behind-ness from the leader; a key deleted while it was away is
    removed first, never resurrected."""
    g = _mem_group("rep.g0")
    for i in range(6):
        g.put(f"k{i}", f"v{i}".encode())
    g.mark_dead("n3")
    assert [n.name for n in g.serving_nodes()] == ["n1", "n2"]
    for i in range(6, 10):
        g.put(f"k{i}", f"v{i}".encode())  # n3 misses these four
    g.delete("k0")  # n3 still holds k0
    g.mark_alive("n3")
    n3 = g.node("n3")
    assert n3.repairing and n3 not in g.serving_nodes()
    copied = g.repair("n3")
    assert copied == 4  # exactly the writes it missed
    assert g.counters["repair_keys"] == 4
    assert not n3.repairing and n3 in g.serving_nodes()
    leader = g.leader()
    assert dict(n3.store.d) == dict(leader.store.d)
    assert n3.store.read("k0") is None  # deletion survived the rejoin
    assert n3.applied_seq == leader.applied_seq


# ---------------------------------------------------------------------------
# chaos sites: seeded deterministic replay
# ---------------------------------------------------------------------------


def test_seeded_replay_ack_drop_is_durable_but_uncounted():
    """'replica.ack' drop loses the follower's ack AFTER the apply:
    the value is durable on the dropped-ack replica, quorum still met
    via the others — and the same seed fires the identical hit log on
    a fresh identical run."""
    plan = FaultPlan(
        [
            FaultSpec(
                "replica.ack", "drop", probability=0.6,
                match={"peer": "n2", "method": "ackrep.g0"},
            )
        ],
        seed=20260806,
    )

    def run_once():
        g = _mem_group("ackrep.g0")
        injector.arm(plan)
        for i in range(6):
            g.put(f"k{i}", f"v{i}".encode())
        hits = injector.site_hits()
        log = injector.hit_log()
        injector.disarm()
        n2 = g.node("n2")
        for i in range(6):  # dropped acks were still applied
            assert n2.store.read(f"k{i}") == f"v{i}".encode()
        assert g.counters["quorum_writes"] == 6
        assert g.counters["quorum_failures"] == 0
        return hits, log

    hits1, log1 = run_once()
    hits2, log2 = run_once()
    assert hits1.get("replica.ack", {}).get("drop", 0) >= 1
    assert log1 == log2 and hits1 == hits2
    # a different seed produces a different schedule
    other = FaultPlan.from_dict(plan.to_dict())
    other.seed = plan.seed + 1
    g = _mem_group("ackrep.g0")
    injector.arm(other)
    for i in range(6):
        g.put(f"k{i}", f"v{i}".encode())
    assert injector.hit_log() != log1
    injector.disarm()


def test_seeded_replay_lease_drop_forces_next_candidate():
    """'replica.lease' drop loses the preferred candidate's grant, so
    the SECOND most-caught-up replica deterministically takes the
    epoch — identical leader, epoch and hit log on replay."""
    plan = FaultPlan(
        [
            FaultSpec(
                "replica.lease", "drop", probability=1.0, max_hits=1,
                match={"method": "lsrep.g0"},
            )
        ],
        seed=7,
    )

    def run_once():
        g = _mem_group("lsrep.g0")
        g.node("n1").applied_seq = 5  # n1 is the preferred candidate
        g.node("n2").applied_seq = 3
        injector.arm(plan)
        leader = g.ensure_leader()
        hits = injector.site_hits()
        log = injector.hit_log()
        injector.disarm()
        assert leader is not None
        return leader.name, g.epoch(), hits, log

    name1, epoch1, hits1, log1 = run_once()
    name2, epoch2, hits2, log2 = run_once()
    assert name1 == name2 == "n2"  # the grant drop decided the election
    assert epoch1 == epoch2 == 1
    assert hits1.get("replica.lease", {}).get("drop", 0) == 1
    assert log1 == log2 and hits1 == hits2


# ---------------------------------------------------------------------------
# cache tier: quorum group over HBM cache channels + bulk repair
# ---------------------------------------------------------------------------

_slices = [120]


def _start_cache_server(device):
    from incubator_brpc_tpu_torch.cache.service import HBMCacheService

    _slices[0] += 1
    svc = HBMCacheService(device=device)
    srv = Server(ServerOptions(redis_service=svc))
    assert srv.start_ici(_slices[0], 9, device=device) == 0
    return svc, srv, f"ici://slice{_slices[0]}/chip9"


def test_replicated_cache_group_quorum_and_bulk_repair(torch_device):
    """The cache adapter: quorum puts land on every HBM replica, and a
    rejoining replica repairs through the bulk DMGET/DMSET surface
    (CacheShardStore carries read_many/write_many) — repair_keys still
    equals its exact behind-ness and deleted keys stay deleted."""
    from incubator_brpc_tpu_torch.cache.channel import CacheChannel

    servers, eps = [], []
    try:
        for _ in range(3):
            svc, srv, ep = _start_cache_server(torch_device)
            servers.append(srv)
            eps.append(ep)
        chans = [CacheChannel(f"list://{ep}", lb="rr",
                              options=ChannelOptions(timeout_ms=30000,
                                                     ici_device=torch_device))
                 for ep in eps]
        g = replicated_cache_group(
            "t.cache", chans, endpoints=eps, register=False,
            lease_ttl_s=5.0,
        )
        keys = [f"ck{i}" for i in range(8)]
        for k in keys:
            g.put(k, f"v-{k}".encode())
        for n in g.nodes:  # quorum fan reached every replica
            for k in keys:
                assert n.store.read(k) == f"v-{k}".encode()
        assert g.counters["quorum_writes"] == len(keys)
        g.mark_dead("t.cache.2")
        extra = [f"ck{i}" for i in range(8, 12)]
        for k in extra:
            g.put(k, f"v-{k}".encode())
        g.delete("ck0")
        g.mark_alive("t.cache.2")
        node = g.node("t.cache.2")
        assert node.repairing and node not in g.serving_nodes()
        copied = g.repair("t.cache.2")
        assert copied == len(extra)  # the four writes it missed
        assert g.counters["repair_keys"] == len(extra)
        assert node in g.serving_nodes()
        assert node.store.read("ck0") is None  # deletion not resurrected
        for k in keys[1:] + extra:
            assert node.store.read(k) == f"v-{k}".encode()
    finally:
        for srv in servers:
            srv.stop()


# ---------------------------------------------------------------------------
# observability: the /replication builtin + /status section
# ---------------------------------------------------------------------------


def test_replication_builtin_page_and_status_section():
    from types import SimpleNamespace

    from incubator_brpc_tpu_torch.builtin import (
        _replication_section,
        replication_page,
    )

    g = _mem_group("pagetest.g0")
    register_group(g)
    try:
        g.put("pk", b"pv")
        status, body, ctype = replication_page(
            None, SimpleNamespace(query={})
        )
        assert status == 200 and ctype == "application/json"
        assert "pagetest.g0" in body and '"quorum_writes"' in body
        status, body, _ = replication_page(
            None, SimpleNamespace(query={"name": "pagetest.g0"})
        )
        assert status == 200
        assert '"quorum_writes": 1' in body and '"leader": "n1"' in body
        status, _, _ = replication_page(
            None, SimpleNamespace(query={"name": "no-such"})
        )
        assert status == 404
        lines = _replication_section()
        line = next(ln for ln in lines if "pagetest.g0" in ln)
        assert "writes=1" in line and "leader=n1" in line
        assert "serving=3/3" in line
    finally:
        unregister_group("pagetest.g0")
