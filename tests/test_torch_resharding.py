"""Live re-sharding (docs/resharding.md): zero-downtime N→M scheme
migration for the sharded PS and the HBM cache tier, proven under
kill-mid-migration chaos.

What's under test, by layer:

* the pure planner — ``moved_keys`` equals EXACTLY the scheme delta
  (golden-pinned), and the consistent-hash ring growth analog moves
  keys only onto the new nodes;
* the client plane — ``DynamicShardChannel`` routing by migration
  epoch: reads fall back old→new during COPY, writes dual-apply during
  DUAL_WRITE, in-flight fan-outs finish on the scheme they started on
  across a CUTOVER (epoch snapshot at issue);
* the coordinator — PREPARE→DUAL_WRITE→COPY→CUTOVER→DRAIN→DONE with
  per-key read-back checksums, survivor completion, and rollback,
  driven over live PS and cache clusters;
* chaos — the 'reshard.copy' and 'reshard.cutover' sites under
  ``reshard_storm_plan`` inside RecoveryHarness: kill a source shard
  mid-COPY and the migration completes from surviving (dual-written)
  replicas or rolls back, with every concurrent op completing exactly
  once and ERPC-only error codes — replayed deterministically;
* satellites — StableShardLB shed parity ('shard' LB demotes and
  probes like mesh_locality), and ShardRoutedChannel membership flaps
  mid-fan-out staying exactly-once per shard.

Every proof is a STEP-LOG count (keys moved/copied/drained, epoch,
per-server call counters), never timing.

Carried by hand from ``tests/test_resharding.py``.  The live PS migration
cases are held by ``tests/test_torch_sharded_ps.py``.  Besides the package
name, the cache migrations' servers and channels are given the device the
case runs on (the CPU, or the card).
"""

import pytest

from incubator_brpc_tpu_torch.chaos import (
    FaultPlan,
    FaultSpec,
    reshard_storm_plan,
)
from incubator_brpc_tpu_torch.chaos import injector
from incubator_brpc_tpu_torch.client.channel import ChannelOptions
from incubator_brpc_tpu_torch.client.naming_service import ServerNode
from incubator_brpc_tpu_torch.resharding import (
    ROLLED_BACK,
    CacheShardStore,
    MigrationView,
    ReshardCoordinator,
    ReshardingState,
    ShardUnavailable,
    format_epoch_tag,
    max_epoch,
    moved_keys,
    parse_epoch_tag,
    shard_of,
    states_snapshot,
)
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
from incubator_brpc_tpu_torch.utils.endpoint import str2endpoint

from torch_carry import torch_device  # noqa: F401  (fixture)


@pytest.fixture(autouse=True)
def always_disarm():
    yield
    injector.disarm()


# ---------------------------------------------------------------------------
# the pure planner: moved set == scheme delta, golden-pinned
# ---------------------------------------------------------------------------


def test_moved_keys_exactly_equals_scheme_delta():
    """The 2→4 migration pair of the shard_of golden pin: the moved
    set is PRECISELY {k : murmur3(k)%2 != murmur3(k)%4}, every mover's
    destination is new capacity (shard ≥ 2, since h%4 ∈ {0,1} implies
    h%2 == h%4), and nothing else remaps."""
    keys = [f"key{i}" for i in range(16)]
    mv = moved_keys(keys, 2, 4)
    assert sorted(mv) == [
        "key0", "key12", "key14", "key5", "key6", "key8", "key9",
    ]
    # golden pairs (murmur3_32 seed 0): drift here strands stored keys
    assert mv["key0"] == (1, 3)
    assert mv["key8"] == (0, 2)
    assert mv["key9"] == (0, 2)
    for k, (src, dst) in mv.items():
        assert src == shard_of(k, 2) and dst == shard_of(k, 4)
        assert dst >= 2, "a mover landed on an old-identity shard"
    for k in keys:
        if k not in mv:
            assert shard_of(k, 2) == shard_of(k, 4)
    # bytes keys census like the cache adapter produces
    assert moved_keys([b"key0"], 2, 4) == {"key0": (1, 3)}


def test_consistent_hash_ring_growth_only_moves_to_new_nodes():
    """ConsistentHashingLB analog of the migration pair: growing the
    ring {A,B} → {A,B,C,D} reassigns keys ONLY to the added nodes —
    no key moves between survivors (the property that makes ring-based
    cache migration copy-only-to-new-capacity)."""
    from incubator_brpc_tpu_torch.client.load_balancer import (
        SelectIn,
        create_load_balancer,
    )
    from incubator_brpc_tpu_torch.utils.endpoint import EndPoint

    nodes = [ServerNode(EndPoint("10.1.0.%d" % i, 80)) for i in range(1, 5)]
    small = create_load_balancer("c_murmurhash")
    big = create_load_balancer("c_murmurhash")
    for n in nodes[:2]:
        small.add_server(n)
    for n in nodes:
        big.add_server(n)
    moved = 0
    # code 0 is the "no request code" sentinel (random pick) — skip it
    for code in range(1, 257):
        before = small.select_server(SelectIn(request_code=code))
        after = big.select_server(SelectIn(request_code=code))
        if before != after:
            moved += 1
            assert after in nodes[2:], (
                f"key {code} moved {before} → {after}: between survivors"
            )
    assert moved > 0, "ring growth moved nothing — degenerate ring"


def test_epoch_tag_grammar_and_backward_compat():
    """"i/N@E" parses; the plain partition parser IGNORES epoch tags
    (int("4@7") raises → None) so pre-migration clients skip rather
    than misroute epoch-published nodes."""
    from incubator_brpc_tpu_torch.client.combo import PartitionParser

    assert parse_epoch_tag("1/4@7") == (1, 4, 7)
    assert parse_epoch_tag("0/2") == (0, 2, 0)
    assert parse_epoch_tag("bogus") is None
    assert parse_epoch_tag("") is None
    assert format_epoch_tag(3, 4, 2) == "3/4@2"
    assert PartitionParser().parse("1/4@7") is None
    assert PartitionParser().parse("1/4") == (1, 4)

    ep = str2endpoint("10.2.0.1:80")
    nodes = [
        ServerNode(ep, tag=format_epoch_tag(0, 4, 3)),
        ServerNode(ep, tag="1/4"),
        ServerNode(ep, tag="not-a-partition"),
    ]
    assert max_epoch(nodes) == 3
    view = MigrationView(epoch=1)
    view.on_servers_changed(nodes)
    assert view.epoch == 3
    assert view.cut_over()  # 3 > base 1: the naming bump propagated


def test_resharding_state_persists_and_resumes(tmp_path):
    path = str(tmp_path / "mig.json")
    st = ReshardingState("persist-test", 2, 4, path=path)
    st.bump("keys_moved", 7)
    st.enter("COPY", epoch=0)
    resumed = ReshardingState.load(path)
    assert resumed is not None
    assert resumed.phase == "COPY"
    assert resumed.old_n == 2 and resumed.new_n == 4
    assert resumed.counters["keys_moved"] == 7
    assert ReshardingState.load(str(tmp_path / "missing.json")) is None
    assert "persist-test" in states_snapshot()


def test_resharding_builtin_page():
    from types import SimpleNamespace

    from incubator_brpc_tpu_torch.builtin import resharding_page

    ReshardingState("builtin-test", 2, 4)
    status, body, ctype = resharding_page(None, SimpleNamespace(query={}))
    assert status == 200 and ctype == "application/json"
    assert "builtin-test" in body
    status, body, _ = resharding_page(
        None, SimpleNamespace(query={"name": "builtin-test"})
    )
    assert status == 200 and '"old_n": 2' in body
    status, _, _ = resharding_page(
        None, SimpleNamespace(query={"name": "no-such"})
    )
    assert status == 404


# ---------------------------------------------------------------------------
# in-memory coordinator: chaos sites + deterministic replay
# ---------------------------------------------------------------------------


class MemShard:
    """In-memory store adapter — the coordinator contract without RPC."""

    def __init__(self):
        self.d = {}
        self.dead = False

    def _chk(self):
        if self.dead:
            raise ShardUnavailable("dead")

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


def _mem_cluster(n_keys=24):
    old = [MemShard() for _ in range(2)]
    new = old + [MemShard() for _ in range(2)]
    keys = [f"key{i}" for i in range(n_keys)]
    for k in keys:
        old[shard_of(k, 2)].write(k, f"v-{k}".encode())
    return old, new, keys


def test_copy_faults_retry_and_corrupt_recopies():
    """'reshard.copy' drop loses one attempt (retried next round);
    corrupt trips the read-back checksum (counted, re-copied) — the
    migration still completes with every key verified in place."""
    old, new, keys = _mem_cluster()
    plan = FaultPlan(
        [
            FaultSpec("reshard.copy", "drop", probability=0.5, max_hits=4),
            FaultSpec("reshard.copy", "corrupt", probability=0.3,
                      max_hits=2),
        ],
        seed=11,
    )
    injector.arm(plan)
    try:
        rep = ReshardCoordinator(
            "mem-faults", old, new, view=MigrationView()
        ).run()
    finally:
        injector.disarm()
    assert rep["completed"], rep
    assert rep["counters"]["checksum_failures"] == 2
    assert rep["counters"]["copy_retries"] >= 1
    for k in keys:
        assert new[shard_of(k, 4)].read(k) == f"v-{k}".encode()


def test_cutover_drop_rolls_back_clean():
    """'reshard.cutover' drop → ROLLED_BACK: old scheme untouched and
    still complete, new-only shards wiped, epoch NOT bumped."""
    old, new, keys = _mem_cluster()
    view = MigrationView()
    plan = FaultPlan(
        [FaultSpec("reshard.cutover", "drop", probability=1.0)], seed=5
    )
    injector.arm(plan)
    try:
        rep = ReshardCoordinator("mem-rb", old, new, view=view).run()
    finally:
        injector.disarm()
    assert rep["rolled_back"] and rep["phase"] == ROLLED_BACK
    assert not view.cut_over()
    for k in keys:
        assert old[shard_of(k, 2)].read(k) == f"v-{k}".encode()
    assert not new[2].d and not new[3].d
    assert rep["counters"]["rollbacks"] == 1


def test_storm_plan_replays_deterministically():
    """Same seed, same workload → identical (site, action, traversal)
    hit logs across two arms: a kill-mid-COPY failure replays exactly."""
    logs = []
    for _ in range(2):
        old, new, keys = _mem_cluster()
        plan = reshard_storm_plan(
            peers=[], seed=42, copy_drop_pct=0.4, copy_max_hits=5,
            cutover_delay_us=100,
        )
        injector.arm(plan)
        try:
            rep = ReshardCoordinator(
                "replay", old, new, view=MigrationView()
            ).run()
            logs.append(injector.hit_log())
        finally:
            injector.disarm()
        assert rep["completed"], rep
    assert logs[0] == logs[1]
    assert any(site == "reshard.copy" for site, _, _ in logs[0])


# ---------------------------------------------------------------------------
# satellite: StableShardLB shed parity ('shard' == mesh_locality contract)
# ---------------------------------------------------------------------------


def test_stable_shard_lb_shed_parity_demotes_and_probes():
    """on_shed demotes the owner (keys fail over to the next sorted
    server), every PROBE_EVERYth demoted pick probes the owner, and
    successful feedback decays the pressure until ownership restores —
    the same revival contract mesh_locality already had."""
    from incubator_brpc_tpu_torch.client.load_balancer import (
        SelectIn,
        create_load_balancer,
    )
    from incubator_brpc_tpu_torch.utils.endpoint import EndPoint

    lb = create_load_balancer("shard")
    nodes = [ServerNode(EndPoint("10.3.0.%d" % i, 80)) for i in range(1, 4)]
    for n in nodes:
        lb.add_server(n)
    sin = SelectIn(request_code=0)
    owner = lb.select_server(sin)
    # one shed is below SHED_TRIP: ownership unchanged
    lb.on_shed(owner)
    assert lb.select_server(sin) == owner
    lb.on_shed(owner)
    assert lb.shedding(owner)
    # demoted: the owner's keys route to a DIFFERENT server now, with
    # every PROBE_EVERYth pick probing the owner for revival
    picks = [lb.select_server(sin) for _ in range(lb.PROBE_EVERY * 3)]
    others = [p for p in picks if p != owner]
    probes = [p for p in picks if p == owner]
    assert others, "shed owner kept all traffic"
    assert probes, "no probe picks — a shed owner could never revive"
    assert len(others) > len(probes)
    # successes decay the pressure; ownership restores
    for _ in range(2):
        lb.feedback(owner, 100, failed=False)
    assert not lb.shedding(owner)
    assert lb.select_server(sin) == owner
    # pressure is capped: a storm of sheds can't dig an unbounded hole
    for _ in range(50):
        lb.on_shed(owner)
    assert lb._shed[owner] == lb.SHED_MAX


# ---------------------------------------------------------------------------
# cache tier: the same migration over HBMCacheStore shards
# ---------------------------------------------------------------------------

_slices = [95]


def _start_cache_server(device):
    from incubator_brpc_tpu_torch.cache.service import HBMCacheService

    _slices[0] += 1
    svc = HBMCacheService(device=device)
    srv = Server(ServerOptions(redis_service=svc))
    assert srv.start_ici(_slices[0], 9, device=device) == 0
    return svc, srv, f"ici://slice{_slices[0]}/chip9"


def test_cache_migration_moves_scheme_delta_and_spilled_gets_miss_clean(torch_device):
    """HBM cache tier 2→4: the coordinator migrates through the redis
    KEYS/GET/SET/DEL surface; mid-COPY a GET for a not-yet-copied key
    on its NEW owner is a CLEAN miss (nil → None, no error) — the
    spilled-read contract; post-DRAIN the sources hold zero moved
    keys and every value sits at its new owner."""
    from incubator_brpc_tpu_torch.cache.channel import CacheChannel

    servers, chans = [], []
    try:
        eps = []
        for _ in range(4):
            svc, srv, ep = _start_cache_server(torch_device)
            servers.append(srv)
            eps.append(ep)
        chans = [CacheChannel(f"list://{ep}", lb="rr",
                              options=ChannelOptions(timeout_ms=30000,
                                                     ici_device=torch_device))
                 for ep in eps]
        old_parts = [CacheShardStore(c) for c in chans[:2]]
        new_parts = [CacheShardStore(c) for c in chans]

        keys = [f"key{i}" for i in range(12)]
        for k in keys:
            old_parts[shard_of(k, 2)].write(k, f"v-{k}".encode())
        planned = moved_keys(keys, 2, 4)
        assert planned

        probe = {"checked": False, "clean": None}

        def spilled_probe(key, src, dst):
            if not probe["checked"]:
                probe["checked"] = True
                # the key is ABOUT to copy: its new owner must answer
                # nil (None), never an error, to a spilled read
                probe["clean"] = chans[dst].get(key) is None

        view = MigrationView()
        rep = ReshardCoordinator(
            "cache-live", old_parts, new_parts, view=view,
            on_copy=spilled_probe,
        ).run()
        assert rep["completed"], rep
        assert probe["checked"] and probe["clean"] is True
        assert rep["counters"]["keys_moved"] == len(planned)
        # placement equals the new scheme; sources drained
        for k in keys:
            assert chans[shard_of(k, 4)].get_host(k) == f"v-{k}".encode()
        for i, part in enumerate(old_parts):
            left = set(part.list_keys())
            stale = {k for k, (s, _) in planned.items() if s == i} & left
            assert not stale, f"cache source {i} still holds {stale}"
        assert rep["counters"]["keys_drained"] == len(planned)
        # the spilled-read probe pins the per-key engine: a copy hook
        # is a per-key observer, so the bulk lane must have stayed cold
        assert rep["counters"]["collective_steps"] == 0, rep["counters"]
    finally:
        for c in chans:
            c.close()
        for srv in servers:
            srv.stop()


def test_cache_migration_bulk_collective_steps_much_less_than_keys(torch_device):
    """The bulk-move lowering, step-log proof: with bulk-capable
    stores (CacheShardStore rides DMGET/DMSET stacked bulks), no armed
    chaos, and no copy hook, each owner-changing (src, dst) range moves
    as ≤3 collective steps — stacked read, stacked write, stacked
    verify — so the step log shows collective_steps ≪ keys_moved while
    every value still lands verified at its new owner."""
    from incubator_brpc_tpu_torch.cache.channel import CacheChannel

    servers, chans = [], []
    try:
        eps = []
        for _ in range(4):
            svc, srv, ep = _start_cache_server(torch_device)
            servers.append(srv)
            eps.append(ep)
        chans = [CacheChannel(f"list://{ep}", lb="rr",
                              options=ChannelOptions(timeout_ms=30000,
                                                     ici_device=torch_device))
                 for ep in eps]
        old_parts = [CacheShardStore(c) for c in chans[:2]]
        new_parts = [CacheShardStore(c) for c in chans]

        keys = [f"blk{i}" for i in range(24)]
        for k in keys:
            old_parts[shard_of(k, 2)].write(k, f"v-{k}".encode())
        planned = moved_keys(keys, 2, 4)
        assert len(planned) >= 8, "tiny plan cannot prove steps ≪ keys"

        rep = ReshardCoordinator(
            "cache-bulk", old_parts, new_parts, view=MigrationView()
        ).run()
        assert rep["completed"], rep
        c = rep["counters"]
        assert c["keys_moved"] == len(planned)
        assert c["bulk_ranges"] > 0, "bulk lane never engaged"
        assert 0 < c["collective_steps"] <= 3 * c["bulk_ranges"], c
        assert c["collective_steps"] < c["keys_moved"], (
            f"step log: {c['collective_steps']} collective steps for "
            f"{c['keys_moved']} keys — not a collective lowering"
        )
        assert c["checksum_failures"] == 0, c
        # placement equals the new scheme; sources drained
        for k in keys:
            assert chans[shard_of(k, 4)].get_host(k) == f"v-{k}".encode()
        for i, part in enumerate(old_parts):
            left = set(part.list_keys())
            stale = {k for k, (s, _) in planned.items() if s == i} & left
            assert not stale, f"cache source {i} still holds {stale}"
    finally:
        for c in chans:
            c.close()
        for srv in servers:
            srv.stop()
