"""HBM cache tier tests, carried by hand from ``tests/test_hbm_cache.py``:
device-resident store, locality-routed cluster client, chaos + determinism
regressions.

The LB units are the JAX file's.  Every store, server port and channel is
given the device the case runs on (the CPU, where values are CPU tensors,
or the card): the port has no default device.  The data-plane tests speak
real RESP over the ICI fabric (device values stay resident end to end).
The transfer-witness proofs run in a subprocess with the port's witness
armed, so arming the lane cannot leak into other tests.
"""

import os
import subprocess
import sys
import textwrap
import time

import pytest

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.cache import (
    CacheChannel,
    HBMCacheService,
    HBMCacheStore,
)
from incubator_brpc_tpu_torch.cache import store as cache_store
from incubator_brpc_tpu_torch.cache.channel import CacheError
from incubator_brpc_tpu_torch.chaos import FaultPlan, FaultSpec, injector
from incubator_brpc_tpu_torch.chaos.storm import admission_pressure_plan
from incubator_brpc_tpu_torch.client.channel import ChannelOptions
from incubator_brpc_tpu_torch.client.load_balancer import (
    ConsistentHashingLB,
    MeshLocalityLB,
    SelectIn,
)
from incubator_brpc_tpu_torch.client.naming_service import ServerNode
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
from incubator_brpc_tpu_torch.utils.endpoint import str2endpoint
from incubator_brpc_tpu_torch.utils.hashes import murmur3_32
from incubator_brpc_tpu_torch.utils.iobuf import DeviceRef

from torch_carry import torch_device  # noqa: F401  (fixture)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ICI coords are process-global (the fabric registry) — this suite owns
# slices 40+ (test_ici owns slice 7, the smoke scripts used 0/1)
_slice_counter = [40]


def fresh_slices(n=1):
    s = _slice_counter[0]
    _slice_counter[0] += n
    return tuple(range(s, s + n)) if n > 1 else s


@pytest.fixture(autouse=True)
def always_disarm():
    yield
    injector.disarm()


def _metric_snapshot():
    return {
        "hits": cache_store.cache_hits.get_value(),
        "misses": cache_store.cache_misses.get_value(),
        "evictions": cache_store.cache_evictions.get_value(),
        "hbm_bytes": cache_store.cache_hbm_bytes.get_value(),
    }


def _metric_delta(before):
    after = _metric_snapshot()
    return {k: after[k] - before[k] for k in before}


def _host_bytes(v):
    if v is None or isinstance(v, bytes):
        return v
    return bytes(DeviceRef(v).view())


# ---------------------------------------------------------------------------
# store units
# ---------------------------------------------------------------------------

def test_store_set_get_roundtrip_device(torch_device):
    st = HBMCacheStore(device=torch_device, hbm_budget_bytes=1 << 20)
    before = _metric_snapshot()
    assert st.set(b"k", b"hello-hbm")
    v = st.get(b"k")
    assert v is not None and not isinstance(v, bytes)
    assert int(v.nbytes) == len(b"hello-hbm")
    assert _host_bytes(v) == b"hello-hbm"
    assert st.get(b"absent") is None
    d = _metric_delta(before)
    assert d["hits"] == 1 and d["misses"] == 1
    assert d["hbm_bytes"] == len(b"hello-hbm")
    assert b"k" in st and len(st) == 1 and st.hbm_used == 9


def test_store_replace_and_delete_accounting(torch_device):
    st = HBMCacheStore(device=torch_device, hbm_budget_bytes=1 << 20)
    before = _metric_snapshot()
    st.set(b"k", b"x" * 100)
    st.set(b"k", b"y" * 40)  # replace: accounting must not leak the 100
    assert st.hbm_used == 40
    assert st.delete(b"k")
    assert not st.delete(b"k")
    assert st.hbm_used == 0 and len(st) == 0
    assert _metric_delta(before)["hbm_bytes"] == 0


def test_store_lru_eviction_under_budget(torch_device):
    st = HBMCacheStore(device=torch_device, hbm_budget_bytes=1000)
    before = _metric_snapshot()
    st.set(b"a", b"a" * 400)
    st.set(b"b", b"b" * 400)
    st.get(b"a")  # a is now most-recent: b must be the victim
    st.set(b"c", b"c" * 400)
    assert b"b" not in st
    assert b"a" in st and b"c" in st
    assert st.hbm_used == 800 <= st.budget
    d = _metric_delta(before)
    assert d["evictions"] == 1
    assert d["hbm_bytes"] == st.hbm_used


def test_store_value_over_budget_refused(torch_device):
    st = HBMCacheStore(device=torch_device, hbm_budget_bytes=64)
    assert not st.set(b"big", b"z" * 65)
    assert b"big" not in st and st.hbm_used == 0


def test_store_flush(torch_device):
    st = HBMCacheStore(device=torch_device, hbm_budget_bytes=1 << 20)
    for i in range(5):
        st.set(b"k%d" % i, b"v" * 10)
    assert st.flush() == 5
    assert len(st) == 0 and st.hbm_used == 0
    s = st.stats()
    assert s["entries"] == 0 and s["hbm_used"] == 0
    assert s["hbm_budget"] == 1 << 20 and s["enabled"]


def test_store_deviceref_whole_array_adopted_zero_copy(torch_device):
    import torch

    st = HBMCacheStore(device=torch_device, hbm_budget_bytes=1 << 20)
    arr = torch.arange(64, dtype=torch.uint8, device=torch_device)
    assert st.set(b"dev", DeviceRef(arr))
    # the ICI SET path: the delivered array is adopted, not copied
    assert st.get(b"dev") is arr


def test_store_disabled_mode_host_bytes(torch_device):
    st = HBMCacheStore(device=torch_device, enabled=False)
    assert st.set(b"k", b"plain")
    assert st.get(b"k") == b"plain"  # bytes, no device involvement
    assert st.get_host(b"k") == b"plain"
    assert st.delete(b"k")


def test_store_get_host_spills_device_value(torch_device):
    st = HBMCacheStore(device=torch_device, hbm_budget_bytes=1 << 20)
    st.set(b"k", b"\x00\xff spill me")
    assert st.get_host(b"k") == b"\x00\xff spill me"
    assert st.get_host(b"gone") is None


def test_store_get_many_fused_same_length(torch_device):
    st = HBMCacheStore(device=torch_device, hbm_budget_bytes=1 << 20)
    for i in range(3):
        st.set(b"f%d" % i, bytes([i]) * 64)
    values, stacked = st.get_many([b"f0", b"f1", b"miss", b"f2"])
    assert values[2] is None and all(v is not None for i, v in enumerate(values) if i != 2)
    assert stacked is not None
    # 3 hits pad up to the 4-bucket; each row is one 64-byte value
    assert tuple(stacked.shape) == (4, 64)
    assert _host_bytes(values[0]) == b"\x00" * 64
    assert _host_bytes(values[1]) == b"\x01" * 64


def test_store_get_many_mixed_lengths_not_fused(torch_device):
    st = HBMCacheStore(device=torch_device, hbm_budget_bytes=1 << 20)
    st.set(b"a", b"x" * 8)
    st.set(b"b", b"y" * 16)
    values, stacked = st.get_many([b"a", b"b"])
    assert stacked is None
    assert _host_bytes(values[0]) == b"x" * 8
    assert _host_bytes(values[1]) == b"y" * 16


# ---------------------------------------------------------------------------
# chaos site cache.lookup
# ---------------------------------------------------------------------------

def test_chaos_cache_lookup_drop_forces_miss(torch_device):
    st = HBMCacheStore(device=torch_device, hbm_budget_bytes=1 << 20)
    st.set(b"victim", b"present")
    st.set(b"bystander", b"safe")
    before = _metric_snapshot()
    injector.arm(FaultPlan(
        [FaultSpec("cache.lookup", "drop", probability=1.0,
                   match={"method": "victim"})],
        seed=11, name="cache-drop",
    ))
    assert st.get(b"victim") is None  # present key, forced miss
    assert _host_bytes(st.get(b"bystander")) == b"safe"  # matcher is per-key
    injector.disarm()
    assert _host_bytes(st.get(b"victim")) == b"present"
    d = _metric_delta(before)
    assert d["misses"] == 1 and d["hits"] == 2
    hits = injector.site_hits()
    assert hits.get("cache.lookup", {}).get("drop") == 1


def test_chaos_cache_lookup_delay_is_bounded_straggler(torch_device):
    st = HBMCacheStore(device=torch_device, hbm_budget_bytes=1 << 20)
    st.set(b"slow", b"eventually")
    injector.arm(FaultPlan(
        [FaultSpec("cache.lookup", "delay_us", arg=20_000, probability=1.0,
                   max_hits=1)],
        seed=5, name="cache-straggler",
    ))
    t0 = time.monotonic()
    v = st.get(b"slow")
    elapsed = time.monotonic() - t0
    assert _host_bytes(v) == b"eventually"  # delayed, never corrupted
    assert elapsed >= 0.015


# ---------------------------------------------------------------------------
# ConsistentHashingLB determinism (golden-pinned ring)
# ---------------------------------------------------------------------------

_RING_MEMBERS = ("ici://slice0/chip1", "ici://slice0/chip2", "ici://slice1/chip1")

# murmur3_32(b"key-%d") for key-0..key-11 — pinned so a hash change
# (which would reshuffle every cluster's key ownership) fails loudly
_KEY_CODES = [
    3812096191, 2561742240, 4093138188, 2034982562, 3789224358, 512346046,
    136335094, 2054334308, 339503824, 3102890356, 568422892, 2041436440,
]

# ring-walk owner of key-i over the 3-member ring (pure function of the
# member set: any client, any join order, must agree on these)
_KEY_OWNERS = [
    "ici://slice1/chip1", "ici://slice0/chip2", "ici://slice0/chip2",
    "ici://slice0/chip1", "ici://slice1/chip1", "ici://slice1/chip1",
    "ici://slice0/chip2", "ici://slice0/chip1", "ici://slice0/chip1",
    "ici://slice0/chip2", "ici://slice0/chip1", "ici://slice0/chip1",
]

# owner of key-i when its primary owner is excluded (breaker-isolated):
# the failover target is the NEXT ring point, also deterministic
_KEY_FAILOVER = [
    "ici://slice0/chip1", "ici://slice1/chip1", "ici://slice1/chip1",
    "ici://slice0/chip2", "ici://slice0/chip2", "ici://slice0/chip2",
    "ici://slice0/chip1", "ici://slice0/chip2", "ici://slice1/chip1",
    "ici://slice0/chip1", "ici://slice0/chip2", "ici://slice0/chip2",
]

_RING_FIRST5 = [
    (10285887, "ici://slice0/chip1"),
    (12499358, "ici://slice0/chip2"),
    (15246177, "ici://slice1/chip1"),
    (18022791, "ici://slice0/chip1"),
    (25930408, "ici://slice1/chip1"),
]


def _nodes(addrs=_RING_MEMBERS):
    return [ServerNode(str2endpoint(a)) for a in addrs]


def _build_ring(cls=ConsistentHashingLB, order=None):
    lb = cls()
    for n in order if order is not None else _nodes():
        lb.add_server(n)
    return lb


def test_ring_golden_positions_and_owners():
    lb = _build_ring()
    hashes, nodes = lb._ring.read()
    assert len(hashes) == len(_RING_MEMBERS) * ConsistentHashingLB.REPLICAS
    assert [(h, str(n.endpoint)) for h, n in zip(hashes[:5], nodes[:5])] \
        == _RING_FIRST5
    for i in range(12):
        code = murmur3_32(b"key-%d" % i)
        assert code == _KEY_CODES[i]
        picked = lb.select_server(SelectIn(request_code=code))
        assert str(picked.endpoint) == _KEY_OWNERS[i], f"key-{i}"


def test_ring_is_pure_function_of_member_set():
    # a client that learned the membership in reverse order (or lost
    # and re-added a node) must own keys identically
    fwd = _build_ring()
    rev = _build_ring(order=list(reversed(_nodes())))
    churn = _build_ring()
    n0 = _nodes()[0]
    churn.remove_server(n0)
    churn.add_server(n0)
    for lb in (rev, churn):
        for i in range(12):
            assert str(
                lb.select_server(SelectIn(request_code=_KEY_CODES[i])).endpoint
            ) == _KEY_OWNERS[i]
    assert fwd._ring.read() == rev._ring.read() == churn._ring.read()


def test_ring_deterministic_exclusion_failover():
    lb = _build_ring()
    by_addr = {str(n.endpoint): n for n in _nodes()}
    for i in range(12):
        owner = by_addr[_KEY_OWNERS[i]]
        picked = lb.select_server(
            SelectIn(request_code=_KEY_CODES[i], excluded=frozenset({owner}))
        )
        assert str(picked.endpoint) == _KEY_FAILOVER[i], f"key-{i}"
    # all excluded: still answers (better the owner than none)
    picked = lb.select_server(
        SelectIn(request_code=_KEY_CODES[0], excluded=frozenset(_nodes()))
    )
    assert picked is not None


# ---------------------------------------------------------------------------
# MeshLocalityLB: locality ranking, shed weighting, probe revival
# ---------------------------------------------------------------------------

def test_mesh_locality_without_coords_degrades_to_plain_ring():
    lb = _build_ring(cls=MeshLocalityLB)
    for i in range(12):
        assert str(
            lb.select_server(SelectIn(request_code=_KEY_CODES[i])).endpoint
        ) == _KEY_OWNERS[i]


def test_mesh_locality_prefers_same_slice_replicas():
    lb = _build_ring(cls=MeshLocalityLB)
    lb.set_local_coords((0, 9))  # slice0 is home: chips 1 and 2 are local
    for i in range(12):
        picked = lb.select_server(SelectIn(request_code=_KEY_CODES[i]))
        assert picked.endpoint.coords[0] == 0, f"key-{i} spilled to DCN"
    assert lb.locality_fraction() == 1.0
    # still deterministic: the same key picks the same local replica
    again = [
        str(lb.select_server(SelectIn(request_code=c)).endpoint)
        for c in _KEY_CODES
    ]
    assert again == [
        str(lb.select_server(SelectIn(request_code=c)).endpoint)
        for c in _KEY_CODES
    ]


def test_mesh_locality_spills_only_when_locals_shed_or_excluded():
    lb = _build_ring(cls=MeshLocalityLB)
    lb.set_local_coords((0, 9))
    locals_ = [n for n in _nodes() if n.endpoint.coords[0] == 0]
    remote = [n for n in _nodes() if n.endpoint.coords[0] == 1][0]
    sin = SelectIn(request_code=_KEY_CODES[0])
    # one local shedding: traffic shifts to the OTHER local, not DCN
    for _ in range(MeshLocalityLB.SHED_TRIP):
        lb.on_shed(locals_[0])
    picked = lb.select_server(sin)
    assert picked == locals_[1]
    # both locals shedding: now DCN spill is allowed (modulo the
    # revival probe, which deliberately re-tries a shedding local)
    for _ in range(MeshLocalityLB.SHED_TRIP):
        lb.on_shed(locals_[1])
    picks = {lb.select_server(sin) for _ in range(MeshLocalityLB.PROBE_EVERY - 1)}
    assert remote in picks
    # excluded locals (breaker isolation) spill too
    lb2 = _build_ring(cls=MeshLocalityLB)
    lb2.set_local_coords((0, 9))
    assert lb2.select_server(
        SelectIn(request_code=_KEY_CODES[0], excluded=frozenset(locals_))
    ) == remote


def test_mesh_locality_probe_revival_decays_shed():
    # 1 local + 1 remote: once the local sheds, only the periodic probe
    # can ever pick it again — its successes must decay the pressure
    # back below the trip point (the spill is not permanent)
    members = ["ici://slice0/chip1", "ici://slice1/chip1"]
    lb = _build_ring(cls=MeshLocalityLB, order=_nodes(members))
    lb.set_local_coords((0, 9))
    local = _nodes(members)[0]
    for _ in range(MeshLocalityLB.SHED_MAX):
        lb.on_shed(local)
    assert lb.shedding(local)
    sin = SelectIn(request_code=_KEY_CODES[0])
    probed = 0
    for _ in range(10 * MeshLocalityLB.PROBE_EVERY):
        picked = lb.select_server(sin)
        if picked == local:
            probed += 1
            lb.feedback(local, 100, failed=False)  # the probe succeeded
        if not lb.shedding(local):
            break
    assert probed >= 1, "shedding local was never probed"
    assert not lb.shedding(local), "probe successes did not decay the shed"
    assert lb.select_server(sin) == local  # locality restored


def test_mesh_locality_shed_saturates_and_decays():
    lb = _build_ring(cls=MeshLocalityLB)
    node = _nodes()[0]
    for _ in range(MeshLocalityLB.SHED_MAX + 5):
        lb.on_shed(node)
    assert lb._shed[node] == MeshLocalityLB.SHED_MAX
    for _ in range(MeshLocalityLB.SHED_MAX):
        lb.feedback(node, 100, failed=False)
    assert not lb.shedding(node) and lb._shed[node] == 0
    lb.feedback(node, 100, failed=True)  # failures never decay
    assert lb._shed[node] == 0


# ---------------------------------------------------------------------------
# redis front over the ICI fabric (device value plane)
# ---------------------------------------------------------------------------

def _start_cache_server(slice_id, chip, device, **store_kwargs):
    svc = HBMCacheService(device=device, **store_kwargs)
    srv = Server(ServerOptions(redis_service=svc))
    assert srv.start_ici(slice_id, chip, device=device) == 0
    return srv, svc


def _options(device):
    return ChannelOptions(timeout_ms=30000, ici_device=device)


# ---------------------------------------------------------------------------
# CacheChannel: consistent-hash cluster with ICI locality
# ---------------------------------------------------------------------------

def _start_cluster(local_slice, remote_slice, device):
    """Two replicas in the client's ICI neighborhood + one across DCN."""
    servers = [
        _start_cache_server(local_slice, 1, device)[0],
        _start_cache_server(local_slice, 2, device)[0],
        _start_cache_server(remote_slice, 1, device)[0],
    ]
    url = (
        f"list://ici://slice{local_slice}/chip1,"
        f"ici://slice{local_slice}/chip2,"
        f"ici://slice{remote_slice}/chip1"
    )
    return servers, url


def test_cache_channel_cluster_locality_and_roundtrip(torch_device):
    ls, rs = fresh_slices(2)
    servers, url = _start_cluster(ls, rs, torch_device)
    cc = CacheChannel(url, local_coords=(ls, 9), options=_options(torch_device))
    try:
        payloads = {f"key-{i}": bytes([i]) * 64 for i in range(12)}
        for k, v in payloads.items():
            cc.set(k, v)
        for k, v in payloads.items():
            got = cc.get(k)
            assert got is not None, f"{k} missed its owner"
            assert not isinstance(got, bytes), "ICI GET came back as host bytes"
            assert _host_bytes(got) == v
        assert cc.get("never-set") is None
        assert cc.delete("key-0") and not cc.delete("key-0")
        # >=90% locality while healthy is the contract; with both
        # local replicas up every pick must stay in the neighborhood
        assert cc.locality_fraction() >= 0.9
        b = cc.balancer()
        assert b.picks_remote == 0, "healthy cluster spilled to DCN"
    finally:
        cc.close()
        for srv in servers:
            srv.stop()


def test_cache_channel_get_many_groups_by_replica(torch_device):
    ls, rs = fresh_slices(2)
    servers, url = _start_cluster(ls, rs, torch_device)
    cc = CacheChannel(url, local_coords=(ls, 9), options=_options(torch_device))
    try:
        keys = [f"mkey-{i}" for i in range(8)]
        for i, k in enumerate(keys):
            cc.set(k, bytes([i]) * 64)
        res = cc.get_many(keys + ["mkey-miss"])
        assert res.lengths[:-1] == [64] * 8 and res.lengths[-1] == -1
        for i in range(8):
            assert res.hit(i)
            assert res.host_bytes(i) == bytes([i]) * 64
        assert res.row(8) is None and res.host_bytes(8) is None
    finally:
        cc.close()
        for srv in servers:
            srv.stop()


def test_cache_channel_set_many_one_dmset_per_replica_group(torch_device):
    """The bulk write surface the resharding COPY rides: set_many
    groups pairs by routed replica, ships ONE DMSET per group, returns
    the stored count, and every value is readable at its owner."""
    ls, rs = fresh_slices(2)
    servers, url = _start_cluster(ls, rs, torch_device)
    cc = CacheChannel(url, local_coords=(ls, 9), options=_options(torch_device))
    try:
        items = [(f"bulkw-{i}", bytes([i + 1]) * 48) for i in range(10)]
        assert cc.set_many(items) == 10
        for k, v in items:
            got = cc.get(k)
            assert got is not None, f"{k} missed after bulk write"
            assert _host_bytes(got) == v
        res = cc.get_many([k for k, _ in items])
        assert res.lengths == [48] * 10
        assert cc.set_many([]) == 0
    finally:
        cc.close()
        for srv in servers:
            srv.stop()


def test_cache_channel_single_replica_batch_keeps_stacked_array(torch_device):
    s = fresh_slices()
    srv, _ = _start_cache_server(s, 1, torch_device)
    cc = CacheChannel(f"list://ici://slice{s}/chip1", local_coords=(s, 9),
                      options=_options(torch_device))
    try:
        keys = [f"skey-{i}" for i in range(4)]
        for i, k in enumerate(keys):
            cc.set(k, bytes([i + 1]) * 32)
        res = cc.get_many(keys)
        assert res.stacked is not None, "co-located batch lost its fusion"
        assert tuple(res.stacked.shape) == (4, 32)
        assert res.host_bytes(2) == b"\x03" * 32
    finally:
        cc.close()
        srv.stop()


def test_cache_channel_tier_shed_spill_probe_relocalize(torch_device):
    """Satellite: tier-aware weighting end to end.  An admission storm
    on the local owner sheds GETs (EOVERCROWDED) → the LB routes
    around; once the storm passes, revival probes decay the shed and
    traffic re-localizes to >=90%."""
    ls, rs = fresh_slices(2)
    servers, url = _start_cluster(ls, rs, torch_device)
    cc = CacheChannel(url, local_coords=(ls, 9), options=_options(torch_device))
    try:
        cc.set("stormy", b"s" * 64)
        injector.arm(admission_pressure_plan(
            seed=7, reject_pct=1.0, method="redis.GET", max_hits=6,
        ))
        sheds = spilled_misses = 0
        for _ in range(12):
            try:
                if cc.get("stormy") is None:
                    # routed around the shedding owner: the stand-in
                    # replica doesn't hold the key — a clean miss, not
                    # an error (the cache tier is not replicated)
                    spilled_misses += 1
            except CacheError as e:  # EOVERCROWDED while the storm burns
                assert e.code == errors.EOVERCROWDED, e
                sheds += 1
        assert sheds >= 1, "storm never shed a GET"
        assert spilled_misses >= 1, "shed owner was never routed around"
        b = cc.balancer()
        assert any(v >= b.SHED_TRIP for v in b._shed.values()), \
            "shed signal never reached the balancer"
        injector.disarm()
        for _ in range(40):  # probes + successes decay the shed pressure
            cc.get("stormy")  # misses allowed while still spilled
        b.picks_local = b.picks_remote = 0  # fresh locality measurement
        for _ in range(20):
            got = cc.get("stormy")
            assert got is not None, "traffic never re-localized to the owner"
            assert _host_bytes(got) == b"s" * 64
        assert cc.locality_fraction() >= 0.9, (
            b.picks_local, b.picks_remote, dict(b._shed),
        )
    finally:
        cc.close()
        for srv in servers:
            srv.stop()


def test_cache_channel_fabric_naming_feeds_membership(torch_device):
    """tpu://fabric membership: the default NS discovers started cache
    servers by polling the fabric registry (0.5s interval) — warm up
    until the first poll lands."""
    s = fresh_slices()
    srv, _ = _start_cache_server(s, 1, torch_device)
    cc = CacheChannel(
        "tpu://fabric",
        local_coords=(s, 9),
        options=ChannelOptions(
            timeout_ms=30000, connection_group=f"cachefab{s}",
            ici_device=torch_device,
        ),
    )
    try:
        deadline = time.monotonic() + 10
        while True:
            try:
                cc.set("warm", b"x" * 16)
                break
            except Exception:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.1)
        got = cc.get("warm")
        assert got is not None and _host_bytes(got) == b"x" * 16
    finally:
        cc.close()
        srv.stop()


# ---------------------------------------------------------------------------
# transfer-witness proof: the hot path does ZERO device→host pulls
# ---------------------------------------------------------------------------

def _child_device(device):
    return "torch.device('cpu')" if device.type == "cpu" else "torch.device('cuda', 0)"


def _run_child(code, timeout=180):
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=timeout, cwd=REPO_ROOT,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )


def test_witness_ici_hit_path_zero_pulls_tcp_spill_manifested(torch_device):
    """Armed witness, whole data plane live: ICI SET+GET+DMGET must use
    NO device→host transfer (no violation, no spill-scope use), the TCP
    GET must exit through exactly the manifested ``cache.host-spill``
    choke point, and the fused gather must stay inside its retrace
    bound."""
    code = textwrap.dedent(f"""\
        import sys
        sys.path.insert(0, {str(REPO_ROOT)!r})
        from incubator_brpc_tpu_torch.analysis import device_witness as dw
        dw.enable()
        import torch
        DEV = {_child_device(torch_device)}
        from incubator_brpc_tpu_torch.cache import HBMCacheService
        from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
        from incubator_brpc_tpu_torch.client.controller import Controller
        from incubator_brpc_tpu_torch.protocols import redis as R
        from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

        def call(ch, *commands):
            req = R.RedisRequest()
            for cmd in commands:
                req.add_command(*cmd)
            resp = R.RedisResponse()
            ctrl = Controller()
            ch.call_method(R.redis_method_spec(), ctrl, req, resp)
            assert not ctrl.failed(), ctrl.error_text()
            return resp

        svc = HBMCacheService(device=DEV)
        srv = Server(ServerOptions(redis_service=svc))
        assert srv.start_ici(60, 1, device=DEV) == 0
        ch = Channel(ChannelOptions(protocol="redis", timeout_ms=60000,
                                    ici_device=DEV))
        assert ch.init("ici://slice60/chip1") == 0
        for i in range(3):
            call(ch, ("SET", b"w%d" % i, bytes([i]) * 64))
        # hot path: GET + fused DMGET, device-resident end to end
        arr = call(ch, ("GET", b"w0")).reply(0).device_array()
        assert arr is not None and int(arr.nbytes) == 64
        fused, lengths, payload = call(
            ch, ("DMGET", b"w0", b"w1", b"w2")).reply(0).value
        assert fused.value == 1
        stacked = payload.device_array()
        assert stacked is not None and tuple(stacked.shape) == (4, 64)
        rep = dw.cross_check()
        assert rep["violations"] == [], rep["violations"]
        assert "cache.host-spill" not in rep["scope_uses"], rep["scope_uses"]
        # host-client spill: TCP GET goes through the manifested scope
        assert srv.stop() == 0
        srv2 = Server(ServerOptions(redis_service=svc))
        assert srv2.start(0) == 0
        ch2 = Channel(ChannelOptions(protocol="redis", timeout_ms=60000,
                                     connection_group="wit-tcp"))
        assert ch2.init("127.0.0.1:%d" % srv2.port) == 0
        v = call(ch2, ("GET", b"w1")).reply(0).bytes_value()
        assert v == bytes([1]) * 64
        srv2.stop()
        rep = dw.cross_check()
        assert rep["violations"] == [], rep["violations"]
        assert rep["scope_uses"].get("cache.host-spill", 0) >= 1, \\
            rep["scope_uses"]
        assert dw.retrace_contradictions() == []
        print("CACHE-WITNESS-OK")
    """)
    proc = _run_child(code)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    assert "CACHE-WITNESS-OK" in proc.stdout

def test_witness_bulk_copy_zero_violations_ledger_balanced(torch_device):
    """Armed witness over the bulk-move COPY: a 2→4 cache
    migration riding DMGET/DMSET stacked bulks must record ZERO
    unmanifested device→host pulls (every read-back exits through the
    manifested iobuf.host-view choke point), zero retrace
    contradictions, a step log with collective_steps ≪ keys_moved, and
    an hbm_account ledger that balances to exactly the stored bytes
    after DRAIN."""
    code = textwrap.dedent(f"""\
        import gc
        import sys
        sys.path.insert(0, {str(REPO_ROOT)!r})
        from incubator_brpc_tpu_torch.analysis import device_witness as dw
        dw.enable()
        import torch
        DEV = {_child_device(torch_device)}
        from incubator_brpc_tpu_torch.client.channel import ChannelOptions
        from incubator_brpc_tpu_torch.utils.flags import set_flag
        set_flag("profiler_hbm_enabled", True)
        from incubator_brpc_tpu_torch.cache import HBMCacheService
        from incubator_brpc_tpu_torch.cache.channel import CacheChannel
        from incubator_brpc_tpu_torch.observability.profiling import hbm_profile
        from incubator_brpc_tpu_torch.resharding.migration import (
            CacheShardStore, MigrationView, ReshardCoordinator, shard_of,
        )
        from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

        servers, eps = [], []
        for i in range(4):
            srv = Server(ServerOptions(redis_service=HBMCacheService(device=DEV)))
            assert srv.start_ici(70 + i, 9, device=DEV) == 0
            servers.append(srv)
            eps.append("ici://slice%d/chip9" % (70 + i))
        chans = [CacheChannel("list://" + ep, lb="rr",
                              options=ChannelOptions(timeout_ms=30000,
                                                     ici_device=DEV))
                 for ep in eps]
        old = [CacheShardStore(c) for c in chans[:2]]
        new = [CacheShardStore(c) for c in chans]
        keys = ["wit%d" % i for i in range(16)]
        for k in keys:
            old[shard_of(k, 2)].write(k, b"x" * 64)
        rep = ReshardCoordinator(
            "wit-bulk", old, new, view=MigrationView()
        ).run()
        assert rep["completed"], rep
        c = rep["counters"]
        assert c["bulk_ranges"] > 0, c
        assert 0 < c["collective_steps"] < c["keys_moved"], c
        w = dw.cross_check()
        assert w["violations"] == [], w["violations"]
        assert dw.retrace_contradictions() == []
        # ledger balance: after DRAIN every key lives exactly once
        gc.collect()
        tags = hbm_profile()["tags"]
        assert tags.get("cache.values", {{}}).get("bytes") == 16 * 64, tags
        for ch in chans:
            ch.close()
        for srv in servers:
            srv.stop()
        print("COPY-WITNESS-OK")
    """)
    proc = _run_child(code)
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    assert "COPY-WITNESS-OK" in proc.stdout
