"""Cache-tier cluster resilience: replica death → DCN spill failover →
health-check revival, under RecoveryHarness invariants.

The cluster here is the smallest shape that exercises every leg: one
replica in the client's ICI neighborhood (the locality winner) and one
across DCN.  Killing the local replica must fail over WITHOUT surfacing
anything beyond clean cache misses and whitelisted error codes; a
restart at the same mesh coordinates must be discovered by the health
prober and win back >=90% locality.

Carried by hand from ``tests/test_cache_cluster.py``: every cache server,
server port and the CacheChannel are given the device the case runs on
(the CPU, or the card), as the port has no default device.
"""

import time

import pytest

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.cache import CacheChannel, HBMCacheService
from incubator_brpc_tpu_torch.cache.channel import CacheError
from incubator_brpc_tpu_torch.client.channel import ChannelOptions
from incubator_brpc_tpu_torch.chaos import (
    FaultPlan,
    FaultSpec,
    RecoveryHarness,
    injector,
)
from incubator_brpc_tpu_torch.chaos.harness import wait_until
from incubator_brpc_tpu_torch.client.naming_service import ServerNode
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
from incubator_brpc_tpu_torch.utils.endpoint import str2endpoint
from incubator_brpc_tpu_torch.utils.iobuf import DeviceRef

from torch_carry import torch_device  # noqa: F401  (fixture)

# process-global fabric: this module owns slices 70+ (test_hbm_cache
# owns 40+, test_ici slice 7)
_slice_counter = [70]


def fresh_slices(n=2):
    s = _slice_counter[0]
    _slice_counter[0] += n
    return tuple(range(s, s + n))


@pytest.fixture(autouse=True)
def always_disarm():
    yield
    injector.disarm()


def _start_cache_server(slice_id, chip, device):
    srv = Server(ServerOptions(redis_service=HBMCacheService(device=device)))
    assert srv.start_ici(slice_id, chip, device=device) == 0
    return srv


def _host_bytes(v):
    if v is None or isinstance(v, bytes):
        return v
    return bytes(DeviceRef(v).view())


def test_kill_local_replica_dcn_spill_then_health_check_revival(torch_device):
    local_slice, remote_slice = fresh_slices()
    local_addr = f"ici://slice{local_slice}/chip1"
    remote_addr = f"ici://slice{remote_slice}/chip1"
    servers = {
        "local": _start_cache_server(local_slice, 1, torch_device),
        "remote": _start_cache_server(remote_slice, 1, torch_device),
    }
    cc = CacheChannel(
        f"list://{local_addr},{remote_addr}", local_coords=(local_slice, 9),
        options=ChannelOptions(timeout_ms=30000, ici_device=torch_device),
    )
    payload = b"f" * 64
    local_node = ServerNode(str2endpoint(local_addr))

    def guarded_get(h):
        """One GET, outcome recorded the harness way: error CODES, not
        exceptions, and a refill on miss (the cache-client contract)."""
        try:
            v = cc.get("failover")
            h.record_error(0)
        except CacheError as e:
            h.record_error(e.code)
            return None
        if v is None:
            try:
                cc.set("failover", payload)
            except CacheError as e:
                h.record_error(e.code)
        return v

    def local_isolated():
        st = cc._channel._lb._states.get(local_node)
        return st is not None and st.breaker.is_isolated()

    def workload(h):
        b = cc.balancer()
        # -- healthy: the local replica owns the key and serves it hot
        cc.set("failover", payload)
        for _ in range(5):
            assert _host_bytes(guarded_get(h)) == payload
        assert b.picks_remote == 0, "healthy GETs spilled to DCN"

        # -- kill the local replica (fabric port unregisters: the next
        # select sees it unroutable → breaker trips → DCN failover)
        servers["local"].stop()
        spill_hits = 0
        for _ in range(20):
            v = guarded_get(h)  # miss-then-refill lands on the remote
            if v is not None and _host_bytes(v) == payload:
                spill_hits += 1
        assert spill_hits >= 1, "remote replica never served the key"
        assert b.picks_remote > 0, "failover never crossed to DCN"
        assert local_isolated(), "dead local replica was never isolated"

        # -- restart at the SAME mesh coordinates: the health prober
        # (1s interval, fabric routability) must revive it unaided
        servers["local"] = _start_cache_server(local_slice, 1, torch_device)
        assert wait_until(lambda: not local_isolated(), timeout_s=10), \
            "health check never revived the restarted replica"

        # -- locality wins back: fresh store misses refill, then >=90%
        # of GETs land back in the ICI neighborhood
        for _ in range(5):
            guarded_get(h)  # refill cycle against the fresh store
        b.picks_local = b.picks_remote = 0
        for _ in range(20):
            assert _host_bytes(guarded_get(h)) == payload
        assert cc.locality_fraction() >= 0.9, (
            b.picks_local, b.picks_remote,
        )
        return {"spill_hits": spill_hits}

    # straggler lookups ride along while the replica dies: the chaos
    # site must only delay, never corrupt or deadlock the failover
    plan = FaultPlan(
        [FaultSpec("cache.lookup", "delay_us", arg=5_000, probability=0.3,
                   max_hits=5)],
        seed=29, name="cache-failover",
    )
    harness = RecoveryHarness(plan, wall_clock_s=60.0, settle_s=5.0)
    try:
        report = harness.run_or_raise(workload)
        assert report.workload_result["spill_hits"] >= 1
        # failover must surface ONLY whitelisted codes (checked by the
        # harness) and mostly clean successes
        assert report.error_codes.count(0) >= 25
    finally:
        cc.close()
        for srv in servers.values():
            srv.stop()


def test_membership_shrink_reroutes_remaining_replica(torch_device):
    """A replica leaving the NAMING membership (not just dying) must
    drain its ownership to the survivors deterministically."""
    local_slice, = fresh_slices(1)
    a = _start_cache_server(local_slice, 1, torch_device)
    b_srv = _start_cache_server(local_slice, 2, torch_device)
    cc = CacheChannel(
        f"list://ici://slice{local_slice}/chip1,"
        f"ici://slice{local_slice}/chip2",
        local_coords=(local_slice, 9),
        options=ChannelOptions(timeout_ms=30000, ici_device=torch_device),
    )
    try:
        keys = [f"shrink-{i}" for i in range(8)]
        for k in keys:
            cc.set(k, b"v" * 32)
        # drop chip1 from the LB membership (what a naming update does)
        balancer = cc.balancer()
        node_a = ServerNode(str2endpoint(f"ici://slice{local_slice}/chip1"))
        assert balancer.remove_server(node_a)
        for k in keys:
            v = cc.get(k)  # every key now routes to chip2 …
            if v is None:
                cc.set(k, b"v" * 32)  # … whose store may need a refill
        for k in keys:
            assert _host_bytes(cc.get(k)) == b"v" * 32
    finally:
        cc.close()
        a.stop()
        b_srv.stop()
