"""ReplicatedShardChannel: the client face of the replication tier.

Wraps the ShardRoutedChannel contract so existing stubs keep working
(``ps_stub(replicated_ps_channel(...))`` is a drop-in for
``ps_stub(sharded_ps_channel(...))``):

* **writes** (Put/Delete) route by key to the owning shard GROUP and
  run the quorum protocol (replication/group.py): through the leader,
  epoch-stamped, acked only after quorum — failures surface as ERPC
  codes (ESTALEEPOCH / ETOOMANYFAILS / EINTERNAL), never hangs;
* **reads** (everything else routed) fan to the nearest serving
  replica: each group's read plane is a
  :class:`~incubator_brpc_tpu_torch.client.combo.ManualClusterChannel` under
  the ``mesh_locality`` LB with backup-request hedging
  (``hedge_ms``) — a dead/slow replica costs one hedge, not a tail;
* **fan-out methods** (Forward) ride an inner ShardRoutedChannel whose
  partitions are the per-group LEADER channels — Forward mutates
  device state ordering, so it keeps the through-the-leader rule;
* **RF=1 is byte-for-byte the unreplicated path**: every group has one
  member, the channel delegates ALL calls to a plain
  ShardRoutedChannel built over those members, and no group/lease/
  quorum code runs on the call path (the OFF/ON/OFF bench triplet
  holds ≈0%).

Membership is refreshed off each group's ``members_version`` — one int
compare per call on the steady path; node lists rebuild only when a
replica dies, rejoins, or the leader moves.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.replication import metrics as _m
from incubator_brpc_tpu_torch.replication.group import (
    ReplicaGroup,
    ReplicaNode,
    ReplicationError,
    register_group,
)


def _server_node(endpoint: str):
    from incubator_brpc_tpu_torch.client.naming_service import ServerNode
    from incubator_brpc_tpu_torch.utils.endpoint import str2endpoint

    return ServerNode(str2endpoint(endpoint))


class ReplicatedShardChannel:
    """Channel duck-type over a list of :class:`ReplicaGroup`\\ s (one
    per shard, in shard order) plus their members' RPC endpoints."""

    WRITE_METHODS = frozenset({"Put", "Delete"})

    def __init__(
        self,
        groups: Sequence[ReplicaGroup],
        key_fn: Optional[Callable[[object], str]] = None,
        seed: int = 0,
        hedge_ms: int = 50,
        read_lb: str = "mesh_locality",
        timeout_ms: int = 20000,
        fail_limit: int = 0,
        channel_options=None,
        write_methods=None,
    ):
        from incubator_brpc_tpu_torch.client.channel import ChannelOptions
        from incubator_brpc_tpu_torch.client.combo import (
            ManualClusterChannel,
            ParallelChannelOptions,
            ShardRoutedChannel,
        )

        if not groups:
            raise ValueError("ReplicatedShardChannel needs >= 1 group")
        self.groups = list(groups)
        self._key_fn = key_fn or (
            lambda req: str(getattr(req, "message", "") or "")
        )
        self._seed = int(seed)
        self._write = (
            frozenset(write_methods)
            if write_methods is not None
            else self.WRITE_METHODS
        )
        self._lock = threading.Lock()
        self.rf1 = all(len(g.nodes) == 1 for g in self.groups)
        opts = ParallelChannelOptions(
            fail_limit=fail_limit, timeout_ms=timeout_ms
        )
        if self.rf1:
            # replication factor 1: the whole tier collapses to the
            # existing unreplicated ShardRoutedChannel — nothing
            # replication-shaped runs per call (the disabled path is
            # free by construction)
            from incubator_brpc_tpu_torch.client.channel import Channel

            subs = []
            for g in self.groups:
                sub = Channel(channel_options)
                rc = sub.init(g.nodes[0].endpoint)
                if rc != 0:
                    raise ValueError(
                        f"cannot init shard channel to {g.nodes[0].endpoint}"
                    )
                subs.append(sub)
            self._direct = ShardRoutedChannel(
                options=opts, key_fn=self._key_fn, seed=self._seed
            )
            self._direct.set_partitions(subs)
            return
        self._direct = None
        from dataclasses import replace as _dc_replace

        base = channel_options if channel_options is not None else ChannelOptions()
        read_opts = _dc_replace(base, backup_request_ms=int(hedge_ms))
        # per-group read plane: serving replicas under the locality LB,
        # hedged; per-group write plane: the leader, re-fed on change
        self._read_chans = [
            ManualClusterChannel(read_lb, read_opts) for _ in self.groups
        ]
        self._leader_chans = [
            ManualClusterChannel("rr", channel_options) for _ in self.groups
        ]
        self._versions = [-1] * len(self.groups)
        self._reader = ShardRoutedChannel(
            options=opts, key_fn=self._key_fn, seed=self._seed
        )
        self._reader.set_partitions(self._read_chans)
        self._fan = ShardRoutedChannel(
            options=opts, key_fn=self._key_fn, seed=self._seed
        )
        self._fan.set_partitions(self._leader_chans)

    # -- ShardRoutedChannel surface ------------------------------------------
    def shard_of(self, key: str, n: Optional[int] = None) -> int:
        from incubator_brpc_tpu_torch.utils.hashes import murmur3_32

        if n is None:
            n = len(self.groups)
        return murmur3_32(str(key).encode(), seed=self._seed) % n

    def partition_count(self) -> int:
        return len(self.groups)

    def set_fanout(self, method_name: str, prepare_leg=None, merge=None):
        if self._direct is not None:
            self._direct.set_fanout(method_name, prepare_leg, merge)
        else:
            self._fan.set_fanout(method_name, prepare_leg, merge)

    # -- membership refresh ---------------------------------------------------
    def _refresh(self, idx: int) -> None:
        """Re-feed group ``idx``'s read/leader channels iff its
        members_version moved — an int compare on the steady path."""
        g = self.groups[idx]
        v = g.members_version
        if v == self._versions[idx]:
            return
        with self._lock:
            if v == self._versions[idx]:
                return
            serving = g.serving_nodes()
            self._read_chans[idx].set_nodes(
                [_server_node(n.endpoint) for n in serving]
            )
            leader = g.ensure_leader()
            self._leader_chans[idx].set_nodes(
                [_server_node(leader.endpoint)] if leader is not None else []
            )
            # re-read: ensure_leader may itself bump the version (a
            # fresh election); cache the post-election value so the
            # next call doesn't rebuild again
            self._versions[idx] = g.members_version

    def _refresh_all(self) -> None:
        for i in range(len(self.groups)):
            self._refresh(i)

    # -- the call plane -------------------------------------------------------
    def call_method(self, method_spec, controller, request, response,
                    done=None):
        if self._direct is not None:  # RF=1: the unreplicated path
            return self._direct.call_method(
                method_spec, controller, request, response, done
            )
        m = method_spec.method_name
        if m in self._write:
            return self._call_write(
                m, method_spec, controller, request, response, done
            )
        if m in self._fan._fanout:
            self._refresh_all()
            return self._fan.call_method(
                method_spec, controller, request, response, done
            )
        return self._call_read(
            method_spec, controller, request, response, done
        )

    def _call_read(self, method_spec, controller, request, response, done):
        idx = self.shard_of(self._key_fn(request))
        self._refresh(idx)

        def account():
            if getattr(controller, "_used_backup", False):
                g = self.groups[idx]
                g.counters["hedged_reads"] += 1
                _m.replica_hedged_reads << 1

        if done is None:
            self._reader.call_method(method_spec, controller, request, response)
            account()
            return

        def wrapped_done():
            account()
            done()

        self._reader.call_method(
            method_spec, controller, request, response, wrapped_done
        )

    def _call_write(self, m, method_spec, controller, request, response,
                    done):
        key = self._key_fn(request)
        idx = self.shard_of(key)
        g = self.groups[idx]
        # the attachment is the value — snapshot before anything else
        # consumes it (the DynamicShardChannel discipline)
        value = (
            controller.request_attachment.to_bytes()
            if not controller.request_attachment.empty()
            else b""
        )

        def run_sync():
            start_ns = time.monotonic_ns()
            controller.shard_index = idx
            try:
                if m == "Delete":
                    existed = g.read_any(key) is not None
                    g.delete(key)
                    response.message = "1" if existed else "0"
                else:
                    g.put(key, value)
                    response.message = key
            except ReplicationError as e:
                controller.set_failed(e.code, f"{m}({key}): {e}")
            except Exception as e:  # noqa: BLE001
                controller.set_failed(
                    errors.EINTERNAL, f"replicated {m}({key}) raised: {e}"
                )
            controller.latency_us = (time.monotonic_ns() - start_ns) // 1000

        if done is None:
            run_sync()
        else:
            from incubator_brpc_tpu_torch.runtime import scheduler

            def run_async():
                run_sync()
                done()

            scheduler.spawn(run_async)

    # -- introspection --------------------------------------------------------
    def describe(self) -> Dict[str, dict]:
        return {g.name: g.describe() for g in self.groups}


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

def replicated_ps_channel(
    group_endpoints: Sequence[Sequence[str]],
    board=None,
    quorum: Optional[int] = None,
    lease_ttl_s: float = 0.5,
    hedge_ms: int = 50,
    read_lb: str = "mesh_locality",
    timeout_ms: int = 20000,
    seed: int = 0,
    channel_options=None,
    store_timeout_ms: int = 10000,
    name_prefix: str = "ps",
    register: bool = True,
) -> ReplicatedShardChannel:
    """The replicated counterpart of ``sharded_ps_channel``:
    ``group_endpoints[i]`` lists shard i's replica endpoints (RF = its
    length; pass one endpoint per group for the unreplicated RF=1
    collapse).  Wires the PsService Forward fan-out contract and
    registers the groups for the ``/replication`` builtin."""
    from incubator_brpc_tpu_torch.client.channel import Channel
    from incubator_brpc_tpu_torch.models.parameter_server import (
        ps_forward_merge,
        ps_forward_prepare_leg,
    )
    from incubator_brpc_tpu_torch.replication.lease import LeaseBoard
    from incubator_brpc_tpu_torch.resharding.migration import PsShardStore

    if board is None:
        board = LeaseBoard(lease_ttl_s)
    groups: List[ReplicaGroup] = []
    for i, members in enumerate(group_endpoints):
        nodes = []
        for ep in members:
            sub = Channel(channel_options)
            rc = sub.init(str(ep))
            if rc != 0:
                raise ValueError(f"cannot init replica channel to {ep}")
            nodes.append(
                ReplicaNode(
                    name=f"{name_prefix}.g{i}.{ep}",
                    store=PsShardStore(sub, timeout_ms=store_timeout_ms),
                    endpoint=str(ep),
                )
            )
        g = ReplicaGroup(
            f"{name_prefix}.g{i}", nodes, board=board, quorum=quorum,
            lease_ttl_s=lease_ttl_s,
        )
        if register:
            register_group(g)
        groups.append(g)
    ch = ReplicatedShardChannel(
        groups, seed=seed, hedge_ms=hedge_ms, read_lb=read_lb,
        timeout_ms=timeout_ms, channel_options=channel_options,
    )
    ch.set_fanout("Forward", ps_forward_prepare_leg, ps_forward_merge)
    return ch


def replicated_cache_group(
    name: str,
    cache_channels: Sequence,
    endpoints: Optional[Sequence[str]] = None,
    board=None,
    quorum: Optional[int] = None,
    lease_ttl_s: float = 0.5,
    register: bool = True,
) -> ReplicaGroup:
    """A replica group over HBM cache members (CacheChannel each) —
    the cache tier's replication adapter.  Repair rides the bulk
    DMGET/DMSET surface automatically (CacheShardStore carries
    read_many/write_many), so catching a replica up moves key ranges
    in collective steps, not key-by-key."""
    from incubator_brpc_tpu_torch.replication.lease import LeaseBoard
    from incubator_brpc_tpu_torch.resharding.migration import CacheShardStore

    if board is None:
        board = LeaseBoard(lease_ttl_s)
    eps = list(endpoints) if endpoints is not None else [""] * len(
        list(cache_channels)
    )
    nodes = [
        ReplicaNode(
            name=f"{name}.{i}",
            store=CacheShardStore(cc),
            endpoint=eps[i] or f"{name}.{i}",
        )
        for i, cc in enumerate(cache_channels)
    ]
    g = ReplicaGroup(
        name, nodes, board=board, quorum=quorum, lease_ttl_s=lease_ttl_s
    )
    if register:
        register_group(g)
    return g
