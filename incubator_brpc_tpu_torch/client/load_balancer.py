"""Load balancers — lock-free-read server selection.

Analog of reference LoadBalancer (load_balancer.h:40-105) and the
policy/ implementations (global.cpp:141-149). Every implementation
keeps its server set in a DoublyBufferedData snapshot so the hot
``select_server`` path is a read with no lock — the structural property
the reference gets from butil::DoublyBufferedData
(doubly_buffered_data.h:37-51).

Implemented: rr, wrr, random, wr (weighted random), c_murmurhash
(consistent hashing with a murmur3 ketama-style ring,
consistent_hashing_load_balancer.cpp), la (locality-aware:
latency×inflight weighted, locality_aware_load_balancer.{h,cpp},
doc docs/cn/lalb.md).
"""

from __future__ import annotations

import bisect
import itertools
import threading
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

from incubator_brpc_tpu_torch.client.naming_service import ServerNode
from incubator_brpc_tpu_torch.utils.containers import DoublyBufferedData
from incubator_brpc_tpu_torch.utils.hashes import fast_rand_less_than, murmur3_32


@dataclass
class SelectIn:
    """Analog of LoadBalancer::SelectIn (load_balancer.h)."""

    excluded: frozenset = frozenset()  # nodes already tried this RPC
    request_code: int = 0  # hash key for consistent hashing


class LoadBalancer:
    name = ""

    def add_server(self, node: ServerNode) -> bool:
        raise NotImplementedError

    def remove_server(self, node: ServerNode) -> bool:
        raise NotImplementedError

    def reset_servers(self, nodes: List[ServerNode]):
        snapshot = self.servers()
        for node in snapshot:
            if node not in nodes:
                self.remove_server(node)
        for node in nodes:
            if node not in snapshot:
                self.add_server(node)

    def select_server(self, sin: SelectIn) -> Optional[ServerNode]:
        raise NotImplementedError

    def feedback(self, node: ServerNode, latency_us: int, failed: bool):
        pass

    def servers(self) -> List[ServerNode]:
        raise NotImplementedError


class _SnapshotLB(LoadBalancer):
    """Common base: node list in a DoublyBufferedData."""

    def __init__(self):
        self._data: DoublyBufferedData = DoublyBufferedData(tuple())

    def add_server(self, node: ServerNode) -> bool:
        added = []

        def mod(cur):
            if node in cur:
                return cur
            added.append(True)
            return cur + (node,)

        self._data.modify(mod)
        return bool(added)

    def remove_server(self, node: ServerNode) -> bool:
        removed = []

        def mod(cur):
            if node not in cur:
                return cur
            removed.append(True)
            return tuple(x for x in cur if x != node)

        self._data.modify(mod)
        return bool(removed)

    def servers(self) -> List[ServerNode]:
        return list(self._data.read())

    def _candidates(self, sin: SelectIn) -> Tuple[ServerNode, ...]:
        snap = self._data.read()
        if not sin.excluded:
            return snap
        filtered = tuple(n for n in snap if n not in sin.excluded)
        return filtered or snap  # all excluded: better any than none


class RoundRobinLB(_SnapshotLB):
    name = "rr"

    def __init__(self):
        super().__init__()
        self._counter = itertools.count()

    def select_server(self, sin: SelectIn) -> Optional[ServerNode]:
        cands = self._candidates(sin)
        if not cands:
            return None
        return cands[next(self._counter) % len(cands)]


class WeightedRoundRobinLB(_SnapshotLB):
    name = "wrr"

    def __init__(self):
        super().__init__()
        self._counter = itertools.count()
        # weight-expanded snapshot, rebuilt only on membership change so
        # the select hot path is a single index (DoublyBufferedData read)
        self._expanded: DoublyBufferedData = DoublyBufferedData(tuple())

    def _rebuild_expanded(self):
        nodes = self._data.read()
        expanded: List[ServerNode] = []
        for n in nodes:
            expanded.extend([n] * max(1, n.weight))
        self._expanded.modify(lambda _: tuple(expanded))

    def add_server(self, node: ServerNode) -> bool:
        added = super().add_server(node)
        if added:
            self._rebuild_expanded()
        return added

    def remove_server(self, node: ServerNode) -> bool:
        removed = super().remove_server(node)
        if removed:
            self._rebuild_expanded()
        return removed

    def select_server(self, sin: SelectIn) -> Optional[ServerNode]:
        expanded = self._expanded.read()
        if not expanded:
            return None
        if not sin.excluded:
            return expanded[next(self._counter) % len(expanded)]
        for _ in range(len(expanded)):
            node = expanded[next(self._counter) % len(expanded)]
            if node not in sin.excluded:
                return node
        return expanded[next(self._counter) % len(expanded)]


class RandomLB(_SnapshotLB):
    name = "random"

    def select_server(self, sin: SelectIn) -> Optional[ServerNode]:
        cands = self._candidates(sin)
        if not cands:
            return None
        return cands[fast_rand_less_than(len(cands))]


class WeightedRandomLB(_SnapshotLB):
    name = "wr"

    def select_server(self, sin: SelectIn) -> Optional[ServerNode]:
        cands = self._candidates(sin)
        if not cands:
            return None
        total = sum(max(1, n.weight) for n in cands)
        r = fast_rand_less_than(total)
        acc = 0
        for n in cands:
            acc += max(1, n.weight)
            if r < acc:
                return n
        return cands[-1]


class ConsistentHashingLB(LoadBalancer):
    """Ketama-style ring with murmur3 virtual nodes
    (consistent_hashing_load_balancer.cpp; 100 replicas/node there)."""

    name = "c_murmurhash"
    REPLICAS = 100

    def __init__(self):
        self._ring: DoublyBufferedData = DoublyBufferedData(((), ()))  # (hashes, nodes)
        self._members: Dict[ServerNode, bool] = {}
        self._lock = threading.Lock()

    def _rebuild(self):
        points: List[Tuple[int, ServerNode]] = []
        for node in self._members:
            base = str(node.endpoint).encode()
            for r in range(self.REPLICAS * max(1, node.weight)):
                points.append((murmur3_32(base + b"-%d" % r), node))
        # endpoint tie-break: two nodes hashing a virtual point to the
        # same value would otherwise order by membership-insertion order
        # — clients that learned the cluster in different orders (or a
        # restarted client) would disagree on key ownership exactly at
        # collisions.  With the tie-break the ring is a pure function of
        # the member set (golden-pinned in tests).
        points.sort(key=lambda p: (p[0], str(p[1].endpoint)))
        hashes = tuple(p[0] for p in points)
        nodes = tuple(p[1] for p in points)
        self._ring.modify(lambda _: (hashes, nodes))

    def add_server(self, node: ServerNode) -> bool:
        with self._lock:
            if node in self._members:
                return False
            self._members[node] = True
            self._rebuild()
            return True

    def remove_server(self, node: ServerNode) -> bool:
        with self._lock:
            if node not in self._members:
                return False
            del self._members[node]
            self._rebuild()
            return True

    def servers(self) -> List[ServerNode]:
        return list(self._members)

    def select_server(self, sin: SelectIn) -> Optional[ServerNode]:
        hashes, nodes = self._ring.read()
        if not hashes:
            return None
        h = (
            sin.request_code & 0xFFFFFFFF
            if sin.request_code
            else murmur3_32(b"%d" % fast_rand_less_than(1 << 30))
        )
        idx = bisect.bisect_left(hashes, h) % len(hashes)
        # walk the ring past excluded nodes
        for step in range(len(hashes)):
            node = nodes[(idx + step) % len(hashes)]
            if node not in sin.excluded:
                return node
        return nodes[idx]


class MeshLocalityLB(ConsistentHashingLB):
    """Consistent hashing made mesh-topology-aware (the cache tier's
    router, docs/cache.md): key ownership comes from the same
    deterministic murmur3 ketama ring as ``c_murmurhash``, but the ring
    walk is re-ranked by ICI locality and shed pressure —

      0. same-ICI-neighborhood replicas (endpoint slice ==
         ``local_coords`` slice) that are not shedding,
      1. remote (DCN) replicas not shedding,
      2. anything shedding, locals first.

    Within a class, candidates keep deterministic ring order, so two
    healthy clusters route a key identically to plain consistent
    hashing restricted to the local slice.  Spill to DCN happens only
    when every local replica is excluded (breaker-isolated/dead) or
    shedding — the tier's locality contract, regression-tested at
    >=90% local under healthy load.

    Shed signals arrive via ``on_shed`` (LoadBalancerWithNaming feeds
    EOVERCROWDED completions — the admission tier's retry-elsewhere
    code); each successful feedback decays the pressure so a revived
    replica re-earns local preference without wall-clock coupling."""

    name = "mesh_locality"
    SHED_TRIP = 2  # consecutive-ish sheds before we route around
    SHED_MAX = 8
    PROBE_EVERY = 4  # every Nth spilled pick probes the shedding local

    def __init__(self):
        super().__init__()
        self.local_coords: Optional[Tuple[int, int]] = None
        self._shed: Dict[ServerNode, int] = {}
        self._shed_lock = threading.Lock()
        self.picks_local = 0
        self.picks_remote = 0
        self._probe_tick = 0

    def set_local_coords(self, coords) -> None:
        """The client's own mesh coordinates (slice, chip) — typically
        ``TpuTopologyNamingService`` fabric/mesh coordinates."""
        self.local_coords = tuple(coords) if coords is not None else None

    def _is_local(self, node: ServerNode) -> bool:
        if self.local_coords is None:
            return False
        ep = node.endpoint
        if not ep.is_ici():
            return False
        return ep.coords[0] == self.local_coords[0]

    def on_shed(self, node: ServerNode) -> None:
        with self._shed_lock:
            self._shed[node] = min(self.SHED_MAX, self._shed.get(node, 0) + 1)

    def shedding(self, node: ServerNode) -> bool:
        return self._shed.get(node, 0) >= self.SHED_TRIP

    def feedback(self, node: ServerNode, latency_us: int, failed: bool):
        if not failed:
            with self._shed_lock:
                s = self._shed.get(node, 0)
                if s:
                    self._shed[node] = s - 1

    def select_server(self, sin: SelectIn) -> Optional[ServerNode]:
        hashes, nodes = self._ring.read()
        if not hashes:
            return None
        h = (
            sin.request_code & 0xFFFFFFFF
            if sin.request_code
            else murmur3_32(b"%d" % fast_rand_less_than(1 << 30))
        )
        idx = bisect.bisect_left(hashes, h) % len(hashes)
        best = None
        best_rank = None
        local_shed = None  # first shedding local seen, in ring order
        seen = set()
        for step in range(len(hashes)):
            node = nodes[(idx + step) % len(hashes)]
            if node in seen:
                continue
            seen.add(node)
            if node in sin.excluded:
                continue
            local = self._is_local(node)
            shed = self.shedding(node)
            if local and shed and local_shed is None:
                local_shed = node
            rank = (2 + (not local)) if shed else (0 if local else 1)
            if rank == 0:
                best = node
                break
            if best_rank is None or rank < best_rank:
                best, best_rank = node, rank
        if best is None:
            return nodes[idx]  # all excluded: better the owner than none
        if best_rank is not None and local_shed is not None:
            # circuit-breaker revival probe: a spill pick occasionally
            # re-tries the shedding local replica so its successes can
            # decay the pressure (feedback) — without this the replica
            # never gets picked again and the spill becomes permanent
            self._probe_tick += 1
            if self._probe_tick % self.PROBE_EVERY == 0:
                best = local_shed
        if self._is_local(best):
            self.picks_local += 1
        else:
            self.picks_remote += 1
        return best

    def locality_fraction(self) -> float:
        total = self.picks_local + self.picks_remote
        return self.picks_local / total if total else 0.0


class LocalityAwareLB(_SnapshotLB):
    """Latency/inflight-weighted selection (lalb): weight_i ∝
    1 / (ema_latency_i × (inflight_i + 1)); fresh nodes get the mean
    weight so they are probed (doc docs/cn/lalb.md)."""

    name = "la"

    def __init__(self):
        super().__init__()
        self._stats: Dict[ServerNode, List[float]] = {}  # [ema_lat_us, inflight]
        self._stats_lock = threading.Lock()
        self._alpha = 0.3

    def select_server(self, sin: SelectIn) -> Optional[ServerNode]:
        cands = self._candidates(sin)
        if not cands:
            return None
        with self._stats_lock:
            weights = []
            for n in cands:
                st = self._stats.get(n)
                if st is None or st[0] <= 0:
                    weights.append(-1.0)  # unknown: assign mean later
                else:
                    weights.append(1.0 / (st[0] * (st[1] + 1.0)))
            known = [w for w in weights if w > 0]
            mean = sum(known) / len(known) if known else 1.0
            weights = [w if w > 0 else mean for w in weights]
            total = sum(weights)
            r = (fast_rand_less_than(1 << 30) / float(1 << 30)) * total
            acc = 0.0
            chosen = cands[-1]
            for n, w in zip(cands, weights):
                acc += w
                if r < acc:
                    chosen = n
                    break
            return chosen

    def on_dispatch(self, node: ServerNode):
        """Called once the node is definitively chosen (socket acquired);
        select_server itself must not count inflight — rejected
        candidates would leak the count and deflate their weight."""
        with self._stats_lock:
            st = self._stats.setdefault(node, [0.0, 0.0])
            st[1] += 1.0

    def on_undispatch(self, node: ServerNode):
        """Release an inflight count for a dispatch whose attempt was
        superseded (retry/backup) — feedback() only decrements once."""
        with self._stats_lock:
            st = self._stats.get(node)
            if st is not None:
                st[1] = max(0.0, st[1] - 1.0)

    def feedback(self, node: ServerNode, latency_us: int, failed: bool):
        with self._stats_lock:
            st = self._stats.setdefault(node, [0.0, 0.0])
            st[1] = max(0.0, st[1] - 1.0)
            lat = float(latency_us if not failed else max(latency_us, 100_000) * 10)
            st[0] = lat if st[0] <= 0 else st[0] * (1 - self._alpha) + lat * self._alpha


class DynPartLB(_SnapshotLB):
    """Weighted selection where each candidate's weight is supplied
    LIVE by a callable — the DynamicPartitionChannel registers one
    entry per partition SCHEME and weights it by the scheme's current
    server count, so capacity migrating between schemes shifts traffic
    proportionally (reference DynPartLoadBalancer::SelectServer,
    policy/dynpart_load_balancer.cpp:109-162, weighting sub-channels by
    schan::GetSubChannelWeight).

    Works as a plain LB too: nodes without a weight callable count as
    weight = max(1, node.weight)."""

    name = "dynpart"

    @staticmethod
    def _weight_of(node) -> int:
        fn = getattr(node, "dynpart_weight", None)
        if callable(fn):
            try:
                return max(0, int(fn()))
            except Exception:  # noqa: BLE001 — a raising probe = empty
                return 0
        return max(1, int(getattr(node, "weight", 1) or 1))

    def select_server(self, sin: SelectIn) -> Optional[ServerNode]:
        nodes = self._data.read()
        cands = [n for n in nodes if n not in sin.excluded] or list(nodes)
        weighted = [(n, self._weight_of(n)) for n in cands]
        total = sum(w for _, w in weighted)
        if total <= 0:
            return None
        r = fast_rand_less_than(total)
        acc = 0
        for n, w in weighted:
            acc += w
            if r < acc:
                return n
        return None


class StableShardLB(_SnapshotLB):
    """Deterministic keyed shard routing for a flat cluster used as a
    sharded KV (docs/sharded_ps.md): ``request_code % n`` over the
    ENDPOINT-SORTED member list.  Sorting (not insertion order) is
    what makes the key→server mapping reproducible across restarts and
    across clients that learned the membership in different orders —
    the property the ShardRoutedChannel gets from NS tag indices, for
    channels that have only a node list.  Excluded (already-failed)
    owners fail over to the next server in sorted order, still
    deterministically.

    Shed pressure (EOVERCROWDED completions fed through ``on_shed`` by
    LoadBalancerWithNaming, same contract as ``mesh_locality``) demotes
    an overloaded owner: its keys fail over to the next server in
    sorted order until successes decay the pressure, with every Nth
    demoted pick probing the owner so it re-earns ownership.  Without
    this the retry-elsewhere code looped straight back to the same
    shedding replica — ``% n`` is memoryless."""

    name = "shard"
    SHED_TRIP = 2  # consecutive-ish sheds before keys route around
    SHED_MAX = 8
    PROBE_EVERY = 4  # every Nth demoted pick probes the shedding owner

    def __init__(self):
        super().__init__()
        # endpoint-sorted snapshot, rebuilt on membership change so the
        # select hot path is one index (same shape as WRR's expansion)
        self._sorted: DoublyBufferedData = DoublyBufferedData(tuple())
        self._shed: Dict[ServerNode, int] = {}
        self._shed_lock = threading.Lock()
        self._probe_tick = 0

    def _rebuild_sorted(self):
        nodes = self._data.read()
        ordered = tuple(sorted(nodes, key=lambda n: str(n.endpoint)))
        self._sorted.modify(lambda _: ordered)

    def add_server(self, node: ServerNode) -> bool:
        added = super().add_server(node)
        if added:
            self._rebuild_sorted()
        return added

    def remove_server(self, node: ServerNode) -> bool:
        removed = super().remove_server(node)
        if removed:
            self._rebuild_sorted()
        return removed

    def on_shed(self, node: ServerNode) -> None:
        with self._shed_lock:
            self._shed[node] = min(self.SHED_MAX, self._shed.get(node, 0) + 1)

    def shedding(self, node: ServerNode) -> bool:
        return self._shed.get(node, 0) >= self.SHED_TRIP

    def feedback(self, node: ServerNode, latency_us: int, failed: bool):
        if not failed:
            with self._shed_lock:
                s = self._shed.get(node, 0)
                if s:
                    self._shed[node] = s - 1

    def select_server(self, sin: SelectIn) -> Optional[ServerNode]:
        ordered = self._sorted.read()
        if not ordered:
            return None
        idx = (sin.request_code or 0) % len(ordered)
        shed_owner = None  # first shedding candidate, in walk order
        fallback = None  # first non-excluded shedding candidate
        for step in range(len(ordered)):
            node = ordered[(idx + step) % len(ordered)]
            if node in sin.excluded:
                continue
            if self.shedding(node):
                if shed_owner is None:
                    shed_owner = node
                if fallback is None:
                    fallback = node
                continue
            if shed_owner is not None:
                # demoted pick: occasionally probe the shedding owner so
                # its successes can decay the pressure (feedback) — the
                # same revival contract as mesh_locality
                self._probe_tick += 1
                if self._probe_tick % self.PROBE_EVERY == 0:
                    return shed_owner
            return node
        if fallback is not None:
            return fallback  # everyone shedding: better overloaded than none
        return ordered[idx]  # all excluded: better the owner than none


_lb_registry: Dict[str, type] = {}


def register_load_balancer(cls):
    _lb_registry[cls.name] = cls
    return cls


for _cls in (
    RoundRobinLB,
    WeightedRoundRobinLB,
    RandomLB,
    WeightedRandomLB,
    ConsistentHashingLB,
    MeshLocalityLB,
    LocalityAwareLB,
    DynPartLB,
    StableShardLB,
):
    register_load_balancer(_cls)


def create_load_balancer(name: str) -> Optional[LoadBalancer]:
    cls = _lb_registry.get(name)
    return cls() if cls else None
