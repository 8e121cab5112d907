"""Per-shard replica groups: quorum writes under a leader lease,
epoch-fenced, with repair riding the resharding verified-move engine.

One :class:`ReplicaGroup` owns the replicas of ONE shard (PS shard i,
or one cache ring position).  The protocol is deliberately small
(docs/replication.md):

* the leader is whoever holds the group's lease on the
  :class:`~incubator_brpc_tpu_torch.replication.lease.LeaseBoard` — elected
  by ``ensure_leader()`` (most-caught-up live replica wins ties), kept
  by renewal at half-TTL;
* a write fans from the leader to every serving replica carrying the
  lease epoch; each replica FENCES epochs older than the newest lease
  it has seen (``StaleEpoch`` → ESTALEEPOCH on the wire) — a deposed
  leader can never get a write acknowledged;
* the write acks to the caller only after ``quorum`` replicas applied
  it AND the lease is still valid at ack time — an acked write
  therefore lives on a majority and survives any single failure;
* reads may land on ANY serving replica (the channel fans them with
  hedging); a rejoining replica is NOT serving until ``repair()``
  copies it up to date through the resharding
  ``verified_write``/``verified_write_many`` path — migration and
  repair are one engine.

Chaos site ``replica.ack`` (docs/chaos.md) fires on each FOLLOWER
apply: ``drop`` loses the ack AFTER the apply (the write is durable on
that replica but uncounted — quorum degrades, data does not), and
``delay_us`` stretches the ack.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.chaos import injector as _chaos
from incubator_brpc_tpu_torch.replication import metrics as _m
from incubator_brpc_tpu_torch.replication.lease import Lease, LeaseBoard
from incubator_brpc_tpu_torch.resharding.migration import (
    ShardUnavailable,
    verified_write,
    verified_write_many,
)


class ReplicationError(RuntimeError):
    """Base of the replication failures a channel maps onto ERPC
    codes (``.code``)."""

    code = errors.EINTERNAL


class StaleEpoch(ReplicationError):
    """The write's lease epoch is older than the group's newest lease —
    the fencing invariant fired.  The writer must re-elect and reissue
    under the new epoch; NEVER retriable under the same lease."""

    code = errors.ESTALEEPOCH


class QuorumLost(ReplicationError):
    """Fewer than ``quorum`` replicas acknowledged the write — too many
    dead/unreachable members.  Same family as a ParallelChannel with
    too many failed legs."""

    code = errors.ETOOMANYFAILS


class NoLeader(ReplicationError):
    """No candidate could take the lease within the write budget
    (board partitioned / chaos dropping every grant)."""

    code = errors.EINTERNAL


class LeaderLost(ReplicationError):
    """The leader's own store died mid-write — the group must step the
    lease down and re-elect before retrying."""

    code = errors.EINTERNAL


class ReplicaNode:
    """One replica: a shard store (PsShardStore / CacheShardStore /
    anything with read/write/delete/list_keys) plus the replication
    bookkeeping the group fences and repairs with."""

    def __init__(self, name: str, store, endpoint: str = ""):
        self.name = name
        self.store = store
        self.endpoint = endpoint or name
        self.alive = True
        #: a repairing replica applies nothing and serves nothing until
        #: repair() finishes copying it up to date
        self.repairing = False
        #: newest lease epoch this replica has SEEN — writes below
        #: max(floor, board epoch) are fenced even if the board is
        #: unreachable (the replica remembers)
        self.epoch_floor = 0
        #: highest write sequence applied — the election tiebreak
        #: (most-caught-up candidate wins) and the repair target
        self.applied_seq = 0

    def apply(self, group: "ReplicaGroup", epoch: int, seq: int,
              op: str, key: str, value: Optional[bytes],
              is_leader: bool) -> bool:
        """Apply one replicated write; True iff the leader may COUNT
        this replica's ack.  Raises StaleEpoch on a fenced epoch and
        ShardUnavailable when the replica is dead."""
        if not self.alive or self.repairing:
            raise ShardUnavailable(f"replica {self.name} not serving")
        floor = max(group.board.epoch_of(group.name), self.epoch_floor)
        if epoch < floor:
            raise StaleEpoch(
                f"epoch {epoch} < {floor} on {self.name} (fenced)"
            )
        self.epoch_floor = max(self.epoch_floor, epoch)
        acked = True
        if not is_leader and _chaos.armed:
            spec = _chaos.check(
                "replica.ack", peer=self.name, method=group.name
            )
            if spec is not None:
                if spec.action == "delay_us":
                    _chaos.sleep_us(spec.arg)
                elif spec.action == "drop":
                    # the ack is lost AFTER the apply below: the write
                    # is durable here, just uncounted — quorum
                    # degrades, readable data does not
                    acked = False
        if op == "put":
            self.store.write(key, value)
        elif op == "delete":
            self.store.delete(key)
        else:
            raise ValueError(f"unknown replicated op {op!r}")
        self.applied_seq = max(self.applied_seq, seq)
        return acked


# ---------------------------------------------------------------------------
# registry (the /replication builtin reads this)
# ---------------------------------------------------------------------------

_REGISTRY_LOCK = threading.Lock()
_GROUPS: Dict[str, "ReplicaGroup"] = {}


def register_group(group: "ReplicaGroup") -> None:
    with _REGISTRY_LOCK:
        _GROUPS[group.name] = group


def unregister_group(name: str) -> None:
    with _REGISTRY_LOCK:
        _GROUPS.pop(name, None)


def groups_snapshot() -> Dict[str, dict]:
    with _REGISTRY_LOCK:
        groups = list(_GROUPS.values())
    return {g.name: g.describe() for g in groups}


class ReplicaGroup:
    """The replicas of one shard plus the write/election/repair logic.

    ``quorum`` defaults to a majority of the group; RF=1 degenerates to
    quorum 1 with the sole member a permanent leader — the unreplicated
    semantics exactly (the channel additionally bypasses groups
    entirely at RF=1, so this is belt and braces)."""

    COUNTER_KEYS = (
        "leader_changes", "quorum_writes", "quorum_failures",
        "fenced_writes", "repair_keys", "hedged_reads",
    )

    def __init__(self, name: str, nodes: List[ReplicaNode],
                 board: Optional[LeaseBoard] = None,
                 quorum: Optional[int] = None,
                 lease_ttl_s: float = 0.5,
                 write_timeout_s: float = 5.0):
        if not nodes:
            raise ValueError("a replica group needs at least one node")
        self.name = name
        self.nodes = list(nodes)
        self.board = board if board is not None else LeaseBoard(lease_ttl_s)
        self.quorum = int(quorum) if quorum else len(nodes) // 2 + 1
        if not 1 <= self.quorum <= len(nodes):
            raise ValueError(
                f"quorum {self.quorum} out of range for {len(nodes)} nodes"
            )
        self.lease_ttl_s = float(lease_ttl_s)
        self.write_timeout_s = float(write_timeout_s)
        self._lock = threading.Lock()
        self._seq = 0
        self._lease: Optional[Lease] = None
        self._leader: Optional[ReplicaNode] = None
        # last DISTINCT leader name ever elected — leader_changes counts
        # transitions between different names, surviving the step_down
        # gap in between (initial elections from no-leader don't count)
        self._last_leader: Optional[str] = None
        #: bumped whenever the serving set or the leader changes — the
        #: channel compares this int per call to refresh its node lists
        #: cheaply (no allocation on the steady path)
        self.members_version = 0
        self.counters: Dict[str, int] = {k: 0 for k in self.COUNTER_KEYS}

    # -- membership --------------------------------------------------------
    def node(self, name: str) -> ReplicaNode:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def serving_nodes(self) -> List[ReplicaNode]:
        return [n for n in self.nodes if n.alive and not n.repairing]

    def mark_dead(self, name: str) -> None:
        node = self.node(name)
        if node.alive:
            node.alive = False
            with self._lock:
                self.members_version += 1
            # a dead leader steps its lease down so failover does not
            # have to wait out the TTL (the TTL still bounds the case
            # where nobody NOTICES the death)
            if self._leader is node and self._lease is not None:
                self.board.release(
                    self.name, self._lease.holder, self._lease.epoch
                )

    def mark_alive(self, name: str) -> None:
        """A rejoined replica is alive but NOT serving until repair()
        completes — lease-edge rule 3 (docs/replication.md)."""
        node = self.node(name)
        node.alive = True
        node.repairing = True
        with self._lock:
            self.members_version += 1

    # -- leadership --------------------------------------------------------
    def leader(self) -> Optional[ReplicaNode]:
        return self._leader

    def lease(self) -> Optional[Lease]:
        return self._lease

    def epoch(self) -> int:
        return self._lease.epoch if self._lease is not None else 0

    def ensure_leader(self) -> Optional[ReplicaNode]:
        """Renew the current lease (at < half TTL remaining) or elect:
        the most-caught-up serving replica acquires the next epoch.
        None when no lease could be taken (board dark / chaos) — the
        write loop retries until its budget runs out."""
        lease, leader = self._lease, self._leader
        if (
            lease is not None and leader is not None
            and leader.alive and not leader.repairing
            and self.board.validate(self.name, lease.holder, lease.epoch)
        ):
            if lease.remaining() < self.lease_ttl_s / 2.0:
                renewed = self.board.renew(
                    self.name, lease.holder, lease.epoch, self.lease_ttl_s
                )
                if renewed is not None:
                    self._lease = renewed
            return leader
        candidates = sorted(
            self.serving_nodes(), key=lambda n: -n.applied_seq
        )
        for cand in candidates:
            got = self.board.acquire(self.name, cand.name, self.lease_ttl_s)
            if got is None:
                continue
            self._lease, self._leader = got, cand
            with self._lock:
                self.members_version += 1
            if (
                self._last_leader is not None
                and self._last_leader != cand.name
            ):
                self.counters["leader_changes"] += 1
                _m.replica_leader_changes << 1
            self._last_leader = cand.name
            return cand
        return None

    def step_down(self) -> None:
        """Drop the local notion of leadership (and release the lease
        if still held) — the StaleEpoch/LeaderLost recovery edge."""
        lease = self._lease
        if lease is not None:
            self.board.release(self.name, lease.holder, lease.epoch)
        self._lease, self._leader = None, None
        with self._lock:
            self.members_version += 1

    # -- writes ------------------------------------------------------------
    def write_as(self, leader: ReplicaNode, epoch: int, op: str,
                 key: str, value: Optional[bytes] = None) -> int:
        """ONE write attempt as ``leader`` under ``epoch`` — the
        low-level step the lease-edge tests drive directly (an old
        leader calling this after losing its lease must see every
        attempt raise StaleEpoch and ack NOTHING).  Returns the
        sequence number on success."""
        with self._lock:
            self._seq += 1
            seq = self._seq
        acks = 0
        fenced: Optional[StaleEpoch] = None
        for node in self.nodes:
            if not node.alive or node.repairing:
                continue
            try:
                ok = node.apply(
                    self, epoch, seq, op, key, value,
                    is_leader=node is leader,
                )
            except StaleEpoch as e:
                fenced = e
            except ShardUnavailable:
                if node is leader:
                    raise LeaderLost(
                        f"leader {leader.name} died mid-write"
                    ) from None
                # a dead follower just fails to ack; health marking is
                # the caller's business (mark_dead)
            else:
                if ok:
                    acks += 1
        # never ack under a fenced or lapsed lease — even if a quorum
        # applied, the caller must re-elect and reissue so the ack is
        # attributable to a live epoch (the zero-acked-write-loss proof
        # leans on this ordering)
        if fenced is not None or not self.board.validate(
            self.name, leader.name, epoch
        ):
            self.counters["fenced_writes"] += 1
            _m.replica_fenced_writes << 1
            raise fenced if fenced is not None else StaleEpoch(
                f"lease for epoch {epoch} lapsed before ack"
            )
        if acks < self.quorum:
            self.counters["quorum_failures"] += 1
            _m.replica_quorum_failures << 1
            raise QuorumLost(
                f"{acks}/{self.quorum} acks for {op}({key})"
            )
        self.counters["quorum_writes"] += 1
        _m.replica_quorum_writes << 1
        return seq

    def _replicated(self, op: str, key: str,
                    value: Optional[bytes]) -> int:
        import time as _time

        deadline = _time.monotonic() + self.write_timeout_s
        last: ReplicationError = NoLeader(
            f"no leader for {self.name} within write budget"
        )
        while _time.monotonic() < deadline:
            leader = self.ensure_leader()
            if leader is None:
                _time.sleep(min(0.01, self.lease_ttl_s / 10.0))
                continue
            epoch = self.epoch()
            try:
                return self.write_as(leader, epoch, op, key, value)
            except LeaderLost as e:
                last = e
                self.mark_dead(leader.name)
                self.step_down()
            except StaleEpoch as e:
                # our lease moved on under us: drop it and re-elect
                last = e
                self._lease, self._leader = None, None
                with self._lock:
                    self.members_version += 1
            except QuorumLost as e:
                last = e
                _time.sleep(min(0.01, self.lease_ttl_s / 10.0))
        raise last

    def put(self, key: str, value: bytes) -> int:
        """Quorum write; returns the applied sequence.  Raises a
        ReplicationError (→ ERPC code) when the group cannot take the
        write within ``write_timeout_s``."""
        return self._replicated("put", key, bytes(value))

    def delete(self, key: str) -> int:
        return self._replicated("delete", key, None)

    # -- reads -------------------------------------------------------------
    def read_any(self, key: str) -> Optional[bytes]:
        """Read from the first serving replica that answers — the
        in-process fallback path; the channel's hedged fan-out is the
        production read plane."""
        err: Optional[Exception] = None
        for node in self.serving_nodes():
            try:
                return node.store.read(key)
            except ShardUnavailable as e:
                err = e
        if err is not None:
            raise err
        raise ShardUnavailable(f"no serving replica in {self.name}")

    # -- repair ------------------------------------------------------------
    def repair(self, name: str,
               on_copy: Optional[Callable[[str], None]] = None) -> int:
        """Catch replica ``name`` up from the leader through the
        resharding verified-move path (bulk when both stores carry the
        DMGET/DMSET surface and no chaos wants per-key semantics), then
        admit it to the serving set.  Returns keys copied (its
        behind-ness) — counted into ``repair_keys``."""
        node = self.node(name)
        leader = self.ensure_leader()
        if leader is None:
            raise NoLeader(f"cannot repair {name}: no leader")
        if node is leader:
            raise ValueError("cannot repair the leader from itself")
        node.alive = True
        node.repairing = True
        with self._lock:
            self.members_version += 1
        src, dst = leader.store, node.store
        want = set(src.list_keys())
        have = set(dst.list_keys())
        # extraneous keys (deleted while the replica was away) go first
        # so a read after repair can never resurrect a deleted value
        for key in sorted(have - want):
            dst.delete(key)
        missing = sorted(want - have)
        stale: List[str] = []
        copied = 0
        from incubator_brpc_tpu_torch.resharding.migration import range_checksum

        for key in sorted(want & have):
            a, b = src.read(key), dst.read(key)
            if a is None:
                continue
            if b is None or range_checksum(a) != range_checksum(b):
                stale.append(key)
        todo = missing + stale
        bulk_ok = (
            not _chaos.armed
            and on_copy is None
            and callable(getattr(src, "read_many", None))
            and callable(getattr(dst, "write_many", None))
            and callable(getattr(dst, "read_many", None))
        )
        while todo:
            if bulk_ok and len(todo) >= 2:
                values = src.read_many(todo)
                present = [
                    (k, v) for k, v in zip(todo, values) if v is not None
                ]
                ok_keys, failed_keys, _ = (
                    verified_write_many(dst, present) if present
                    else ([], [], {})
                )
                copied += len(ok_keys)
                todo = list(failed_keys)
            else:
                remaining: List[str] = []
                for key in todo:
                    if on_copy is not None:
                        on_copy(key)
                    value = src.read(key)
                    if value is None:
                        continue  # deleted under us — nothing to copy
                    ok, _ = verified_write(dst, key, value)
                    if ok:
                        copied += 1
                    else:
                        remaining.append(key)  # re-copy next round
                todo = remaining
        node.applied_seq = leader.applied_seq
        node.epoch_floor = max(node.epoch_floor, self.epoch())
        node.repairing = False
        with self._lock:
            self.members_version += 1
        self.counters["repair_keys"] += copied
        _m.replica_repair_keys << copied
        return copied

    # -- introspection ------------------------------------------------------
    def describe(self) -> dict:
        lease = self._lease
        return {
            "leader": self._leader.name if self._leader else None,
            "epoch": lease.epoch if lease else 0,
            "lease_remaining_s": (
                round(max(0.0, lease.remaining()), 3) if lease else 0.0
            ),
            "quorum": self.quorum,
            "replicas": [
                {
                    "name": n.name,
                    "endpoint": n.endpoint,
                    "alive": n.alive,
                    "repairing": n.repairing,
                    "applied_seq": n.applied_seq,
                    "epoch_floor": n.epoch_floor,
                }
                for n in self.nodes
            ],
            "counters": dict(self.counters),
        }
