"""Chaos storms — standing fault-plan shapes for the overload suite.

A *storm* is the composed failure mode production actually sees: some
fraction of links resetting while one replica turns slow, under mixed
multi-tenant load.  This module builds those plans from knobs instead
of hand-rolled spec lists, so the storm SUITE (tests/test_overload_
storm.py), the bench (`bench.py bench_overload_storm`) and operators
(`/chaos` POST of `plan.to_dict()`) all fire the identical seeded,
replayable experiment (docs/overload.md, docs/chaos.md).

Shapes:

* ``storm_plan`` — N% link resets across a peer set (socket.write
  ``reset``) + one slow replica (socket.read ``delay_us`` matched on
  that peer: every response read from it stalls, which is what a
  fabric-degraded or GC-wedged replica looks like from the client).
* ``admission_pressure_plan`` — deterministic admission rejections via
  the ``admission.decide`` site, optionally scoped to one tier: load
  tests of the shed/retry-elsewhere path with zero real saturation.
* ``reshard_storm_plan`` — the kill-mid-migration shape: link resets
  across the shard peers WHILE the live re-sharding coordinator's
  per-key copies drop/stall (``reshard.copy``), optionally stretching
  the cutover publication (``reshard.cutover``).  The acceptance suite
  (tests/test_resharding.py) kills a source shard under this plan and
  proves complete-or-rollback.
* ``replica_storm_plan`` — the leader-kill shape for the replicated
  HA tier: lease grants/renewals dropping (``replica.lease`` — forced
  failovers), one follower's quorum acks degrading (``replica.ack``),
  and optionally one replica's responses stalling on the client's
  read plane (socket.read ``delay_us``).  The acceptance suite
  (tests/test_replication.py) kills a LEADER mid-write-storm under
  this plan and proves zero acked-write loss.
"""

from __future__ import annotations

from typing import Optional, Sequence

from incubator_brpc_tpu_torch.chaos.plan import FaultPlan, FaultSpec


def storm_plan(
    peers: Sequence[object],
    seed: int,
    reset_pct: float = 0.25,
    reset_max_hits: int = 0,
    slow_peer: Optional[object] = None,
    slow_delay_us: int = 50_000,
    slow_pct: float = 1.0,
    slow_max_hits: int = 0,
    name: str = "storm",
) -> FaultPlan:
    """``reset_pct`` of writes toward each peer in ``peers`` reset the
    connection; reads from ``slow_peer`` stall ``slow_delay_us`` each
    (capped by the injector's MAX_DELAY_US = 200ms).  Peers are
    matched as substrings of the remote endpoint ("127.0.0.1:8000",
    "slice0/chip1"...).  Budgets default unlimited — bound a standing
    storm with max_hits or ttl, or disarm explicitly."""
    specs = []
    for peer in peers:
        specs.append(
            FaultSpec(
                "socket.write", "reset",
                probability=reset_pct,
                max_hits=reset_max_hits,
                match={"peer": str(peer)},
            )
        )
    if slow_peer is not None:
        specs.append(
            FaultSpec(
                "socket.read", "delay_us",
                arg=int(slow_delay_us),
                probability=slow_pct,
                max_hits=slow_max_hits,
                match={"peer": str(slow_peer)},
            )
        )
    return FaultPlan(specs, seed=seed, name=name)


def reshard_storm_plan(
    peers: Sequence[object],
    seed: int,
    reset_pct: float = 0.25,
    reset_max_hits: int = 0,
    copy_drop_pct: float = 0.5,
    copy_max_hits: int = 0,
    copy_delay_us: int = 0,
    cutover_delay_us: int = 0,
    name: str = "reshard-storm",
) -> FaultPlan:
    """The standing re-sharding chaos shape: ``reset_pct`` of writes
    toward every shard peer reset the connection (the client sees
    flapping links while the migration streams ranges), and
    ``copy_drop_pct`` of the coordinator's per-key copy attempts drop
    (the key stays pending — the retry/rollback machinery must absorb
    it).  ``copy_delay_us`` > 0 additionally stretches the surviving
    copies, widening the kill-mid-COPY window the acceptance test
    aims its shard kill into; ``cutover_delay_us`` > 0 stretches the
    epoch-bump publication so in-flight fan-outs race it."""
    specs = []
    for peer in peers:
        specs.append(
            FaultSpec(
                "socket.write", "reset",
                probability=reset_pct,
                max_hits=reset_max_hits,
                match={"peer": str(peer)},
            )
        )
    specs.append(
        FaultSpec(
            "reshard.copy", "drop",
            probability=copy_drop_pct,
            max_hits=copy_max_hits,
        )
    )
    if copy_delay_us:
        specs.append(
            FaultSpec(
                "reshard.copy", "delay_us",
                arg=int(copy_delay_us),
                probability=1.0,
            )
        )
    if cutover_delay_us:
        specs.append(
            FaultSpec(
                "reshard.cutover", "delay_us",
                arg=int(cutover_delay_us),
                probability=1.0,
            )
        )
    return FaultPlan(specs, seed=seed, name=name)


def replica_storm_plan(
    seed: int,
    group: Optional[str] = None,
    lease_drop_pct: float = 0.0,
    lease_max_hits: int = 0,
    lease_delay_us: int = 0,
    ack_drop_pct: float = 0.0,
    ack_peer: Optional[str] = None,
    ack_max_hits: int = 0,
    slow_peer: Optional[object] = None,
    slow_delay_us: int = 50_000,
    slow_pct: float = 1.0,
    slow_max_hits: int = 0,
    name: str = "replica-storm",
) -> FaultPlan:
    """The replication tier's standing chaos shape.  ``lease_drop_pct``
    of lease grants/renewals are lost (scoped to ``group`` when given —
    that group keeps failing over while others stay stable);
    ``ack_drop_pct`` of follower acks vanish after the apply (scoped to
    ``ack_peer`` — one follower's quorum contribution degrades while
    its data stays intact); ``slow_peer`` stalls every response read
    from one replica on the CLIENT's read plane (socket.read) — the
    degraded-fabric shape the leader-kill acceptance runs under.  Note
    it stalls the reader's event loop, so it is NOT a hedging target:
    the hedged tail-cut bench slows a replica server-side instead
    (bench_replicated_ps)."""
    specs = []
    if lease_drop_pct > 0:
        specs.append(
            FaultSpec(
                "replica.lease", "drop",
                probability=lease_drop_pct,
                max_hits=lease_max_hits,
                match={"method": group} if group else None,
            )
        )
    if lease_delay_us:
        specs.append(
            FaultSpec(
                "replica.lease", "delay_us",
                arg=int(lease_delay_us),
                probability=1.0,
                match={"method": group} if group else None,
            )
        )
    if ack_drop_pct > 0:
        match = {}
        if group:
            match["method"] = group
        if ack_peer:
            match["peer"] = str(ack_peer)
        specs.append(
            FaultSpec(
                "replica.ack", "drop",
                probability=ack_drop_pct,
                max_hits=ack_max_hits,
                match=match or None,
            )
        )
    if slow_peer is not None:
        specs.append(
            FaultSpec(
                "socket.read", "delay_us",
                arg=int(slow_delay_us),
                probability=slow_pct,
                max_hits=slow_max_hits,
                match={"peer": str(slow_peer)},
            )
        )
    if not specs:
        raise ValueError("replica_storm_plan with every knob at zero")
    return FaultPlan(specs, seed=seed, name=name)


def admission_pressure_plan(
    seed: int,
    reject_pct: float = 0.5,
    tier: Optional[str] = None,
    method: Optional[str] = None,
    max_hits: int = 0,
    name: str = "admission-pressure",
) -> FaultPlan:
    """Force ``reject_pct`` of admission decisions to shed
    (EOVERCROWDED), optionally only for one tier and/or method — the
    deterministic knob behind the shed/retry-elsewhere tests."""
    match = {}
    if tier:
        match["tier"] = tier
    if method:
        match["method"] = method
    return FaultPlan(
        [
            FaultSpec(
                "admission.decide", "reject",
                probability=reject_pct,
                max_hits=max_hits,
                match=match or None,
            )
        ],
        seed=seed,
        name=name,
    )
