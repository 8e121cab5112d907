"""Replication-tier metrics (``rpc_replica_*``; registered at import —
METRIC_MODULES lint).  This module is jax-free at import by contract:
the metrics lint imports it anywhere, including hosts with no
accelerator runtime.

The per-group step-log counters live on each :class:`ReplicaGroup`
(``group.counters``) — these process-wide adders mirror them so
``/metrics`` and dashboards see the pod totals.
"""

from __future__ import annotations

from incubator_brpc_tpu_torch.metrics.reducer import Adder

#: a shard group's leader moved to a DIFFERENT node (initial elections
#: from no-leader do not count — the bench's steady-segment guard pins
#: this to 0 under healthy traffic)
replica_leader_changes = Adder(0).expose("rpc_replica_leader_changes")
#: writes acknowledged to the caller after a quorum of replicas
#: confirmed (the acked-write durability proof counts these)
replica_quorum_writes = Adder(0).expose("rpc_replica_quorum_writes")
#: write attempts that could NOT gather a quorum (too many dead /
#: unacked replicas) — surfaced to the caller as ETOOMANYFAILS
replica_quorum_failures = Adder(0).expose("rpc_replica_quorum_failures")
#: write attempts rejected because their lease epoch was stale
#: (ESTALEEPOCH — the fencing invariant firing, docs/replication.md)
replica_fenced_writes = Adder(0).expose("rpc_replica_fenced_writes")
#: keys copied onto a rejoining/fresh replica by the repair engine
#: (the shared resharding verified-move path)
replica_repair_keys = Adder(0).expose("rpc_replica_repair_keys")
#: replicated reads whose first attempt was slow/dead enough that the
#: backup-request machinery hedged to another replica
replica_hedged_reads = Adder(0).expose("rpc_replica_hedged_reads")
