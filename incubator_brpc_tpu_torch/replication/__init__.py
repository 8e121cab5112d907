"""Replicated HA tier: per-shard replica groups for the sharded PS and
the HBM cache — leader leases with epoch fencing, quorum writes,
hedged locality reads, and repair through the resharding verified-move
engine (docs/replication.md, ROADMAP item 3).

Layering (all composition, no forked services):

* ``lease``   — epoch-numbered leader leases + the naming-tag grammar
* ``group``   — ReplicaGroup/ReplicaNode: quorum writes, fencing,
  election, repair (= resharding ``verified_write``/``_many``)
* ``channel`` — ReplicatedShardChannel wrapping ShardRoutedChannel so
  existing stubs keep working; ``replicated_ps_channel`` /
  ``replicated_cache_group`` builders
* ``metrics`` — the ``rpc_replica_*`` adders (METRIC_MODULES)
"""

from incubator_brpc_tpu_torch.replication.channel import (  # noqa: F401
    ReplicatedShardChannel,
    replicated_cache_group,
    replicated_ps_channel,
)
from incubator_brpc_tpu_torch.replication.group import (  # noqa: F401
    LeaderLost,
    NoLeader,
    QuorumLost,
    ReplicaGroup,
    ReplicaNode,
    ReplicationError,
    StaleEpoch,
    groups_snapshot,
    register_group,
    unregister_group,
)
from incubator_brpc_tpu_torch.replication.lease import (  # noqa: F401
    Lease,
    LeaseBoard,
    format_lease_tag,
    max_lease_epoch,
    parse_lease_tag,
)
