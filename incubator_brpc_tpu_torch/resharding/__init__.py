"""resharding/ — live N→M scheme migration for sharded stores.

See :mod:`resharding.migration` for the state machine and
docs/resharding.md for the design.  Jax-free at import (the migration
control plane never touches device state directly — values move
through the store adapters' RPC surfaces).
"""

from incubator_brpc_tpu_torch.resharding.migration import (
    COPY,
    CUTOVER,
    DONE,
    DRAIN,
    DUAL_WRITE,
    IDLE,
    PHASES,
    PREPARE,
    ROLLED_BACK,
    CacheShardStore,
    MigrationFailed,
    MigrationView,
    PsShardStore,
    ReshardCoordinator,
    ReshardingState,
    ShardUnavailable,
    format_epoch_tag,
    max_epoch,
    moved_keys,
    parse_epoch_tag,
    range_checksum,
    shard_of,
    states_snapshot,
)

__all__ = [
    "IDLE",
    "PREPARE",
    "DUAL_WRITE",
    "COPY",
    "CUTOVER",
    "DRAIN",
    "DONE",
    "ROLLED_BACK",
    "PHASES",
    "CacheShardStore",
    "MigrationFailed",
    "MigrationView",
    "PsShardStore",
    "ReshardCoordinator",
    "ReshardingState",
    "ShardUnavailable",
    "format_epoch_tag",
    "max_epoch",
    "moved_keys",
    "parse_epoch_tag",
    "range_checksum",
    "shard_of",
    "states_snapshot",
]
