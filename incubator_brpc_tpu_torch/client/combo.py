"""Combo channels — not ported yet.

The JAX package's ``client/combo.py`` holds the fan-out channels
(``ParallelChannel``, ``PartitionChannel``: ROADMAP.md queue 1 item 5,
with the collectives) and the composed cluster channels
(``SelectiveChannel``, ``ShardRoutedChannel``, ``DynamicShardChannel``,
``ManualClusterChannel``, …: item 12).  Every name looked up here
raises ``NotImplementedError`` naming its item, so a caller that
reaches a combo channel (a replicated PS channel, a PS migration) gets
that, not an ``ImportError``.
"""

from __future__ import annotations

from incubator_brpc_tpu_torch.unported import unported

# the fan-out channels come with the collectives
_ITEM = {"ParallelChannel": 5, "PartitionChannel": 5}


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    unported(f"{name} (client/combo.py)", _ITEM.get(name, 12))
