"""CacheChannel — the cluster cache's client data plane.

The JAX package's ``cache/channel.py`` routes every key through a
naming service and a consistent-hashing load balancer; the port has no
cluster channels yet (ROADMAP.md queue 1 item 12), so ``CacheChannel``
raises ``NotImplementedError`` naming that item.  A single cache node
is reached with the port's plain redis ``Channel`` over ``ici://``
(or TCP), speaking GET/SET/DMGET/DMSET directly.
"""

from __future__ import annotations

from incubator_brpc_tpu_torch.unported import unported


class CacheChannel:
    """Client of the HBM cache tier over a naming-fed cluster: not
    ported yet (cluster channels, ROADMAP.md queue 1 item 12)."""

    def __init__(self, *args, **kwargs):
        unported("CacheChannel (cluster channels)", 12)
