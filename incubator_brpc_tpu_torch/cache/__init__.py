"""HBM-resident cache tier (port of the JAX package's ``cache/``).

Values live in device memory as exact-length tensors; GETs on ICI
peers ship them as IOBuf DeviceRef segments with zero device->host
pulls, host clients get bytes through the manifested
``cache.host-spill`` scope only.  The redis and memcache protocols
front the same store.  ``CacheChannel`` routes keys over a naming-fed
cluster of nodes by consistent hashing (``mesh_locality`` by default);
a single node is also reached with a plain redis ``Channel``.
"""

from incubator_brpc_tpu_torch.cache.channel import CacheChannel
from incubator_brpc_tpu_torch.cache.service import (
    HBMCacheMemcacheService,
    HBMCacheService,
)
from incubator_brpc_tpu_torch.cache.store import HBMCacheStore

__all__ = [
    "CacheChannel",
    "HBMCacheMemcacheService",
    "HBMCacheService",
    "HBMCacheStore",
]
