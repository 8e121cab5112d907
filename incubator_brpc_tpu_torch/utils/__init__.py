"""Base utility layer (analog of brpc's butil, reference src/butil/)."""

from incubator_brpc_tpu_torch.utils.iobuf import IOBuf, IOBufCutter  # noqa: F401
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint  # noqa: F401
from incubator_brpc_tpu_torch.utils.resource_pool import ResourcePool, ObjectPool  # noqa: F401
from incubator_brpc_tpu_torch.utils.containers import (  # noqa: F401
    DoublyBufferedData,
    FlatMap,
    BoundedQueue,
)
