"""The device data plane: ICI fabric transport with device-resident
payloads, mesh management, and the collective lowerings that
fan-out/partition/streaming channels use."""

from incubator_brpc_tpu_torch.parallel.mesh import (  # noqa: F401
    create_mesh,
    default_mesh,
    device_for_chip,
    ici_endpoints,
)
from incubator_brpc_tpu_torch.parallel.ici import (  # noqa: F401
    IciFabric,
    IciPort,
    StagingRing,
    get_fabric,
)
