"""The device data plane: ICI endpoints over torch devices."""

from incubator_brpc_tpu_torch.parallel.mesh import device_for_chip  # noqa: F401
from incubator_brpc_tpu_torch.parallel.ici import (  # noqa: F401
    IciFabric,
    IciPort,
    StagingRing,
    get_fabric,
)
