"""Client stack (analog of reference Channel/Controller + policy/)."""

from incubator_brpc_tpu_torch.client.controller import Controller  # noqa: F401
from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions  # noqa: F401
