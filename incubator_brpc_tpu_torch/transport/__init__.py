"""Core transport (analog of reference src/brpc/ core files): Socket,
EventDispatcher, InputMessenger, Acceptor, SocketMap (SURVEY.md §2.4)."""

from incubator_brpc_tpu_torch.transport.socket import Socket, SocketOptions  # noqa: F401
from incubator_brpc_tpu_torch.transport.event_dispatcher import get_dispatcher  # noqa: F401
from incubator_brpc_tpu_torch.transport.input_messenger import InputMessenger  # noqa: F401
from incubator_brpc_tpu_torch.transport.socket_map import SocketMap, get_socket_map  # noqa: F401
