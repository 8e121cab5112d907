"""Server stack (analog of reference src/brpc/server.{h,cpp} + builtin/)."""

from incubator_brpc_tpu_torch.server.service import Service, rpc_method, MethodSpec  # noqa: F401
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions  # noqa: F401
