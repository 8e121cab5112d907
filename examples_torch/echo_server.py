"""Echo server (reference example/echo_c++/server.cpp analog).

    python examples_torch/echo_server.py [port]

The C++ engine serves tpu_std on the main port; the builtin
observability pages ride the TCP internal port (port+1) — browse
http://localhost:<port+1>/."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from incubator_brpc_tpu_torch.models.echo import EchoService
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

if __name__ == "__main__":
    port = int(sys.argv[1]) if len(sys.argv) > 1 else 8000
    srv = Server(ServerOptions(native_engine=True, internal_port=port + 1))
    srv.add_service(EchoService())
    assert srv.start(port) == 0, "start failed"
    print(f"echo server on :{srv.port} "
          f"(builtin pages: http://localhost:{srv.internal_port}/)")
    try:
        import time

        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()
