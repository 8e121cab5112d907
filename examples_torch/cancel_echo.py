"""RPC cancelation (reference example/cancel_c++): StartCancel aborts
an in-flight async RPC; its done callback still runs exactly once,
with the controller failed as ECANCELED.

    python examples_torch/cancel_echo.py
"""

import os
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server

if __name__ == "__main__":
    srv = Server()
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=30000))
    assert ch.init(f"127.0.0.1:{srv.port}") == 0
    stub = echo_stub(ch)

    fin = threading.Event()
    c = Controller()
    # a request the handler will sit on for 2s — plenty of time to cancel
    stub.Echo(c, EchoRequest(message="slow", sleep_us=2_000_000),
              done=fin.set)
    c.start_cancel()
    assert fin.wait(10), "done callback never ran after cancel"
    assert c.failed(), "canceled RPC must fail"
    assert c.error_code == errors.ECANCELED, c.error_code
    print(f"canceled in-flight RPC -> error_code={c.error_code} "
          f"({c.error_text()}); done ran exactly once")
    ch.close()
    srv.stop()
