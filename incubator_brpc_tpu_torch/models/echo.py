"""EchoService — the canonical test/benchmark service.

Analog of reference example/echo_c++/server.cpp plus the
behavior-controlled fault-injection service the test suite uses
(test/brpc_channel_unittest.cpp:134-162): the request can ask the
server to fail, close the connection, or sleep before answering.
"""

from __future__ import annotations

import time

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest, EchoResponse
from incubator_brpc_tpu_torch.server.service import Service, ServiceStub, rpc_method


class EchoService(Service):
    """Echoes request.message; honors fault-injection fields."""

    def __init__(self, attach_echo: bool = True):
        self._attach_echo = attach_echo

    def native_fastpaths(self):
        """Echo answers entirely inside the C++ engine when the server
        runs with native_engine=True; the engine falls back to the
        Python handler above whenever a fault-injection field is set."""
        return {"Echo": ("echo", self._attach_echo)}

    def native_http_fastpaths(self):
        """Raw-body HTTP echo served entirely in C on native-engine
        servers (response body = request body — the reference
        http_server example's handler shape).  The pb/JSON semantic
        route at /EchoService/Echo stays on the Python stack."""
        return ["/EchoService/Echo.raw"]

    @rpc_method(EchoRequest, EchoResponse)
    def Echo(self, controller, request, response, done):
        if request.server_fail:
            controller.set_failed(request.server_fail, "injected failure")
            done()
            return
        if request.close_fd:
            controller.close_connection()
            done()
            return
        if request.sleep_us:
            time.sleep(request.sleep_us / 1e6)
        response.message = request.message
        response.code = request.code
        # echo the attachment back (reference echo example does this)
        if self._attach_echo and len(controller.request_attachment):
            controller.response_attachment.append(controller.request_attachment)
        done()


def echo_stub(channel) -> ServiceStub:
    return ServiceStub(channel, EchoService)
