"""Streaming echo — bidirectional stream service.

Analog of reference example/streaming_echo_c++: the client creates a
stream on the Echo RPC; the server accepts and echoes every received
chunk back on the same stream.
"""

from __future__ import annotations

from incubator_brpc_tpu_torch.client.stream import Stream, StreamHandler, StreamOptions
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest, EchoResponse
from incubator_brpc_tpu_torch.server.service import Service, rpc_method


class _EchoBack(StreamHandler):
    def on_received_messages(self, stream, messages):
        for m in messages:
            stream.write(m)


class StreamingEchoService(Service):
    SERVICE_NAME = "StreamingEchoService"

    @rpc_method(EchoRequest, EchoResponse)
    def StartStream(self, controller, request, response, done):
        if controller._remote_stream_settings is None:
            from incubator_brpc_tpu_torch import errors

            controller.set_failed(errors.EREQUEST, "no stream in request")
            done()
            return
        Stream.accept(controller, _EchoBack())
        response.message = "stream-accepted"
        done()
