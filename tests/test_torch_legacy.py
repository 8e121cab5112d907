"""The port's legacy pb protocol family (hulu, sofa, nshead, nova,
public, esp, ubrpc, nshead_mcpack), against the JAX package's tests of it
(``tests/test_legacy_protocols.py``, mirrored case for case): byte-level
framing checks and real client/server pairs in one process.  The wire
bytes and the cross-package interop of the family are held to the JAX
package in ``tests/test_torch_protocol_matrix.py``.
"""

import struct

import pytest

from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions


def _echo_server(**opts):
    srv = Server(ServerOptions(**opts) if opts else None)
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    return srv


def _echo_via(protocol, srv, message):
    ch = Channel(ChannelOptions(protocol=protocol, timeout_ms=5000))
    assert ch.init(f"127.0.0.1:{srv.port}") == 0
    stub = echo_stub(ch)
    c = Controller()
    r = stub.Echo(c, EchoRequest(message=message))
    ch.close()
    return c, r


def test_hulu_e2e():
    srv = _echo_server()
    try:
        c, r = _echo_via("hulu_pbrpc", srv, "hulu-hello")
        assert not c.failed(), c.error_text()
        assert r.message == "hulu-hello"
    finally:
        srv.stop()


def test_hulu_frame_layout():
    from incubator_brpc_tpu_torch.protocols.legacy import _hulu_frame

    wire = _hulu_frame(b"METAX", b"PAYLOAD").to_bytes()
    assert wire[:4] == b"HULU"
    body_size, meta_size = struct.unpack_from("<II", wire, 4)
    assert meta_size == 5 and body_size == 5 + 7
    assert wire[12:17] == b"METAX" and wire[17:] == b"PAYLOAD"


def test_sofa_e2e():
    srv = _echo_server()
    try:
        c, r = _echo_via("sofa_pbrpc", srv, "sofa-hello")
        assert not c.failed(), c.error_text()
        assert r.message == "sofa-hello"
    finally:
        srv.stop()


def test_sofa_frame_layout():
    from incubator_brpc_tpu_torch.protos import legacy_meta_pb2 as pb
    from incubator_brpc_tpu_torch.protocols.legacy import _sofa_frame

    meta = pb.SofaRpcMeta()
    meta.type = pb.SofaRpcMeta.REQUEST
    meta.sequence_id = 3
    wire = _sofa_frame(meta, b"BODY").to_bytes()
    assert wire[:4] == b"SOFA"
    meta_size, body_size, message_size = struct.unpack_from("<IQQ", wire, 4)
    assert body_size == 4
    assert message_size == meta_size + body_size
    assert wire[-4:] == b"BODY"


def test_sofa_unknown_method_fails():
    srv = _echo_server()
    try:
        ch = Channel(ChannelOptions(protocol="sofa_pbrpc", timeout_ms=5000))
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        from incubator_brpc_tpu_torch.server.service import MethodSpec
        from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoResponse

        spec = MethodSpec("NoSvc", "NoMethod", EchoRequest, EchoResponse)
        c = Controller()
        ch.call_method(spec, c, EchoRequest(message="x"), EchoResponse())
        assert c.failed()
        ch.close()
    finally:
        srv.stop()


def test_nshead_raw_service():
    from incubator_brpc_tpu_torch.protocols.legacy import NsheadMessage, NsheadService

    class Upper(NsheadService):
        def process(self, controller, request):
            reply = NsheadMessage(id=request.id, log_id=request.log_id)
            reply.body.append(request.body.to_bytes().upper())
            return reply

    srv = Server(ServerOptions(nshead_service=Upper()))
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    try:
        import socket as pysock

        s = pysock.create_connection(("127.0.0.1", srv.port), timeout=5)
        req = NsheadMessage(id=7, log_id=42)
        req.body.append(b"hello-nshead")
        s.sendall(req.pack().to_bytes())
        s.settimeout(5)
        data = b""
        while len(data) < 36 + len(b"hello-nshead"):
            data += s.recv(4096)
        s.close()
        mid, ver, log_id, provider, magic, reserved, blen = struct.unpack(
            "<HHI16sIII", data[:36]
        )
        assert magic == 0xFB709394
        assert mid == 7 and log_id == 42
        assert data[36 : 36 + blen] == b"HELLO-NSHEAD"
    finally:
        srv.stop()


def test_nova_e2e():
    srv = _echo_server(nova_service=EchoService())
    try:
        c, r = _echo_via("nova_pbrpc", srv, "nova-hello")
        assert not c.failed(), c.error_text()
        assert r.message == "nova-hello"
    finally:
        srv.stop()


def test_public_pbrpc_e2e():
    srv = _echo_server()
    try:
        c, r = _echo_via("public_pbrpc", srv, "public-hello")
        assert not c.failed(), c.error_text()
        assert r.message == "public-hello"
    finally:
        srv.stop()


def test_esp_e2e():
    """esp client against an in-process esp-speaking socket server."""
    import socket as pysock
    import threading

    from incubator_brpc_tpu_torch.protocols.legacy import ESP_HEAD_SIZE, EspMessage
    from incubator_brpc_tpu_torch.server.service import MethodSpec

    ls = pysock.socket()
    ls.bind(("127.0.0.1", 0))
    ls.listen(1)
    port = ls.getsockname()[1]

    def server():
        conn, _ = ls.accept()
        head = b""
        while len(head) < ESP_HEAD_SIZE:
            head += conn.recv(ESP_HEAD_SIZE - len(head))
        frm, to, msg, msg_id, blen = struct.unpack("<QQIQi", head)
        body = b""
        while len(body) < blen:
            body += conn.recv(blen - len(body))
        reply = body[::-1]
        conn.sendall(struct.pack("<QQIQi", to, frm, msg, msg_id, len(reply)) + reply)
        conn.close()
        ls.close()

    t = threading.Thread(target=server, daemon=True)
    t.start()
    ch = Channel(ChannelOptions(protocol="esp", timeout_ms=5000))
    assert ch.init(f"127.0.0.1:{port}") == 0
    spec = MethodSpec("esp", "msg", EspMessage, bytes)
    c = Controller()
    req = EspMessage(to=9, msg=1, body=b"esp-payload")
    ch.call_method(spec, c, req, None)
    assert not c.failed(), c.error_text()
    assert c.response_attachment.to_bytes() == b"esp-payload"[::-1]
    ch.close()
    t.join(2)


def test_ubrpc_e2e():
    """ubrpc: mcpack content envelope over nshead (reference
    policy/ubrpc2pb_protocol.cpp), via the UbrpcAdaptor nshead service."""
    from incubator_brpc_tpu_torch.protocols.legacy import UbrpcAdaptor

    srv = Server(ServerOptions(nshead_service=UbrpcAdaptor()))
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    try:
        c, r = _echo_via("ubrpc", srv, "ubrpc-hello")
        assert not c.failed(), c.error_text()
        assert r.message == "ubrpc-hello"
        # unknown method surfaces the mcpack error envelope
        from incubator_brpc_tpu_torch.server.service import MethodSpec
        from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoResponse

        ch = Channel(ChannelOptions(protocol="ubrpc", timeout_ms=5000))
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        c2 = Controller()
        ch.call_method(
            MethodSpec("EchoService", "Nope", EchoRequest, EchoResponse),
            c2, EchoRequest(message="x"), EchoResponse(),
        )
        assert c2.failed()
        ch.close()
    finally:
        srv.stop()


def test_nshead_mcpack_e2e():
    """nshead_mcpack: body IS the mcpack message; routes to the first
    service's first method (reference NsheadMcpackAdaptor)."""
    from incubator_brpc_tpu_torch.protocols.legacy import NsheadMcpackAdaptor

    srv = Server(ServerOptions(nshead_service=NsheadMcpackAdaptor()))
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    try:
        c, r = _echo_via("nshead_mcpack", srv, "mcpack-hello")
        assert not c.failed(), c.error_text()
        assert r.message == "mcpack-hello"
    finally:
        srv.stop()
