"""The port's thrift framed-binary and mongo wire protocols, against the
JAX package's tests of them (``tests/test_thrift_mongo.py``, mirrored
case for case): byte-exact framing checks plus a real client and server
in one process.  Their wire bytes and cross-package interop are held to
the JAX package in ``tests/test_torch_protocol_matrix.py``.
"""

import socket
import struct

import pytest

from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

# ---------------------------------------------------------------- thrift ----
from incubator_brpc_tpu_torch.protocols.thrift import (
    CALL,
    REPLY,
    T_I32,
    T_STRING,
    T_STRUCT,
    ThriftService,
    ThriftStub,
    VERSION_1,
    pack_message,
)


def test_thrift_pack_is_strict_binary_framed():
    wire = pack_message("Echo", CALL, 7, {1: (T_STRING, b"hi")})
    frame_len = struct.unpack(">I", wire[:4])[0]
    assert frame_len == len(wire) - 4
    ver_type = struct.unpack(">I", wire[4:8])[0]
    assert ver_type == (VERSION_1 | CALL)
    name_len = struct.unpack(">i", wire[8:12])[0]
    assert wire[12 : 12 + name_len] == b"Echo"
    seqid = struct.unpack(">i", wire[12 + name_len : 16 + name_len])[0]
    assert seqid == 7
    # struct: field 1 T_STRING "hi", then T_STOP
    rest = wire[16 + name_len :]
    assert rest == b"\x0b\x00\x01\x00\x00\x00\x02hi\x00"


def _thrift_echo_service():
    svc = ThriftService()

    def echo(ctrl, fields, done):
        msg = fields.get(1, (T_STRING, b""))[1]
        done({0: (T_STRUCT, {1: (T_STRING, msg), 2: (T_I32, len(msg))})})

    svc.add_method("Echo", echo)
    return svc


def test_thrift_client_server_e2e():
    srv = Server(ServerOptions(thrift_service=_thrift_echo_service()))
    from incubator_brpc_tpu_torch.models.echo import EchoService

    srv.add_service(EchoService())  # same port also speaks tpu_std
    assert srv.start(0) == 0
    try:
        ch = Channel(ChannelOptions(protocol="thrift", timeout_ms=5000))
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        stub = ThriftStub(ch)
        c = Controller()
        result = stub.call(c, "Echo", {1: (T_STRING, b"thrift-hello")})
        assert not c.failed(), c.error_text()
        _, ret = result[0]
        assert ret[1][1] == b"thrift-hello"
        assert ret[2][1] == len(b"thrift-hello")
        ch.close()
    finally:
        srv.stop()


def test_thrift_unknown_method_is_exception():
    srv = Server(ServerOptions(thrift_service=_thrift_echo_service()))
    from incubator_brpc_tpu_torch.models.echo import EchoService

    srv.add_service(EchoService())
    assert srv.start(0) == 0
    try:
        ch = Channel(ChannelOptions(protocol="thrift", timeout_ms=5000))
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        c = Controller()
        ThriftStub(ch).call(c, "Nope", {})
        assert c.failed()
        assert "unknown method" in c.error_text()
        ch.close()
    finally:
        srv.stop()


# ----------------------------------------------------------------- mongo ----
from incubator_brpc_tpu_torch.protocols.mongo import (
    OP_MSG,
    OP_QUERY,
    OP_REPLY,
    MongoServiceAdaptor,
    bson_decode,
    bson_encode,
    pack_op_msg,
)


def test_bson_roundtrip():
    doc = {
        "str": "hello",
        "i32": 42,
        "i64": 1 << 40,
        "f": 2.5,
        "yes": True,
        "no": False,
        "nil": None,
        "sub": {"a": 1},
        "arr": [1, "two", 3.0],
        "bin": b"\x00\x01\x02",
    }
    decoded, pos = bson_decode(bson_encode(doc))
    assert pos == len(bson_encode(doc))
    assert decoded == doc


class _PingAdaptor(MongoServiceAdaptor):
    def handle(self, controller, doc):
        if "ping" in doc:
            return {"ok": 1.0}
        if "echo" in doc:
            return {"ok": 1.0, "you_sent": doc["echo"]}
        return {"ok": 0.0, "errmsg": "unknown command", "code": 59}


def _mongo_server():
    srv = Server(ServerOptions(mongo_service_adaptor=_PingAdaptor()))
    from incubator_brpc_tpu_torch.models.echo import EchoService

    srv.add_service(EchoService())
    assert srv.start(0) == 0
    return srv


def _mongo_roundtrip(port, wire: bytes) -> bytes:
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    s.sendall(wire)
    s.settimeout(5)
    head = b""
    while len(head) < 16:
        head += s.recv(16 - len(head))
    (length,) = struct.unpack_from("<i", head, 0)
    body = head
    while len(body) < length:
        body += s.recv(length - len(body))
    s.close()
    return body


def test_mongo_op_msg_ping():
    srv = _mongo_server()
    try:
        req = pack_op_msg(0, {"ping": 1, "$db": "admin"}, request_id=99)
        resp = _mongo_roundtrip(srv.port, req)
        length, request_id, response_to, op_code = struct.unpack_from("<iiii", resp, 0)
        assert op_code == OP_MSG
        assert response_to == 99
        doc, _ = bson_decode(resp, 21)  # 16 head + 4 flags + 1 kind
        assert doc["ok"] == 1.0
    finally:
        srv.stop()


def test_mongo_op_msg_echo_command():
    srv = _mongo_server()
    try:
        req = pack_op_msg(0, {"echo": {"x": 7, "s": "v"}}, request_id=5)
        resp = _mongo_roundtrip(srv.port, req)
        doc, _ = bson_decode(resp, 21)
        assert doc["ok"] == 1.0
        assert doc["you_sent"] == {"x": 7, "s": "v"}
    finally:
        srv.stop()


def test_mongo_legacy_op_query():
    srv = _mongo_server()
    try:
        q = bson_encode({"ping": 1})
        body = struct.pack("<i", 0) + b"admin.$cmd\x00" + struct.pack("<ii", 0, 1) + q
        wire = struct.pack("<iiii", 16 + len(body), 3, 0, OP_QUERY) + body
        resp = _mongo_roundtrip(srv.port, wire)
        length, request_id, response_to, op_code = struct.unpack_from("<iiii", resp, 0)
        assert op_code == OP_REPLY
        assert response_to == 3
        # OP_REPLY: flags i32, cursor i64, start i32, nret i32, then doc
        nret = struct.unpack_from("<i", resp, 32)[0]
        assert nret == 1
        doc, _ = bson_decode(resp, 36)
        assert doc["ok"] == 1.0
    finally:
        srv.stop()


def test_mongo_no_adaptor_reports_error():
    srv = Server()
    from incubator_brpc_tpu_torch.models.echo import EchoService

    srv.add_service(EchoService())
    assert srv.start(0) == 0
    try:
        req = pack_op_msg(0, {"ping": 1}, request_id=1)
        resp = _mongo_roundtrip(srv.port, req)
        doc, _ = bson_decode(resp, 21)
        assert doc["ok"] == 0.0
        assert "no mongo service" in doc["errmsg"]
    finally:
        srv.stop()
