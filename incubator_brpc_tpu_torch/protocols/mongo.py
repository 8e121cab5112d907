"""Mongo wire protocol — server side.

Analog of reference policy/mongo_protocol.cpp + mongo_head.h +
mongo_service_adaptor.h: the server answers MongoDB wire-protocol
clients. Standard header (16 bytes LE: messageLength, requestID,
responseTo, opCode); supported ops: OP_MSG (2013, modern — kind-0 body
section) answered with OP_MSG, and legacy OP_QUERY (2004) answered with
OP_REPLY (1). Documents are (de)serialized by the minimal BSON codec
below (dict ↔ bytes; the subset of types drivers use for commands).

User surface mirrors the reference's MongoServiceAdaptor: subclass
MongoServiceAdaptor, implement ``handle(controller, doc) -> doc``.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.protocols import ParseResult, Protocol, register_protocol
from incubator_brpc_tpu_torch.utils.iobuf import IOBuf
from incubator_brpc_tpu_torch.utils.logging import log_error

OP_REPLY = 1
OP_QUERY = 2004
OP_GET_MORE = 2005
OP_MSG = 2013

_KNOWN_OPS = {OP_REPLY, OP_QUERY, OP_GET_MORE, OP_MSG, 2001, 2002, 2006, 2007, 2010, 2011}
_MAX_MESSAGE = 48 << 20  # mongo's own wire limit


# ---------------------------------------------------------------------------
# minimal BSON
# ---------------------------------------------------------------------------
def bson_encode(doc: Dict) -> bytes:
    body = b"".join(_bson_element(k, v) for k, v in doc.items())
    return struct.pack("<i", len(body) + 5) + body + b"\x00"


def _bson_element(key: str, v) -> bytes:
    name = key.encode() + b"\x00"
    if isinstance(v, bool):  # before int: bool is an int subclass
        return b"\x08" + name + (b"\x01" if v else b"\x00")
    if isinstance(v, float):
        return b"\x01" + name + struct.pack("<d", v)
    if isinstance(v, int):
        if -(2**31) <= v < 2**31:
            return b"\x10" + name + struct.pack("<i", v)
        return b"\x12" + name + struct.pack("<q", v)
    if isinstance(v, str):
        raw = v.encode()
        return b"\x02" + name + struct.pack("<i", len(raw) + 1) + raw + b"\x00"
    if isinstance(v, bytes):
        return b"\x05" + name + struct.pack("<i", len(v)) + b"\x00" + v
    if v is None:
        return b"\x0a" + name
    if isinstance(v, dict):
        return b"\x03" + name + bson_encode(v)
    if isinstance(v, (list, tuple)):
        arr = {str(i): item for i, item in enumerate(v)}
        return b"\x04" + name + bson_encode(arr)
    raise TypeError(f"bson: unsupported type {type(v)}")


def bson_decode(data: bytes, pos: int = 0) -> Tuple[Dict, int]:
    """→ (doc, next_pos)."""
    (length,) = struct.unpack_from("<i", data, pos)
    if length < 5 or pos + length > len(data):
        raise ValueError("bson document truncated")
    end = pos + length - 1  # the trailing 0x00
    cur = pos + 4
    doc: Dict = {}
    while cur < end:
        etype = data[cur]
        cur += 1
        zero = data.index(b"\x00", cur)
        key = data[cur:zero].decode("utf-8", "replace")
        cur = zero + 1
        if etype == 0x01:
            (val,) = struct.unpack_from("<d", data, cur)
            cur += 8
        elif etype == 0x02:
            (n,) = struct.unpack_from("<i", data, cur)
            val = data[cur + 4 : cur + 4 + n - 1].decode("utf-8", "replace")
            cur += 4 + n
        elif etype in (0x03, 0x04):
            val, nxt = bson_decode(data, cur)
            if etype == 0x04:
                val = [val[k] for k in sorted(val, key=lambda s: int(s or 0))]
            cur = nxt
        elif etype == 0x05:
            (n,) = struct.unpack_from("<i", data, cur)
            val = data[cur + 5 : cur + 5 + n]
            cur += 5 + n
        elif etype == 0x07:  # ObjectId
            val = data[cur : cur + 12]
            cur += 12
        elif etype == 0x08:
            val = data[cur] != 0
            cur += 1
        elif etype == 0x09:  # UTC datetime (ms)
            (val,) = struct.unpack_from("<q", data, cur)
            cur += 8
        elif etype == 0x0A:
            val = None
        elif etype == 0x10:
            (val,) = struct.unpack_from("<i", data, cur)
            cur += 4
        elif etype == 0x12:
            (val,) = struct.unpack_from("<q", data, cur)
            cur += 8
        else:
            raise ValueError(f"bson: unsupported element type 0x{etype:02x}")
        doc[key] = val
    return doc, pos + length


# ---------------------------------------------------------------------------
# wire messages
# ---------------------------------------------------------------------------
class MongoMessage:
    __slots__ = ("request_id", "response_to", "op_code", "doc", "collection")

    def __init__(self, request_id: int, response_to: int, op_code: int,
                 doc: Optional[Dict], collection: str = ""):
        self.request_id = request_id
        self.response_to = response_to
        self.op_code = op_code
        self.doc = doc
        self.collection = collection


def parse(buf: IOBuf, sock, read_eof: bool) -> ParseResult:
    head = buf.fetch(16)
    if head is None:
        got = buf.fetch(min(len(buf), 16)) or b""
        if len(got) >= 16:
            return ParseResult.try_others()
        # can't rule mongo out until the op_code bytes arrive
        return ParseResult.not_enough() if _plausible(got) else ParseResult.try_others()
    length, request_id, response_to, op_code = struct.unpack("<iiii", head)
    if op_code not in _KNOWN_OPS:
        return ParseResult.try_others()
    if length < 16 or length > _MAX_MESSAGE:
        return ParseResult.bad()
    if len(buf) < length:
        return ParseResult.not_enough()
    buf.pop_front(16)
    body = buf.cut_bytes(length - 16)
    try:
        if op_code == OP_MSG:
            # u32 flagBits, then sections; kind 0 = one BSON body
            if len(body) < 5 or body[4] != 0:
                return ParseResult.bad()
            doc, _ = bson_decode(body, 5)
            return ParseResult.ok(MongoMessage(request_id, response_to, op_code, doc))
        if op_code == OP_QUERY:
            # i32 flags, cstring collection, i32 skip, i32 nreturn, BSON
            zero = body.index(b"\x00", 4)
            collection = body[4:zero].decode("utf-8", "replace")
            doc, _ = bson_decode(body, zero + 1 + 8)
            return ParseResult.ok(
                MongoMessage(request_id, response_to, op_code, doc, collection)
            )
    except (ValueError, IndexError, struct.error) as e:
        log_error("bad mongo message: %r", e)
        return ParseResult.bad()
    # other legacy ops: acknowledge with an error document
    return ParseResult.ok(MongoMessage(request_id, response_to, op_code, None))


def _plausible(got: bytes) -> bool:
    if len(got) < 4:
        return True
    (length,) = struct.unpack_from("<i", got, 0)
    return 16 <= length <= _MAX_MESSAGE


def pack_op_msg(response_to: int, doc: Dict, request_id: int = 0) -> bytes:
    body = struct.pack("<I", 0) + b"\x00" + bson_encode(doc)
    return (
        struct.pack("<iiii", 16 + len(body), request_id, response_to, OP_MSG)
        + body
    )


def pack_op_reply(response_to: int, docs: List[Dict], request_id: int = 0) -> bytes:
    payload = b"".join(bson_encode(d) for d in docs)
    body = struct.pack("<iqii", 0, 0, 0, len(docs)) + payload
    return (
        struct.pack("<iiii", 16 + len(body), request_id, response_to, OP_REPLY)
        + body
    )


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------
class MongoServiceAdaptor:
    """Subclass and register as ServerOptions.mongo_service_adaptor
    (reference mongo_service_adaptor.h). ``handle`` receives the
    command/query document and returns the reply document."""

    def handle(self, controller, doc: Dict) -> Dict:
        raise NotImplementedError


def process_request(msg: MongoMessage, sock) -> None:
    from incubator_brpc_tpu_torch.client.controller import Controller

    server = sock.server
    adaptor = getattr(getattr(server, "options", None), "mongo_service_adaptor", None)
    reply_id = msg.request_id
    if adaptor is None or msg.doc is None:
        err = {"ok": 0.0, "errmsg": "no mongo service" if adaptor is None
               else f"unsupported opcode {msg.op_code}", "code": 59}
        wire = (
            pack_op_reply(reply_id, [err])
            if msg.op_code != OP_MSG
            else pack_op_msg(reply_id, err)
        )
        sock.write(IOBuf(wire), ignore_eovercrowded=True)
        return
    ctrl = Controller()
    ctrl.server = server
    ctrl._server_socket = sock
    ctrl.remote_side = sock.remote
    ctrl.service_name = "mongo"
    ctrl.method_name = msg.collection or str(msg.doc and next(iter(msg.doc), ""))
    try:
        reply = adaptor.handle(ctrl, msg.doc)
    except Exception as e:  # noqa: BLE001
        log_error("mongo adaptor raised: %r", e)
        reply = {"ok": 0.0, "errmsg": f"handler raised: {e}", "code": 8}
    ctrl._release_session_local()  # handler done: pool the user data
    if ctrl.failed():
        reply = {"ok": 0.0, "errmsg": ctrl.error_text(), "code": ctrl.error_code}
    if not isinstance(reply, dict):
        reply = {"ok": 1.0}
    if msg.op_code == OP_MSG:
        wire = pack_op_msg(reply_id, reply)
    else:
        wire = pack_op_reply(reply_id, [reply])
    sock.write(IOBuf(wire), ignore_eovercrowded=True)


PROTOCOL = Protocol(
    name="mongo",
    parse=parse,
    process_request=process_request,
)


def register():
    register_protocol(PROTOCOL)
