"""Thrift framed-binary protocol — client + server.

Analog of reference policy/thrift_protocol.cpp + thrift_message.h:
TFramedTransport (u32 BE frame length) carrying strict TBinaryProtocol
messages (version 0x8001, message name, seqid, then the args/result
struct). The reference hands raw thrift structs to user code; here
structs round-trip through plain Python values:

    field dict  {field_id: (TType, value)}  — explicit, lossless

The server dispatches by thrift method name to handlers registered on a
ThriftService; seqid is the correlation id, so the client runs over the
standard single multiplexed connection.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.protocols import ParseResult, Protocol, register_protocol
from incubator_brpc_tpu_torch.runtime.call_id import default_pool as _id_pool
from incubator_brpc_tpu_torch.runtime.call_id import wire_cid32
from incubator_brpc_tpu_torch.utils.iobuf import IOBuf
from incubator_brpc_tpu_torch.utils.logging import log_error

VERSION_1 = 0x80010000
_VERSION_MASK = 0xFFFF0000

# TMessageType
CALL, REPLY, EXCEPTION, ONEWAY = 1, 2, 3, 4

# TType
T_STOP, T_BOOL, T_BYTE, T_DOUBLE = 0, 2, 3, 4
T_I16, T_I32, T_I64, T_STRING = 6, 8, 10, 11
T_STRUCT, T_MAP, T_SET, T_LIST = 12, 13, 14, 15

_MAX_FRAME = 64 << 20


# ---------------------------------------------------------------------------
# TBinaryProtocol value codec over field dicts {fid: (ttype, value)}
# ---------------------------------------------------------------------------
class _Writer:
    def __init__(self):
        self.parts = []

    def i8(self, v):
        self.parts.append(struct.pack(">b", v))

    def i16(self, v):
        self.parts.append(struct.pack(">h", v))

    def i32(self, v):
        self.parts.append(struct.pack(">i", v))

    def u32(self, v):
        self.parts.append(struct.pack(">I", v & 0xFFFFFFFF))

    def i64(self, v):
        self.parts.append(struct.pack(">q", v))

    def double(self, v):
        self.parts.append(struct.pack(">d", v))

    def string(self, v):
        if isinstance(v, str):
            v = v.encode()
        self.parts.append(struct.pack(">i", len(v)))
        self.parts.append(v)

    def value(self, ttype, v):
        if ttype == T_BOOL:
            self.i8(1 if v else 0)
        elif ttype == T_BYTE:
            self.i8(v)
        elif ttype == T_DOUBLE:
            self.double(v)
        elif ttype == T_I16:
            self.i16(v)
        elif ttype == T_I32:
            self.i32(v)
        elif ttype == T_I64:
            self.i64(v)
        elif ttype == T_STRING:
            self.string(v)
        elif ttype == T_STRUCT:
            self.struct(v)
        elif ttype == T_MAP:
            kt, vt, items = v
            self.i8(kt)
            self.i8(vt)
            self.i32(len(items))
            for k, val in items.items() if isinstance(items, dict) else items:
                self.value(kt, k)
                self.value(vt, val)
        elif ttype in (T_SET, T_LIST):
            et, items = v
            self.i8(et)
            self.i32(len(items))
            for item in items:
                self.value(et, item)
        else:
            raise ValueError(f"unsupported ttype {ttype}")

    def struct(self, fields: Dict[int, Tuple[int, object]]):
        for fid, (ttype, v) in sorted(fields.items()):
            self.i8(ttype)
            self.i16(fid)
            self.value(ttype, v)
        self.i8(T_STOP)

    def bytes(self) -> bytes:
        return b"".join(self.parts)


class _Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def _take(self, n) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("thrift payload truncated")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def i8(self):
        return struct.unpack(">b", self._take(1))[0]

    def i16(self):
        return struct.unpack(">h", self._take(2))[0]

    def i32(self):
        return struct.unpack(">i", self._take(4))[0]

    def i64(self):
        return struct.unpack(">q", self._take(8))[0]

    def double(self):
        return struct.unpack(">d", self._take(8))[0]

    def string(self):
        n = self.i32()
        if n < 0:
            raise ValueError("negative string length")
        return self._take(n)

    def value(self, ttype):
        if ttype == T_BOOL:
            return bool(self.i8())
        if ttype == T_BYTE:
            return self.i8()
        if ttype == T_DOUBLE:
            return self.double()
        if ttype == T_I16:
            return self.i16()
        if ttype == T_I32:
            return self.i32()
        if ttype == T_I64:
            return self.i64()
        if ttype == T_STRING:
            return self.string()
        if ttype == T_STRUCT:
            return self.struct()
        if ttype == T_MAP:
            kt, vt, n = self.i8(), self.i8(), self.i32()
            return (kt, vt, [(self.value(kt), self.value(vt)) for _ in range(n)])
        if ttype in (T_SET, T_LIST):
            et, n = self.i8(), self.i32()
            return (et, [self.value(et) for _ in range(n)])
        raise ValueError(f"unsupported ttype {ttype}")

    def struct(self) -> Dict[int, Tuple[int, object]]:
        fields = {}
        while True:
            ttype = self.i8()
            if ttype == T_STOP:
                return fields
            fid = self.i16()
            fields[fid] = (ttype, self.value(ttype))


class ThriftMessage:
    __slots__ = ("method", "mtype", "seqid", "fields")

    def __init__(self, method: str, mtype: int, seqid: int, fields):
        self.method = method
        self.mtype = mtype
        self.seqid = seqid
        self.fields = fields  # {fid: (ttype, value)}


def pack_message(method: str, mtype: int, seqid: int, fields) -> bytes:
    w = _Writer()
    w.u32(VERSION_1 | mtype)
    w.string(method)
    w.u32(seqid)
    w.struct(fields or {})
    body = w.bytes()
    return struct.pack(">I", len(body)) + body


def exception_fields(message: str, etype: int = 6) -> dict:
    """TApplicationException struct (1: message, 2: type).
    etype 6 = INTERNAL_ERROR, 1 = UNKNOWN_METHOD."""
    return {1: (T_STRING, message), 2: (T_I32, etype)}


# ---- framing ---------------------------------------------------------------
def parse(buf: IOBuf, sock, read_eof: bool) -> ParseResult:
    head = buf.fetch(8)
    if head is None:
        got = buf.fetch(min(len(buf), 8)) or b""
        # an empty/short prefix could still become a thrift frame IF the
        # version bytes we have so far agree
        if len(got) >= 5 and got[4] != 0x80:
            return ParseResult.try_others()
        return ParseResult.not_enough()
    (frame_len,) = struct.unpack_from(">I", head, 0)
    version = struct.unpack_from(">I", head, 4)[0] & _VERSION_MASK
    if version != (VERSION_1 & _VERSION_MASK):
        return ParseResult.try_others()
    if frame_len > _MAX_FRAME or frame_len < 12:
        return ParseResult.bad()
    if len(buf) < 4 + frame_len:
        return ParseResult.not_enough()
    buf.pop_front(4)
    body = buf.cut_bytes(frame_len)
    try:
        r = _Reader(body)
        ver_type = r.i32() & 0xFFFFFFFF
        mtype = ver_type & 0xFF
        method = r.string().decode("utf-8", "replace")
        seqid = r.i32() & 0xFFFFFFFF
        fields = r.struct()
    except ValueError as e:
        log_error("bad thrift frame: %r", e)
        return ParseResult.bad()
    return ParseResult.ok(ThriftMessage(method, mtype, seqid, fields))


# ---- server side -----------------------------------------------------------
class ThriftService:
    """Register with ServerOptions.thrift_service (the reference's
    ServerOptions.thrift_service, thrift_service.h). Handlers:

        svc.add_method("Echo", fn)  with
        fn(controller, fields: dict, done(result_fields | None))
    """

    def __init__(self):
        self._methods = {}

    def add_method(self, name: str, fn):
        self._methods[name] = fn
        return self

    def find(self, name: str):
        return self._methods.get(name)


def process_request(msg: ThriftMessage, sock) -> None:
    from incubator_brpc_tpu_torch.client.controller import Controller

    server = sock.server
    oneway = msg.mtype == ONEWAY  # spec: NOTHING may be written back
    svc = getattr(getattr(server, "options", None), "thrift_service", None)
    if svc is None:
        if not oneway:
            sock.write(
                IOBuf(
                    pack_message(
                        msg.method, EXCEPTION, msg.seqid,
                        exception_fields("no thrift service configured", 1),
                    )
                ),
                ignore_eovercrowded=True,
            )
        return
    fn = svc.find(msg.method)
    if fn is None:
        if not oneway:
            sock.write(
                IOBuf(
                    pack_message(
                        msg.method, EXCEPTION, msg.seqid,
                        exception_fields(f"unknown method {msg.method}", 1),
                    )
                ),
                ignore_eovercrowded=True,
            )
        return
    ctrl = Controller()
    ctrl.server = server
    ctrl._server_socket = sock
    ctrl.remote_side = sock.remote
    sent = [False]

    def done(result_fields=None):
        if sent[0]:
            return
        sent[0] = True
        ctrl._release_session_local()  # handler done: pool the user data
        if oneway:
            return  # oneway calls never get a reply frame
        if ctrl.failed():
            wire = pack_message(
                msg.method, EXCEPTION, msg.seqid,
                exception_fields(ctrl.error_text() or "failed"),
            )
        else:
            # thrift result struct: field 0 = return value
            wire = pack_message(msg.method, REPLY, msg.seqid, result_fields or {})
        sock.write(IOBuf(wire), ignore_eovercrowded=True)

    try:
        fn(ctrl, msg.fields, done)
    except Exception as e:  # noqa: BLE001
        log_error("thrift handler %s raised: %r", msg.method, e)
        if not sent[0]:
            ctrl.set_failed(errors.EINTERNAL, f"handler raised: {e}")
            done()


# ---- client side -----------------------------------------------------------
def serialize_request(request, controller) -> IOBuf:
    """request is the args field dict; packing happens per attempt."""
    out = IOBuf()
    w = _Writer()
    w.struct(request or {})
    out.append(w.bytes())
    return out


def pack_request(request_buf: IOBuf, wire_cid: int, method_spec, controller) -> IOBuf:
    seqid = wire_cid32(wire_cid)
    w = _Writer()
    w.u32(VERSION_1 | CALL)
    w.string(method_spec.method_name)
    w.u32(seqid)
    head = w.bytes()
    body_len = len(head) + len(request_buf)
    out = IOBuf()
    out.append(struct.pack(">I", body_len) + head)
    out.append(request_buf)
    return out


def process_response(msg: ThriftMessage, sock) -> None:
    cid = _full_cid(sock, msg.seqid)
    pool = _id_pool()
    ctrl = pool.lock(cid)
    if ctrl is None:
        return
    if msg.mtype == EXCEPTION:
        emsg = msg.fields.get(1, (T_STRING, b"thrift exception"))[1]
        if isinstance(emsg, bytes):
            emsg = emsg.decode("utf-8", "replace")
        ctrl.set_failed(errors.ERESPONSE, emsg)
    else:
        if ctrl._response is not None and isinstance(ctrl._response, dict):
            ctrl._response.clear()
            ctrl._response.update(msg.fields)
    ctrl._finalize_locked(cid)


def _full_cid(sock, seqid: int) -> int:
    """seqid carries the gen-mixed 32-bit cid form (wire_cid32);
    responses arrive on the socket the request went out on, where the
    full id is registered as a response waiter (socket.waiting_cids)."""
    with sock._write_lock:
        for full in sock.waiting_cids:
            if wire_cid32(full) == seqid:
                return full
    return seqid


class ThriftStub:
    """Client helper: stub.call(cntl, "Echo", {1: (T_STRING, b"hi")})
    → result field dict (field 0 is the thrift return value)."""

    def __init__(self, channel):
        self._channel = channel

    def call(self, controller, method: str, fields=None, done=None) -> dict:
        from incubator_brpc_tpu_torch.server.service import MethodSpec

        spec = MethodSpec("thrift", method, dict, dict)
        response: dict = {}
        self._channel.call_method(spec, controller, fields or {}, response, done)
        return response


PROTOCOL = Protocol(
    name="thrift",
    parse=parse,
    serialize_request=serialize_request,
    pack_request=pack_request,
    process_request=process_request,
    process_response=process_response,
)


def register():
    register_protocol(PROTOCOL)
