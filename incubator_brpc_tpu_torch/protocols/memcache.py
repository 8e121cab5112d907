"""Memcache binary protocol — pipelined client + server.

Analog of reference policy/memcache_binary_protocol.cpp +
memcache.{h,cpp} (client-only there). Binary framing: 24-byte header
(magic 0x80 request / 0x81 response, opcode, key/extras/body lengths,
status, opaque, cas) + extras + key + value.

Usage (mirrors memcache.h Get/Set/PopGet):

    req = MemcacheRequest()
    req.set("k", b"v", flags=0, exptime=0)
    req.get("k")
    resp = MemcacheResponse()
    channel.call_method(memcache_method_spec(), ctrl, req, resp)
    ok, value, flags, cas = resp.pop_get()

Each op answers exactly one response, in order, so a request of N ops
rides Socket.pipelined_info with count=N like redis.

Server side (TPU extension past the reference): set
``ServerOptions.memcache_service`` to a ``MemcacheService`` and any
binary-protocol memcached client can talk to the port.  The length-
prefixed framing makes the device-value path simpler than redis: a
value region that is exactly one whole-array DeviceRef ships HBM→HBM
over ICI without materializing (GET replies and SET ingests both)."""

from __future__ import annotations

import struct
import threading
from typing import List, Optional, Tuple

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.protocols import ParseResult, Protocol, register_protocol
from incubator_brpc_tpu_torch.runtime.call_id import default_pool as _id_pool
from incubator_brpc_tpu_torch.utils.iobuf import DeviceRef, IOBuf
from incubator_brpc_tpu_torch.utils.logging import log_error

MAGIC_REQUEST = 0x80
MAGIC_RESPONSE = 0x81

# opcodes (protocol_binary.h names)
OP_GET = 0x00
OP_SET = 0x01
OP_ADD = 0x02
OP_REPLACE = 0x03
OP_DELETE = 0x04
OP_INCREMENT = 0x05
OP_DECREMENT = 0x06
OP_FLUSH = 0x08
OP_NOOP = 0x0A
OP_VERSION = 0x0B
OP_APPEND = 0x0E
OP_PREPEND = 0x0F
OP_TOUCH = 0x1C

# status codes
STATUS_OK = 0x0000
STATUS_KEY_NOT_FOUND = 0x0001
STATUS_KEY_EXISTS = 0x0002
STATUS_ITEM_NOT_STORED = 0x0005

_HEADER = struct.Struct(">BBHBBHIIQ")  # magic op keylen extras dtype status bodylen opaque cas


def pack_header(
    magic: int, opcode: int, key_len: int, extras_len: int, body_len: int,
    status: int = 0, opaque: int = 0, cas: int = 0,
) -> bytes:
    return _HEADER.pack(
        magic, opcode, key_len, extras_len, 0, status, body_len, opaque, cas
    )


class MemcacheOpResponse:
    __slots__ = ("opcode", "status", "key", "extras", "value", "cas")

    def __init__(self, opcode, status, key, extras, value, cas):
        self.opcode = opcode
        self.status = status
        self.key = key
        self.extras = extras
        self.value = value
        self.cas = cas

    @property
    def ok(self) -> bool:
        return self.status == STATUS_OK

    def device_array(self):
        """The HBM-resident jax.Array of a device-path value, or None
        for host values."""
        if isinstance(self.value, DeviceRef):
            return self.value.whole_array()
        return None

    def bytes_value(self) -> bytes:
        """The value as host bytes; device values MATERIALIZE (one
        manifested pull through iobuf.host-view)."""
        if isinstance(self.value, DeviceRef):
            return bytes(self.value.view())
        return self.value


def _is_device_value(v) -> bool:
    """An HBM-resident value operand (jax.Array / DeviceRef), not host
    bytes — rides the wire as a DeviceRef segment."""
    if isinstance(v, DeviceRef):
        return True
    return (
        hasattr(v, "nbytes")
        and hasattr(v, "dtype")
        and not isinstance(v, (bytes, bytearray, memoryview))
    )


class MemcacheRequest:
    def __init__(self):
        # host-byte chunks interleaved with device arrays (a SET value
        # may be an HBM-resident jax.Array — the cache ingest path)
        self._chunks: List = []
        self._count = 0
        self._has_device = False

    @property
    def op_count(self) -> int:
        return self._count

    def _add(self, opcode: int, key: bytes = b"", extras: bytes = b"",
             value=b"", cas: int = 0):
        if _is_device_value(value):
            vlen = int(value.nbytes)
            self._chunks.append(
                pack_header(
                    MAGIC_REQUEST, opcode, len(key), len(extras),
                    len(extras) + len(key) + vlen, cas=cas,
                )
                + extras + key
            )
            self._chunks.append(value)
            self._has_device = True
        else:
            self._chunks.append(
                pack_header(
                    MAGIC_REQUEST, opcode, len(key), len(extras),
                    len(extras) + len(key) + len(value), cas=cas,
                )
                + extras + key + value
            )
        self._count += 1

    @staticmethod
    def _b(v):
        if _is_device_value(v):
            return v
        return v.encode() if isinstance(v, str) else bytes(v)

    # ---- ops (memcache.h surface) ------------------------------------------
    def get(self, key):
        self._add(OP_GET, self._b(key))

    def set(self, key, value, flags: int = 0, exptime: int = 0, cas: int = 0):
        extras = struct.pack(">II", flags, exptime)
        self._add(OP_SET, self._b(key), extras, self._b(value), cas)

    def add(self, key, value, flags: int = 0, exptime: int = 0):
        self._add(OP_ADD, self._b(key), struct.pack(">II", flags, exptime),
                  self._b(value))

    def replace(self, key, value, flags: int = 0, exptime: int = 0, cas: int = 0):
        self._add(OP_REPLACE, self._b(key), struct.pack(">II", flags, exptime),
                  self._b(value), cas)

    def append(self, key, value):
        self._add(OP_APPEND, self._b(key), b"", self._b(value))

    def prepend(self, key, value):
        self._add(OP_PREPEND, self._b(key), b"", self._b(value))

    def delete(self, key):
        self._add(OP_DELETE, self._b(key))

    def incr(self, key, delta: int = 1, initial: int = 0, exptime: int = 0xFFFFFFFF):
        extras = struct.pack(">QQI", delta, initial, exptime)
        self._add(OP_INCREMENT, self._b(key), extras)

    def decr(self, key, delta: int = 1, initial: int = 0, exptime: int = 0xFFFFFFFF):
        extras = struct.pack(">QQI", delta, initial, exptime)
        self._add(OP_DECREMENT, self._b(key), extras)

    def touch(self, key, exptime: int):
        self._add(OP_TOUCH, self._b(key), struct.pack(">I", exptime))

    def flush_all(self, delay: int = 0):
        self._add(OP_FLUSH, b"", struct.pack(">I", delay))

    def version(self):
        self._add(OP_VERSION)

    def SerializeToString(self) -> bytes:
        if self._has_device:
            raise ValueError("device-payload request needs serialize_iobuf()")
        return b"".join(self._chunks)

    def serialize_iobuf(self) -> IOBuf:
        out = IOBuf()
        for c in self._chunks:
            if isinstance(c, bytes):
                out.append(c)
            else:
                out.append_device(c)
        return out


class MemcacheResponse:
    def __init__(self):
        self._ops: List[MemcacheOpResponse] = []
        self._pop_index = 0

    def _set_ops(self, ops: List[MemcacheOpResponse]):
        self._ops = list(ops)
        self._pop_index = 0

    @property
    def op_count(self) -> int:
        return len(self._ops)

    def op(self, i: int) -> MemcacheOpResponse:
        return self._ops[i]

    def _pop(self) -> Optional[MemcacheOpResponse]:
        if self._pop_index >= len(self._ops):
            return None
        op = self._ops[self._pop_index]
        self._pop_index += 1
        return op

    # ---- pop helpers (PopGet/PopStore/PopCounter analogs) -------------------
    def pop_get(self) -> Tuple[bool, bytes, int, int]:
        """→ (ok, value, flags, cas)."""
        op = self._pop()
        if op is None or not op.ok:
            return False, b"", 0, 0
        flags = struct.unpack(">I", op.extras[:4])[0] if len(op.extras) >= 4 else 0
        return True, op.value, flags, op.cas

    def pop_store(self) -> Tuple[bool, int]:
        """→ (ok, cas) for set/add/replace/append/prepend/delete/touch."""
        op = self._pop()
        if op is None:
            return False, 0
        return op.ok, op.cas

    def pop_counter(self) -> Tuple[bool, int]:
        """→ (ok, new_value) for incr/decr."""
        op = self._pop()
        if op is None or not op.ok or len(op.value) < 8:
            return False, 0
        return True, struct.unpack(">Q", op.value[:8])[0]

    def pop_version(self) -> Tuple[bool, str]:
        op = self._pop()
        if op is None or not op.ok:
            return False, ""
        return True, op.value.decode("latin1")

    def ParseFromString(self, data: bytes):
        pass


class _MemcacheMethodSpec:
    service_name = "memcache"
    method_name = "ops"
    full_name = "memcache.ops"
    request_class = MemcacheRequest
    response_class = MemcacheResponse


def memcache_method_spec() -> _MemcacheMethodSpec:
    return _MemcacheMethodSpec()


# ---- protocol callbacks -----------------------------------------------------
class _MemcacheReq:
    """One parsed server-side request op."""

    __slots__ = ("opcode", "key", "extras", "value", "cas", "opaque")

    def __init__(self, opcode, key, extras, value, cas, opaque):
        self.opcode = opcode
        self.key = key
        self.extras = extras
        self.value = value  # bytes | DeviceRef (device-resident SET)
        self.cas = cas
        self.opaque = opaque


def _fetch_header(buf: IOBuf) -> Optional[bytes]:
    """The 24-byte header without materializing device segments (the
    header is always host bytes at the front; ``fetch`` would copy_to
    across a device ref if the header straddled segments)."""
    parts = []
    need = 24
    for ref in buf.iter_refs():
        if need <= 0:
            break
        if isinstance(ref, DeviceRef):
            raise ValueError("memcache header inside a device segment")
        v = ref.view()
        take = min(len(v), need)
        parts.append(bytes(v[:take]))
        need -= take
    if need > 0:
        return None
    return b"".join(parts)


def _cut_value(buf: IOBuf, value_len: int):
    """Consume the value region: exactly one whole-array DeviceRef at
    the front stays device-resident; anything else takes the byte path
    (materializing device windows through iobuf.host-view)."""
    if value_len == 0:
        return b""
    first = next(iter(buf.iter_refs()), None)
    if (
        isinstance(first, DeviceRef)
        and first.length == value_len
        and first.whole_array() is not None
    ):
        out = IOBuf()
        buf.cutn(out, value_len)
        return out.device_segments()[0]
    return buf.cut_bytes(value_len)


def parse(buf: IOBuf, sock, read_eof: bool) -> ParseResult:
    if buf.has_device_payload():
        first = next(iter(buf.iter_refs()), None)
        if isinstance(first, DeviceRef):
            return ParseResult.bad()  # a frame never starts mid-payload
        head = bytes(first.view()[:1])
    else:
        head = buf.fetch(1)
    if not head:
        return ParseResult.not_enough()
    magic = head[0]
    if sock.is_server_side:
        if magic != MAGIC_REQUEST:
            return ParseResult.try_others()
        # only servers that actually speak memcache claim 0x80 frames —
        # other binary protocols must keep their shot at the bytes
        service = getattr(
            getattr(getattr(sock, "server", None), "options", None),
            "memcache_service",
            None,
        )
        if service is None:
            return ParseResult.try_others()
    elif magic != MAGIC_RESPONSE:
        return ParseResult.try_others()
    try:
        header = _fetch_header(buf)
    except ValueError:
        return ParseResult.bad()
    if header is None:
        return ParseResult.not_enough()
    (magic, opcode, key_len, extras_len, _dt, status, body_len, opaque, cas) = (
        _HEADER.unpack(header)
    )
    if body_len < extras_len + key_len:
        return ParseResult.bad()
    if len(buf) < 24 + body_len:
        return ParseResult.not_enough()
    buf.pop_front(24)
    ek = buf.cut_bytes(extras_len + key_len)
    extras = ek[:extras_len]
    key = ek[extras_len:]
    value = _cut_value(buf, body_len - extras_len - key_len)
    if sock.is_server_side:
        return ParseResult.ok(
            _MemcacheReq(opcode, key, extras, value, cas, opaque)
        )
    return ParseResult.ok(
        MemcacheOpResponse(opcode, status, key, extras, value, cas)
    )


def serialize_request(request: MemcacheRequest, controller) -> IOBuf:
    if request.op_count == 0:
        raise ValueError("MemcacheRequest has no ops")
    controller._memcache_count = request.op_count
    return request.serialize_iobuf()


def pack_request(request_buf: IOBuf, wire_cid: int, method_spec, controller) -> IOBuf:
    count = getattr(controller, "_memcache_count", 1)
    packet = IOBuf()
    channel = controller._channel
    auth = channel.options.auth if channel is not None else None
    if auth is not None:
        # couchbase-style SASL: the authenticator's credential IS a
        # complete memcache SASL_AUTH packet (CouchbaseAuthenticator,
        # reference policy/couchbase_authenticator.cpp); it must be the
        # FIRST packet on the connection, so it rides the same
        # conn_preamble mechanism as redis AUTH — Socket.write decides
        # the one writer that prepends it.  cid 0 discards the server's
        # SASL response.
        cred = auth.generate_credential()
        controller._conn_preamble = (
            IOBuf(cred.encode("latin1")), [(0, 1)],
        )
    packet.append(request_buf)
    # FIFO entry registers inside the write, atomic with queue order
    controller._pipelined_entries = [(wire_cid, count)]
    return packet


def process_response(op: MemcacheOpResponse, sock) -> None:
    from incubator_brpc_tpu_torch.protocols import accumulate_pipelined

    done = accumulate_pipelined(sock, op)
    if done is None:
        return
    cid, ops = done
    if not cid:
        return
    pool = _id_pool()
    ctrl = pool.lock(cid)
    if ctrl is None:
        return
    if ctrl._response is not None:
        ctrl._response._set_ops(ops)
    ctrl._finalize_locked(cid)


# ---- server side (TPU extension past the client-only reference) -------------
class MemcacheService:
    """In-memory binary-memcached server: set
    ``ServerOptions.memcache_service = MemcacheService()`` and the port
    answers get/set/add/replace/delete/incr/decr/append/prepend/touch/
    flush/version/noop.  Subclasses override ``handle_op`` for custom
    stores (the HBM cache tier overrides it to serve DeviceRef values);
    the default keeps host bytes in a dict with flags + cas."""

    VERSION = b"1.6.0-tpu"

    def __init__(self):
        self._d = {}  # key -> [value bytes, flags, cas]
        self._cas = 0
        self._lock = threading.Lock()

    @staticmethod
    def _host(value) -> bytes:
        if isinstance(value, DeviceRef):
            return bytes(value.view())
        if _is_device_value(value):
            return bytes(DeviceRef(value).view())
        return bytes(value)

    def handle_op(self, op: _MemcacheReq, sock) -> Tuple[int, bytes, object, int]:
        """→ (status, extras, value, cas).  ``value`` may be bytes or a
        device array (whole jax.Array) for the HBM-resident path."""
        code = op.opcode
        if code == OP_GET:
            with self._lock:
                ent = self._d.get(op.key)
            if ent is None:
                return STATUS_KEY_NOT_FOUND, b"", b"Not found", 0
            return STATUS_OK, struct.pack(">I", ent[1]), ent[0], ent[2]
        if code in (OP_SET, OP_ADD, OP_REPLACE):
            flags = struct.unpack(">I", op.extras[:4])[0] if len(op.extras) >= 4 else 0
            value = self._host(op.value)
            with self._lock:
                exists = op.key in self._d
                if code == OP_ADD and exists:
                    return STATUS_KEY_EXISTS, b"", b"", 0
                if code == OP_REPLACE and not exists:
                    return STATUS_KEY_NOT_FOUND, b"", b"", 0
                if op.cas and exists and self._d[op.key][2] != op.cas:
                    return STATUS_KEY_EXISTS, b"", b"", 0
                self._cas += 1
                self._d[op.key] = [value, flags, self._cas]
                return STATUS_OK, b"", b"", self._cas
        if code == OP_DELETE:
            with self._lock:
                ok = self._d.pop(op.key, None) is not None
            return (STATUS_OK if ok else STATUS_KEY_NOT_FOUND), b"", b"", 0
        if code in (OP_APPEND, OP_PREPEND):
            value = self._host(op.value)
            with self._lock:
                ent = self._d.get(op.key)
                if ent is None:
                    return STATUS_ITEM_NOT_STORED, b"", b"", 0
                ent[0] = ent[0] + value if code == OP_APPEND else value + ent[0]
                self._cas += 1
                ent[2] = self._cas
                return STATUS_OK, b"", b"", self._cas
        if code in (OP_INCREMENT, OP_DECREMENT):
            if len(op.extras) < 20:
                return STATUS_ITEM_NOT_STORED, b"", b"", 0
            delta, initial, _exp = struct.unpack(">QQI", op.extras[:20])
            with self._lock:
                ent = self._d.get(op.key)
                if ent is None:
                    cur = initial
                else:
                    try:
                        cur = int(ent[0])
                    except ValueError:
                        return STATUS_ITEM_NOT_STORED, b"", b"", 0
                    cur = cur + delta if code == OP_INCREMENT else max(0, cur - delta)
                self._cas += 1
                self._d[op.key] = [str(cur).encode(), 0, self._cas]
                return STATUS_OK, b"", struct.pack(">Q", cur), self._cas
        if code == OP_TOUCH:
            with self._lock:
                ok = op.key in self._d
            return (STATUS_OK if ok else STATUS_KEY_NOT_FOUND), b"", b"", 0
        if code == OP_FLUSH:
            with self._lock:
                self._d.clear()
            return STATUS_OK, b"", b"", 0
        if code == OP_NOOP:
            return STATUS_OK, b"", b"", 0
        if code == OP_VERSION:
            return STATUS_OK, b"", self.VERSION, 0
        return 0x0081, b"", b"Unknown command", 0  # UNKNOWN_COMMAND


def pack_response_into(
    out: IOBuf, opcode: int, status: int, extras: bytes, value, cas: int,
    opaque: int = 0,
) -> None:
    """Pack one response frame; an HBM-resident value ships as a
    DeviceRef segment (memcache's length-prefixed framing needs no
    trailer, so the device array IS the value region)."""
    if _is_device_value(value):
        arr = value.whole_array() if isinstance(value, DeviceRef) else value
        if arr is None:  # windowed ref: materialize once, manifested
            value = bytes(value.view())
        else:
            out.append(pack_header(
                MAGIC_RESPONSE, opcode, 0, len(extras),
                len(extras) + int(arr.nbytes), status=status,
                opaque=opaque, cas=cas,
            ))
            if extras:
                out.append(extras)
            out.append_device(arr)
            return
    out.append(pack_header(
        MAGIC_RESPONSE, opcode, 0, len(extras), len(extras) + len(value),
        status=status, opaque=opaque, cas=cas,
    ))
    if extras:
        out.append(extras)
    if value:
        out.append(value)


def process_request(op: _MemcacheReq, sock) -> None:
    service = getattr(
        getattr(getattr(sock, "server", None), "options", None),
        "memcache_service",
        None,
    )
    if service is None:
        status, extras, value, cas = 0x0081, b"", b"Unknown command", 0
    else:
        # same unified admission gate as every other protocol; a shed
        # answers the binary-protocol Busy status (0x0085)
        verdict = sock.server.admission.admit(
            f"memcache.{op.opcode:#04x}", None
        )
        if not verdict.admitted:
            status, extras, value, cas = 0x0085, b"", b"Busy", 0
        else:
            ticket = verdict.ticket
            try:
                status, extras, value, cas = service.handle_op(op, sock)
            except Exception as e:  # noqa: BLE001 — handler bug answers, not kills
                log_error("memcache handler op=%#x raised: %r", op.opcode, e)
                status, extras, value, cas = 0x0084, b"", b"Internal error", 0
            finally:
                if ticket is not None:
                    ticket.release()
    out = IOBuf()
    pack_response_into(out, op.opcode, status, extras, value, cas, op.opaque)
    sock.write(out, ignore_eovercrowded=True)


PROTOCOL = Protocol(
    name="memcache",
    parse=parse,
    serialize_request=serialize_request,
    pack_request=pack_request,
    process_request=process_request,
    process_response=process_response,
    support_server=True,  # TPU extension: memcache_service on the port
    support_pipelined=True,
    process_ordered=True,
)


def register():
    register_protocol(PROTOCOL)
