"""Redis protocol — RESP client + redis-speaking server, pipelined.

Analog of reference policy/redis_protocol.cpp + redis.{h,cpp} +
redis_command/redis_reply (RESP wire format, RFC-less but precisely
specified): the exemplar correlation-less pipelined protocol. Client
usage mirrors redis.h:43-47:

    req = RedisRequest()
    req.add_command("SET", "k", "v")
    req.add_command("GET", "k")
    resp = RedisResponse()
    channel.call_method(redis_method_spec(), ctrl, req, resp)
    resp.reply(1).value  # b"v"

Server side (reference redis.h RedisService/RedisCommandHandler): set
``ServerOptions.redis_service`` to a ``RedisService`` subclass whose
lower-case methods implement commands; any redis-cli can talk to it.

Pipelining: one RedisRequest = N commands = N in-order replies; the
per-connection FIFO rides Socket.pipelined_info with count=N — the
machinery HTTP uses loosely is exercised exactly here. Responses are
matched strictly in arrival order, so the protocol is process_ordered
on the server and the client accumulates replies per (cid, count).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.protocols import ParseResult, Protocol, register_protocol
from incubator_brpc_tpu_torch.runtime.call_id import default_pool as _id_pool
from incubator_brpc_tpu_torch.utils.iobuf import DeviceRef, IOBuf
from incubator_brpc_tpu_torch.utils.logging import log_error


def _is_device_value(v) -> bool:
    """A bulk-string payload that lives in HBM: a DeviceRef segment or a
    raw jax.Array (anything with nbytes+dtype that is not host bytes)."""
    if isinstance(v, DeviceRef):
        return True
    return (
        hasattr(v, "nbytes")
        and hasattr(v, "dtype")
        and not isinstance(v, (bytes, bytearray, memoryview))
    )

# reply types (reference redis_reply.h:33-38)
REPLY_STRING = 1  # bulk string
REPLY_ARRAY = 2
REPLY_INTEGER = 3
REPLY_NIL = 4
REPLY_STATUS = 5  # simple string (+OK)
REPLY_ERROR = 6


class RedisReply:
    __slots__ = ("type", "value")

    def __init__(self, rtype: int, value=None):
        self.type = rtype
        self.value = value

    # constructors
    @staticmethod
    def status(s: str) -> "RedisReply":
        return RedisReply(REPLY_STATUS, s)

    @staticmethod
    def error(s: str) -> "RedisReply":
        return RedisReply(REPLY_ERROR, s)

    @staticmethod
    def integer(n: int) -> "RedisReply":
        return RedisReply(REPLY_INTEGER, int(n))

    @staticmethod
    def bulk(b) -> "RedisReply":
        if isinstance(b, str):
            b = b.encode()
        return RedisReply(REPLY_STRING, b)

    @staticmethod
    def nil() -> "RedisReply":
        return RedisReply(REPLY_NIL, None)

    @staticmethod
    def array(items: List["RedisReply"]) -> "RedisReply":
        return RedisReply(REPLY_ARRAY, list(items))

    # predicates (reference redis_reply.h surface)
    def is_device(self) -> bool:
        """True when this bulk's payload is HBM-resident (the zero-copy
        device path: value is a DeviceRef or jax.Array, not host bytes)."""
        return self.type == REPLY_STRING and _is_device_value(self.value)

    def device_array(self):
        """The HBM-resident jax.Array of a device-path bulk reply, or
        None for host replies / windowed refs (which must materialize)."""
        v = self.value
        if isinstance(v, DeviceRef):
            return v.whole_array()
        if _is_device_value(v):
            return v
        return None

    def bytes_value(self) -> Optional[bytes]:
        """The bulk payload as host bytes.  Host replies return their
        value directly; device replies MATERIALIZE (a manifested
        device→host pull through iobuf.host-view) — never call this on
        the hot path of a device consumer."""
        v = self.value
        if isinstance(v, DeviceRef):
            return bytes(v.view())
        if _is_device_value(v):
            return bytes(DeviceRef(v).view())
        return v

    def is_nil(self) -> bool:
        return self.type == REPLY_NIL

    def is_error(self) -> bool:
        return self.type == REPLY_ERROR

    def __eq__(self, other):
        if isinstance(other, RedisReply):
            return self.type == other.type and self.value == other.value
        return NotImplemented

    def __repr__(self):
        names = {1: "str", 2: "arr", 3: "int", 4: "nil", 5: "status", 6: "err"}
        return f"RedisReply<{names.get(self.type)}:{self.value!r}>"


def _coerce_reply(v) -> RedisReply:
    """Server handlers may return plain Python values."""
    if isinstance(v, RedisReply):
        return v
    if v is None:
        return RedisReply.nil()
    if isinstance(v, bool):
        return RedisReply.integer(int(v))
    if isinstance(v, int):
        return RedisReply.integer(v)
    if isinstance(v, (bytes, bytearray)):
        return RedisReply.bulk(bytes(v))
    if isinstance(v, str):
        return RedisReply.bulk(v)
    if isinstance(v, (list, tuple)):
        return RedisReply.array([_coerce_reply(x) for x in v])
    return RedisReply.error(f"ERR unserializable reply type {type(v).__name__}")


# ---- RESP wire format -------------------------------------------------------
def pack_command(*components) -> bytes:
    """One command as a RESP array of bulk strings (what clients send)."""
    out = [b"*%d\r\n" % len(components)]
    for c in components:
        if isinstance(c, str):
            c = c.encode()
        elif isinstance(c, int):
            c = b"%d" % c
        out.append(b"$%d\r\n%s\r\n" % (len(c), c))
    return b"".join(out)


def pack_reply(r: RedisReply) -> bytes:
    t = r.type
    if t == REPLY_STATUS:
        return b"+%s\r\n" % str(r.value).encode()
    if t == REPLY_ERROR:
        return b"-%s\r\n" % str(r.value).encode()
    if t == REPLY_INTEGER:
        return b":%d\r\n" % r.value
    if t == REPLY_NIL:
        return b"$-1\r\n"
    if t == REPLY_STRING:
        v = r.value or b""
        return b"$%d\r\n%s\r\n" % (len(v), v)
    if t == REPLY_ARRAY:
        if r.value is None:
            return b"*-1\r\n"
        return b"*%d\r\n" % len(r.value) + b"".join(pack_reply(x) for x in r.value)
    raise ValueError(f"bad reply type {t}")


def pack_reply_into(r: RedisReply, out: IOBuf) -> None:
    """Pack one reply into ``out``, keeping HBM-resident bulk payloads
    as DeviceRef segments (the ICI transport ships them zero-copy; a
    host transport materializes lazily at the wire).  Host-only replies
    take the plain ``pack_reply`` byte path."""
    if r.type == REPLY_STRING and _is_device_value(r.value):
        arr = r.value.whole_array() if isinstance(r.value, DeviceRef) else r.value
        if arr is None:
            # windowed ref: no zero-copy identity to ship; materialize
            # once through the sanctioned iobuf.host-view choke point
            b = bytes(r.value.view())
            out.append(b"$%d\r\n" % len(b))
            out.append(b)
            out.append(b"\r\n")
            return
        out.append(b"$%d\r\n" % int(arr.nbytes))
        out.append_device(arr)
        out.append(b"\r\n")
        return
    if r.type == REPLY_ARRAY and r.value:
        if any(_carries_device(x) for x in r.value):
            out.append(b"*%d\r\n" % len(r.value))
            for x in r.value:
                pack_reply_into(x, out)
            return
    out.append(pack_reply(r))


def _carries_device(r: RedisReply) -> bool:
    if r.type == REPLY_STRING:
        return _is_device_value(r.value)
    if r.type == REPLY_ARRAY and r.value:
        return any(_carries_device(x) for x in r.value)
    return False


_MAX_NESTING = 32


def parse_reply(
    data: bytes, pos: int = 0, _depth: int = 0
) -> Tuple[Optional[RedisReply], int]:
    """Parse ONE RESP value at pos. Returns (reply, new_pos) or
    (None, pos) when incomplete. Raises ValueError on malformed input
    (including absurd nesting — unbounded recursion would let a peer
    wedge the read task with a RecursionError)."""
    if _depth > _MAX_NESTING:
        raise ValueError("RESP nesting too deep")
    if pos >= len(data):
        return None, pos
    marker = data[pos : pos + 1]
    line_end = data.find(b"\r\n", pos)
    if line_end < 0:
        return None, pos
    line = data[pos + 1 : line_end]
    after = line_end + 2
    if marker == b"+":
        return RedisReply.status(line.decode("utf-8", "replace")), after
    if marker == b"-":
        return RedisReply.error(line.decode("utf-8", "replace")), after
    if marker == b":":
        return RedisReply.integer(int(line)), after
    if marker == b"$":
        n = int(line)
        if n == -1:
            return RedisReply.nil(), after
        if n < 0:
            raise ValueError(f"bad bulk length {n}")
        if len(data) < after + n + 2:
            return None, pos
        if data[after + n : after + n + 2] != b"\r\n":
            raise ValueError("bulk string not CRLF terminated")
        return RedisReply(REPLY_STRING, data[after : after + n]), after + n + 2
    if marker == b"*":
        n = int(line)
        if n == -1:
            return RedisReply(REPLY_ARRAY, None), after
        if n < 0:
            raise ValueError(f"bad array length {n}")
        items = []
        p = after
        for _ in range(n):
            item, p2 = parse_reply(data, p, _depth + 1)
            if item is None:
                return None, pos
            items.append(item)
            p = p2
        return RedisReply.array(items), p
    raise ValueError(f"bad RESP marker {marker!r}")


# ---- device-aware RESP parse ------------------------------------------------
class _FallbackParse(Exception):
    """The buffer's device-segment layout doesn't line up with RESP
    framing (a device ref mid-line, a bulk body only partially device):
    the caller falls back to the materializing byte path — correct, but
    it pulls, so the transfer witness keeps the hot path honest."""


class _SpanCursor:
    """A logical read cursor over an IOBuf's ref sequence that yields
    host bytes and treats DeviceRef segments as opaque spans.  Nothing
    is consumed from the buffer — the caller pops ``consumed`` bytes
    only once a complete reply parsed."""

    __slots__ = ("refs", "i", "off", "consumed")

    def __init__(self, refs):
        self.refs = refs
        self.i = 0
        self.off = 0
        self.consumed = 0

    def _cur(self):
        while self.i < len(self.refs):
            ref = self.refs[self.i]
            if self.off < ref.length:
                return ref
            self.i += 1
            self.off = 0
        return None

    def at_device(self) -> Optional[DeviceRef]:
        ref = self._cur()
        if isinstance(ref, DeviceRef) and self.off == 0:
            return ref
        return None

    def take_device(self) -> DeviceRef:
        ref = self.refs[self.i]
        self.i += 1
        self.off = 0
        self.consumed += ref.length
        return ref

    def read_host(self, n: int) -> Optional[bytes]:
        """Read exactly n host bytes; None = buffer exhausted (need more
        data); raises _FallbackParse when a device segment intrudes."""
        parts = []
        left = n
        while left > 0:
            ref = self._cur()
            if ref is None:
                return None
            if isinstance(ref, DeviceRef):
                raise _FallbackParse
            take = min(ref.length - self.off, left)
            parts.append(bytes(ref.view()[self.off : self.off + take]))
            self.off += take
            self.consumed += take
            left -= take
        return b"".join(parts)

    def read_line(self) -> Optional[bytes]:
        """Read one CRLF-terminated line of host bytes (without the
        CRLF); None = incomplete."""
        out = bytearray()
        while True:
            ref = self._cur()
            if ref is None:
                return None
            if isinstance(ref, DeviceRef):
                raise _FallbackParse
            v = ref.view()
            span = bytes(v[self.off : ref.length])
            idx = span.find(b"\n")
            if idx < 0:
                out += span
                self.consumed += len(span)
                self.i += 1
                self.off = 0
                if len(out) > 1 << 16:
                    raise ValueError("RESP line too long")
                continue
            out += span[: idx + 1]
            self.off += idx + 1
            self.consumed += idx + 1
            if len(out) < 2 or out[-2:] != b"\r\n":
                raise ValueError("RESP line not CRLF terminated")
            return bytes(out[:-2])


def _parse_value_spans(cur: _SpanCursor, _depth: int = 0) -> Optional[RedisReply]:
    """Parse ONE RESP value at the cursor, keeping device segments
    device-resident: a bulk string whose body is exactly one whole-array
    DeviceRef becomes a reply carrying that ref (zero materialization).
    Returns None when incomplete; raises ValueError on malformed input
    and _FallbackParse on layouts needing the byte path."""
    if _depth > _MAX_NESTING:
        raise ValueError("RESP nesting too deep")
    line = cur.read_line()
    if line is None:
        return None
    if not line:
        raise ValueError("empty RESP line")
    marker, body = line[:1], line[1:]
    if marker == b"+":
        return RedisReply.status(body.decode("utf-8", "replace"))
    if marker == b"-":
        return RedisReply.error(body.decode("utf-8", "replace"))
    if marker == b":":
        return RedisReply.integer(int(body))
    if marker == b"$":
        n = int(body)
        if n == -1:
            return RedisReply.nil()
        if n < 0:
            raise ValueError(f"bad bulk length {n}")
        dev = cur.at_device()
        if dev is not None and dev.length == n and dev.whole_array() is not None:
            ref = cur.take_device()
            tail = cur.read_host(2)
            if tail is None:
                return None
            if tail != b"\r\n":
                raise ValueError("bulk string not CRLF terminated")
            return RedisReply(REPLY_STRING, ref)
        if dev is not None:
            raise _FallbackParse  # windowed/partial device body
        data = cur.read_host(n)
        if data is None:
            return None
        tail = cur.read_host(2)
        if tail is None:
            return None
        if tail != b"\r\n":
            raise ValueError("bulk string not CRLF terminated")
        return RedisReply(REPLY_STRING, data)
    if marker == b"*":
        n = int(body)
        if n == -1:
            return RedisReply(REPLY_ARRAY, None)
        if n < 0:
            raise ValueError(f"bad array length {n}")
        items = []
        for _ in range(n):
            item = _parse_value_spans(cur, _depth + 1)
            if item is None:
                return None
            items.append(item)
        return RedisReply.array(items)
    raise ValueError(f"bad RESP marker {marker!r}")


def parse_device_aware(buf: IOBuf) -> Tuple[Optional[RedisReply], int]:
    """Parse ONE RESP value from a buffer that carries DeviceRef
    segments, WITHOUT materializing them (the ``copy_to`` path would
    pull every HBM value to host just to frame the reply).  Returns
    (reply, consumed); (None, 0) = incomplete.  Raises ValueError on
    malformed input, _FallbackParse when the layout needs the byte
    path.  The caller pops ``consumed`` bytes on success — the reply's
    DeviceRef objects keep their arrays alive independently."""
    cur = _SpanCursor(buf.iter_refs())
    value = _parse_value_spans(cur)
    if value is None:
        return None, 0
    return value, cur.consumed


# ---- client-side messages (reference RedisRequest/RedisResponse) -----------
class RedisRequest:
    def __init__(self):
        # chunks: host bytes interleaved with device arrays — a command
        # component may be an HBM-resident jax.Array (the cache SET
        # ingest path); it rides the wire as a DeviceRef bulk segment
        self._chunks: List = []
        self._count = 0
        self._has_device = False

    def add_command(self, *components) -> bool:
        """add_command("SET", "k", "v") — AddCommand analog (one command
        per call; components are sent verbatim, no quoting needed).
        A component may be a device-resident jax.Array: it is framed as
        a bulk string of its nbytes and shipped as a DeviceRef segment
        (zero-copy over ICI; lazily materialized on host transports)."""
        if not components:
            return False
        host = bytearray(b"*%d\r\n" % len(components))
        for c in components:
            if isinstance(c, str):
                c = c.encode()
            elif isinstance(c, int):
                c = b"%d" % c
            if _is_device_value(c):
                host += b"$%d\r\n" % int(c.nbytes)
                self._chunks.append(bytes(host))
                self._chunks.append(c)
                self._has_device = True
                host = bytearray(b"\r\n")
            else:
                host += b"$%d\r\n%s\r\n" % (len(c), c)
        self._chunks.append(bytes(host))
        self._count += 1
        return True

    @property
    def command_count(self) -> int:
        return self._count

    def clear(self):
        self._chunks = []
        self._count = 0
        self._has_device = False

    def SerializeToString(self) -> bytes:  # Message-compatible surface
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


class RedisResponse:
    def __init__(self):
        self._replies: List[RedisReply] = []

    def reply(self, i: int) -> RedisReply:
        return self._replies[i]

    @property
    def reply_size(self) -> int:
        return len(self._replies)

    def _set_replies(self, replies: List[RedisReply]):
        self._replies = list(replies)

    def ParseFromString(self, data: bytes):  # unused; protocol fills directly
        pass


class _RedisMethodSpec:
    service_name = "redis"
    method_name = "command"
    full_name = "redis.command"
    request_class = RedisRequest
    response_class = RedisResponse


def redis_method_spec() -> _RedisMethodSpec:
    return _RedisMethodSpec()


# ---- protocol callbacks -----------------------------------------------------
class _WireMsg:
    """One parsed wire unit: a reply (client side) or command (server)."""

    __slots__ = ("reply", "command")

    def __init__(self, reply=None, command=None):
        self.reply = reply
        self.command = command


def parse(buf: IOBuf, sock, read_eof: bool) -> ParseResult:
    if buf.has_device_payload():
        # device-resident segments in the frame: the span parser keeps
        # them in HBM (fetch/copy_to below would pull them to host just
        # to frame the reply)
        first = next(iter(buf.iter_refs()), None)
        if isinstance(first, DeviceRef):
            return ParseResult.bad()  # RESP never starts mid-payload
        try:
            value, consumed = parse_device_aware(buf)
        except _FallbackParse:
            value, consumed = None, -1  # materializing path below
        except (ValueError, IndexError, RecursionError):
            return ParseResult.bad()
        if consumed >= 0:
            if value is None:
                return ParseResult.not_enough()
            buf.pop_front(consumed)
            if sock.is_server_side:
                if value.type != REPLY_ARRAY or not value.value:
                    return ParseResult.bad()
                return ParseResult.ok(_WireMsg(command=value))
            return ParseResult.ok(_WireMsg(reply=value))
    head = buf.fetch(1)
    if not head:
        return ParseResult.not_enough()
    if sock.is_server_side:
        if head not in (b"*",):  # clients speak RESP arrays (or inline, unsupported)
            return ParseResult.try_others()
    else:
        if head not in (b"+", b"-", b":", b"$", b"*"):
            return ParseResult.try_others()
    # bound the copy: one reply is usually tiny, and copying the whole
    # buffer per cut makes a large pipelined batch O(N^2). Retry with
    # the full buffer only when a genuinely big reply needs it.
    limit = 1 << 16
    data = buf.copy_to(min(len(buf), limit))
    try:
        value, pos = parse_reply(data, 0)
        if value is None and len(buf) > limit:
            data = buf.copy_to(len(buf))
            value, pos = parse_reply(data, 0)
    except (ValueError, IndexError, RecursionError):
        return ParseResult.bad()
    if value is None:
        return ParseResult.not_enough()
    buf.pop_front(pos)
    if sock.is_server_side:
        if value.type != REPLY_ARRAY or not value.value:
            return ParseResult.bad()
        return ParseResult.ok(_WireMsg(command=value))
    return ParseResult.ok(_WireMsg(reply=value))


def serialize_request(request: RedisRequest, controller) -> IOBuf:
    if request.command_count == 0:
        raise ValueError("RedisRequest has no commands")
    controller._redis_count = request.command_count
    return request.serialize_iobuf()


def pack_request(request_buf: IOBuf, wire_cid: int, method_spec, controller) -> IOBuf:
    count = getattr(controller, "_redis_count", 1)
    packet = IOBuf()
    channel = controller._channel
    auth = channel.options.auth if channel is not None else None
    if auth is not None:
        # The first command on a credentialed connection must be AUTH
        # (the server's verify gate demands it). The credential is
        # computed here (raising fails the RPC), but WHICH writer
        # prepends it is decided inside Socket.write under the write
        # lock — deciding here would let a concurrent packet overtake
        # the AUTH and hit the gate unauthenticated. cid 0 = delivery
        # discards the +OK.
        cred = auth.generate_credential()
        controller._conn_preamble = (IOBuf(pack_command("AUTH", cred)), [(0, 1)])
    packet.append(request_buf)
    # FIFO entries register inside the write, atomic with queue order
    controller._pipelined_entries = [(wire_cid, count)]
    return packet


def process_response(msg: _WireMsg, sock) -> None:
    """Accumulate replies for the FIFO-front RPC; deliver at count."""
    from incubator_brpc_tpu_torch.protocols import accumulate_pipelined

    done = accumulate_pipelined(sock, msg.reply)
    if done is None:
        return
    cid, replies = done
    if not cid:
        return  # cid 0: protocol-internal command (AUTH), discard reply
    pool = _id_pool()
    ctrl = pool.lock(cid)
    if ctrl is None:
        return
    if ctrl._response is not None:
        ctrl._response._set_replies(replies)
    first_err = next((r for r in replies if r.is_error()), None)
    if first_err is not None and len(replies) == 1:
        # single-command convenience: surface the error on the controller
        # (multi-command pipelines inspect per-reply errors themselves).
        # An -OVERCROWDED reply is the server's admission shed riding
        # RESP: map it back to the retry-elsewhere code so LB feedback
        # (on_shed) and the retry policy treat it like any other shed.
        text = str(first_err.value)
        if text.startswith("OVERCROWDED"):
            ctrl.set_failed(errors.EOVERCROWDED, text)
        else:
            ctrl.set_failed(errors.ERESPONSE, text)
    ctrl._finalize_locked(cid)


# ---- server side (reference redis.h RedisService) ---------------------------
class RedisService:
    """Subclass and define lower-case methods named after commands:

        class KV(RedisService):
            def get(self, key): return self._d.get(key)
            def set(self, key, value): self._d[key] = value; return "OK"

    Return values coerce: str→bulk, "OK"-style statuses via
    RedisReply.status, int→integer, None→nil, list→array, RedisReply
    passthrough. Unknown commands answer -ERR unknown command."""

    def handle(self, command: str, args: List[bytes]) -> RedisReply:
        fn = getattr(self, command.lower(), None)
        if fn is None or command.startswith("_") or command.lower() == "handle":
            return RedisReply.error(f"ERR unknown command '{command}'")
        try:
            return _coerce_reply(fn(*args))
        except TypeError as e:
            return RedisReply.error(f"ERR wrong number of arguments: {e}")
        except Exception as e:  # noqa: BLE001
            log_error("redis handler %s raised: %r", command, e)
            return RedisReply.error(f"ERR internal: {e}")

    # defaults everyone expects
    def ping(self, *args):
        if args:
            return RedisReply.bulk(args[0])
        return RedisReply.status("PONG")

    def auth(self, *args):
        # reaching here means the connection's verify gate passed (or no
        # authenticator is configured): acknowledge
        return RedisReply.status("OK")


class KVRedisService(RedisService):
    """In-memory key/value RedisService (the reference redis_server
    example's CommandHandler set, as a service).

    On a native-engine server this flags ``native_kv``: the C++ engine
    answers GET/SET/DEL/EXISTS/INCR/PING from its own sharded map with
    zero Python per command, and only unrecognized commands reach the
    Python methods below.  NOTE the two stores are separate — when the
    engine serves the hot commands, the Python dict here only ever sees
    keys touched by fallback commands.  On the Python transport this
    class is a complete working KV."""

    native_kv = True

    def __init__(self):
        self._d = {}
        self._lock = __import__("threading").Lock()

    def set(self, key, value):
        with self._lock:
            self._d[bytes(key)] = bytes(value)
        return RedisReply.status("OK")

    def get(self, key):
        with self._lock:
            return self._d.get(bytes(key))

    def delete(self, *keys):  # DEL is a python keyword
        with self._lock:
            return sum(1 for k in keys if self._d.pop(bytes(k), None) is not None)

    # RedisService.handle dispatches on the lower-cased command name;
    # map the wire name DEL onto delete()
    def handle(self, command: str, args) -> RedisReply:
        if command.upper() == "DEL":
            return _coerce_reply(self.delete(*args))
        return super().handle(command, args)

    def exists(self, key):
        with self._lock:
            return 1 if bytes(key) in self._d else 0

    def incr(self, key):
        with self._lock:
            k = bytes(key)
            try:
                cur = int(self._d.get(k, b"0"))
            except ValueError:
                return RedisReply.error(
                    "ERR value is not an integer or out of range"
                )
            cur += 1
            self._d[k] = str(cur).encode()
            return cur


def _command_bytes(part) -> Optional[bytes]:
    """A RESP command element must be a bulk string; anything else
    (an integer, a nested array) is a protocol violation, not a crash.
    A device-resident bulk passes its DeviceRef through untouched (the
    cache SET ingest path adopts the array without materializing)."""
    if part.type != REPLY_STRING:
        return None
    if _is_device_value(part.value):
        return part.value
    return part.value or b""


def process_request(msg: _WireMsg, sock) -> None:
    server = sock.server
    service = getattr(getattr(server, "options", None), "redis_service", None)
    parts = msg.command.value
    name = _command_bytes(parts[0])
    ticket = None
    if service is None:
        reply = RedisReply.error("ERR this server speaks no redis")
    elif name is None or not isinstance(name, bytes):
        reply = RedisReply.error("ERR protocol error: command not a bulk string")
    else:
        cmd = name.decode("utf-8", "replace")
        # unified admission decision point (server/admission.py): redis
        # traffic — the cache tier's data plane — sheds like every
        # other protocol.  RESP has no meta error channel, so the
        # retry-elsewhere code rides an -OVERCROWDED error reply that
        # process_response maps back onto EOVERCROWDED (which is what
        # feeds tier-aware LB shed signals client-side).
        verdict = server.admission.admit(f"redis.{cmd.upper()}", None)
        if not verdict.admitted:
            if verdict.code == errors.EOVERCROWDED:
                reply = RedisReply.error(
                    f"OVERCROWDED {verdict.reason or 'admission shed'}"
                )
            else:
                reply = RedisReply.error(
                    f"ERR busy: {verdict.reason or 'admission drop'}"
                )
        else:
            ticket = verdict.ticket
            args = [_command_bytes(p) for p in parts[1:]]
            # connection-aware services (the HBM cache tier) see the
            # socket to decide device-resident vs host-materialized
            # replies
            handler = getattr(service, "handle_conn", None)
            try:
                if handler is not None:
                    reply = handler(cmd, args, sock)
                else:
                    reply = service.handle(cmd, args)
            except BaseException:
                if ticket is not None:
                    ticket.release()
                raise
    out = IOBuf()
    pack_reply_into(reply, out)
    sock.write(out, ignore_eovercrowded=True)
    if ticket is not None:
        ticket.release()


def verify(msg: _WireMsg, sock) -> bool:
    """AUTH-command authentication doesn't fit the first-message
    credential model; a redis-speaking server with a brpc Authenticator
    validates the first command being AUTH <credential>."""
    server = sock.server
    auth = getattr(getattr(server, "options", None), "auth", None)
    if auth is None:
        return True
    parts = msg.command.value if msg.command else None
    if not parts or len(parts) < 2:
        return False
    name = _command_bytes(parts[0])
    cred_b = _command_bytes(parts[1])
    if name is None or cred_b is None or name.upper() != b"AUTH":
        return False
    from incubator_brpc_tpu_torch.protocols import _call_verify_credential

    rc, _ = _call_verify_credential(auth, cred_b.decode("utf-8", "replace"), sock)
    return rc == 0


PROTOCOL = Protocol(
    name="redis",
    parse=parse,
    serialize_request=serialize_request,
    pack_request=pack_request,
    process_request=process_request,
    process_response=process_response,
    verify=verify,
    support_pipelined=True,
    # RESP has no correlation ids: replies must leave in arrival order
    process_ordered=True,
)


def register():
    register_protocol(PROTOCOL)
