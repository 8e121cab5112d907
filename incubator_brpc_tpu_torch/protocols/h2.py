"""HTTP/2 + gRPC — framed, multiplexed RPC on one connection.

Analog of reference policy/http2_rpc_protocol.cpp (1,835 LoC client+
server) with gRPC semantics from grpc.{h,cpp} (grpc-timeout parsing,
grpc-status mapping). Framing per RFC 7540: SETTINGS / HEADERS /
CONTINUATION / DATA / RST_STREAM / WINDOW_UPDATE / PING / GOAWAY, with
connection + per-stream flow-control windows. Header blocks ride HPACK
(protocols/hpack.py) — one encoder and one decoder per connection, so
all sends serialize under the connection's send lock.

gRPC mapping: request = HEADERS(:method POST, :path /Service/Method,
content-type application/grpc, grpc-timeout) + DATA(1-byte compress
flag + u32 BE length + payload pb); response = HEADERS(:status 200) +
DATA + trailers HEADERS(grpc-status, grpc-message). One server port
speaks h2 alongside tpu_std/http: the parser claims the connection on
the h2 client preface magic.
"""

from __future__ import annotations

import struct
import threading
from typing import Dict, List, Optional, Tuple

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.protocols import ParseResult, Protocol, register_protocol
from incubator_brpc_tpu_torch.protocols.hpack import HpackDecoder, HpackEncoder
from incubator_brpc_tpu_torch.runtime.call_id import default_pool as _id_pool
from incubator_brpc_tpu_torch.utils.iobuf import IOBuf
from incubator_brpc_tpu_torch.utils.logging import log_error, log_verbose

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# frame types (RFC 7540 §6)
DATA = 0x0
HEADERS = 0x1
PRIORITY = 0x2
RST_STREAM = 0x3
SETTINGS = 0x4
PUSH_PROMISE = 0x5
PING = 0x6
GOAWAY = 0x7
WINDOW_UPDATE = 0x8
CONTINUATION = 0x9

# flags
FLAG_END_STREAM = 0x1  # DATA/HEADERS
FLAG_ACK = 0x1  # SETTINGS/PING
FLAG_END_HEADERS = 0x4
FLAG_PADDED = 0x8
FLAG_PRIORITY = 0x20

# settings ids
SETTINGS_HEADER_TABLE_SIZE = 0x1
SETTINGS_MAX_CONCURRENT_STREAMS = 0x3
SETTINGS_INITIAL_WINDOW_SIZE = 0x4
SETTINGS_MAX_FRAME_SIZE = 0x5

DEFAULT_WINDOW = 65535
DEFAULT_FRAME_SIZE = 16384
# we advertise (and replenish to) a large receive window: RPC payloads
# are bulk tensors, not browser streams
RECV_WINDOW = 1 << 24
# streams we accept concurrently per connection (advertised + enforced)
MAX_CONCURRENT_STREAMS = 128
# RST_STREAM error codes (RFC 7540 §7)
H2_REFUSED_STREAM = 0x7

# gRPC status codes (subset used for mapping)
GRPC_OK = 0
GRPC_UNKNOWN = 2
GRPC_DEADLINE_EXCEEDED = 4
GRPC_NOT_FOUND = 5
GRPC_RESOURCE_EXHAUSTED = 8
GRPC_OUT_OF_RANGE = 11
GRPC_UNIMPLEMENTED = 12
GRPC_UNAVAILABLE = 14
GRPC_UNAUTHENTICATED = 16


def _grpc_status_of(error_code: int) -> int:
    return {
        0: GRPC_OK,
        errors.ERPCTIMEDOUT: GRPC_DEADLINE_EXCEEDED,
        errors.ENOSERVICE: GRPC_UNIMPLEMENTED,
        errors.ENOMETHOD: GRPC_UNIMPLEMENTED,
        # the drop-vs-retry split (docs/overload.md) must survive the
        # h2 hop: ELIMIT ("request expired while queued — drop") rides
        # OUT_OF_RANGE so it cannot collapse into the retriable
        # RESOURCE_EXHAUSTED that EOVERCROWDED sheds use
        errors.ELIMIT: GRPC_OUT_OF_RANGE,
        errors.EOVERCROWDED: GRPC_RESOURCE_EXHAUSTED,
        errors.ELOGOFF: GRPC_UNAVAILABLE,
        errors.ERPCAUTH: GRPC_UNAUTHENTICATED,
    }.get(error_code, GRPC_UNKNOWN)


def _error_of_grpc(status: int) -> int:
    return {
        GRPC_OK: 0,
        GRPC_DEADLINE_EXCEEDED: errors.ERPCTIMEDOUT,
        GRPC_UNIMPLEMENTED: errors.ENOMETHOD,
        # RESOURCE_EXHAUSTED is what the server sends for ADMISSION
        # sheds: decode as EOVERCROWDED (retry elsewhere —
        # docs/overload.md code mapping), not ELIMIT (drop) — mapping
        # it to the drop code would make grpc overload rejections
        # non-retriable while tpu_std's reissue against another replica
        GRPC_RESOURCE_EXHAUSTED: errors.EOVERCROWDED,
        GRPC_OUT_OF_RANGE: errors.ELIMIT,
        GRPC_UNAVAILABLE: errors.ELOGOFF,
        GRPC_UNAUTHENTICATED: errors.ERPCAUTH,
    }.get(status, errors.ERESPONSE)


def pack_frame(ftype: int, flags: int, stream_id: int, payload: bytes = b"") -> bytes:
    return (
        struct.pack(">I", len(payload))[1:]
        + bytes((ftype, flags))
        + struct.pack(">I", stream_id & 0x7FFFFFFF)
        + payload
    )


class H2Stream:
    __slots__ = (
        "sid", "headers", "trailers", "data", "end_stream", "cid",
        "send_window", "pending_out", "sent_end", "pending_trailers",
    )

    def __init__(self, sid: int, initial_window: int):
        self.sid = sid
        self.headers: Optional[List[Tuple[str, str]]] = None
        self.trailers: Optional[List[Tuple[str, str]]] = None
        self.data = IOBuf()
        self.end_stream = False
        self.cid = 0  # client-side correlation
        self.send_window = initial_window
        self.pending_out = IOBuf()  # DATA bytes waiting for window
        self.sent_end = False
        # trailers to emit AFTER pending_out fully drains: sending them
        # eagerly while DATA is parked on flow control would truncate
        # the response (trailers-before-data) — encoded lazily at drain
        # time so HPACK order equals wire order
        self.pending_trailers: Optional[List[Tuple[str, str]]] = None


class H2Context:
    """Per-connection HTTP/2 state (the reference's H2Context on
    Socket::parsing_context)."""

    def __init__(self, sock, is_server: bool):
        self.sock = sock
        self.is_server = is_server
        self.encoder = HpackEncoder()
        self.decoder = HpackDecoder()
        self.send_lock = threading.RLock()  # orders HPACK encode + write
        self.streams: Dict[int, H2Stream] = {}
        self.next_stream_id = 1 if not is_server else 2
        self.peer_frame_size = DEFAULT_FRAME_SIZE
        self.peer_initial_window = DEFAULT_WINDOW
        self.peer_max_streams = 1 << 30  # until peer's SETTINGS says less
        self.max_concurrent_streams = MAX_CONCURRENT_STREAMS  # we enforce
        self.conn_send_window = DEFAULT_WINDOW
        self.conn_recv_consumed = 0
        self.goaway_received = False
        self.preface_sent = False
        self.settings_sent = False
        # header-block assembly (HEADERS + CONTINUATION*)
        self.assembling_sid = 0
        self.assembling = b""
        self.assembling_flags = 0
        self.goaway_sent = False

    # ---- sending ------------------------------------------------------------
    def ensure_preface(self):
        """Client magic + both sides' initial SETTINGS (first use)."""
        out = b""
        if not self.is_server and not self.preface_sent:
            self.preface_sent = True
            out += PREFACE
        if not self.settings_sent:
            self.settings_sent = True
            out += pack_frame(
                SETTINGS,
                0,
                0,
                struct.pack(">HI", SETTINGS_INITIAL_WINDOW_SIZE, RECV_WINDOW)
                + struct.pack(">HI", SETTINGS_MAX_FRAME_SIZE, DEFAULT_FRAME_SIZE)
                + struct.pack(
                    ">HI", SETTINGS_MAX_CONCURRENT_STREAMS, self.max_concurrent_streams
                ),
            )
            # grow the connection-level receive window
            out += pack_frame(
                WINDOW_UPDATE, 0, 0, struct.pack(">I", RECV_WINDOW - DEFAULT_WINDOW)
            )
        return out

    def send_headers(
        self, sid: int, headers: List[Tuple[str, str]], end_stream: bool
    ) -> bytes:
        block = self.encoder.encode(headers)
        flags = FLAG_END_HEADERS | (FLAG_END_STREAM if end_stream else 0)
        return pack_frame(HEADERS, flags, sid, block)

    def data_frames(self, stream: H2Stream, data: IOBuf, end_stream: bool) -> bytes:
        """Chunk DATA to frame-size and available windows; excess parks
        in stream.pending_out (drained by WINDOW_UPDATE)."""
        stream.pending_out.append(data)
        if end_stream:
            stream.sent_end = True
        return self._drain_stream(stream)

    def _drain_stream(self, stream: H2Stream) -> bytes:
        out = b""
        while not stream.pending_out.empty():
            budget = min(
                self.peer_frame_size, stream.send_window, self.conn_send_window
            )
            if budget <= 0:
                return out
            chunk = IOBuf()
            stream.pending_out.cutn(chunk, budget)
            n = len(chunk)
            stream.send_window -= n
            self.conn_send_window -= n
            last = (
                stream.pending_out.empty()
                and stream.sent_end
                and stream.pending_trailers is None
            )
            out += pack_frame(
                DATA, FLAG_END_STREAM if last else 0, stream.sid, chunk.to_bytes()
            )
        if stream.pending_out.empty() and stream.pending_trailers is not None:
            # all DATA flushed: NOW the trailers may go (encoding here,
            # under send_lock, keeps HPACK order == wire order) and the
            # stream may leave the table (WINDOW_UPDATE no longer needed)
            trailers = stream.pending_trailers
            stream.pending_trailers = None
            out += self.send_headers(stream.sid, trailers, end_stream=True)
            self.streams.pop(stream.sid, None)
        return out

    def drain_all(self) -> bytes:
        out = b""
        for stream in list(self.streams.values()):
            if not stream.pending_out.empty():
                out += self._drain_stream(stream)
        return out

    def write(self, payload: bytes) -> int:
        if not payload:
            return 0
        return self.sock.write(IOBuf(payload), ignore_eovercrowded=True)


_ctx_create_lock = threading.Lock()


def _ctx(sock, is_server: bool) -> H2Context:
    ctx = getattr(sock, "h2_ctx", None)
    if ctx is None:
        with _ctx_create_lock:
            ctx = getattr(sock, "h2_ctx", None)
            if ctx is None:
                ctx = H2Context(sock, is_server)
                sock.h2_ctx = ctx
    return ctx


# ---- parse (both sides) -----------------------------------------------------
class H2Frame:
    __slots__ = ("ftype", "flags", "sid", "payload")

    def __init__(self, ftype, flags, sid, payload):
        self.ftype = ftype
        self.flags = flags
        self.sid = sid
        self.payload = payload


def parse(buf: IOBuf, sock, read_eof: bool) -> ParseResult:
    ctx = getattr(sock, "h2_ctx", None)
    if ctx is None:
        if not sock.is_server_side:
            return ParseResult.try_others()
        # server: claim the connection iff it opens with the h2 preface
        head = buf.fetch(min(len(buf), len(PREFACE)))
        if head is None or not PREFACE.startswith(head):
            return ParseResult.try_others()
        if len(head) < len(PREFACE):
            return ParseResult.not_enough()
        buf.pop_front(len(PREFACE))
        ctx = _ctx(sock, is_server=True)
        with ctx.send_lock:
            ctx.write(ctx.ensure_preface())
    header = buf.fetch(9)
    if header is None:
        return ParseResult.not_enough()
    length = int.from_bytes(header[:3], "big")
    if length > (1 << 24) - 1:
        return ParseResult.bad()
    if len(buf) < 9 + length:
        return ParseResult.not_enough()
    buf.pop_front(9)
    payload = buf.cut_bytes(length)
    ftype, flags = header[3], header[4]
    sid = struct.unpack(">I", header[5:9])[0] & 0x7FFFFFFF
    return ParseResult.ok(H2Frame(ftype, flags, sid, payload))


# ---- frame processing (in place — frames are ordered) ----------------------
def process_frame(frame: H2Frame, sock) -> None:
    ctx = getattr(sock, "h2_ctx", None)
    if ctx is None:
        return
    try:
        _process_frame(ctx, frame, sock)
    except Exception as e:  # noqa: BLE001
        log_error("h2 frame processing failed: %r", e)
        sock.set_failed(errors.EREQUEST, f"h2 error: {e}")


def _process_frame(ctx: H2Context, frame: H2Frame, sock) -> None:
    ftype = frame.ftype
    if ctx.assembling_sid and ftype != CONTINUATION:
        sock.set_failed(errors.EREQUEST, "expected CONTINUATION")
        return
    if ftype == SETTINGS:
        _on_settings(ctx, frame)
    elif ftype in (HEADERS, CONTINUATION):
        _on_headers(ctx, frame, sock)
    elif ftype == DATA:
        _on_data(ctx, frame, sock)
    elif ftype == WINDOW_UPDATE:
        if len(frame.payload) == 4:
            inc = struct.unpack(">I", frame.payload)[0] & 0x7FFFFFFF
            with ctx.send_lock:
                if frame.sid == 0:
                    ctx.conn_send_window += inc
                else:
                    stream = ctx.streams.get(frame.sid)
                    if stream is not None:
                        stream.send_window += inc
                ctx.write(ctx.drain_all())
    elif ftype == RST_STREAM:
        code = struct.unpack(">I", frame.payload)[0] if len(frame.payload) == 4 else 0
        _on_rst(ctx, frame.sid, code)
    elif ftype == PING:
        if not frame.flags & FLAG_ACK:
            with ctx.send_lock:
                ctx.write(pack_frame(PING, FLAG_ACK, 0, frame.payload))
    elif ftype == GOAWAY:
        _on_goaway(ctx, frame, sock)
    elif ftype in (PRIORITY, PUSH_PROMISE):
        pass  # tolerated, unused
    else:
        log_verbose("h2: ignoring unknown frame type %d", ftype)


def _on_settings(ctx: H2Context, frame: H2Frame) -> None:
    if frame.flags & FLAG_ACK:
        return
    payload = frame.payload
    # apply under send_lock: send_window/encoder state is concurrently
    # read-modify-written by _drain_stream on writer threads
    with ctx.send_lock:
        for off in range(0, len(payload) - 5, 6):
            ident, value = struct.unpack_from(">HI", payload, off)
            if ident == SETTINGS_MAX_FRAME_SIZE:
                ctx.peer_frame_size = max(DEFAULT_FRAME_SIZE, min(value, 1 << 24))
            elif ident == SETTINGS_INITIAL_WINDOW_SIZE:
                delta = value - ctx.peer_initial_window
                ctx.peer_initial_window = value
                for stream in ctx.streams.values():
                    stream.send_window += delta
            elif ident == SETTINGS_HEADER_TABLE_SIZE:
                ctx.encoder.set_max_table_size(value)
            elif ident == SETTINGS_MAX_CONCURRENT_STREAMS:
                ctx.peer_max_streams = value
        ctx.write(ctx.ensure_preface() + pack_frame(SETTINGS, FLAG_ACK, 0))


def _strip_padding_priority(frame: H2Frame) -> bytes:
    payload = frame.payload
    if frame.flags & FLAG_PADDED:
        pad = payload[0]
        payload = payload[1 : len(payload) - pad]
    if frame.ftype == HEADERS and frame.flags & FLAG_PRIORITY:
        payload = payload[5:]
    return payload


def _on_headers(ctx: H2Context, frame: H2Frame, sock) -> None:
    if frame.ftype == HEADERS:
        ctx.assembling_sid = frame.sid
        ctx.assembling = _strip_padding_priority(frame)
        ctx.assembling_flags = frame.flags
    else:  # CONTINUATION
        if frame.sid != ctx.assembling_sid:
            sock.set_failed(errors.EREQUEST, "CONTINUATION stream mismatch")
            return
        ctx.assembling += frame.payload
        ctx.assembling_flags |= frame.flags & FLAG_END_HEADERS
    if not ctx.assembling_flags & FLAG_END_HEADERS:
        return
    sid = ctx.assembling_sid
    block, flags = ctx.assembling, ctx.assembling_flags
    ctx.assembling_sid, ctx.assembling = 0, b""
    headers = ctx.decoder.decode(block)
    stream = ctx.streams.get(sid)
    if stream is None:
        if ctx.is_server and len(ctx.streams) >= ctx.max_concurrent_streams:
            # enforce our advertised SETTINGS_MAX_CONCURRENT_STREAMS:
            # refuse (retriable) instead of queueing unbounded work
            with ctx.send_lock:
                ctx.write(
                    pack_frame(
                        RST_STREAM, 0, sid, struct.pack(">I", H2_REFUSED_STREAM)
                    )
                )
            return
        stream = H2Stream(sid, ctx.peer_initial_window)
        ctx.streams[sid] = stream
    if stream.headers is None:
        stream.headers = headers
    else:
        stream.trailers = headers
    if flags & FLAG_END_STREAM:
        stream.end_stream = True
        _on_stream_complete(ctx, stream, sock)


def _on_data(ctx: H2Context, frame: H2Frame, sock) -> None:
    stream = ctx.streams.get(frame.sid)
    payload = _strip_padding_priority(frame)
    n = len(frame.payload)
    if stream is None:
        # DATA racing a local RST/completed stream still consumed
        # connection window: replenish it or the peer's view of the
        # connection send window leaks by n per orphan frame
        if n:
            with ctx.send_lock:
                ctx.write(pack_frame(WINDOW_UPDATE, 0, 0, struct.pack(">I", n)))
        return
    stream.data.append(payload)
    # replenish receive windows eagerly (bulk-RPC profile)
    if n:
        with ctx.send_lock:
            ctx.write(
                pack_frame(WINDOW_UPDATE, 0, 0, struct.pack(">I", n))
                + pack_frame(WINDOW_UPDATE, 0, frame.sid, struct.pack(">I", n))
            )
    if frame.flags & FLAG_END_STREAM:
        stream.end_stream = True
        _on_stream_complete(ctx, stream, sock)


def _on_rst(ctx: H2Context, sid: int, code: int) -> None:
    stream = ctx.streams.pop(sid, None)
    if stream is None:
        return
    if not ctx.is_server and stream.cid:
        _id_pool().error(
            stream.cid, errors.ECLOSE, f"h2 stream reset (code {code})"
        )
    _finish_goaway_drain(ctx)


def _on_goaway(ctx: H2Context, frame: H2Frame, sock) -> None:
    """Graceful GOAWAY (RFC 7540 §6.8): streams the peer promises to
    process (sid <= last_stream_id) keep running; only streams above it
    fail (retriable — they were provably unprocessed). The connection
    drains and dies when the survivors complete."""
    last_sid = (
        struct.unpack(">I", frame.payload[:4])[0] & 0x7FFFFFFF
        if len(frame.payload) >= 4
        else 0
    )
    # flag + sweep under send_lock: issue() checks goaway_received under
    # the same lock, so no new stream can slip between the check and the
    # sweep (it either sees the flag and refuses, or is already in
    # ctx.streams when the sweep runs)
    victims = []
    with ctx.send_lock:
        ctx.goaway_received = True
        sock.draining = True  # SocketMap stops handing this connection out
        if not ctx.is_server:
            for sid in list(ctx.streams):
                if sid > last_sid:
                    stream = ctx.streams.pop(sid, None)
                    if stream is not None and stream.cid:
                        victims.append(stream.cid)
    for cid in victims:
        _id_pool().error(cid, errors.EFAILEDSOCKET, "h2 GOAWAY refused stream")
    _finish_goaway_drain(ctx)


def _finish_goaway_drain(ctx: H2Context) -> None:
    if ctx.goaway_received and not ctx.streams and not ctx.sock.failed:
        ctx.sock.set_failed(errors.ECLOSE, "h2 connection drained after GOAWAY")


def send_goaway(sock) -> None:
    """Server-initiated graceful shutdown notice on an h2 connection."""
    ctx = getattr(sock, "h2_ctx", None)
    if ctx is None or ctx.goaway_sent:
        return
    ctx.goaway_sent = True
    last = max((sid for sid in ctx.streams), default=0)
    with ctx.send_lock:
        ctx.write(pack_frame(GOAWAY, 0, 0, struct.pack(">II", last, 0)))


# ---- gRPC message framing ---------------------------------------------------
def _grpc_wrap(payload: IOBuf) -> IOBuf:
    out = IOBuf(struct.pack(">BI", 0, len(payload)))
    out.append(payload)
    return out


def _grpc_unwrap(data: IOBuf) -> Optional[bytes]:
    if len(data) < 5:
        return b"" if len(data) == 0 else None
    head = data.cut_bytes(5)
    flag, length = struct.unpack(">BI", head)
    if flag & 1:
        return None  # compressed grpc messages unsupported (no codec negotiated)
    body = data.cut_bytes(length)
    return body if len(body) == length else None


def _header(headers: List[Tuple[str, str]], name: str, default: str = "") -> str:
    for n, v in headers:
        if n == name:
            return v
    return default


def _grpc_timeout_value(timeout_ms) -> str:
    return f"{max(1, int(timeout_ms))}m"


def _parse_grpc_timeout(value: str) -> Optional[int]:
    """→ milliseconds (reference grpc.cpp ParseTimeoutFromHeader)."""
    if not value:
        return None
    unit = value[-1]
    try:
        n = int(value[:-1])
    except ValueError:
        return None
    scale = {"H": 3600000, "M": 60000, "S": 1000, "m": 1, "u": 0.001, "n": 1e-6}
    if unit not in scale:
        return None
    return max(1, int(n * scale[unit]))


# ---- client side ------------------------------------------------------------
def serialize_request(request, controller) -> IOBuf:
    return IOBuf(request.SerializeToString())


def issue(sock, request_buf: IOBuf, wire_cid: int, method_spec, controller) -> None:
    """Pack + write one gRPC request atomically on the connection
    (HPACK encode order must equal wire order)."""
    ctx = _ctx(sock, is_server=False)
    path = f"/{method_spec.service_name}/{method_spec.method_name}"
    authority = str(sock.remote or "host")
    headers = [
        (":method", "POST"),
        (":scheme", "http"),
        (":path", path),
        (":authority", authority),
        ("content-type", "application/grpc"),
        ("te", "trailers"),
    ]
    if controller.timeout_ms:
        headers.append(("grpc-timeout", _grpc_timeout_value(controller.timeout_ms)))
    tenant = controller.__dict__.get("tenant")
    if tenant:
        # tenant identity for server-side admission (docs/overload.md)
        headers.append(("x-tpu-tenant", tenant))
    channel = controller._channel
    auth = channel.options.auth if channel is not None else None
    if auth is not None:
        cred = auth.generate_credential()  # raising fails the RPC (issue_rpc)
        if cred:
            if "\r" in cred or "\n" in cred:
                raise ValueError("credential contains CR/LF")
            headers.append(("authorization", cred))
    body = _grpc_wrap(request_buf)
    with ctx.send_lock:
        if ctx.goaway_received:
            _id_pool().error(
                wire_cid, errors.EFAILEDSOCKET, "h2 connection is draining (GOAWAY)"
            )
            return
        if len(ctx.streams) >= ctx.peer_max_streams:
            # peer's SETTINGS_MAX_CONCURRENT_STREAMS reached: backpressure
            _id_pool().error(
                wire_cid, errors.EOVERCROWDED, "h2 peer max_concurrent_streams"
            )
            return
        out = ctx.ensure_preface()
        sid = ctx.next_stream_id
        ctx.next_stream_id += 2
        stream = H2Stream(sid, ctx.peer_initial_window)
        stream.cid = wire_cid
        ctx.streams[sid] = stream
        sock.add_response_waiter(wire_cid)
        out += ctx.send_headers(sid, headers, end_stream=False)
        out += ctx.data_frames(stream, body, end_stream=True)
        rc = ctx.write(out)
    if rc:
        _id_pool().error(wire_cid, rc, "h2 write failed")


def _complete_client_stream(ctx: H2Context, stream: H2Stream, sock) -> None:
    ctx.streams.pop(stream.sid, None)
    cid = stream.cid
    if cid:
        # remove the waiter BEFORE the goaway drain check: the drain's
        # set_failed sweeps waiting_cids, and erroring this cid would
        # discard the response we are holding (retry of a done RPC)
        sock.remove_response_waiter(cid)
    _finish_goaway_drain(ctx)
    if cid:
        _deliver_client_stream(ctx, stream, sock, cid)


def _deliver_client_stream(ctx: H2Context, stream: H2Stream, sock, cid) -> None:
    from incubator_brpc_tpu_torch.transport.event_dispatcher import in_dispatcher

    pool = _id_pool()
    if in_dispatcher():
        # never block the event loop on a contended id (timeout/retry
        # handlers hold it briefly): re-dispatch to a worker — a stall
        # here would freeze every socket on this dispatcher
        ctrl = pool.try_lock(cid)
        if ctrl is type(pool).BUSY:
            from incubator_brpc_tpu_torch.runtime import scheduler

            scheduler.spawn(_deliver_client_stream, ctx, stream, sock, cid)
            return
    else:
        ctrl = pool.lock(cid)
    if ctrl is None:
        return
    headers = stream.headers or []
    trailers = stream.trailers if stream.trailers is not None else headers
    status = _header(headers, ":status", "200")
    grpc_status = _header(trailers, "grpc-status", "")
    grpc_message = _header(trailers, "grpc-message", "")
    if status != "200":
        ctrl.set_failed(errors.EHTTP, f"h2 :status {status}")
        ctrl._finalize_locked(cid)
        return
    if grpc_status not in ("", "0"):
        # a malformed grpc-status fails THIS rpc, not the connection
        try:
            mapped = _error_of_grpc(int(grpc_status))
        except ValueError:
            mapped = errors.ERESPONSE
            grpc_message = grpc_message or f"malformed grpc-status {grpc_status!r}"
        # server-returned retriable codes (an EOVERCROWDED admission
        # shed decoded from RESOURCE_EXHAUSTED) re-enter the same
        # retry arbitration as on tpu_std: the shedding replica joins
        # the exclusion set and the reissue lands elsewhere
        ctrl._error_from_server = True
        if mapped not in (
            errors.ERPCTIMEDOUT, errors.ECANCELED, errors.ERESPONSE
        ) and ctrl._try_retry_locked(
            cid, mapped, grpc_message or f"grpc-status {grpc_status}"
        ):
            return
        ctrl.set_failed(mapped, grpc_message or f"grpc-status {grpc_status}")
        ctrl._finalize_locked(cid)
        return
    body = _grpc_unwrap(stream.data)
    if body is None:
        ctrl.set_failed(errors.ERESPONSE, "bad grpc message framing")
        ctrl._finalize_locked(cid)
        return
    try:
        if ctrl._response is not None:
            ctrl._response.ParseFromString(body)
    except Exception as e:  # noqa: BLE001
        ctrl.set_failed(errors.ERESPONSE, f"parse response failed: {e}")
    ctrl._finalize_locked(cid)


# ---- server side ------------------------------------------------------------
def _on_stream_complete(ctx: H2Context, stream: H2Stream, sock) -> None:
    if ctx.is_server:
        # user code runs OFF the connection's ordered frame loop: one
        # slow handler must not stall the other streams multiplexed on
        # this connection (reference dispatches each stream to a
        # bthread, policy/http2_rpc_protocol.cpp). The in-use hold pins
        # the socket object until the handler's response is written.
        if sock._inuse_acquire():
            from incubator_brpc_tpu_torch.runtime import scheduler

            scheduler.spawn(_run_server_stream, ctx, stream, sock)
    else:
        _complete_client_stream(ctx, stream, sock)


def _run_server_stream(ctx: H2Context, stream: H2Stream, sock) -> None:
    try:
        _process_server_stream(ctx, stream, sock)
    finally:
        sock._inuse_release()


def _respond(ctx: H2Context, sid: int, grpc_status: int, message: str, body: Optional[IOBuf]) -> None:
    with ctx.send_lock:
        stream = ctx.streams.get(sid)
        if stream is None:
            # the peer RST the stream while the handler ran (server
            # streams stay registered until responded): drop the
            # response BEFORE any HPACK encode — encoding mutates the
            # connection's dynamic table, and a discarded block would
            # desynchronize the peer's decoder for good. Resurrecting
            # the entry would also park it forever (no WINDOW_UPDATE
            # comes for a reset stream).
            return
        out = ctx.send_headers(
            sid,
            [(":status", "200"), ("content-type", "application/grpc")],
            end_stream=False,
        )
        # the stream stays registered until its DATA fully drains, so a
        # flow-control-parked body is still reachable by WINDOW_UPDATE;
        # the trailers are parked with it and emitted strictly after the
        # last DATA frame (trailers-before-data truncated big responses)
        if body is not None and grpc_status == GRPC_OK:
            stream.pending_out.append(_grpc_wrap(body))
        stream.sent_end = True
        trailers = [("grpc-status", str(grpc_status))]
        if message:
            trailers.append(("grpc-message", message))
        stream.pending_trailers = trailers
        out += ctx._drain_stream(stream)
        ctx.write(out)


def _process_server_stream(ctx: H2Context, stream: H2Stream, sock) -> None:
    from incubator_brpc_tpu_torch.client.controller import Controller

    headers = stream.headers or []
    path = _header(headers, ":path")
    server = sock.server
    sid = stream.sid
    parts = path.strip("/").split("/")
    if server is None or not server.is_running():
        return _respond(ctx, sid, GRPC_UNAVAILABLE, "server stopped", None)
    if len(parts) != 2:
        return _respond(ctx, sid, GRPC_UNIMPLEMENTED, f"bad path {path!r}", None)
    service_name, method_name = parts
    # h2 has no framing-level first message to verify (the first frame
    # is SETTINGS), so auth rides the request headers per stream —
    # Protocol.auth_in_protocol exempts h2 from the first-message gate.
    # The context stays per-request (attached to the controller below):
    # concurrent streams may carry different identities, so the shared
    # socket must not hold any one of them.
    auth_ctx = None
    auth = getattr(getattr(server, "options", None), "auth", None)
    if auth is not None:
        from incubator_brpc_tpu_torch.protocols import _call_verify_credential

        rc, auth_ctx = _call_verify_credential(
            auth, _header(headers, "authorization", ""), sock, attach_to_sock=False
        )
        if rc != 0:
            return _respond(ctx, sid, GRPC_UNAUTHENTICATED, "authentication failed", None)
    method = server.find_method(service_name, method_name)
    if method is None:
        return _respond(ctx, sid, GRPC_UNIMPLEMENTED, f"unknown {path}", None)
    status = server.method_status(method.full_name)
    # unified admission decision point (server/admission.py): tenant
    # identity rides the x-tpu-tenant request header on h2/grpc
    verdict = server.admission.admit(
        method.full_name, status, _header(headers, "x-tpu-tenant", "") or ""
    )
    if not verdict.admitted:
        return _respond(
            ctx, sid, GRPC_RESOURCE_EXHAUSTED, verdict.reason, None
        )
    ticket = verdict.ticket
    body = _grpc_unwrap(stream.data)
    if body is None:
        if status is not None:
            status.on_response(0, error=True)
        if ticket is not None:
            ticket.release()
        return _respond(ctx, sid, GRPC_UNKNOWN, "bad grpc framing", None)
    request = method.request_class()
    try:
        request.ParseFromString(body)
    except Exception as e:  # noqa: BLE001
        if status is not None:
            status.on_response(0, error=True)
        if ticket is not None:
            ticket.release()
        return _respond(ctx, sid, GRPC_UNKNOWN, f"parse failed: {e}", None)

    ctrl = Controller()
    ctrl.server = server
    ctrl._server_socket = sock
    ctrl._auth_context = auth_ctx
    ctrl.remote_side = sock.remote
    ctrl.service_name = service_name
    ctrl.method_name = method_name
    if verdict.tier is not None:
        # same stamp as tpu_std/http: the batcher's tier-aware queue
        # cap and the per-tier latency feed read it off the controller
        ctrl._admission_tier = verdict.tier
    timeout_ms = _parse_grpc_timeout(_header(headers, "grpc-timeout"))
    if timeout_ms is not None:
        ctrl.timeout_ms = timeout_ms
    response = method.response_class()
    import time as _time

    start_ns = _time.monotonic_ns()
    sent = [False]

    def done():
        if sent[0]:
            return
        sent[0] = True
        ctrl._release_session_local()  # handler done: pool the user data
        if ticket is not None:
            ticket.release()
        latency_us = (_time.monotonic_ns() - start_ns) // 1000
        if status is not None:
            status.on_response(latency_us, error=ctrl.failed())
        # per-tier observed latency (server/admission.py): feeds the
        # latency-fed auto limiter; no-op unless a tier was stamped
        from incubator_brpc_tpu_torch.server import admission as _admission

        _admission.note_controller_latency(ctrl, latency_us)
        if ctrl.failed():
            _respond(ctx, sid, _grpc_status_of(ctrl.error_code), ctrl.error_text(), None)
        else:
            _respond(ctx, sid, GRPC_OK, "", IOBuf(response.SerializeToString()))

    try:
        method.fn(ctrl, request, response, done)  # ← USER CODE
    except Exception as e:  # noqa: BLE001
        log_error("grpc method %s raised: %r", method.full_name, e)
        if not sent[0]:
            ctrl.set_failed(errors.EINTERNAL, f"method raised: {e}")
            done()


PROTOCOL = Protocol(
    name="h2",
    parse=parse,
    serialize_request=serialize_request,
    issue=issue,
    process_request=process_frame,
    process_response=process_frame,
    process_in_place=True,  # frames are stateful and ordered
    auth_in_protocol=True,  # per-stream authorization header check
)

# gRPC is the h2 protocol under its conventional name (reference
# registers h2 once; grpc rides the same wire): parse=None so the
# InputMessenger never double-tries the same wire format.
GRPC_PROTOCOL = Protocol(
    name="grpc",
    parse=None,
    serialize_request=serialize_request,
    issue=issue,
    process_response=process_frame,
    process_in_place=True,
)


def register():
    register_protocol(PROTOCOL)
    register_protocol(GRPC_PROTOCOL)
