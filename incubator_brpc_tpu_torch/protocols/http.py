"""HTTP/1.x protocol — restful RPC + builtin service pages.

Analog of reference policy/http_rpc_protocol.cpp (1,603 LoC) + the
http_parser/HttpHeader/URI stack (SURVEY.md §2.4 "HTTP stack"):
- Server side: pb services are exposed automatically as
  ``POST /ServiceName/MethodName`` with JSON bodies (json2pb), and
  builtin observability pages (/status /vars /flags ...) are served on
  the same port — the same-port-speaks-all-protocols inversion.
- Client side: channels with protocol="http" issue requests and match
  responses by arrival order on the connection (HTTP/1.1 has no
  correlation id; in-order matching is what the reference does for
  single connections).
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, unquote, urlsplit

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.protocols import ParseResult, Protocol, register_protocol
from incubator_brpc_tpu_torch.runtime.call_id import default_pool as _id_pool
from incubator_brpc_tpu_torch.serialization.json2pb import json_to_proto, proto_to_json
from incubator_brpc_tpu_torch.utils.iobuf import IOBuf
from incubator_brpc_tpu_torch.utils.logging import log_error

_METHODS = (b"GET ", b"POST", b"PUT ", b"DELE", b"HEAD", b"PATC", b"OPTI")
_MAX_HEADER = 64 << 10
# budget for a pb handler to run its done callback before the request
# is answered 503 (tests shrink this to exercise the timeout path)
HANDLER_TIMEOUT_S = 30.0

HTTP_STATUS = {
    200: "OK",
    400: "Bad Request",
    403: "Forbidden",
    404: "Not Found",
    500: "Internal Server Error",
    501: "Not Implemented",
    503: "Service Unavailable",
}


class HttpMessage:
    """Parsed request or response (HttpHeader + body analog)."""

    __slots__ = (
        "is_request",
        "method",
        "path",
        "query",
        "status",
        "headers",
        "body",
        "version",
        "progressive_stream",  # _ProgressiveBody for chunked responses
        "received_us",  # rpcz phase stamps (transport cut loop)
        "parse_done_us",
        "enqueued_us",
    )

    def __init__(self):
        self.is_request = True
        self.method = "GET"
        self.path = "/"
        self.query: Dict[str, str] = {}
        self.status = 200
        self.headers: Dict[str, str] = {}
        self.body = IOBuf()
        self.version = "HTTP/1.1"
        self.progressive_stream = None
        self.received_us = 0
        self.parse_done_us = 0
        self.enqueued_us = 0

    def header(self, name: str, default=None):
        return self.headers.get(name.lower(), default)


class _ChunkedCtx:
    """Per-socket state for an in-progress chunked body (RFC 7230 §4.1).
    Lives on the socket between parse() calls. Client responses stream
    (the headers message was already dispatched, chunks flow to the
    _ProgressiveBody); server requests accumulate into msg.body."""

    __slots__ = ("msg", "stream")

    def __init__(self, msg, stream=None):
        self.msg = msg
        self.stream = stream  # _ProgressiveBody | None


def parse(buf: IOBuf, sock, read_eof: bool) -> ParseResult:
    ctx = getattr(sock, "_http_chunk_ctx", None)
    if ctx is not None:
        r = _parse_chunks(buf, sock, ctx)
        if read_eof and getattr(sock, "_http_chunk_ctx", None) is not None:
            # connection died mid-body: unblock any progressive reader
            # (they get the end marker; the half body is all there is)
            sock._http_chunk_ctx = None
            if ctx.stream is not None:
                ctx.stream.finish()
            return ParseResult.bad()
        return r
    head = buf.fetch(min(len(buf), 8))
    if head is None or len(head) < 4:
        return ParseResult.not_enough() if _maybe_http(head or b"") else ParseResult.try_others()
    if not _maybe_http(head):
        return ParseResult.try_others()
    # find end of headers
    raw = buf.copy_to(min(len(buf), _MAX_HEADER))
    idx = raw.find(b"\r\n\r\n")
    if idx < 0:
        if len(raw) >= _MAX_HEADER:
            return ParseResult.bad()
        return ParseResult.not_enough()
    header_block = raw[:idx].decode("latin1")
    lines = header_block.split("\r\n")
    msg = HttpMessage()
    first = lines[0].split(" ", 2)
    if first[0].startswith("HTTP/"):
        msg.is_request = False
        msg.version = first[0]
        try:
            msg.status = int(first[1])
        except (IndexError, ValueError):
            return ParseResult.bad()
    else:
        if len(first) < 3:
            return ParseResult.bad()
        msg.method = first[0].upper()
        msg.version = first[2]
        parts = urlsplit(first[1])
        msg.path = unquote(parts.path) or "/"
        msg.query = {k: v[0] for k, v in parse_qs(parts.query).items()}
    for line in lines[1:]:
        k, _, v = line.partition(":")
        msg.headers[k.strip().lower()] = v.strip()
    if "chunked" in (msg.headers.get("transfer-encoding", "") or "").lower():
        buf.pop_front(idx + 4)
        if not msg.is_request and not sock.is_server_side:
            # client response: dispatch the HEADERS message through the
            # normal (ordered) path NOW — process_response binds it to
            # the right controller in FIFO order; the cut loop re-enters
            # parse() and the chunks stream into msg.progressive_stream
            stream = _ProgressiveBody()
            msg.progressive_stream = stream
            sock._http_chunk_ctx = _ChunkedCtx(msg, stream)
            return ParseResult.ok(msg)
        sock._http_chunk_ctx = _ChunkedCtx(msg, None)
        return _parse_chunks(buf, sock, sock._http_chunk_ctx)
    body_len = int(msg.headers.get("content-length", "0") or 0)
    total = idx + 4 + body_len
    if len(buf) < total:
        return ParseResult.not_enough()
    buf.pop_front(idx + 4)
    buf.cutn(msg.body, body_len)
    return ParseResult.ok(msg)


def _parse_chunks(buf: IOBuf, sock, ctx: _ChunkedCtx) -> ParseResult:
    """Consume as many complete chunks as available.

    Accumulate mode (server-side chunked REQUEST): returns ok(msg) with
    the full de-chunked body after the terminal chunk.
    Stream mode (client-side chunked RESPONSE): the headers message was
    already dispatched; chunks feed the stream, the terminal chunk
    finish()es it, and parsing falls through to whatever pipelined
    message follows in the buffer."""
    while True:
        raw = buf.copy_to(min(len(buf), 32))
        nl = raw.find(b"\r\n")
        if nl < 0:
            if len(raw) >= 32:
                return _chunk_fail(sock, ctx)
            return ParseResult.not_enough()
        size_token = raw[:nl].split(b";", 1)[0].strip()
        try:
            size = int(size_token, 16)
        except ValueError:
            return _chunk_fail(sock, ctx)
        if size == 0:
            # terminal chunk: "0\r\n" + optional trailers + "\r\n"
            tail = buf.copy_to(min(len(buf), _MAX_HEADER))
            end = tail.find(b"\r\n\r\n")
            if end < 0:
                if len(tail) >= _MAX_HEADER:
                    return _chunk_fail(sock, ctx)
                return ParseResult.not_enough()  # trailers in flight
            buf.pop_front(end + 4)
            sock._http_chunk_ctx = None
            if ctx.stream is not None:
                ctx.stream.finish()
                # stream mode already emitted its message at the
                # headers: hand the remaining bytes (the next pipelined
                # message, if complete) straight back to the parser
                if len(buf):
                    return parse(buf, sock, False)
                return ParseResult.not_enough()
            return ParseResult.ok(ctx.msg)
        if len(buf) < nl + 2 + size + 2:
            return ParseResult.not_enough()
        buf.pop_front(nl + 2)
        chunk = buf.cut_bytes(size)
        buf.pop_front(2)  # trailing CRLF
        if ctx.stream is not None:
            ctx.stream.feed(chunk)
        else:
            ctx.msg.body.append(chunk)
            if len(ctx.msg.body) > get_max_body():
                return _chunk_fail(sock, ctx)


def _chunk_fail(sock, ctx: _ChunkedCtx) -> ParseResult:
    """Malformed chunk framing: kill the connection, and unblock any
    progressive reader with the end marker so it never hangs."""
    sock._http_chunk_ctx = None
    if ctx.stream is not None:
        ctx.stream.finish()
    return ParseResult.bad()


def get_max_body() -> int:
    from incubator_brpc_tpu_torch.utils.flags import get_flag

    return get_flag("max_body_size", 2 << 30)


class _ProgressiveBody:
    """Client-side progressive body (reference ProgressiveReader,
    progressive_attachment.h): chunks buffer until a reader attaches
    via Controller.read_progressive_attachment(fn); fn(bytes) per part,
    fn(None) at end-of-body."""

    def __init__(self):
        import threading as _threading

        self._lock = _threading.Lock()
        self._pending = []
        self._reader = None
        self._finished = False
        self._borrowed = []  # connections this body closes at its end

    def feed(self, chunk: bytes):
        with self._lock:
            reader = self._reader
            if reader is None:
                self._pending.append(chunk)
                return
        _safe_read(reader, chunk)

    def finish(self):
        with self._lock:
            reader = self._reader
            self._finished = True
            borrowed, self._borrowed = self._borrowed, []
        if reader is not None:
            _safe_read(reader, None)
        _close_borrowed(borrowed)

    def close_at_end(self, borrowed):
        """Take over a call's connection borrows: the body closes them
        when it ends, and they never go back to a pool."""
        with self._lock:
            if not self._finished:
                self._borrowed.extend(borrowed)
                return
        _close_borrowed(borrowed)

    def attach(self, reader):
        with self._lock:
            self._reader = reader
            pending, self._pending = self._pending, []
            finished = self._finished
        for chunk in pending:
            _safe_read(reader, chunk)
        if finished:
            _safe_read(reader, None)


def _close_borrowed(borrowed):
    from incubator_brpc_tpu_torch.transport.socket_map import release_owned_socket

    for _kind, sid, remote, signature in borrowed:
        release_owned_socket(("short", sid, remote, signature))


def _safe_read(reader, part):
    try:
        reader(part)
    except Exception as e:  # noqa: BLE001 — a raising reader must not
        log_error("progressive reader raised: %r", e)  # kill the parse loop


def _maybe_http(head: bytes) -> bool:
    up = head[:4].upper()
    return up.startswith(b"HTTP") or any(up.startswith(m[: len(up)]) for m in _METHODS)


def build_response(
    status: int, body, content_type: str = "text/plain", headers: Optional[Dict] = None
) -> IOBuf:
    if isinstance(body, str):
        body = body.encode()
    body_buf = body if isinstance(body, IOBuf) else IOBuf(body)
    out = IOBuf()
    hdrs = {
        "Content-Type": content_type,
        "Content-Length": str(len(body_buf)),
        "Connection": "keep-alive",
    }
    if headers:
        hdrs.update(headers)
    head = f"HTTP/1.1 {status} {HTTP_STATUS.get(status, '')}\r\n"
    head += "".join(f"{k}: {v}\r\n" for k, v in hdrs.items())
    out.append(head + "\r\n")
    out.append(body_buf)
    return out


def build_request(
    method: str,
    path: str,
    body=b"",
    content_type="application/json",
    host="",
    headers: Optional[Dict] = None,
) -> IOBuf:
    body_buf = body if isinstance(body, IOBuf) else IOBuf(body)
    out = IOBuf()
    head = f"{method} {path} HTTP/1.1\r\n"
    head += f"Host: {host or 'tpubrpc'}\r\nContent-Type: {content_type}\r\n"
    head += f"Content-Length: {len(body_buf)}\r\nConnection: keep-alive\r\n"
    if headers:
        head += "".join(f"{k}: {v}\r\n" for k, v in headers.items())
    out.append(head + "\r\n")
    out.append(body_buf)
    return out


class ProgressiveAttachment:
    """Server-side chunked response body (reference
    progressive_attachment.{h,cpp}): the handler writes parts as they
    are produced; writes before the response headers go out are
    buffered; close() sends the terminal chunk. Thread-safe — the
    producer usually outlives the request handler."""

    def __init__(self, content_type: str = "application/octet-stream"):
        import threading as _threading

        self._lock = _threading.Lock()
        self._sock = None
        self._pending = []
        self._closed = False
        # what the chunked response's Content-Type header announces —
        # "text/event-stream" turns the stream into SSE (the generate
        # service's browser-shaped path, docs/streaming.md)
        self.content_type = content_type

    def write(self, data) -> int:
        if isinstance(data, str):
            data = data.encode()
        if isinstance(data, IOBuf):
            data = data.to_bytes()
        with self._lock:
            if self._closed:
                return errors.ECLOSE
            sock = self._sock
            if sock is None:
                self._pending.append(data)
                return 0
            # per-write hold, taken under the same lock close() uses:
            # a close() that wins the lock makes this write see _closed;
            # one that loses cannot recycle the slot under our feet
            # (its lifetime-guard release defers until we release)
            if not sock._inuse_acquire():
                return errors.ECLOSE
        try:
            return self._write_chunk(sock, data)
        finally:
            sock._inuse_release()

    @staticmethod
    def _write_chunk(sock, data: bytes) -> int:
        if not data:
            return 0
        out = IOBuf()
        out.append(f"{len(data):x}\r\n".encode())
        out.append(data)
        out.append(b"\r\n")
        return sock.write(out, ignore_eovercrowded=True)

    def backlog_bytes(self) -> int:
        """Unsent bytes queued on the bound connection — producers that
        must not grow without bound against a stalled client (the SSE
        generate path) poll this and stop/evict past their budget.
        0 while unbound (writes are buffering) or after close."""
        with self._lock:
            sock = self._sock
        if sock is None:
            return 0
        return sock._unwritten

    def close(self) -> int:
        with self._lock:
            if self._closed:
                return 0
            self._closed = True
            sock = self._sock
            self._sock = None
        if sock is not None:
            rc = sock.write(IOBuf(b"0\r\n\r\n"), ignore_eovercrowded=True)
            # the response advertised Connection: close — the stream
            # owned the connection, nothing else may ride it.  Graceful:
            # buffered chunks + the terminator above may still sit in
            # the KeepWrite queue under backpressure; an immediate
            # set_failed would drop them (truncated chunked body)
            sock.close_after_flush(errors.ECLOSE, "progressive response complete")
            sock._inuse_release()  # guard taken at _bind
            return rc
        return 0

    def _bind(self, sock):
        """Called once the chunked response headers are written.

        Takes the socket's in-use guard for the attachment's lifetime
        (released at close()): the producer thread writes long after
        the request handler returned, and without the hold the socket's
        pool slot could be recycled and REBORN under a different
        connection — a late write would then ride (and a late failure
        close the fd of) an unrelated socket.  This is the reference's
        SocketUniquePtr refcount held by ProgressiveAttachment
        (progressive_attachment.h: _httpsock member)."""
        if not sock._inuse_acquire():
            # socket already dying: the stream can never be written
            self._abort()
            return
        # Drain the buffered parts BEFORE publishing _sock: once _sock
        # is visible, concurrent write()s go straight to the wire, and
        # publishing first would let a fresh part overtake (or a
        # close() truncate) the buffered ones.  Loop: writes landing
        # during a drain pass re-buffer and drain next pass.
        while True:
            with self._lock:
                pending, self._pending = self._pending, []
                if not pending:
                    self._sock = sock
                    closed = self._closed
                    break
            for data in pending:
                self._write_chunk(sock, data)
        if closed:
            with self._lock:
                self._sock = None
            sock.write(IOBuf(b"0\r\n\r\n"), ignore_eovercrowded=True)
            # graceful for the same reason as close() above
            sock.close_after_flush(errors.ECLOSE, "progressive response complete")
            sock._inuse_release()

    def _abort(self):
        """Handler failed/timed out before the response went out: the
        stream will never bind — writes must stop buffering and report
        the death instead of accumulating forever."""
        with self._lock:
            self._closed = True
            self._pending.clear()

    def __del__(self):
        # backstop for abandoned attachments (producer died without
        # close()): the reference's SocketUniquePtr releases in its
        # destructor; without this the bound socket's pool slot would
        # stay pinned forever
        try:
            self.close()
        except Exception:  # noqa: BLE001 — never raise from GC
            pass


# ---- server side -----------------------------------------------------------
def process_request(msg: HttpMessage, sock) -> None:
    server = sock.server
    if server is None:
        return
    if getattr(sock, "_http_exclusive_stream", False):
        # a progressive response owns this connection (its headers said
        # Connection: close); a request that raced in anyway must not
        # interleave a second response with the chunk stream
        return
    pa_holder = [None]
    try:
        status, body, ctype = _route(server, msg, sock, pa_holder)
    except Exception as e:  # noqa: BLE001
        log_error("http handler raised: %r", e)
        status, body, ctype = 500, f"internal error: {e}", "text/plain"
    pa = pa_holder[0]
    if pa is not None and status == 200:
        # progressive response: headers announce chunked + close (the
        # stream owns the connection from here), body follows as the
        # handler's producer writes into the attachment
        sock._http_exclusive_stream = True
        head = (
            f"HTTP/1.1 200 OK\r\nContent-Type: {ctype}\r\n"
            "Transfer-Encoding: chunked\r\nConnection: close\r\n\r\n"
        )
        sock.write(IOBuf(head.encode()), ignore_eovercrowded=True)
        pa._bind(sock)
        return
    want_close = (msg.header("connection", "") or "").lower() == "close"
    hdrs = {"Connection": "close"} if want_close else None
    sock.write(
        build_response(status, body, ctype, headers=hdrs), ignore_eovercrowded=True
    )
    if want_close:
        # graceful: the response queued above may still be in the
        # KeepWrite path after a partial write — close only once it
        # fully reaches the kernel (set_failed here truncated it)
        sock.close_after_flush(errors.ECLOSE, "connection: close requested")


def _route(server, msg: HttpMessage, sock, pa_holder=None) -> Tuple[int, object, str]:
    path = msg.path.rstrip("/") or "/"
    # 1. builtin services (exact or prefix match)
    handler = server.find_builtin_handler(path)
    if handler is not None:
        if not server.builtin_allowed():
            # internal_port is set: observability pages are reachable
            # only through it (server.cpp:1042-1080)
            return (
                403,
                "builtin services are served on the internal port only",
                "text/plain",
            )
        return handler(server, msg)
    # 2. restful pb service: /Service/Method
    parts = [p for p in path.split("/") if p]
    if len(parts) == 2:
        method = server.find_method(parts[0], parts[1])
        if method is None:
            return 404, f"no such method {parts[0]}.{parts[1]}", "text/plain"
        return _call_pb_method(server, method, msg, sock, pa_holder)
    return 404, f"no handler for {msg.path}", "text/plain"


def _trace_header_ids(msg: HttpMessage) -> Tuple[int, int]:
    """(trace_id, span_id) propagated via x-trace-id / x-span-id hex
    request headers — the HTTP carriage of what tpu_std rides in its
    RpcMeta, so HTTP and tpu_std calls join the same trace. Parsed
    independently: a mangled span id must not discard a valid trace
    id (the join would be lost)."""
    from incubator_brpc_tpu_torch.observability.span import parse_trace_id

    try:
        tid = parse_trace_id(msg.header("x-trace-id", "0") or "0")
    except ValueError:
        tid = 0
    try:
        sid = parse_trace_id(msg.header("x-span-id", "0") or "0")
    except ValueError:
        sid = 0
    return tid, sid


def _call_pb_method(server, method, msg: HttpMessage, sock, pa_holder=None):
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.observability.span import Span

    request = method.request_class()
    if len(msg.body):
        ok, err = json_to_proto(msg.body, request)
        if not ok:
            return 400, f"bad json request: {err}", "text/plain"
    elif msg.query:
        # query params map onto top-level string/int fields
        for k, v in msg.query.items():
            if request.DESCRIPTOR.fields_by_name.get(k) is not None:
                field = request.DESCRIPTOR.fields_by_name[k]
                try:
                    setattr(request, k, int(v) if field.cpp_type in (1, 2, 3, 4) else v)
                except (TypeError, ValueError):
                    pass
    ctrl = Controller()
    ctrl.server = server
    ctrl._server_socket = sock
    ctrl.remote_side = sock.remote
    tid, psid = _trace_header_ids(msg)
    span = Span.create_server(method.service_name, method.method_name, tid, psid)
    if span is not None:
        span.remote_side = str(sock.remote or "")
        span.request_size = len(msg.body)
        span.adopt_message_stamps(msg)
        ctrl._span = span
    response = method.response_class()
    status = server.method_status(method.full_name)
    # unified admission decision point (server/admission.py): tenant
    # identity rides the x-tpu-tenant header on HTTP
    tenant = msg.header("x-tpu-tenant", "") or ""
    verdict = server.admission.admit(method.full_name, status, tenant)
    if not verdict.admitted:
        if span is not None:
            span.end(verdict.code)
        return 503, f"[{verdict.code}] {verdict.reason}", "text/plain"
    if verdict.tier is not None:
        ctrl._admission_tier = verdict.tier
        ctrl._admission_ticket = verdict.ticket
    import threading
    import time as _time

    def _finish(code: int, body=b""):
        # HTTP responses are written by process_request after this
        # returns: response_write is the closest stampable point, and
        # the span closes here with the serialized body size
        ticket = ctrl.__dict__.pop("_admission_ticket", None)
        if ticket is not None:
            ticket.release()
        if span is not None:
            span.response_size = len(body)
            span.stamp("response_write_us")
            span.end(code)

    start = _time.monotonic_ns()
    ev = threading.Event()
    # server span scoped as task-local parent: nested calls the
    # handler makes join this trace (restored before the response)
    from incubator_brpc_tpu_torch.observability.span import swap_current_span

    prev_parent = swap_current_span(span) if span is not None else None
    try:
        exc = server.run_user_method(method, ctrl, request, response, ev.set)
        finished = False if exc is not None else ev.wait(HANDLER_TIMEOUT_S)
    finally:
        if span is not None:
            swap_current_span(prev_parent)
    if span is not None:
        span.stamp("callback_done_us")
    latency_us = (_time.monotonic_ns() - start) // 1000
    if status is not None:
        # a timed-out handler is an error in the method stats even
        # though ctrl (still owned by the running handler) isn't failed
        status.on_response(latency_us, error=(not finished) or ctrl.failed())
    if finished:
        # per-tier observed latency (server/admission.py): feeds the
        # latency-fed auto limiter; no-op unless a tier was stamped
        from incubator_brpc_tpu_torch.server import admission as _admission

        _admission.note_controller_latency(ctrl, latency_us)
    pa = ctrl._progressive_attachment
    if exc is not None:
        if pa is not None:
            pa._abort()
        _finish(errors.EINTERNAL)
        return 500, f"internal error: {exc}", "text/plain"
    if not finished:
        # handler never ran done within the budget: a half-built 200
        # would hand the client partial state as success (and it may
        # still be USING its session-local object — leak, don't pool)
        if pa is not None:
            pa._abort()  # never binding: stop the producer's buffering
        _finish(errors.ERPCTIMEDOUT)
        return 503, "handler timed out", "text/plain"
    ctrl._release_session_local()  # handler done: pool the user data
    if ctrl.failed():
        if pa is not None:
            pa._abort()
        _finish(ctrl.error_code)
        return 500, f"[{ctrl.error_code}] {ctrl.error_text()}", "text/plain"
    if pa is not None and pa_holder is not None:
        pa_holder[0] = pa
        _finish(0)
        return 200, b"", pa.content_type
    body = proto_to_json(response, pretty=True)
    _finish(0, body)
    return 200, body, "application/json"


# ---- client side -----------------------------------------------------------
def serialize_request(request, controller) -> IOBuf:
    if request is None:
        return IOBuf()
    return IOBuf(proto_to_json(request).encode())


def pack_request(request_buf: IOBuf, wire_cid: int, method_spec, controller) -> IOBuf:
    path = f"/{method_spec.service_name}/{method_spec.method_name}"
    body = IOBuf()
    body.append(request_buf)
    extra = None
    if controller._span is not None:
        # trace propagation over HTTP (x-trace-id/x-span-id): the
        # header form of tpu_std's RpcMeta trace fields, in the one
        # canonical printable form (span.format_trace_id)
        from incubator_brpc_tpu_torch.observability.span import format_trace_id

        extra = {
            "x-trace-id": format_trace_id(controller._span.trace_id),
            "x-span-id": format_trace_id(controller._span.span_id),
        }
    tenant = controller.__dict__.get("tenant")
    if tenant:
        # tenant identity for server-side admission — the header form
        # of RpcRequestMeta.tenant (docs/overload.md); CR/LF would
        # smuggle headers into the wire
        if "\r" in tenant or "\n" in tenant:
            raise ValueError("tenant contains CR/LF")
        extra = dict(extra or {})
        extra["x-tpu-tenant"] = tenant
    channel = controller._channel
    auth = channel.options.auth if channel is not None else None
    if auth is not None:
        # raising fails the RPC at pack time (no silent anonymous send);
        # CR/LF in a credential would smuggle headers into the wire
        cred = auth.generate_credential()
        if cred:
            if "\r" in cred or "\n" in cred:
                raise ValueError("credential contains CR/LF")
            extra = dict(extra or {})
            extra["Authorization"] = cred
    packet = build_request("POST", path, body, headers=extra)
    # HTTP/1.1 matches responses by order: the FIFO entry registers
    # inside the write, atomically with the packet's queue position
    controller._pipelined_entries = [(wire_cid, 1)]
    return packet


def process_response(msg: HttpMessage, sock) -> None:
    with sock._write_lock:
        cid, _ = sock.pipelined_info.popleft() if sock.pipelined_info else (0, 0)
    if not cid:
        return
    pool = _id_pool()
    ctrl = pool.lock(cid)
    if ctrl is None:
        return
    if ctrl._span is not None:
        ctrl._span.adopt_message_stamps(msg)
    stream = msg.progressive_stream
    if stream is not None:
        # chunked response: the body follows this headers message
        if getattr(ctrl, "_read_progressively", False):
            # the RPC completes at the headers; the caller reads the
            # body via read_progressive_attachment (controller.h
            # response_will_be_read_progressively)
            ctrl._progressive_body = stream
            if msg.status != 200:
                ctrl.set_failed(errors.EHTTP, f"http status {msg.status}")
            # the body still streams on this connection, and its headers
            # said Connection: close: the RPC's pooled borrow moves to
            # the body, which closes the connection at its end.  Handed
            # back to the pool at finalize, it would carry the next call
            # into a connection the server is about to close.
            with ctrl._rpc_end_lock:
                owned = ctrl._owned_sockets
                ctrl._owned_sockets = [e for e in owned if e[1] != sock.sid]
            stream.close_at_end([e for e in owned if e[1] == sock.sid])
            ctrl._finalize_locked(cid)
            return
        # plain caller: buffer the chunks, finish the RPC at end-of-body
        status = msg.status
        parts = []

        def accumulate(part, cid=cid, status=status):
            if part is not None:
                parts.append(part)
                return
            c2 = pool.lock(cid)
            if c2 is None:  # timed out / canceled while streaming
                return
            body = b"".join(parts)
            if status != 200:
                c2.set_failed(errors.EHTTP, f"http status {status}: {body[:200]!r}")
            else:
                try:
                    if c2._response is not None and body:
                        ok, err = json_to_proto(IOBuf(body), c2._response)
                        if not ok:
                            c2.set_failed(
                                errors.ERESPONSE, f"bad json response: {err}"
                            )
                except Exception as e:  # noqa: BLE001
                    c2.set_failed(errors.ERESPONSE, repr(e))
            c2._finalize_locked(cid)

        pool.unlock(cid)  # reattached at end-of-body by `accumulate`
        stream.attach(accumulate)
        return
    if msg.status != 200:
        ctrl.set_failed(errors.EHTTP, f"http status {msg.status}: {msg.body.copy_to(200)!r}")
        ctrl._finalize_locked(cid)
        return
    try:
        if ctrl._response is not None and len(msg.body):
            ok, err = json_to_proto(msg.body, ctrl._response)
            if not ok:
                ctrl.set_failed(errors.ERESPONSE, f"bad json response: {err}")
    except Exception as e:  # noqa: BLE001
        ctrl.set_failed(errors.ERESPONSE, repr(e))
    ctrl._finalize_locked(cid)


def verify(msg: HttpMessage, sock) -> bool:
    """First-message auth (server authenticator): the Authorization
    header must verify. Requests on an unauthenticated connection are
    rejected by closing it (same as the reference's Verify path)."""
    server = sock.server
    auth = getattr(getattr(server, "options", None), "auth", None)
    if auth is None:
        return True
    if not msg.is_request:
        return True  # client side never verifies
    from incubator_brpc_tpu_torch.protocols import _call_verify_credential

    rc, _ = _call_verify_credential(auth, msg.header("authorization", "") or "", sock)
    return rc == 0


PROTOCOL = Protocol(
    name="http",
    parse=parse,
    serialize_request=serialize_request,
    pack_request=pack_request,
    process_request=process_request,
    process_response=process_response,
    verify=verify,
    support_pipelined=True,
    # HTTP/1.1 has no correlation id: the client matches responses FIFO,
    # so one connection's requests must be processed (and answered) in
    # arrival order
    process_ordered=True,
)


def register():
    register_protocol(PROTOCOL)
