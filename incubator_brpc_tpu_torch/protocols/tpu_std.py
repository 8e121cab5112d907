"""tpu_std — the default protobuf RPC protocol.

Analog of reference baidu_std (policy/baidu_rpc_protocol.cpp, framing
documented in docs/cn/baidu_std.md): fixed 12-byte header
``b"TRPC" + meta_size(u32 BE) + body_size(u32 BE)`` followed by an
RpcMeta protobuf and the body (payload then attachment; attachment
length rides in meta.attachment_size). One framing serves requests and
responses; meta.request/meta.response discriminates.

Supports: correlation ids, compression, attachments, streaming
settings handshake (reference baidu_rpc_protocol.cpp:212-264), and the
TPU extension meta.device_segments describing HBM tensor payloads.
"""

from __future__ import annotations

import struct
import time
from typing import Optional

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.protocols import ParseResult, Protocol, register_protocol
from incubator_brpc_tpu_torch.protocols import compress as compress_mod
from incubator_brpc_tpu_torch.protos import rpc_meta_pb2 as pb
from incubator_brpc_tpu_torch.runtime.call_id import default_pool as _id_pool
from incubator_brpc_tpu_torch.utils.iobuf import IOBuf

MAGIC = b"TRPC"
HEADER_SIZE = 12
_MAX_BODY = 2 << 30


class TpuStdMessage:
    __slots__ = ("meta", "payload", "received_us", "parse_done_us", "enqueued_us")

    def __init__(self, meta, payload: IOBuf):
        self.meta = meta
        self.payload = payload
        # rpcz phase stamps, filled in by the transport cut loop
        self.received_us = 0
        self.parse_done_us = 0
        self.enqueued_us = 0


# ---- parse (both sides) ----------------------------------------------------
def parse(buf: IOBuf, sock, read_eof: bool) -> ParseResult:
    header = buf.fetch(HEADER_SIZE)
    if header is None:
        got = buf.fetch(min(len(buf), 4)) or b""
        if MAGIC.startswith(got[: len(MAGIC)]) or got.startswith(MAGIC):
            return ParseResult.not_enough()
        return ParseResult.try_others()
    if header[:4] != MAGIC:
        return ParseResult.try_others()
    meta_size, body_size = struct.unpack_from(">II", header, 4)
    if meta_size > _MAX_BODY or body_size > _MAX_BODY:
        return ParseResult.bad()
    total = HEADER_SIZE + meta_size + body_size
    if len(buf) < total:
        return ParseResult.not_enough()
    buf.pop_front(HEADER_SIZE)
    meta_bytes = buf.cut_bytes(meta_size)
    payload = IOBuf()
    buf.cutn(payload, body_size)
    meta = pb.RpcMeta()
    try:
        meta.ParseFromString(meta_bytes)
    except Exception:
        return ParseResult.bad()
    # wire-controlled sizes must be validated before any cutn uses them
    if meta.attachment_size < 0 or meta.attachment_size > len(payload):
        return ParseResult.bad()
    if not sock.is_server_side and meta.HasField("response"):
        # A fully-received response means the connection closing is no
        # longer this RPC's problem: deregister the waiter NOW,
        # synchronously in the read task, so an EOF in the same read
        # batch can't error the id before the response task locks it.
        sock.remove_response_waiter(meta.correlation_id)
    return ParseResult.ok(TpuStdMessage(meta, payload))


def _frame(meta: pb.RpcMeta, body: IOBuf) -> IOBuf:
    meta_bytes = meta.SerializeToString()
    out = IOBuf()
    # header+meta in one append (one block write); body ref-shares
    out.append(
        MAGIC + struct.pack(">II", len(meta_bytes), len(body)) + meta_bytes
    )
    out.append(body)
    return out


# ---- client side -----------------------------------------------------------
def serialize_request(request, controller) -> IOBuf:
    """Called once per RPC (channel.cpp:517)."""
    body = IOBuf()
    # bytes = already-serialized request (the pooled fast-path contract,
    # docs/fastpath.md); matches the native path's bytes-mode packing
    raw = request if isinstance(request, bytes) else request.SerializeToString()
    ctype = controller.request_compress_type
    if ctype:
        compressed = compress_mod.compress(IOBuf(raw), ctype)
        if compressed is None:
            raise ValueError(f"unsupported compress type {ctype}")
        body.append(compressed)
    else:
        body.append(raw)
    return body


def pack_request(request_buf: IOBuf, wire_cid: int, method_spec, controller) -> IOBuf:
    """Called per send attempt, retries included (controller.cpp:1140)."""
    meta = pb.RpcMeta()
    meta.request.service_name = method_spec.service_name
    meta.request.method_name = method_spec.method_name
    meta.request.log_id = controller.log_id
    if controller._span is not None:
        meta.request.trace_id = controller._span.trace_id
        meta.request.span_id = controller._span.span_id
    meta.correlation_id = wire_cid
    meta.compress_type = controller.request_compress_type
    tenant = controller.__dict__.get("tenant")
    if tenant:
        # tenant identity for server-side admission (docs/overload.md)
        meta.request.tenant = tenant
    channel = controller._channel
    auth = channel.options.auth if channel is not None else None
    if auth is not None:
        # a raising authenticator FAILS the RPC (issue_rpc catches pack
        # errors) — silently sending unauthenticated would just burn
        # retries against the server's verify gate
        meta.auth_data = auth.generate_credential() or ""
    body = IOBuf()
    body.append(request_buf)  # ref share: serialize-once survives retries
    att = controller.request_attachment
    if len(att):
        meta.attachment_size = len(att)
        body.append(att)
    if controller._request_stream is not None:
        ss = controller._request_stream.fill_settings()
        meta.stream_settings.CopyFrom(ss)
    return _frame(meta, body)


def pack_cancel(wire_cid: int) -> IOBuf:
    """A cancel frame for one in-flight request (hedged-request loser
    cancellation, docs/overload.md): meta only, no body.  The server
    sheds the matching request from batch queues before device work
    and suppresses its response; unknown cids are ignored."""
    meta = pb.RpcMeta()
    meta.correlation_id = wire_cid
    meta.cancel = True
    return _frame(meta, IOBuf())


def process_response(msg: TpuStdMessage, sock) -> None:
    """Client response path (ProcessRpcResponse, baidu_rpc_protocol.cpp:557)."""
    meta = msg.meta
    cid = meta.correlation_id
    pool = _id_pool()
    from incubator_brpc_tpu_torch.transport.event_dispatcher import in_dispatcher

    if in_dispatcher():
        # never block the event loop on a contended id (the timeout /
        # retry handlers hold it briefly): re-dispatch to a worker
        ctrl = pool.try_lock(cid)
        if ctrl is type(pool).BUSY:
            from incubator_brpc_tpu_torch.runtime import scheduler

            scheduler.spawn(process_response, msg, sock)
            return
    else:
        ctrl = pool.lock(cid)
    if ctrl is None:
        return  # stale retry version or finished RPC: dropped
    if ctrl._span is not None:
        # client-side phases: when the response's bytes arrived and
        # when its frame finished parsing
        ctrl._span.adopt_message_stamps(msg)
    if meta.HasField("stream_settings"):
        ctrl._remote_stream_settings = meta.stream_settings
    ctrl._on_response(cid, meta, msg.payload)


# ---- server side -----------------------------------------------------------
def _handle_cancel(sock, cid: int) -> None:
    """A cancel frame (hedge loser / abandoned attempt): flag the
    in-flight request so batch queues shed it before device work and
    its response never hits the wire.  Best-effort — a handler already
    running completes; only the reply is suppressed."""
    reg = getattr(sock, "_srv_inflight", None)
    ctrl = reg.get(cid) if reg is not None else None
    if ctrl is not None:
        ctrl._cancel_requested = True


def process_request(msg: TpuStdMessage, sock) -> None:
    """Server request path (ProcessRpcRequest, baidu_rpc_protocol.cpp:312)."""
    from incubator_brpc_tpu_torch.client.controller import Controller

    meta = msg.meta
    server = sock.server
    req_meta = meta.request
    cid = meta.correlation_id
    if meta.cancel:
        return _handle_cancel(sock, cid)
    ctrl = Controller()
    # wall-clock anchor for RpcResponseMeta.server_time_us: everything
    # from request parse to response serialization counts as "server
    # time"; the client subtracts it from its leg latency to attribute
    # the remainder as wire+queue (observability/cluster.py)
    ctrl._server_recv_ns = time.monotonic_ns()
    ctrl.server = server
    ctrl._server_socket = sock
    ctrl._server_cid = cid
    ctrl._server_meta = meta
    ctrl.remote_side = sock.remote
    ctrl.service_name = req_meta.service_name
    ctrl.method_name = req_meta.method_name
    ctrl.log_id = req_meta.log_id

    # rpcz server span with propagated trace (baidu_rpc_protocol.cpp:382)
    from incubator_brpc_tpu_torch.observability.span import Span, swap_current_span

    ctrl._span = Span.create_server(
        req_meta.service_name, req_meta.method_name,
        req_meta.trace_id, req_meta.span_id,
    )
    if ctrl._span is not None:
        ctrl._span.remote_side = str(sock.remote or "")
        ctrl._span.request_size = len(msg.payload)
        ctrl._span.adopt_message_stamps(msg)
    if server is None or not server.is_running():
        ctrl.set_failed(errors.ELOGOFF, "server stopped")
        return send_response(ctrl, None)
    # rpc_dump sampling gate (reference baidu_rpc_protocol.cpp:329-339)
    if server._rpc_dump_ctx is not None:
        server._rpc_dump_ctx.sample_request(req_meta, msg.payload)
    method = server.find_method(req_meta.service_name, req_meta.method_name)
    if method is None:
        has_service = server.has_service(req_meta.service_name)
        ctrl.set_failed(
            errors.ENOMETHOD if has_service else errors.ENOSERVICE,
            f"unknown {req_meta.service_name}.{req_meta.method_name}",
        )
        return send_response(ctrl, None)
    status = server.method_status(method.full_name)
    # ONE admission decision point before user code (server/admission.py,
    # docs/overload.md): concurrency gate + tier shares + tenant quotas,
    # shed codes from the unified mapping (EOVERCROWDED = retry
    # elsewhere, ELIMIT = drop)
    verdict = server.admission.admit(
        method.full_name, status, req_meta.tenant
    )
    if not verdict.admitted:
        ctrl.set_failed(verdict.code, verdict.reason)
        return send_response(ctrl, None)
    if verdict.tier is not None:
        ctrl._admission_tier = verdict.tier
        ctrl._admission_ticket = verdict.ticket
    # hedge-cancellation registry: cancel frames resolve their target
    # through this per-connection map (cleared in send_response)
    reg = getattr(sock, "_srv_inflight", None)
    if reg is None:
        reg = {}
        try:
            sock._srv_inflight = reg
        except AttributeError:
            reg = None  # facade sockets without attribute storage
    if reg is not None:
        reg[cid] = ctrl
    start_ns = time.monotonic_ns()

    # decompress + parse request (baidu_rpc_protocol.cpp:484-491)
    payload = msg.payload
    att_size = meta.attachment_size
    body = payload
    if att_size:
        body = IOBuf()
        payload.cutn(body, len(payload) - att_size)
        ctrl.request_attachment = payload
    if meta.compress_type:
        body = compress_mod.decompress(body, meta.compress_type)
        if body is None:
            ctrl.set_failed(errors.EREQUEST, "unsupported compress type")
            if status is not None:
                status.on_response(0, error=True)
            return send_response(ctrl, None)
    request = method.request_class()
    try:
        request.ParseFromString(body.as_view())
    except Exception as e:  # noqa: BLE001
        ctrl.set_failed(errors.EREQUEST, f"parse request failed: {e}")
        if status is not None:
            status.on_response(0, error=True)
        return send_response(ctrl, None)
    if meta.HasField("stream_settings"):
        ctrl._remote_stream_settings = meta.stream_settings
    response = method.response_class()

    sent = [False]

    def done():
        if sent[0]:
            return
        sent[0] = True
        if ctrl._span is not None:
            ctrl._span.callback_done_us = time.time_ns() // 1000
        latency_us = (time.monotonic_ns() - start_ns) // 1000
        if status is not None:
            status.on_response(latency_us, error=ctrl.failed())
        # per-tier observed latency (server/admission.py): feeds the
        # latency-fed auto limiter; no-op unless a tier was stamped
        from incubator_brpc_tpu_torch.server import admission as _admission

        _admission.note_controller_latency(ctrl, latency_us)
        send_response(ctrl, response)

    # Micro-batching gate (batching/, docs/batching.md): a method with
    # a live Batcher coalesces into a fused batched execution — the
    # Batcher stamps callback entry and fans completion back through
    # this same done().  Disabled cost: one empty-dict truth test.
    if server._batchers and server.submit_batched(
        method, ctrl, request, response, done
    ):
        return

    # Scope the server span as the task-local parent for the handler:
    # nested client calls and fabric legs made inside it join this
    # trace; restored after so later work on this task can't misparent
    # into a finished trace. Callback-entry stamping + the exception
    # fence live in the server layer.
    prev_parent = (
        swap_current_span(ctrl._span) if ctrl._span is not None else None
    )
    try:
        exc = server.run_user_method(method, ctrl, request, response, done)
        if exc is not None and not sent[0]:
            ctrl.set_failed(errors.EINTERNAL, f"method raised: {exc}")
            done()
    finally:
        if ctrl._span is not None:
            swap_current_span(prev_parent)


def send_response(ctrl, response) -> None:
    """SendRpcResponse analog (baidu_rpc_protocol.cpp:139)."""
    ctrl._release_session_local()  # handler is done: pool the user data
    # admission bookkeeping: the tier/tenant inflight ticket releases
    # exactly once, on whichever path ends the request (idempotent pop)
    ticket = ctrl.__dict__.pop("_admission_ticket", None)
    if ticket is not None:
        ticket.release()
    span = getattr(ctrl, "_span", None)
    if span is not None and span.kind != "server":
        span = None
    sock = ctrl._server_socket
    reg = getattr(sock, "_srv_inflight", None) if sock is not None else None
    if reg is not None:
        reg.pop(ctrl._server_cid, None)
    if ctrl.__dict__.get("_cancel_requested"):
        # hedge loser: the client already completed on another replica
        # (or gave up) — writing the reply would be pure waste
        if span is not None:
            span.end(errors.ECANCELED)
        return
    if sock is None or sock.failed:
        if span is not None:
            span.end(errors.EFAILEDSOCKET)
        return
    if getattr(ctrl, "_close_connection_after_response", False):
        # Controller::CloseConnection: drop the connection, no response
        sock.set_failed(errors.ECLOSE, "closed by server handler")
        if span is not None:
            span.end(errors.ECLOSE)
        return
    meta = pb.RpcMeta()
    meta.correlation_id = ctrl._server_cid
    meta.response.error_code = ctrl.error_code
    if ctrl.error_code:
        meta.response.error_text = ctrl.error_text()
    if ctrl._server_recv_ns:
        # server's own elapsed time rides back in the response meta so
        # the client can split its leg latency into server vs wire+queue
        meta.response.server_time_us = (
            time.monotonic_ns() - ctrl._server_recv_ns
        ) // 1000
    body = IOBuf()
    if response is not None and not ctrl.failed():
        raw = response.SerializeToString()
        ctype = ctrl.response_compress_type
        if ctype:
            compressed = compress_mod.compress(IOBuf(raw), ctype)
            if compressed is not None:
                meta.compress_type = ctype
                body.append(compressed)
            else:
                body.append(raw)
        else:
            body.append(raw)
        att = ctrl.response_attachment
        if len(att):
            meta.attachment_size = len(att)
            body.append(att)
    if ctrl._response_stream is not None:
        meta.stream_settings.CopyFrom(ctrl._response_stream.fill_settings())
    if span is not None:
        # response_size covers the full serialized body (attachment
        # included); the span closes at WRITE COMPLETION via the
        # socket's write_done hook, so server latency includes
        # serialization and send — not just the callback
        span.response_size = len(body)
        span.error_code = ctrl.error_code
        span.response_write_us = time.time_ns() // 1000
    sock.write(_frame(meta, body), ignore_eovercrowded=True, span=span)


def verify(msg: "TpuStdMessage", sock) -> bool:
    """First-message auth on a server connection (reference
    input_messenger.cpp:282-300 + baidu_std verify callback). With no
    server authenticator every connection passes; with one, the meta's
    auth_data must verify or the connection dies with ERPCAUTH."""
    server = sock.server
    auth = getattr(getattr(server, "options", None), "auth", None)
    if auth is None:
        return True
    from incubator_brpc_tpu_torch.protocols import _call_verify_credential

    rc, _ = _call_verify_credential(auth, msg.meta.auth_data or "", sock)
    return rc == 0


PROTOCOL = Protocol(
    name="tpu_std",
    parse=parse,
    serialize_request=serialize_request,
    pack_request=pack_request,
    process_request=process_request,
    process_response=process_response,
    verify=verify,
    pack_cancel=pack_cancel,
)


def register():
    register_protocol(PROTOCOL)
