"""Legacy pb protocol family — hulu, sofa, nshead, nova, public, esp.

Analogs of the reference's legacy ecosystem protocols (SURVEY §2.5,
policy/{hulu,sofa,nova,public}_pbrpc_protocol.cpp, nshead_service.h,
policy/esp_protocol.cpp). Wire facts mirrored from the public formats:

  hulu:   12B header  b"HULU" u32le(body_size) u32le(meta_size),
          body = HuluRpcRequestMeta/ResponseMeta + user message.
  sofa:   24B header  b"SOFA" u32le(meta_size) u64le(body_size)
          u64le(meta_size+body_size), then SofaRpcMeta + user message.
  nshead: 36B struct  <u16 id, u16 version, u32 log_id, char[16]
          provider, u32 magic=0xfb709394, u32 reserved, u32 body_len>,
          then body_len bytes. The base for nova/public framing.
  nova:   nshead whose body is the pb request; method index rides
          head.reserved.
  public: nshead whose body is a PublicPbrpcRequest/Response pb.
  esp:    32B head <u64 from, u64 to, u32 msg, u64 msg_id, i32
          body_len> then body (client side, msg_id correlates).

All integer fields are little-endian (these protocols predate
network-order discipline — reference notes the same).
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.protocols import ParseResult, Protocol, register_protocol
from incubator_brpc_tpu_torch.protos import legacy_meta_pb2 as pb
from incubator_brpc_tpu_torch.runtime.call_id import default_pool as _id_pool
from incubator_brpc_tpu_torch.runtime.call_id import wire_cid32
from incubator_brpc_tpu_torch.utils.iobuf import IOBuf
from incubator_brpc_tpu_torch.utils.logging import log_error

NSHEAD_MAGIC = 0xFB709394
_NSHEAD_FMT = "<HHI16sIII"
NSHEAD_SIZE = struct.calcsize(_NSHEAD_FMT)  # 36
_ESP_FMT = "<QQIQi"
ESP_HEAD_SIZE = struct.calcsize(_ESP_FMT)  # 32
_MAX_BODY = 512 << 20


def _method_by_index(server, service_name: str, index: int):
    svc = server.services().get(service_name)
    if svc is None:
        return None
    names = sorted(svc.method_specs())
    if 0 <= index < len(names):
        return server.find_method(service_name, names[index])
    return None


def _run_method(server, method, payload: IOBuf, ctrl, respond):
    """Shared dispatch tail: parse request, run user code, respond(ctrl,
    response_bytes|None) exactly once."""
    import time as _time

    status = server.method_status(method.full_name)
    # legacy protocols carry no tenant metadata: admitted as the
    # default tier through the same unified decision point
    verdict = server.admission.admit(method.full_name, status)
    if not verdict.admitted:
        ctrl.set_failed(verdict.code, verdict.reason)
        return respond(ctrl, None)
    if verdict.ticket is not None:
        ctrl._admission_ticket = verdict.ticket

    def _respond(ctrl_, body):
        # release the admission ticket on whichever path ends the
        # request (idempotent pop; only active policies mint tickets)
        ticket = ctrl_.__dict__.pop("_admission_ticket", None)
        if ticket is not None:
            ticket.release()
        return respond(ctrl_, body)

    start = _time.monotonic_ns()
    request = method.request_class()
    try:
        request.ParseFromString(payload.as_view())
    except Exception as e:  # noqa: BLE001
        ctrl.set_failed(errors.EREQUEST, f"parse request failed: {e}")
        if status is not None:
            status.on_response(0, error=True)
        return _respond(ctrl, None)
    response = method.response_class()
    sent = [False]

    def done():
        if sent[0]:
            return
        sent[0] = True
        if status is not None:
            status.on_response(
                (_time.monotonic_ns() - start) // 1000, error=ctrl.failed()
            )
        _respond(ctrl, None if ctrl.failed() else response.SerializeToString())
        ctrl._release_session_local()  # handler done: pool the user data

    try:
        method.fn(ctrl, request, response, done)
    except Exception as e:  # noqa: BLE001
        log_error("handler %s raised: %r", method.full_name, e)
        if not sent[0]:
            ctrl.set_failed(errors.EINTERNAL, f"handler raised: {e}")
            done()


def _server_controller(sock, server):
    from incubator_brpc_tpu_torch.client.controller import Controller

    ctrl = Controller()
    ctrl.server = server
    ctrl._server_socket = sock
    ctrl.remote_side = sock.remote
    return ctrl


# ===========================================================================
# hulu_pbrpc
# ===========================================================================
class HuluMessage:
    __slots__ = ("meta_bytes", "payload")

    def __init__(self, meta_bytes: bytes, payload: IOBuf):
        self.meta_bytes = meta_bytes
        self.payload = payload


def hulu_parse(buf: IOBuf, sock, read_eof: bool) -> ParseResult:
    head = buf.fetch(12)
    if head is None:
        got = buf.fetch(min(len(buf), 4)) or b""
        if b"HULU".startswith(got):
            return ParseResult.not_enough()
        return ParseResult.try_others()
    if head[:4] != b"HULU":
        return ParseResult.try_others()
    body_size, meta_size = struct.unpack_from("<II", head, 4)
    if body_size > _MAX_BODY or meta_size > body_size:
        return ParseResult.bad()
    if len(buf) < 12 + body_size:
        return ParseResult.not_enough()
    buf.pop_front(12)
    meta_bytes = buf.cut_bytes(meta_size)
    payload = IOBuf()
    buf.cutn(payload, body_size - meta_size)
    return ParseResult.ok(HuluMessage(meta_bytes, payload))


def _hulu_frame(meta_bytes: bytes, payload) -> IOBuf:
    out = IOBuf()
    body_size = len(meta_bytes) + len(payload)
    out.append(b"HULU" + struct.pack("<II", body_size, len(meta_bytes)) + meta_bytes)
    out.append(payload)
    return out


def hulu_serialize_request(request, controller) -> IOBuf:
    return IOBuf(request.SerializeToString())


def hulu_pack_request(request_buf, wire_cid, method_spec, controller) -> IOBuf:
    meta = pb.HuluRpcRequestMeta()
    meta.service_name = method_spec.service_name
    meta.method_index = 0  # resolved by name server-side (field 14)
    meta.method_name = method_spec.method_name
    meta.correlation_id = wire_cid
    meta.log_id = controller.log_id
    return _hulu_frame(meta.SerializeToString(), request_buf)


def hulu_process_request(msg: HuluMessage, sock) -> None:
    server = sock.server
    meta = pb.HuluRpcRequestMeta()
    try:
        meta.ParseFromString(msg.meta_bytes)
    except Exception:  # noqa: BLE001
        sock.set_failed(errors.EREQUEST, "bad hulu meta")
        return
    ctrl = _server_controller(sock, server)
    ctrl.service_name = meta.service_name
    cid = meta.correlation_id

    def respond(ctrl, response_bytes):
        rmeta = pb.HuluRpcResponseMeta()
        rmeta.correlation_id = cid
        if ctrl.failed():
            rmeta.error_code = ctrl.error_code
            rmeta.error_text = ctrl.error_text()
        sock.write(
            _hulu_frame(rmeta.SerializeToString(), response_bytes or b""),
            ignore_eovercrowded=True,
        )

    if meta.method_name:
        method = server.find_method(meta.service_name, meta.method_name)
    else:
        method = _method_by_index(server, meta.service_name, meta.method_index)
    if method is None:
        ctrl.set_failed(
            errors.ENOMETHOD,
            f"unknown {meta.service_name}#{meta.method_index}/{meta.method_name}",
        )
        return respond(ctrl, None)
    ctrl.method_name = method.method_name
    _run_method(server, method, msg.payload, ctrl, respond)


def hulu_process_response(msg: HuluMessage, sock) -> None:
    meta = pb.HuluRpcResponseMeta()
    try:
        meta.ParseFromString(msg.meta_bytes)
    except Exception:  # noqa: BLE001
        # the correlation id lives IN the meta: with it unparseable the
        # waiting RPC can never be completed individually, and silently
        # dropping the frame would leave it hanging to timeout.  The
        # response stream is corrupt — fail the socket so every waiter
        # completes promptly with EFAILEDSOCKET.
        sock.set_failed(errors.ERESPONSE, "unparseable hulu response meta")
        return
    cid = meta.correlation_id
    ctrl = _id_pool().lock(cid)
    if ctrl is None:
        return
    if meta.error_code:
        ctrl.set_failed(meta.error_code, meta.error_text)
    else:
        try:
            if ctrl._response is not None:
                ctrl._response.ParseFromString(msg.payload.as_view())
        except Exception as e:  # noqa: BLE001
            ctrl.set_failed(errors.ERESPONSE, f"parse response failed: {e}")
    ctrl._finalize_locked(cid)


HULU = Protocol(
    name="hulu_pbrpc",
    parse=hulu_parse,
    serialize_request=hulu_serialize_request,
    pack_request=hulu_pack_request,
    process_request=hulu_process_request,
    process_response=hulu_process_response,
)


# ===========================================================================
# sofa_pbrpc
# ===========================================================================
class SofaMessage:
    __slots__ = ("meta", "payload")

    def __init__(self, meta, payload: IOBuf):
        self.meta = meta
        self.payload = payload


def sofa_parse(buf: IOBuf, sock, read_eof: bool) -> ParseResult:
    head = buf.fetch(24)
    if head is None:
        got = buf.fetch(min(len(buf), 4)) or b""
        if b"SOFA".startswith(got):
            return ParseResult.not_enough()
        return ParseResult.try_others()
    if head[:4] != b"SOFA":
        return ParseResult.try_others()
    meta_size, body_size, message_size = struct.unpack_from("<IQQ", head, 4)
    if message_size != meta_size + body_size or message_size > _MAX_BODY:
        return ParseResult.bad()
    if len(buf) < 24 + message_size:
        return ParseResult.not_enough()
    buf.pop_front(24)
    meta_bytes = buf.cut_bytes(meta_size)
    payload = IOBuf()
    buf.cutn(payload, body_size)
    meta = pb.SofaRpcMeta()
    try:
        meta.ParseFromString(meta_bytes)
    except Exception:  # noqa: BLE001
        return ParseResult.bad()
    return ParseResult.ok(SofaMessage(meta, payload))


def _sofa_frame(meta: pb.SofaRpcMeta, payload) -> IOBuf:
    meta_bytes = meta.SerializeToString()
    out = IOBuf()
    out.append(
        b"SOFA"
        + struct.pack(
            "<IQQ", len(meta_bytes), len(payload), len(meta_bytes) + len(payload)
        )
        + meta_bytes
    )
    out.append(payload)
    return out


def sofa_serialize_request(request, controller) -> IOBuf:
    return IOBuf(request.SerializeToString())


def sofa_pack_request(request_buf, wire_cid, method_spec, controller) -> IOBuf:
    meta = pb.SofaRpcMeta()
    meta.type = pb.SofaRpcMeta.REQUEST
    meta.sequence_id = wire_cid
    meta.method = f"{method_spec.service_name}.{method_spec.method_name}"
    return _sofa_frame(meta, request_buf)


def sofa_process_request(msg: SofaMessage, sock) -> None:
    server = sock.server
    ctrl = _server_controller(sock, server)
    seq = msg.meta.sequence_id

    def respond(ctrl, response_bytes):
        rmeta = pb.SofaRpcMeta()
        rmeta.type = pb.SofaRpcMeta.RESPONSE
        rmeta.sequence_id = seq
        if ctrl.failed():
            rmeta.failed = True
            rmeta.error_code = ctrl.error_code
            rmeta.reason = ctrl.error_text()
        sock.write(_sofa_frame(rmeta, response_bytes or b""), ignore_eovercrowded=True)

    full = msg.meta.method
    service_name, _, method_name = full.rpartition(".")
    # sofa uses package-qualified names: try the last two components
    method = server.find_method(service_name.rpartition(".")[2], method_name)
    if method is None:
        ctrl.set_failed(errors.ENOMETHOD, f"unknown method {full}")
        return respond(ctrl, None)
    ctrl.service_name = method.service_name
    ctrl.method_name = method.method_name
    _run_method(server, method, msg.payload, ctrl, respond)


def sofa_process_response(msg: SofaMessage, sock) -> None:
    cid = msg.meta.sequence_id
    ctrl = _id_pool().lock(cid)
    if ctrl is None:
        return
    if msg.meta.failed:
        ctrl.set_failed(msg.meta.error_code or errors.ERESPONSE, msg.meta.reason)
    else:
        try:
            if ctrl._response is not None:
                ctrl._response.ParseFromString(msg.payload.as_view())
        except Exception as e:  # noqa: BLE001
            ctrl.set_failed(errors.ERESPONSE, f"parse response failed: {e}")
    ctrl._finalize_locked(cid)


SOFA = Protocol(
    name="sofa_pbrpc",
    parse=sofa_parse,
    serialize_request=sofa_serialize_request,
    pack_request=sofa_pack_request,
    process_request=sofa_process_request,
    process_response=sofa_process_response,
)


# ===========================================================================
# nshead (+ NsheadService) — the base framing for nova/public
# ===========================================================================
class NsheadMessage:
    __slots__ = ("id", "version", "log_id", "provider", "reserved", "body")

    def __init__(self, id=0, version=0, log_id=0, provider=b"", reserved=0,
                 body: Optional[IOBuf] = None):
        self.id = id
        self.version = version
        self.log_id = log_id
        self.provider = provider
        self.reserved = reserved
        self.body = body if body is not None else IOBuf()

    def pack(self) -> IOBuf:
        out = IOBuf()
        out.append(
            struct.pack(
                _NSHEAD_FMT,
                self.id & 0xFFFF,
                self.version & 0xFFFF,
                self.log_id & 0xFFFFFFFF,
                (self.provider or b"")[:16].ljust(16, b"\x00"),
                NSHEAD_MAGIC,
                self.reserved & 0xFFFFFFFF,
                len(self.body),
            )
        )
        out.append(self.body)
        return out


def nshead_parse(buf: IOBuf, sock, read_eof: bool) -> ParseResult:
    head = buf.fetch(NSHEAD_SIZE)
    if head is None:
        # magic sits at offset 24: can't rule nshead out before that
        got = buf.fetch(min(len(buf), 28)) or b""
        if len(got) >= 28:
            (magic,) = struct.unpack_from("<I", got, 24)
            if magic != NSHEAD_MAGIC:
                return ParseResult.try_others()
        return ParseResult.not_enough()
    mid, version, log_id, provider, magic, reserved, body_len = struct.unpack(
        _NSHEAD_FMT, head
    )
    if magic != NSHEAD_MAGIC:
        return ParseResult.try_others()
    if body_len > _MAX_BODY:
        return ParseResult.bad()
    if len(buf) < NSHEAD_SIZE + body_len:
        return ParseResult.not_enough()
    buf.pop_front(NSHEAD_SIZE)
    body = IOBuf()
    buf.cutn(body, body_len)
    return ParseResult.ok(
        NsheadMessage(mid, version, log_id, provider.rstrip(b"\x00"), reserved, body)
    )


class NsheadService:
    """Raw nshead server (reference nshead_service.h): subclass,
    implement ``process(controller, request: NsheadMessage) ->
    NsheadMessage`` and register as ServerOptions.nshead_service."""

    def process(self, controller, request: NsheadMessage) -> NsheadMessage:
        raise NotImplementedError


def nshead_process_request(msg: NsheadMessage, sock) -> None:
    server = sock.server
    opts = getattr(server, "options", None)
    # a configured raw NsheadService owns ALL nshead traffic
    svc = getattr(opts, "nshead_service", None)
    if isinstance(svc, NsheadService):
        ctrl = _server_controller(sock, server)
        try:
            reply = svc.process(ctrl, msg)
        except Exception as e:  # noqa: BLE001
            log_error("nshead service raised: %r", e)
            reply = NsheadMessage(id=msg.id, log_id=msg.log_id)
        if reply is not None:
            reply.log_id = reply.log_id or msg.log_id
            sock.write(reply.pack(), ignore_eovercrowded=True)
        return
    # nova and public share the framing: discriminate by the BODY (a
    # valid PublicPbrpcRequest with a service-named body = public),
    # so one server can face both client kinds at once
    req = pb.PublicPbrpcRequest()
    try:
        req.ParseFromString(msg.body.as_view())
        if req.requestBody and req.requestBody[0].service:
            return _public_process_request(msg, sock, req)
    except Exception:  # noqa: BLE001 — not a public request
        pass
    if getattr(opts, "nova_service", None) is not None:
        return _nova_process_request(msg, sock)
    _public_process_request(msg, sock)  # answers with a public error


def nshead_process_response(msg: NsheadMessage, sock) -> None:
    """Client side: every nshead-framed protocol's responses land here.
    Routing is strict when the socket's issuing protocol is known
    (ubrpc/nshead_mcpack/public/nova each get exactly their own
    semantics — a late reply must never be parsed under another
    protocol's rules); only a plain/unknown nshead socket uses the
    body-shape heuristic, and there a public envelope is accepted only
    when its ids are cids this socket is actually waiting on (arbitrary
    nova payload bytes can parse as an all-optional proto2 message)."""
    proto = getattr(sock, "last_protocol", "")
    if proto in ("ubrpc", "nshead_mcpack"):
        if _mcpack_response_finish(msg, sock, proto):
            return
    with sock._write_lock:
        waiting = set(sock.waiting_cids)
    if proto == "public_pbrpc":
        # strict: a public socket's replies are ALWAYS the pb envelope;
        # falling through to nova parsing would bind a late reply (its
        # ids already finalized) to a newer RPC on a recycled id slot
        resp = pb.PublicPbrpcResponse()
        try:
            resp.ParseFromString(msg.body.as_view())
            if resp.responseBody:
                return _public_finish(resp)
        except Exception:  # noqa: BLE001
            pass
        # unusable reply: fail the correlated RPC fast via the echoed
        # log_id (lock()'s gen/version check rejects stale bindings)
        cid = msg.log_id
        for full in waiting:
            if wire_cid32(full) == cid:
                cid = full
                break
        ctrl = _id_pool().lock(cid)
        if ctrl is not None:
            ctrl.set_failed(errors.ERESPONSE, "unparseable public_pbrpc reply")
            ctrl._finalize_locked(cid)
        else:
            log_error("unparseable public_pbrpc reply dropped")
        return
    if proto != "nova_pbrpc":
        # plain nshead channel or unknown: best-effort heuristic
        resp = pb.PublicPbrpcResponse()
        try:
            resp.ParseFromString(msg.body.as_view())
            bodies = list(resp.responseBody)
            if bodies and all(rb.id in waiting for rb in bodies):
                return _public_finish(resp)
        except Exception:  # noqa: BLE001
            pass
    # nova-style: correlate by log_id (the gen-mixed 32-bit cid form;
    # nshead has no wider field — recover the full versioned id from
    # this socket's waiting set)
    cid = msg.log_id
    for full in waiting:
        if wire_cid32(full) == cid:
            cid = full
            break
    ctrl = _id_pool().lock(cid)
    if ctrl is None:
        return
    if msg.reserved:
        # nova replies signal failure through head.reserved (our framing
        # convention: nshead has no error field of its own)
        ctrl.set_failed(int(msg.reserved), "nova server error")
    else:
        try:
            if ctrl._response is not None:
                ctrl._response.ParseFromString(msg.body.as_view())
        except Exception as e:  # noqa: BLE001
            ctrl.set_failed(errors.ERESPONSE, f"parse response failed: {e}")
    ctrl._finalize_locked(cid)


NSHEAD = Protocol(
    name="nshead",
    parse=nshead_parse,
    serialize_request=lambda request, controller: IOBuf(
        request.SerializeToString()
        if hasattr(request, "SerializeToString")
        else bytes(request)
    ),
    pack_request=lambda request_buf, cid, spec, ctrl: NsheadMessage(
        log_id=wire_cid32(cid), body=request_buf
    ).pack(),
    process_request=nshead_process_request,
    process_response=nshead_process_response,
)


# ===========================================================================
# nova_pbrpc — nshead + pb body, method index in head.reserved
# ===========================================================================
def nova_pack_request(request_buf, wire_cid, method_spec, controller) -> IOBuf:
    nmsg = NsheadMessage(log_id=wire_cid32(wire_cid), body=request_buf)
    nmsg.reserved = getattr(method_spec, "_nova_index", 0)
    nmsg.provider = b"nova-pbrpc"
    return nmsg.pack()


def _nova_process_request(msg: NsheadMessage, sock) -> None:
    server = sock.server
    svc = getattr(server.options, "nova_service", None)
    ctrl = _server_controller(sock, server)
    method = None
    if svc is not None:
        names = sorted(svc.method_specs())
        if 0 <= msg.reserved < len(names):
            method = server.find_method(svc.service_name(), names[msg.reserved])

    def respond(ctrl, response_bytes):
        reply = NsheadMessage(id=msg.id, log_id=msg.log_id)
        if ctrl.failed():
            # nshead has no error field: reserved carries the code
            reply.reserved = ctrl.error_code & 0xFFFFFFFF
        reply.body.append(response_bytes or b"")
        sock.write(reply.pack(), ignore_eovercrowded=True)

    if method is None:
        ctrl.set_failed(errors.ENOMETHOD, f"unknown nova method {msg.reserved}")
        return respond(ctrl, None)
    ctrl.service_name = method.service_name
    ctrl.method_name = method.method_name
    _run_method(server, method, msg.body, ctrl, respond)


NOVA = Protocol(
    name="nova_pbrpc",
    parse=nshead_parse,
    serialize_request=lambda request, controller: IOBuf(request.SerializeToString()),
    pack_request=nova_pack_request,
    process_request=nshead_process_request,
    process_response=nshead_process_response,
)


# ===========================================================================
# public_pbrpc — nshead + PublicPbrpcRequest/Response
# ===========================================================================
def public_pack_request(request_buf, wire_cid, method_spec, controller) -> IOBuf:
    req = pb.PublicPbrpcRequest()
    req.requestHead.from_host = "tpubrpc"
    body = req.requestBody.add()
    body.version = "1.0"
    body.charset = "utf8"
    body.service = method_spec.service_name
    body.method_id = getattr(method_spec, "_public_method_id", 0)
    body.id = wire_cid
    body.serialized_request = bytes(request_buf.as_view())
    return NsheadMessage(
        log_id=wire_cid32(wire_cid), body=IOBuf(req.SerializeToString())
    ).pack()


def _public_process_request(msg: NsheadMessage, sock, req=None) -> None:
    server = sock.server
    if req is None:
        req = pb.PublicPbrpcRequest()
        try:
            req.ParseFromString(msg.body.as_view())
        except Exception:  # noqa: BLE001
            sock.set_failed(errors.EREQUEST, "bad nshead body")
            return
    if not req.requestBody:
        sock.set_failed(errors.EREQUEST, "empty public_pbrpc request")
        return
    body = req.requestBody[0]
    ctrl = _server_controller(sock, server)
    ctrl.service_name = body.service
    rid = body.id

    def respond(ctrl, response_bytes):
        resp = pb.PublicPbrpcResponse()
        head = resp.responseHead
        head.code = -ctrl.error_code if ctrl.failed() else 0
        if ctrl.failed():
            head.text = ctrl.error_text()
        rb = resp.responseBody.add()
        rb.id = rid
        if response_bytes:
            rb.serialized_response = response_bytes
        if ctrl.failed():
            rb.error = ctrl.error_code
        reply = NsheadMessage(id=msg.id, log_id=msg.log_id)
        reply.body.append(resp.SerializeToString())
        sock.write(reply.pack(), ignore_eovercrowded=True)

    method = _method_by_index(server, body.service, body.method_id)
    if method is None:
        ctrl.set_failed(
            errors.ENOMETHOD, f"unknown {body.service}#{body.method_id}"
        )
        return respond(ctrl, None)
    ctrl.method_name = method.method_name
    _run_method(server, method, IOBuf(body.serialized_request), ctrl, respond)


def _public_finish(resp: pb.PublicPbrpcResponse) -> None:
    for rb in resp.responseBody:
        cid = rb.id
        ctrl = _id_pool().lock(cid)
        if ctrl is None:
            continue
        if rb.error or (resp.HasField("responseHead") and resp.responseHead.code < 0):
            ctrl.set_failed(
                rb.error or errors.ERESPONSE,
                resp.responseHead.text if resp.HasField("responseHead") else "",
            )
        else:
            try:
                if ctrl._response is not None:
                    ctrl._response.ParseFromString(rb.serialized_response)
            except Exception as e:  # noqa: BLE001
                ctrl.set_failed(errors.ERESPONSE, f"parse response failed: {e}")
        ctrl._finalize_locked(cid)


PUBLIC = Protocol(
    name="public_pbrpc",
    parse=nshead_parse,
    serialize_request=lambda request, controller: IOBuf(request.SerializeToString()),
    pack_request=public_pack_request,
    process_request=nshead_process_request,
    process_response=nshead_process_response,
)


# ===========================================================================
# ubrpc + nshead_mcpack — mcpack bodies over nshead (reference
# policy/ubrpc2pb_protocol.cpp, policy/nshead_mcpack_protocol.cpp; both
# are NsheadService adaptors there too)
# ===========================================================================
class UbrpcAdaptor(NsheadService):
    """ubrpc (mcpack2 format): body is an mcpack object
    {content: [{service_name, method, id, params: [args...]}]}; the
    reply mirrors {content: [{id, result | error_code/error_text}]}.
    Register as ServerOptions.nshead_service."""

    def __init__(self, server=None):
        self._server = server  # resolved lazily from the controller

    def process(self, controller, request: NsheadMessage):
        from incubator_brpc_tpu_torch.serialization import mcpack

        server = controller.server or self._server
        sock = controller._server_socket

        def send_content(content_obj: dict):
            reply = NsheadMessage(id=request.id, log_id=request.log_id)
            reply.body.append(mcpack.dumps({"content": [content_obj]}))
            sock.write(reply.pack(), ignore_eovercrowded=True)

        try:
            doc = mcpack.loads(bytes(request.body.as_view()))
            content = doc["content"][0]
            service_name = content["service_name"]
            method_name = content["method"]
            rid = int(content.get("id", 0))
            params = content.get("params") or []
        except (KeyError, IndexError, TypeError, ValueError, struct.error) as e:
            send_content({"id": 0, "error_code": errors.EREQUEST,
                          "error_text": f"bad ubrpc request: {e}"})
            return None
        method = server.find_method(service_name, method_name)
        if method is None:
            send_content({"id": rid, "error_code": errors.ENOMETHOD,
                          "error_text": f"unknown {service_name}.{method_name}"})
            return None
        controller.service_name = service_name
        controller.method_name = method_name

        # mcpack params → pb bytes so _run_method (done contract +
        # method_status accounting) serves this protocol like the rest
        req_msg = method.request_class()
        try:
            mcpack._dict_to_msg(params[0] if params else {}, req_msg)
        except (TypeError, ValueError, AttributeError) as e:
            send_content({"id": rid, "error_code": errors.EREQUEST,
                          "error_text": f"params do not fit request: {e}"})
            return None

        def respond(ctrl, response_bytes):
            if ctrl.failed():
                send_content({"id": rid, "error_code": ctrl.error_code,
                              "error_text": ctrl.error_text()})
                return
            resp_msg = method.response_class()
            if response_bytes:
                resp_msg.ParseFromString(response_bytes)
            send_content({"id": rid, "result": mcpack._msg_to_dict(resp_msg)})

        _run_method(server, method, IOBuf(req_msg.SerializeToString()),
                    controller, respond)
        return None  # replies are sent by respond(), possibly async


class NsheadMcpackAdaptor(NsheadService):
    """nshead_mcpack: the body IS the mcpack-serialized pb message;
    every request routes to the server's FIRST service's FIRST method
    (reference NsheadMcpackAdaptor semantics). Correlation rides
    nshead.log_id (echoed back)."""

    def __init__(self):
        self._method = None  # routing target is fixed per server

    def _resolve(self, server):
        if self._method is None:
            for name in sorted(server.services()):
                specs = sorted(server.services()[name].method_specs())
                if specs:
                    self._method = server.find_method(name, specs[0])
                    break
        return self._method

    def process(self, controller, request: NsheadMessage):
        from incubator_brpc_tpu_torch.serialization import mcpack

        server = controller.server
        sock = controller._server_socket
        method = self._resolve(server)
        empty = NsheadMessage(id=request.id, log_id=request.log_id)
        if method is None:
            return empty  # no service: empty reply (ref closes the conn)
        req_msg = method.request_class()
        ok, err = mcpack.mcpack_to_proto(bytes(request.body.as_view()), req_msg)
        if not ok:
            log_error("nshead_mcpack request rejected: %s", err)
            return empty
        controller.service_name = method.service_name
        controller.method_name = method.method_name

        def respond(ctrl, response_bytes):
            reply = NsheadMessage(id=request.id, log_id=request.log_id)
            if not ctrl.failed() and response_bytes:
                resp_msg = method.response_class()
                resp_msg.ParseFromString(response_bytes)
                reply.body.append(mcpack.proto_to_mcpack(resp_msg))
            sock.write(reply.pack(), ignore_eovercrowded=True)

        # through _run_method: done contract + method_status accounting
        _run_method(server, method, IOBuf(req_msg.SerializeToString()),
                    controller, respond)
        return None


def ubrpc_pack_request(request_buf, wire_cid, method_spec, controller) -> IOBuf:
    from incubator_brpc_tpu_torch.serialization import mcpack

    req_msg = controller._ubrpc_request
    body = mcpack.dumps(
        {
            "content": [
                {
                    "service_name": method_spec.service_name,
                    "method": method_spec.method_name,
                    "id": wire_cid,
                    "params": [mcpack._msg_to_dict(req_msg)],
                }
            ]
        }
    )
    return NsheadMessage(log_id=wire_cid32(wire_cid), body=IOBuf(body)).pack()


def _ubrpc_serialize(request, controller) -> IOBuf:
    # the mcpack encoding needs the MESSAGE, not pb bytes: stash it
    controller._ubrpc_request = request
    return IOBuf()


def _mcpack_response_finish(msg: NsheadMessage, sock, protocol: str) -> bool:
    """Client completion for ubrpc / nshead_mcpack responses. → handled."""
    from incubator_brpc_tpu_torch.serialization import mcpack

    with sock._write_lock:
        waiting = set(sock.waiting_cids)
    if protocol == "ubrpc":
        try:
            doc = mcpack.loads(bytes(msg.body.as_view()))
            content = doc["content"][0]
        except (KeyError, IndexError, TypeError, ValueError, struct.error) as e:
            # an unusable ubrpc reply must FAIL the RPC here — falling
            # through to nova semantics would parse garbage (or empty
            # bytes) into the response and report silent success
            cid = msg.log_id
            for full in waiting:
                if wire_cid32(full) == cid:
                    cid = full
                    break
            ctrl = _id_pool().lock(cid)
            if ctrl is not None:
                ctrl.set_failed(errors.ERESPONSE, f"bad ubrpc reply: {e}")
                ctrl._finalize_locked(cid)
            return True
        cid = int(content.get("id", 0))
        if cid not in waiting:
            for full in waiting:
                if wire_cid32(full) == msg.log_id:
                    cid = full
                    break
        ctrl = _id_pool().lock(cid)
        if ctrl is None:
            return True
        if content.get("error_code"):
            ctrl.set_failed(int(content["error_code"]),
                            str(content.get("error_text", "")))
        else:
            try:
                if ctrl._response is not None:
                    mcpack._dict_to_msg(content.get("result") or {}, ctrl._response)
            except (TypeError, ValueError, AttributeError) as e:
                ctrl.set_failed(errors.ERESPONSE, f"bad ubrpc result: {e}")
        ctrl._finalize_locked(cid)
        return True
    # nshead_mcpack: correlate via log_id (gen-mixed 32-bit form)
    cid = msg.log_id
    for full in waiting:
        if wire_cid32(full) == cid:
            cid = full
            break
    ctrl = _id_pool().lock(cid)
    if ctrl is None:
        return True
    if len(msg.body) == 0:
        ctrl.set_failed(errors.ERESPONSE, "empty nshead_mcpack reply")
    else:
        ok, err = mcpack.mcpack_to_proto(
            bytes(msg.body.as_view()), ctrl._response
        ) if ctrl._response is not None else (True, "")
        if not ok:
            ctrl.set_failed(errors.ERESPONSE, f"bad mcpack response: {err}")
    ctrl._finalize_locked(cid)
    return True


UBRPC = Protocol(
    name="ubrpc",
    parse=nshead_parse,
    serialize_request=_ubrpc_serialize,
    pack_request=ubrpc_pack_request,
    process_request=nshead_process_request,
    process_response=nshead_process_response,
)

def _nshead_mcpack_serialize(request, controller) -> IOBuf:
    from incubator_brpc_tpu_torch.serialization import mcpack

    return IOBuf(mcpack.proto_to_mcpack(request))


NSHEAD_MCPACK = Protocol(
    name="nshead_mcpack",
    parse=nshead_parse,
    serialize_request=_nshead_mcpack_serialize,
    pack_request=lambda request_buf, cid, spec, ctrl: NsheadMessage(
        log_id=wire_cid32(cid), body=request_buf
    ).pack(),
    process_request=nshead_process_request,
    process_response=nshead_process_response,
)


# ===========================================================================
# esp — 32-byte head, client side (reference policy/esp_protocol.cpp)
# ===========================================================================
class EspMessage:
    __slots__ = ("to", "msg", "msg_id", "body")

    def __init__(self, to=0, msg=0, msg_id=0, body=b""):
        self.to = to
        self.msg = msg
        self.msg_id = msg_id
        self.body = body


def esp_parse(buf: IOBuf, sock, read_eof: bool) -> ParseResult:
    """esp frames carry NO magic: the protocol owns a socket's bytes
    only when the last request sent on it was esp (recorded by the
    issue path). A well-formed frame with an unknown msg_id (a late
    response to a timed-out RPC) is consumed and dropped downstream —
    failing the socket would kill every other in-flight RPC on it."""
    if sock.is_server_side or getattr(sock, "last_protocol", "") != "esp":
        return ParseResult.try_others()
    head = buf.fetch(ESP_HEAD_SIZE)
    if head is None:
        return ParseResult.not_enough()
    frm, to, msg, msg_id, body_len = struct.unpack(_ESP_FMT, head)
    if body_len < 0 or body_len > _MAX_BODY:
        return ParseResult.bad()
    if len(buf) < ESP_HEAD_SIZE + body_len:
        return ParseResult.not_enough()
    buf.pop_front(ESP_HEAD_SIZE)
    body = buf.cut_bytes(body_len)
    return ParseResult.ok(EspMessage(to, msg, msg_id, body))


def esp_serialize_request(request, controller) -> IOBuf:
    if isinstance(request, EspMessage):
        controller._esp_to = request.to
        controller._esp_msg = request.msg
        return IOBuf(request.body)
    return IOBuf(bytes(request))


def esp_pack_request(request_buf, wire_cid, method_spec, controller) -> IOBuf:
    channel = controller._channel
    auth = channel.options.auth if channel is not None else None
    if auth is not None:
        # reference PackEspRequest prepends the authenticator's
        # credential raw on the connection's first request
        # (policy/esp_protocol.cpp:109-114, EspAuthenticator's magic +
        # local port); the conn_preamble mechanism guarantees exactly
        # one writer sends it first.  No reply is generated for it.
        cred = auth.generate_credential()
        controller._conn_preamble = (IOBuf(cred.encode("latin1")), [])
    head = struct.pack(
        _ESP_FMT,
        0,
        getattr(controller, "_esp_to", 0),
        getattr(controller, "_esp_msg", 0),
        wire_cid,
        len(request_buf),
    )
    out = IOBuf(head)
    out.append(request_buf)
    return out


def esp_process_response(msg: EspMessage, sock) -> None:
    ctrl = _id_pool().lock(msg.msg_id)
    if ctrl is None:
        return
    ctrl.response_attachment = IOBuf(msg.body)
    ctrl._finalize_locked(msg.msg_id)


ESP = Protocol(
    name="esp",
    parse=esp_parse,
    serialize_request=esp_serialize_request,
    pack_request=esp_pack_request,
    process_response=esp_process_response,
    support_server=False,
)


def register():
    register_protocol(HULU)
    register_protocol(SOFA)
    register_protocol(NSHEAD)
    register_protocol(NOVA)
    register_protocol(PUBLIC)
    register_protocol(UBRPC)
    register_protocol(NSHEAD_MCPACK)
    register_protocol(ESP)  # must be LAST: headerless, self-validating
