"""Channel — the client entry point.

Port of the JAX package's ``client/channel.py`` (reference brpc::Channel,
channel.{h,cpp}): ``init`` takes a single server address — ``host:port``,
``unix:path`` or ``ici://slice/chip`` — or a naming URL and a load
balancer name (channel.h:160-183), and ``call_method`` drives the RPC
through the Controller (CallMethod, channel.cpp:407-584).
ChannelOptions mirrors channel.h:41-140 and keeps every field of the
JAX package's, with ``ici_device`` a ``torch.device``; a cluster
channel's client ICI port lives on it too.

``connection_type="native"`` runs tpu_std over the C++ engine
(``native/``): a sync call parks in C with the GIL released, an async
one rides the engine's reactor, and ``call_many`` crosses into C once
per window through the submission ring (``client/ring.py``).  Where the
JAX package falls back to pooled connections when the engine cannot be
built, the port raises ``native.NativeEngineError``; the semantic
degradations (another protocol, auth, a custom retry policy, TLS) stay
as they are there, logged.
"""

from __future__ import annotations

import threading
from time import monotonic_ns as _monotonic_ns
from dataclasses import dataclass, field, replace
from typing import Optional

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.global_init import global_init
from incubator_brpc_tpu_torch.metrics.latency_recorder import LatencyRecorder
from incubator_brpc_tpu_torch.protocols import find_protocol
from incubator_brpc_tpu_torch.protocols.compress import COMPRESS_TYPE_NONE
from incubator_brpc_tpu_torch.transport.input_messenger import InputMessenger
from incubator_brpc_tpu_torch.transport.socket_map import acquire_socket
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint, str2endpoint
from incubator_brpc_tpu_torch.utils.logging import log_error

@dataclass
class ChannelOptions:
    """Mirrors reference ChannelOptions (channel.h:41-140)."""

    connect_timeout_ms: int = 1000
    timeout_ms: int = 1000
    backup_request_ms: int = -1
    max_retry: int = 3
    protocol: str = "tpu_std"
    # "" = adaptive (http→pooled, else single); or single | pooled |
    # short | native (tpu_std over the C++ engine's pooled connections:
    # the whole round trip runs with the GIL released, native/engine.cpp)
    connection_type: str = ""
    connection_group: str = ""
    request_compress_type: int = COMPRESS_TYPE_NONE
    retry_policy: object = None
    ns_filter: object = None
    auth: object = None
    enable_circuit_breaker: bool = False
    # torch device owning this channel's ICI client port memory. None
    # (default): responses move by reference with no forced placement
    # hop. Set it and inbound device segments are placed onto (and,
    # same-device, transmitted through the copy+checksum kernels to)
    # that device — the full two-hop data plane.
    ici_device: object = None
    # TLS: a transport/ssl_helper.ChannelSSLOptions enables SSL on every
    # connection this channel opens (reference ChannelOptions.mutable_ssl_options,
    # channel.h; handshake in transport/socket.py Socket.connect)
    ssl_options: object = None


class Channel:
    def __init__(self, options: Optional[ChannelOptions] = None):
        # copy: init() resolves adaptive fields (connection_type) in
        # place, and mutating a caller-owned options object would leak
        # the resolution into other channels built from it
        self.options = replace(options) if options is not None else ChannelOptions()
        self.protocol = None
        self._endpoint: Optional[EndPoint] = None
        self._lb = None  # LoadBalancerWithNaming when cluster-init'ed
        self._messenger = InputMessenger()
        self._latency = None
        self._latency_lock = threading.Lock()
        self._init_done = False
        self._native_fast = False  # set by single-server init()
        self._ici_client_port = None
        self._native_mux_obj = None
        self._nf_call = None  # cached sync-call entry (ext or ctypes)
        self._native_stats_snap = (0, 0)  # (ok, latency_us_sum) harvested
        self._ssl_ctx = None  # built once from options.ssl_options
        self._ring_obj = None  # channel-cached SubmissionRing (call_many)
        self._ring_lock = threading.Lock()  # serializes call_many windows

    # ---- init (channel.h:160-183) ------------------------------------------
    def init(self, naming_url: str, lb_name: Optional[str] = None) -> int:
        """init("ip:port") for a single server, or
        init("file://path" | "list://a:1,b:2" | "tpu://fabric", "rr") for
        a cluster behind a naming service + load balancer."""
        global_init()
        self.protocol = find_protocol(self.options.protocol)
        if self.protocol is None:
            log_error("unknown protocol %r", self.options.protocol)
            return errors.EREQUEST
        self._resolve_connection_type()
        # single-endpoint forms: host:port, unix:path, ici://slice/chip
        # (an ici:// URL names ONE chip; a cluster needs lb_name + a
        # naming service URL like file:// list:// tpu://)
        if lb_name is None and (
            "://" not in naming_url
            or naming_url.startswith("ici://")
            or naming_url.startswith("unix:")
        ):
            try:
                self._endpoint = str2endpoint(naming_url)
            except ValueError as e:
                log_error("bad address %r: %r", naming_url, e)
                return errors.EREQUEST
            self._compute_native_fast()
            self._init_done = True
            return 0
        # cluster path
        from incubator_brpc_tpu_torch.client.lb_with_naming import (
            LoadBalancerWithNaming,
        )

        lb = LoadBalancerWithNaming(ici_device=self.options.ici_device)
        rc = lb.init(naming_url, lb_name or "rr", self.options.ns_filter)
        if rc != 0:
            return rc
        self._lb = lb
        self._init_done = True
        return 0

    def init_single(self, endpoint: EndPoint) -> int:
        global_init()
        self.protocol = find_protocol(self.options.protocol)
        self._resolve_connection_type()
        self._endpoint = endpoint
        self._compute_native_fast()
        self._init_done = True
        return 0

    def _compute_native_fast(self) -> None:
        """Precompute the per-channel half of the native-path gate (the
        per-controller half stays in call_method — this runs once per
        channel, call_method once per RPC)."""
        ep = self._endpoint
        self._native_fast = (
            self.options.connection_type == "native"
            and ep is not None
            and ep.scheme in ("tcp", "uds")
            and self.options.backup_request_ms < 0
            and not self.options.request_compress_type
        )

    def _resolve_connection_type(self):
        """Adaptive connection type (reference adaptive_connection_type):
        correlation-less HTTP/1 defaults to pooled — FIFO matching is
        only safe with one outstanding request per connection."""
        ct = self.options.connection_type
        if ct == "native":
            from incubator_brpc_tpu_torch import native

            # auth (credential packing) and custom retry policies live in
            # the Python call path — silently dropping them would be
            # worse than the speed win, so those channels degrade to
            # pooled (same one-in-flight-per-connection discipline)
            if (
                self.options.protocol != "tpu_std"
                or self.options.auth is not None
                or self.options.retry_policy is not None
                or self.options.ssl_options is not None
            ):
                log_error(
                    "connection_type=native needs tpu_std, no auth, no "
                    "custom retry_policy and no TLS; using pooled"
                )
                self.options.connection_type = "pooled"
                return
            # no engine, no native channel: raise NativeEngineError with
            # the compiler's message rather than serve on pooled
            native.require()
            return
        if ct not in ("single", "pooled", "short", ""):
            log_error("unknown connection_type %r, using single", ct)
            self.options.connection_type = "single"
        elif not ct:
            self.options.connection_type = (
                "pooled" if self.options.protocol == "http" else "single"
            )

    # ---- the RPC entry (CallMethod, channel.cpp:407) -----------------------
    def call_method(self, method_spec, controller, request, response, done=None):
        """Drive one RPC.  The sync native fast path is FUSED into this
        method: a sync RPC over the C++ mux reactor parks the calling
        thread in C on a per-call waiter with the GIL released
        (engine.cpp nc_mux_call), so N sync callers share a connection
        and their submissions batch into single writes.  Pack, round
        trip, and meta parse all happen in C; Python touches only the
        user payload.  Every Python operation here is paid 100k+ times
        a second, which is why the common shape (transport ok, no app
        error, plain payload) completes inline with no further calls:
        retry/deadline machinery and the generic response tail live in
        _call_native_slow and only run when something actually went
        wrong (or the response carries an attachment / compression).

        Per-call recorder work is zero — the C reactor keeps sync-call
        atomics (engine.cpp nc_mux_stats) that the LatencyRecorder
        pulls lazily (_pull_native_stats); native channels are
        single-endpoint, so there is no LB feedback either.

        The native gate runs first: _native_fast is only ever True
        after a successful init, so the uninitialized check below still
        catches every broken channel.  The immutable half of
        eligibility (connection_type, endpoint scheme, engine
        availability) is precomputed at init; per-controller bits and
        the mutable options are re-checked per call."""
        if self._native_fast:
            opts = self.options
            if (
                controller._request_stream is None
                and not controller.request_compress_type
                and not opts.request_compress_type
                and opts.backup_request_ms < 0
                # tenant identity rides RpcRequestMeta.tenant, which
                # the C mux does not pack: a tenant-tagged call must
                # take the Python path or the server would admit it as
                # the default tier, silently bypassing its quota
                and not controller.__dict__.get("tenant")
            ):
                if done is not None:
                    return self._call_native_async(
                        method_spec, controller, request, response, done
                    )
                fc = self._nf_call
                if fc is None:
                    fc = self._native_fastcall()
                    if fc is None:
                        controller.set_failed(
                            errors.EINTERNAL, "native mux unavailable"
                        )
                        return
                # bytes request = already-serialized payload (pack
                # echo-style requests ONCE, outside the call loop — no
                # per-call protobuf churn; see docs/fastpath.md)
                payload = (
                    request
                    if type(request) is bytes
                    else request.SerializeToString()
                )
                att_buf = controller.__dict__.get("request_attachment")
                att = (
                    att_buf.to_bytes()
                    if att_buf is not None and len(att_buf)
                    else b""
                )
                timeout_ms = controller.timeout_ms
                if timeout_ms is None:
                    timeout_ms = opts.timeout_ms
                key = method_spec.__dict__.get("_native_key")
                if key is None:
                    key = (
                        method_spec.service_name.encode(),
                        method_spec.method_name.encode(),
                    )
                    method_spec._native_key = key
                t0 = _monotonic_ns()
                r = fc(
                    key[0], key[1], payload, att,
                    timeout_ms if timeout_ms and timeout_ms > 0 else -1,
                    controller.log_id,
                )
                # mux_call_fast returns the body bytes directly for the
                # common shape; the ctypes fallback (and every non-plain
                # outcome) returns the 6-tuple
                if type(r) is bytes:
                    controller.latency_us = (_monotonic_ns() - t0) // 1000
                    if response is not None:
                        try:
                            response.ParseFromString(r)
                        except Exception as e:  # noqa: BLE001
                            controller.set_failed(
                                errors.ERESPONSE,
                                f"parse response failed: {e}",
                            )
                    else:
                        controller.response_bytes = r
                    return
                rc, body, att_size, ec, etext, ctype = r
                if rc == 0 and not ec and not att_size and not ctype:
                    controller.latency_us = (_monotonic_ns() - t0) // 1000
                    if response is not None:
                        try:
                            response.ParseFromString(body)
                        except Exception as e:  # noqa: BLE001
                            controller.set_failed(
                                errors.ERESPONSE,
                                f"parse response failed: {e}",
                            )
                    else:
                        controller.response_bytes = body
                    return
                return self._call_native_slow(
                    controller, response, rc, body, att_size, ec, etext,
                    ctype, t0, timeout_ms, payload, att, key, fc,
                )
        if not self._init_done:
            controller.set_failed(errors.EINTERNAL, "channel not initialized")
            if done:
                done()
            return
        controller._start_call(self, method_spec, request, response, done)
        if done is None:
            controller.join()

    def _call_native_slow(
        self, controller, response, rc, body, att_size, ec, etext, ctype,
        t0, timeout_ms, payload, att, key, fc,
    ):
        """Off the inline fast path: transport-level errors retry (the
        reactor reconnects under us) on a GLOBAL deadline — attempts
        share the remaining budget, like the Python path's single
        overall timer — then the generic response tail runs."""
        max_retry = controller.max_retry
        if max_retry is None:
            max_retry = self.options.max_retry
        deadline_ns = (
            t0 + timeout_ms * 1_000_000
            if timeout_ms and timeout_ms > 0
            else None
        )
        attempt = 1
        while rc not in (0, -110) and attempt <= max(0, max_retry):
            if deadline_ns is None:
                per_call_ms = -1
            else:
                remaining_ms = (deadline_ns - _monotonic_ns()) // 1_000_000
                if remaining_ms <= 0:
                    rc = -110  # deadline exhausted mid-retry
                    break
                per_call_ms = max(1, int(remaining_ms))
            controller.retry_count = attempt
            r = fc(
                key[0], key[1], payload, att, per_call_ms, controller.log_id
            )
            if type(r) is bytes:  # mux_call_fast common-shape contract
                rc, body, att_size, ec, etext, ctype = 0, r, 0, 0, None, 0
            else:
                rc, body, att_size, ec, etext, ctype = r
            attempt += 1
        controller.latency_us = (_monotonic_ns() - t0) // 1000
        self._finish_native_response(
            controller, response, rc, body, att_size, ec, etext, ctype
        )

    def _finish_native_response(
        self, controller, response, rc, body, att_size, ec, etext, ctype
    ):
        """Shared completion tail for the sync and async native paths:
        rc→error mapping, attachment split, decompression, parse."""
        if rc == -110:
            controller.set_failed(errors.ERPCTIMEDOUT, "reached timeout")
            return
        if rc != 0:
            controller.set_failed(
                errors.EFAILEDSOCKET, f"native transport error rc={rc}"
            )
            return
        if ec:
            controller.set_failed(ec, etext or "")
            return
        if response is None and not ctype and not att_size:
            # bytes mode, plain payload: the caller gets the raw
            # response bytes and parses (or not) on its own schedule.
            # Compressed or attachment-bearing responses fall through
            # to the generic tail below — one copy of that logic.
            controller.response_bytes = body
            return
        if not att_size and not ctype:
            # plain-response fast path (the overwhelmingly common shape):
            # parse straight into the user message, nothing else to do
            try:
                response.ParseFromString(body)
            except Exception as e:  # noqa: BLE001
                controller.set_failed(
                    errors.ERESPONSE, f"parse response failed: {e}"
                )
            return
        from incubator_brpc_tpu_torch.utils.iobuf import IOBuf

        msg_end = len(body) - att_size  # att_size validated <= body in C
        if att_size:
            controller.response_attachment = IOBuf(body[msg_end:])
        msg_bytes = body[:msg_end]
        if ctype:
            from incubator_brpc_tpu_torch.protocols import compress as compress_mod

            buf = compress_mod.decompress(IOBuf(msg_bytes), ctype)
            if buf is None:
                controller.set_failed(
                    errors.ERESPONSE, f"unsupported compress type {ctype}"
                )
                return
            msg_bytes = buf.to_bytes()
        if response is None:
            controller.response_bytes = msg_bytes
            return
        try:
            response.ParseFromString(msg_bytes)
        except Exception as e:  # noqa: BLE001
            controller.set_failed(
                errors.ERESPONSE, f"parse response failed: {e}"
            )

    def _call_native_async(self, method_spec, controller, request, response, done):
        """Async RPC over the C++ mux reactor: submissions batch into
        single writes, completions harvest in batches — the pipelined
        path that amortizes per-RPC syscalls (done runs on the
        harvester thread, like reference done on a bthread worker).
        Closure-free: per-call state rides one context tuple dispatched
        to the stable bound method _native_async_complete, keeping the
        per-call GIL-held cost a few microseconds (the whole user call
        budget on one core is ~7us).  Transport errors retry on the
        shared global deadline, matching the sync native path."""
        mux = self._native_mux()
        if mux is None:
            controller.set_failed(errors.EINTERNAL, "native mux unavailable")
            done()
            return
        payload = (
            request if type(request) is bytes else request.SerializeToString()
        )
        att_buf = controller.__dict__.get("request_attachment")
        att = att_buf.to_bytes() if att_buf is not None and len(att_buf) else b""
        timeout_ms = (
            controller.timeout_ms
            if controller.timeout_ms is not None
            else self.options.timeout_ms
        )
        max_retry = (
            controller.max_retry
            if controller.max_retry is not None
            else self.options.max_retry
        )
        key = getattr(method_spec, "_native_key", None)
        if key is None:
            key = (
                method_spec.service_name.encode(),
                method_spec.method_name.encode(),
            )
            method_spec._native_key = key
        t0 = _monotonic_ns()
        deadline_ns = (
            t0 + timeout_ms * 1_000_000 if timeout_ms and timeout_ms > 0 else None
        )
        ctx = [
            controller, response, done, t0, deadline_ns,
            max(0, max_retry), key, payload, att, mux,
        ]
        if not self._native_async_submit(ctx, -1 if timeout_ms is None or timeout_ms <= 0 else timeout_ms):
            controller.set_failed(errors.EINTERNAL, "native mux unavailable")
            done()

    def _native_async_submit(self, ctx, per_call_ms) -> bool:
        mux = ctx[9]
        key = ctx[6]
        return mux.submit_ctx(
            key[0], key[1], ctx[7], ctx[8], per_call_ms,
            ctx[0].log_id, self._native_async_complete, ctx,
        )

    def _native_async_complete(self, ctx, rc, body, att_size, ec, etext, ctype):
        """Runs on the mux harvester thread, once per completion."""
        controller = ctx[0]
        response = ctx[1]
        done = ctx[2]
        t0 = ctx[3]
        deadline_ns = ctx[4]
        retries_left = ctx[5]
        if rc not in (0, -110) and retries_left > 0:
            # transport error: retry within the remaining global budget.
            # A computed remaining <= 0 must NOT collapse into the -1
            # "no deadline" sentinel (an expired call would resubmit
            # with an infinite timeout and hang past its deadline).
            ctx[5] = retries_left - 1
            controller.retry_count += 1
            if deadline_ns is None:
                if self._native_async_submit(ctx, -1):
                    return
            else:
                remaining = (deadline_ns - _monotonic_ns()) // 1_000_000
                if remaining > 0 and self._native_async_submit(
                    ctx, int(remaining)
                ):
                    return
                rc = -110
        controller.latency_us = (_monotonic_ns() - t0) // 1000
        self._finish_native_response(
            controller, response, rc, body if body is not None else b"",
            att_size, ec, etext, ctype,
        )
        self._on_rpc_end(controller)
        done()

    # ---- vectorized calls (submission/completion ring) ---------------------
    def call_many(self, method_spec, requests, timeout_ms=None,
                  controllers=None):
        """Vectorized RPC: N same-method requests cross the Python↔C
        boundary as a WINDOW (one mux_submit_many) and complete in
        harvest bursts — io_uring's amortization applied to the per-call
        crossing that caps the sync fast path (client/ring.py has the
        full contract).  Returns results IN ORDER: response bytes per
        success, a ring.RingFailure(error_code, error_text) per failure
        — the same ERPC codes the per-call path would set.  A reply that
        carried an attachment (a ``PsService.Get``'s value) comes back as
        a ring.RingReply: a ``bytes`` subclass holding the message, with
        the attachment as an IOBuf on ``.attachment``; a reply without
        one stays plain ``bytes``.

        ``controllers``, when given, is a parallel list; a non-None
        entry makes THAT call degrade to ``call_method`` with that
        controller (tenant-tagged calls keep the tenant quota rule; any
        per-call override — attachment, compression, stream — keeps its
        exact old semantics).  Non-native channels (including fan-out /
        combo subclasses, which inherit this method) degrade entirely:
        every call runs through ``call_method`` with a pooled,
        wiped-on-recycle controller — byte-for-byte the old path."""
        from incubator_brpc_tpu_torch.client import ring as _ring

        with self._ring_lock:
            return _ring.call_many(
                self, method_spec, requests, timeout_ms, controllers
            )

    def submission_ring(self, depth: int = 128):
        """A caller-owned SubmissionRing for pipelined use — the async
        ``submit()/harvest()`` pair (stage calls as they arrive, harvest
        completions in bursts, overlap with application work).  Each
        ring belongs to one thread; ``call_many`` uses a separate
        channel-internal ring and does not contend with these."""
        from incubator_brpc_tpu_torch.client.ring import SubmissionRing

        return SubmissionRing(self, depth)

    def _submission_ring(self):
        """The channel-cached ring backing call_many (callers hold
        _ring_lock)."""
        if self._ring_obj is None:
            from incubator_brpc_tpu_torch.client.ring import SubmissionRing

            self._ring_obj = SubmissionRing(self)
        return self._ring_obj

    def _native_fastcall(self):
        """Resolve + cache the sync-call entry point: the CPython
        extension's mux_call pre-bound to the reactor handle when the
        extension built, else the ctypes call_blocking wrapper."""
        mux = self._native_mux()
        if mux is None:
            return None
        self._nf_call = mux.fast_call_entry()
        return self._nf_call

    def _native_mux(self):
        if self._native_mux_obj is None:
            with self._latency_lock:
                if self._native_mux_obj is None:
                    import socket as _pysock

                    from incubator_brpc_tpu_torch import native

                    try:
                        # UDS: the engine treats a '/'-prefixed host as a
                        # unix-domain path (port ignored)
                        if self._endpoint.scheme == "uds":
                            host, port = self._endpoint.host, 0
                        else:
                            host = _pysock.gethostbyname(self._endpoint.host)
                            port = self._endpoint.port
                        # one conn per channel: the best-measured shape
                        # on the bench curve, and it maps one channel to
                        # one engine worker like the pooled path did
                        self._native_mux_obj = native.NativeMuxClient(
                            host, port, nconns=1
                        )
                    except OSError as e:
                        log_error("native mux init failed: %r", e)
        return self._native_mux_obj


    # ---- socket selection (Controller::IssueRPC hooks) ---------------------
    def _select_socket(self, controller):
        """Returns (err, sid, server_node); single-server channels share
        the connection via SocketMap, ici:// ones the fabric port;
        cluster channels ask the LB."""
        if self._lb is not None:
            return self._lb.select_server(controller, self._messenger)
        if self._endpoint.is_ici():
            sid = self._ici_port().connect(self._endpoint.coords)
            if sid is None:
                return errors.EFAILEDSOCKET, 0, None
            return 0, sid, None
        err, sid = acquire_socket(
            self._endpoint,
            self._messenger,
            self._signature(),
            self.options.connection_type,
            self.options.connect_timeout_ms / 1000.0,
            controller,
            ssl_params=self._ssl_params(),
        )
        return err, sid, None

    def _ici_port(self):
        if self._ici_client_port is None:
            with self._latency_lock:  # double-checked: one port per channel
                if self._ici_client_port is None:
                    from incubator_brpc_tpu_torch.parallel.ici import (
                        acquire_client_port,
                    )

                    # default device=None: responses move by reference, no
                    # forced placement hop; options.ici_device opts into
                    # device-owned delivery (see ChannelOptions)
                    self._ici_client_port = acquire_client_port(
                        device=self.options.ici_device
                    )
        return self._ici_client_port

    def close(self):
        """Release channel resources: the client ICI port, the native
        mux client, and the LB/naming watcher chain, if any."""
        mux = self._native_mux_obj
        if mux is not None:
            self._native_mux_obj = None
            self._nf_call = None
            self._ring_obj = None  # its tags die with the mux
            mux.destroy()
        port = self._ici_client_port
        if port is not None:
            from incubator_brpc_tpu_torch.parallel.ici import get_fabric

            self._ici_client_port = None
            get_fabric().unregister(port.coords)
        if self._lb is not None:
            lb, self._lb = self._lb, None
            self._init_done = False
            lb.close()

    def _signature(self) -> str:
        # the ssl marker keeps TLS and plaintext channels — and channels
        # with DIFFERENT TLS configs (verification, client certs) — from
        # sharing a connection (reference hashes the full
        # ChannelSSLOptions into the SocketMapKey's ChannelSignature)
        ssl_mark = ""
        if self.options.ssl_options is not None:
            import hashlib

            ssl_mark = (
                ":ssl:"
                + hashlib.md5(
                    repr(self.options.ssl_options).encode()
                ).hexdigest()[:10]
            )
        return f"{self.options.protocol}:{self.options.connection_group}{ssl_mark}"

    def _ssl_params(self):
        """(SSLContext, sni_hostname) or None; context built once."""
        opts = self.options.ssl_options
        if opts is None:
            return None
        if self._ssl_ctx is None:
            with self._latency_lock:
                if self._ssl_ctx is None:
                    from incubator_brpc_tpu_torch.transport.ssl_helper import (
                        make_client_context,
                    )

                    self._ssl_ctx = make_client_context(opts)
        return (self._ssl_ctx, opts.sni_name)

    def _on_rpc_end(self, controller):
        """Per-RPC bookkeeping: latency recorder + LB feedback
        (reference Controller::Call::OnComplete).  Batched recording:
        the ~1.5us per-call recorder write would cap aggregate qps on
        its own; observations fold in at the 1 Hz sampler tick."""
        rec = self._latency or self._latency_recorder()
        if not controller.error_code:
            rec.update_batched(controller.latency_us)
        if self._lb is not None:
            self._lb.feedback(controller)

    def _pull_native_stats(self):
        """Lazy harvest of the C mux client's sync-call atomics into the
        LatencyRecorder (called from the recorder before reads and at
        sampler ticks — the sync fast path itself records NOTHING in
        Python).  Counts fold via update_bulk, so percentiles over
        native sync traffic read as the interval mean (bulk_folded)."""
        mux = self._native_mux_obj
        rec = self._latency
        if mux is None or rec is None:
            return
        s = mux.stats()
        last = self._native_stats_snap
        dn = s["ok"] - last[0]
        if dn > 0:
            dsum = s["latency_us_sum"] - last[1]
            self._native_stats_snap = (s["ok"], s["latency_us_sum"])
            rec.update_bulk(dsum // dn, dn)
        if s["latency_us_max"]:
            rec.note_max(s["latency_us_max"])

    def _latency_recorder(self) -> LatencyRecorder:
        if self._latency is None:
            with self._latency_lock:
                if self._latency is None:
                    rec = LatencyRecorder()
                    if self._native_fast:
                        rec.set_pull_source(self._pull_native_stats)
                    self._latency = rec
        return self._latency

    def latency_recorder(self) -> LatencyRecorder:
        return self._latency_recorder()
