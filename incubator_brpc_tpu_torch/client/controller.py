"""Controller — per-RPC state machine shared by client & server roles.

Analog of reference brpc::Controller (controller.{h,cpp}): carries
timeouts, retry budget, compression, attachments, error state, the
versioned correlation id, and drives IssueRPC (controller.cpp:985-1199)
plus the retry/backup arbitration of OnVersionedRPCReturned (:568).

Client lifecycle (mirrors SURVEY.md §3.2):
  CallMethod → create CallId(on_error=_id_on_error) → serialize once →
  arm deadline (+backup) timer → IssueRPC → [sync] join(cid)
  response → protocol locks wire cid (stale attempts fail) →
  _on_response → finalize → unlock_and_destroy → join wakes / done runs
  error (timeout / socket failure) → _id_on_error under the id lock →
  retry (bump version, reissue) or finalize.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.client.retry import default_retry_policy
from incubator_brpc_tpu_torch.protocols.compress import COMPRESS_TYPE_NONE
from incubator_brpc_tpu_torch.runtime import scheduler
from incubator_brpc_tpu_torch.runtime.call_id import default_pool as _id_pool
from incubator_brpc_tpu_torch.runtime.timer_thread import get_timer_thread
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint
from incubator_brpc_tpu_torch.utils.iobuf import IOBuf
from incubator_brpc_tpu_torch.utils.logging import log_error

# Controller freelist (Controller.acquire/release).  A plain list:
# append/pop are GIL-atomic, and a stale controller is always released
# pre-wiped, so acquire hands out objects indistinguishable from fresh
# ones.  Bounded so a burst can't pin memory forever.
_pool: list = []
_POOL_MAX = 4096


def acquire_controller() -> "Controller":
    """Pooled Controller for high-rate callers (see docs/fastpath.md).
    Flat implementation — this pair runs once per RPC on the fast path,
    so it skips the method-dispatch hop of Controller.acquire/release."""
    try:
        return _pool.pop()  # GIL-atomic
    except IndexError:
        return Controller()


def release_controller(controller: "Controller") -> None:
    controller.__dict__.clear()
    if len(_pool) < _POOL_MAX:
        _pool.append(controller)


class Controller:
    # ---- field defaults -----------------------------------------------------
    # All immutable defaults live on the CLASS: constructing a
    # Controller touches no instance state at all, so Controller() costs
    # ~0.1us instead of ~2.4us of attribute stores.  That matters
    # because the native sync/async fast paths create one per RPC and
    # the whole user-visible call budget on one core is ~7us
    # (reference parity: Controller is a POD-ish stack object there,
    # controller.h).  reset() is a __dict__ wipe back to these defaults.
    # Mutable fields (IOBufs, lists, lock, set) are lazily materialized
    # by the properties below on first touch; _start_call materializes
    # the lock eagerly before any cross-thread use.
    # shared state
    error_code = 0
    _error_text = ""
    request_compress_type = COMPRESS_TYPE_NONE
    response_compress_type = COMPRESS_TYPE_NONE
    log_id = 0
    remote_side: Optional[EndPoint] = None
    local_side: Optional[EndPoint] = None
    # client state
    timeout_ms: Optional[int] = None  # None = channel default
    max_retry: Optional[int] = None
    retry_count = 0
    # tenant identity for server-side admission control
    # (docs/overload.md): packed into RpcRequestMeta.tenant; the server
    # maps it to a priority tier / quota at dispatch
    tenant = ""
    # True while arbitrating an error the SERVER returned (vs one the
    # local transport generated) — the retry policy's retry-elsewhere
    # rule for EOVERCROWDED reads it
    _error_from_server = False
    backup_request_ms: Optional[int] = None
    call_id = 0  # base cid (any-version form used by timers)
    _current_cid = 0  # wire cid of the live attempt
    _channel = None
    _method_spec = None
    _request_buf: Optional[IOBuf] = None
    _response = None
    _done: Optional[Callable] = None
    _timer_id = 0
    _backup_timer_id = 0
    _retry_backoff_timer_id = 0  # pending backed-off retry (chaos/backoff)
    _start_ns = 0
    latency_us = 0
    # server's own elapsed time (RpcResponseMeta.server_time_us): the
    # leg's latency_us minus this is the wire+queue residual the
    # cluster straggler attribution splits on (observability/cluster.py)
    server_time_us = 0
    # server-side anchor for stamping server_time_us into the response
    _server_recv_ns = 0
    _retry_policy = None
    _used_backup = False
    _sending_sid = 0
    _selected_server = None  # LB bookkeeping (Feedback)
    # FIFO entries the next write must register atomically with its
    # queue position (set by pack_request of pipelined protocols)
    _pipelined_entries = None
    # (bytes, entries) to prepend once per connection (redis AUTH)
    _conn_preamble = None
    _auth_context = None  # per-request identity (h2 per-stream auth)
    _finalized = False
    _span = None
    # raw response payload when the call ran in bytes mode (native fast
    # path with response=None); None otherwise
    response_bytes = None
    # server state
    server = None
    _server_socket = None
    _server_cid = 0
    _server_meta = None
    service_name = ""
    method_name = ""
    # streaming
    _request_stream = None
    _response_stream = None
    _remote_stream_settings = None
    _session_local = None  # pooled per-RPC user data (server side)
    # progressive bodies (reference progressive_attachment.h)
    _read_progressively = False  # client opt-in, set before call
    _progressive_body = None  # client: _ProgressiveBody to read
    _progressive_attachment = None  # server: PA being written

    def __init__(self):
        pass

    def reset(self):
        self.__dict__.clear()

    # ---- pooled construction (the zero-Python-per-call fast path) ----------
    # The reference's Controller is a stack object reused implicitly per
    # call frame (controller.h); here the analog is an explicit LIFO
    # freelist.  Contract (docs/fastpath.md): release() wipes ALL
    # per-call state (reset is a __dict__ clear back to class defaults),
    # so nothing — errors, timeouts, attachments, retry counts — can
    # bleed into the next acquire.  Never release a controller whose RPC
    # is still in flight (async: release only from/after done()).
    @classmethod
    def acquire(cls) -> "Controller":
        return acquire_controller()

    def release(self):
        release_controller(self)

    # ---- lazily-materialized mutable fields ---------------------------------
    # Data descriptors shadow the instance __dict__, so the properties
    # own the storage: getters create-on-first-touch, setters write the
    # same slot.  Untouched fields cost nothing per instance.
    @staticmethod
    def _lazy(name, factory):
        def get(self):
            v = self.__dict__.get(name)
            if v is None:
                v = self.__dict__[name] = factory()
            return v

        def set_(self, v):
            self.__dict__[name] = v

        return property(get, set_)

    request_attachment = _lazy.__func__("request_attachment", IOBuf)
    response_attachment = _lazy.__func__("response_attachment", IOBuf)
    _lb_dispatches = _lazy.__func__("_lb_dispatches", list)
    _waiter_regs = _lazy.__func__("_waiter_regs", list)
    # sockets this RPC borrowed exclusively (connection_type pooled/
    # short): (kind, sid, remote, signature); released at finalize
    _owned_sockets = _lazy.__func__("_owned_sockets", list)
    _excluded = _lazy.__func__("_excluded", set)  # servers already tried
    # monotonic_ns stamp per issued attempt (chaos retry-spacing asserts)
    _attempt_times_ns = _lazy.__func__("_attempt_times_ns", list)
    # guards the dispatch/waiter lists against a backup attempt racing
    # finalize: issue_rpc runs spawned, outside the id lock, and may
    # register a waiter/dispatch after _finalize_locked swept them
    _rpc_end_lock = _lazy.__func__("_rpc_end_lock", threading.Lock)

    # ---- error surface (controller.h) --------------------------------------
    def failed(self) -> bool:
        return self.error_code != 0

    def error_text(self) -> str:
        return self._error_text or (
            errors.error_text(self.error_code) if self.error_code else ""
        )

    def set_failed(self, code: int, text: str = ""):
        self.error_code = code or errors.EINTERNAL
        self._error_text = text

    # ---- per-attempt bookkeeping (swept by _finalize_locked) ----------------
    def try_record_dispatch(self, node) -> bool:
        """Record an LB on_dispatch for the end-of-RPC sweep. False =
        the RPC already finalized; the caller must undo its dispatch."""
        with self._rpc_end_lock:
            if self._finalized:
                return False
            self._lb_dispatches.append(node)
            return True

    def take_dispatches(self):
        with self._rpc_end_lock:
            d = self._lb_dispatches
            self._lb_dispatches = []
            return d

    def _try_record_waiter(self, sid: int, wire_cid: int) -> bool:
        with self._rpc_end_lock:
            if self._finalized:
                return False
            self._waiter_regs.append((sid, wire_cid))
            return True

    def try_record_owned(self, entry) -> bool:
        """Record a pooled/short socket borrow for the finalize release.
        False = already finalized; the caller must release it itself."""
        with self._rpc_end_lock:
            if self._finalized:
                return False
            self._owned_sockets.append(entry)
            return True

    # ---- client call driving ------------------------------------------------
    def _start_call(self, channel, method_spec, request, response, done):
        from incubator_brpc_tpu_torch.protocols import find_protocol

        # materialize the end-of-RPC lock while still single-threaded:
        # lazy creation from two racing threads would yield two locks
        self._rpc_end_lock  # noqa: B018 — touch creates it
        self._channel = channel
        self._method_spec = method_spec
        self._response = response
        self._done = done
        self._retry_policy = channel.options.retry_policy or default_retry_policy()
        if self.timeout_ms is None:
            self.timeout_ms = channel.options.timeout_ms
        if self.max_retry is None:
            self.max_retry = channel.options.max_retry
        if self.backup_request_ms is None:
            self.backup_request_ms = channel.options.backup_request_ms
        if self.request_compress_type == COMPRESS_TYPE_NONE:
            self.request_compress_type = channel.options.request_compress_type
        self._start_ns = time.monotonic_ns()
        # rpcz client span (Span::CreateClientSpan, channel.cpp:478)
        from incubator_brpc_tpu_torch.observability.span import Span

        self._span = Span.create_client(
            method_spec.service_name, method_spec.method_name
        )
        proto = channel.protocol
        pool = _id_pool()
        self._current_cid = pool.create(data=self, on_error=Controller._id_on_error)
        from incubator_brpc_tpu_torch.runtime.call_id import wildcard

        self.call_id = wildcard(self._current_cid)
        # serialize ONCE per RPC (channel.cpp:517)
        try:
            self._request_buf = proto.serialize_request(request, self)
        except Exception as e:  # noqa: BLE001
            self.set_failed(errors.EREQUEST, f"serialize failed: {e}")
            pool.lock(self._current_cid)
            self._finalize_locked(self._current_cid)
            return
        # arm overall deadline (channel.cpp:550-567)
        if self.timeout_ms and self.timeout_ms > 0:
            self._timer_id = get_timer_thread().schedule(
                self._handle_timeout, self.timeout_ms / 1000.0, self.call_id
            )
        if self.backup_request_ms and self.backup_request_ms > 0:
            self._backup_timer_id = get_timer_thread().schedule(
                self._handle_backup_request, self.backup_request_ms / 1000.0,
                self.call_id,
            )
        self.issue_rpc(self._current_cid)

    def join(self):
        _id_pool().join(self.call_id)

    def issue_rpc(self, wire_cid: int):
        """Select a server socket and send (IssueRPC, controller.cpp:985).
        Called without the id lock held."""
        # Stale-spawn guard, BEFORE any state is touched: a backed-off
        # retry spawn can outlive its RPC (timer pops racing finalize).
        # A mismatched cid means this attempt's world is gone — the
        # call finalized and the Controller was released (wiped cid 0)
        # or even reacquired for a new call (fresh cid); a live newer
        # attempt also invalidates this one (version bumped).  Writing
        # anything here would repopulate a pooled controller.
        if wire_cid != self._current_cid or self._channel is None:
            return
        # attempt-time stamp: one ns clock read + list append per
        # ATTEMPT (not per call on the fused native path, which never
        # enters issue_rpc) — the chaos harness asserts retry/backoff
        # spacing against these
        self._attempt_times_ns.append(time.monotonic_ns())
        channel = self._channel
        proto = channel.protocol
        err, sid, server = channel._select_socket(self)
        if err:
            # couldn't reach any server: feed the error through the id so
            # retry/finalize arbitration stays in one place
            _id_pool().error(wire_cid, err, "failed to select/connect server")
            return
        self._sending_sid = sid
        self._selected_server = server
        from incubator_brpc_tpu_torch.transport.socket import Socket

        sock = Socket.address(sid)
        if sock is None or sock.failed:
            _id_pool().error(wire_cid, errors.EFAILEDSOCKET, "socket gone")
            return
        self.remote_side = sock.remote
        # headerless protocols (esp) validate incoming bytes against
        # the protocol this socket is actually speaking
        sock.last_protocol = proto.name
        # A backup/retry attempt racing finalize must leave ZERO
        # per-socket state behind (waiting_cids, http pipelined_info),
        # or the connection desynchronizes. Ordering: create the state,
        # then publish it for the finalize sweep; on a lost race the
        # publish fails and this attempt undoes its own state — the
        # sweep can never miss a published registration.
        if proto.issue is not None:
            # stateful protocols (h2) pack+write atomically themselves
            # and register the response waiter internally
            if not sock.is_server_side and not self._try_record_waiter(sid, wire_cid):
                return  # finalized before any state was created
            try:
                proto.issue(sock, self._request_buf, wire_cid, self._method_spec, self)
            except Exception as e:  # noqa: BLE001
                _id_pool().error(wire_cid, errors.EREQUEST, f"issue failed: {e}")
            with self._rpc_end_lock:
                swept = self._finalized
            if swept:
                # finalize may have swept before issue() registered the
                # waiter; removing again here is idempotent either way
                sock.remove_response_waiter(wire_cid)
            return
        if not sock.is_server_side:
            sock.add_response_waiter(wire_cid)
            if not self._try_record_waiter(sid, wire_cid):
                sock.remove_response_waiter(wire_cid)
                return
        try:
            packet = proto.pack_request(
                self._request_buf, wire_cid, self._method_spec, self
            )
        except Exception as e:  # noqa: BLE001
            _id_pool().error(wire_cid, errors.EREQUEST, f"pack failed: {e}")
            return
        entries, self._pipelined_entries = self._pipelined_entries, None
        preamble, self._conn_preamble = self._conn_preamble, None
        prev_span = None
        # Scope this attempt's span as the task-local parent while the
        # packet enters the transport — but only on fabric sockets:
        # that is where collective sub-spans (ici/dcn legs) are created
        # and need the client span as parent. Kernel sockets create no
        # sub-spans, so the TCP hot path skips both TLS swaps.
        swap = self._span is not None and sock.ici_port is not None
        if self._span is not None:
            # the generic "write" stamp: for a client span the queued
            # bytes are the REQUEST; sent_us follows at flush
            self._span.response_write_us = time.time_ns() // 1000
        if swap:
            from incubator_brpc_tpu_torch.observability.span import swap_current_span

            prev_span = swap_current_span(self._span)
        try:
            rc = sock.write(
                packet, notify_cid=wire_cid, pipelined_entries=entries,
                conn_preamble=preamble, span=self._span,
            )
        finally:
            if swap:
                swap_current_span(prev_span)
        # rc!=0 already routed the error through the id pool

    # ---- error / timeout / retry arbitration -------------------------------
    def _reissue_after_backoff(self, cid):
        """Timer-thread continuation of a backed-off retry: the timer
        only SPAWNS the attempt (issue_rpc may block on connect).
        Two stale-firing guards — the timer may pop concurrently with
        finalize (unschedule misses an already-popped entry):
        _current_cid no longer matching catches a released/reused
        Controller (release wipes it to 0, a new call mints a new cid);
        _finalized catches completed-but-not-yet-released.  Read via
        __dict__ so a released controller is not re-polluted by the
        lazy-lock property.  The residual spawn-vs-finalize window is
        the same one backup requests already have: issue_rpc's
        _try_record_waiter undoes the attempt's state on a lost race."""
        if self._current_cid != cid or self.__dict__.get("_finalized"):
            return
        scheduler.spawn(self.issue_rpc, cid)

    def remaining_ms(self) -> Optional[float]:
        """Milliseconds left in this RPC's overall deadline budget;
        None when the call has no deadline."""
        if not self.timeout_ms or self.timeout_ms <= 0 or not self._start_ns:
            return None
        elapsed_ms = (time.monotonic_ns() - self._start_ns) / 1e6
        return self.timeout_ms - elapsed_ms

    def attempt_times_ns(self) -> list:
        """monotonic_ns stamps of every attempt issued (first try,
        retries, backups) — the chaos harness reads retry spacing here."""
        return list(self.__dict__.get("_attempt_times_ns") or ())

    def _attempt_pending(self) -> bool:
        """Whether any of this RPC's issued attempts is still awaiting
        a response (its waiter remains registered on its socket — the
        responding attempt's waiter is removed at parse time, before
        the id is locked).  Used by hedge arbitration: an error from
        one replica must not decide the RPC while another attempt is
        live."""
        from incubator_brpc_tpu_torch.transport.socket import Socket

        with self._rpc_end_lock:
            regs = list(self._waiter_regs)
        for sid, cid_reg in regs:
            sock = Socket.address(sid)
            if sock is not None and not sock.failed:
                with sock._write_lock:
                    if cid_reg in sock.waiting_cids:
                        return True
        return False

    def has_unexcluded_replica(self) -> bool:
        """Whether the channel's cluster still offers a replica this
        RPC has not already tried/excluded — the retry policy's
        "EOVERCROWDED is retriable only on a DIFFERENT server" gate.
        Single-server channels (no LB) have nowhere else to go."""
        channel = self._channel
        lb = getattr(channel, "_lb", None)
        if lb is None:
            return False
        excluded = set(self.__dict__.get("_excluded") or ())
        if self._selected_server is not None:
            excluded.add(self._selected_server)
        return any(n not in excluded for n in lb.servers())

    def _handle_timeout(self, cid):
        _id_pool().error(cid, errors.ERPCTIMEDOUT, "reached timeout")

    def _handle_backup_request(self, cid):
        _id_pool().error(cid, errors.EBACKUPREQUEST, "")

    @staticmethod
    def _id_on_error(data, cid, error_code, error_text):
        """Runs UNDER the id lock (reference bthread_id_error semantics)."""
        self: Controller = data
        pool = _id_pool()
        if error_code == errors.EBACKUPREQUEST:
            # hedged request: send a second attempt, keep first in flight
            # (channel.cpp:537-558). Same wire cid version: first response wins.
            # A pending backed-off retry is superseded — this backup IS
            # the reissue (just earlier); leaving the timer armed would
            # put a THIRD identical attempt on the wire when it pops.
            if self._retry_backoff_timer_id:
                get_timer_thread().unschedule(self._retry_backoff_timer_id)
                self._retry_backoff_timer_id = 0
            self._used_backup = True
            # hedge to a DIFFERENT replica (docs/overload.md): the slow
            # attempt's server joins the exclusion set so the LB picks
            # another one — a backup landing on the same wedged replica
            # hedges nothing.  Single-server channels have no LB and
            # reissue on the shared connection as before.
            if self._selected_server is not None:
                self._excluded.add(self._selected_server)
            pool.unlock(cid)
            scheduler.spawn(self.issue_rpc, self._current_cid)
            return
        if error_code not in (
            errors.ERPCTIMEDOUT, errors.ECANCELED
        ) and self._try_retry_locked(cid, error_code, error_text):
            return
        self.set_failed(error_code, error_text)
        self._finalize_locked(cid)

    def _try_retry_locked(self, cid, error_code, error_text) -> bool:
        """Retry arbitration under the id lock, shared by transport
        errors (_id_on_error) and server-returned retriable codes
        (_on_response — an EOVERCROWDED shed from admission arrives as
        a RESPONSE, not a socket failure, and must still reissue
        against a different replica).  True = a new attempt was
        scheduled and the id stays alive; False = the caller finalizes
        with the error."""
        if self.retry_count >= (self.max_retry or 0):
            return False
        pool = _id_pool()
        self.error_code = error_code
        self._error_text = error_text
        if not self._retry_policy.do_retry(self):
            self.error_code = 0
            self._error_text = ""
            return False
        self.error_code = 0
        self._error_text = ""
        # the origin marker is per-arbitration, not per-RPC: the NEXT
        # attempt's error must re-establish where it came from
        self.__dict__.pop("_error_from_server", None)
        self.retry_count += 1
        if self._selected_server is not None:
            self._excluded.add(self._selected_server)
        new_cid = pool.bump_version(self._current_cid)
        self._current_cid = new_cid
        pool.unlock(new_cid)
        # retry backoff (retry_policy.backoff_ms; 0 on the default
        # policy = the historical immediate reissue).  The sleep
        # rides the timer thread — never a worker — and the overall
        # deadline timer stays armed, so a backoff that outlives
        # the budget resolves as ERPCTIMEDOUT like any slow attempt.
        delay_ms = 0.0
        bk = getattr(self._retry_policy, "backoff_ms", None)
        if bk is not None:
            try:
                delay_ms = bk(self) or 0.0
            except Exception as e:  # noqa: BLE001
                log_error("retry backoff_ms raised: %r", e)
        if delay_ms > 0:
            self._retry_backoff_timer_id = get_timer_thread().schedule(
                self._reissue_after_backoff, delay_ms / 1000.0, new_cid
            )
        else:
            scheduler.spawn(self.issue_rpc, new_cid)
        return True

    # ---- response path ------------------------------------------------------
    def _on_response(self, cid, meta, payload: IOBuf):
        """Runs UNDER the id lock with the parsed response (client side)."""
        from incubator_brpc_tpu_torch.protocols import compress as compress_mod

        rmeta = meta.response
        if rmeta.server_time_us:
            # read before any error-path return: a shed/failed leg still
            # carries the server's elapsed time for attribution
            self.server_time_us = rmeta.server_time_us
        if rmeta.error_code != 0:
            if self.__dict__.get("_used_backup") and self._attempt_pending():
                # hedged RPC with the OTHER attempt still in flight:
                # one replica's shed/error is not the RPC's outcome —
                # first SUCCESS wins.  Arbitrating now would exclude
                # _selected_server (the LAST-issued attempt's replica,
                # possibly the healthy one) and bump the cid version,
                # killing a backup that was about to succeed.  Ignore
                # this response; the overall deadline timer bounds the
                # wait, and the last attempt to answer arbitrates.
                _id_pool().unlock(cid)
                return
            # server-returned retriable codes (an EOVERCROWDED shed
            # from admission, ELOGOFF from a stopping server) re-enter
            # the SAME retry arbitration as transport errors: the
            # failed replica joins the exclusion set so the reissue
            # lands elsewhere — retrying an overloaded server against
            # itself is how overload spreads
            # mark the origin: the retry policy's "EOVERCROWDED only
            # retries on a different replica" rule applies to SERVER
            # sheds, not to the client's own transient write
            # backpressure (which arrives via _id_on_error instead)
            self._error_from_server = True
            if rmeta.error_code not in (
                errors.ERPCTIMEDOUT, errors.ECANCELED
            ) and self._try_retry_locked(
                cid, rmeta.error_code, rmeta.error_text
            ):
                return
            self.set_failed(rmeta.error_code, rmeta.error_text)
            self._finalize_locked(cid)
            return
        # stream negotiation completed: wire the client stream onto the
        # connection (reference: response meta stream_settings handling)
        if self._request_stream is not None and self._remote_stream_settings is not None:
            from incubator_brpc_tpu_torch.transport.socket import Socket

            sock = Socket.address(self._sending_sid)
            if sock is not None and not sock.failed:
                self._request_stream.establish(
                    sock,
                    self._remote_stream_settings.stream_id,
                    self._remote_stream_settings,
                )
        try:
            att_size = meta.attachment_size
            body = payload
            if att_size:
                body = IOBuf()
                payload.cutn(body, len(payload) - att_size)
                self.response_attachment = payload
            if meta.compress_type:
                body = compress_mod.decompress(body, meta.compress_type)
                if body is None:
                    raise ValueError("unsupported compress type")
            if self._response is not None:
                self._response.ParseFromString(body.as_view())
        except Exception as e:  # noqa: BLE001
            self.set_failed(errors.ERESPONSE, f"parse response failed: {e}")
        self._finalize_locked(cid)

    def _finalize_locked(self, cid):
        """Complete the RPC: stats, timers, destroy id, run done.
        Must hold the id lock."""
        pool = _id_pool()
        with self._rpc_end_lock:
            self._finalized = True
            regs = self._waiter_regs
            self._waiter_regs = []
        if regs:
            from incubator_brpc_tpu_torch.transport.socket import Socket

            # every attempt (retries, backups) registered its own
            # (sid, cid); removing only the last one leaks the earlier
            # registrations until their socket dies
            channel = self._channel
            pack_cancel = getattr(
                getattr(channel, "protocol", None), "pack_cancel", None
            )
            for sid, cid_reg in regs:
                sock = Socket.address(sid)
                if sock is None:
                    continue
                still_pending = sock.remove_response_waiter(cid_reg)
                if (
                    still_pending
                    and pack_cancel is not None
                    and not sock.failed
                    and not sock.is_server_side
                    and getattr(sock, "ici_port", None) is None
                ):
                    # kernel sockets only: a fabric frame carries window
                    # credits and device-payload structure a bare
                    # cancel meta would corrupt (ICI losers are bounded
                    # by the fabric's own failure handling)
                    # an attempt this RPC abandoned (hedge loser, a
                    # timed-out or superseded try) is still being
                    # served: a cancel frame lets the server shed it
                    # before device work and drop the reply — hedging
                    # must never double the work (docs/overload.md).
                    # The stale-cid guard already discards whatever
                    # the loser might still send back.
                    try:
                        sock.write(
                            pack_cancel(cid_reg), ignore_eovercrowded=True
                        )
                    except Exception as e:  # noqa: BLE001 — cancel is
                        # best-effort; the RPC itself is already done
                        log_error("cancel frame send failed: %r", e)
        with self._rpc_end_lock:
            owned, self._owned_sockets = self._owned_sockets, []
        if owned:
            from incubator_brpc_tpu_torch.transport.socket_map import release_owned_socket

            for entry in owned:
                release_owned_socket(entry)
        if self._timer_id:
            get_timer_thread().unschedule(self._timer_id)
            self._timer_id = 0
        if self._backup_timer_id:
            get_timer_thread().unschedule(self._backup_timer_id)
            self._backup_timer_id = 0
        if self._retry_backoff_timer_id:
            get_timer_thread().unschedule(self._retry_backoff_timer_id)
            self._retry_backoff_timer_id = 0
        self.latency_us = (time.monotonic_ns() - self._start_ns) // 1000
        if self._span is not None:
            self._span.remote_side = str(self.remote_side or "")
            self._span.end(self.error_code)
        channel = self._channel
        if channel is not None:
            channel._on_rpc_end(self)
        done = self._done
        pool.unlock_and_destroy(cid)
        if done is not None:
            scheduler.spawn(self._run_done, done)

    def _run_done(self, done):
        try:
            done()
        except Exception as e:  # noqa: BLE001
            log_error("rpc done callback raised: %r", e)

    def start_cancel(self):
        """Analog of Controller::StartCancel — cancel the in-flight RPC."""
        if self.call_id:
            _id_pool().error(self.call_id, errors.ECANCELED, "canceled by caller")

    # ---- server-side helpers ------------------------------------------------
    def auth_context(self):
        """The AuthContext a passing verify_credential attached to this
        request (h2: per-stream) or its connection (reference
        Controller::auth_context)."""
        if self._auth_context is not None:
            return self._auth_context
        return getattr(self._server_socket, "auth_context", None)

    def close_connection(self):
        """Server handler asks to close the connection after responding
        (controller.h:433)."""
        self._close_connection_after_response = True

    # ---- server-side user data (server.cpp:811-851) ------------------------
    def session_local_data(self):
        """Per-RPC reusable object from the server's pool (reference
        Controller::session_local_data); returns to the pool when the
        response goes out. None unless session_local_data_factory set."""
        if self._session_local is None and self.server is not None:
            self._session_local = self.server.acquire_session_local()
        return self._session_local

    def thread_local_data(self):
        """Per worker-thread object (thread_local_data_factory)."""
        return self.server.thread_local_data() if self.server else None

    def _release_session_local(self):
        data, self._session_local = self._session_local, None
        if data is not None and self.server is not None:
            self.server.return_session_local(data)

    # ---- progressive bodies (reference progressive_attachment.h,
    # controller.h response_will_be_read_progressively) ----------------------
    def response_will_be_read_progressively(self):
        """Client, before the call: don't buffer the response body —
        the RPC completes at the response headers and the body streams
        to the reader passed to read_progressive_attachment()."""
        self._read_progressively = True

    def read_progressive_attachment(self, reader) -> int:
        """Client, after the call: reader(bytes) runs per body part,
        reader(None) at end-of-body. Returns 0, or EREQUEST when the
        response wasn't progressive."""
        body = self._progressive_body
        if body is None:
            return errors.EREQUEST
        body.attach(reader)
        return 0

    def create_progressive_attachment(self, content_type=None):
        """Server handler: switch the response to a chunked stream.
        Returned ProgressiveAttachment accepts write() immediately
        (buffered until the response headers go out after done()) and
        must be close()d to terminate the stream.  ``content_type``
        overrides the chunked response's Content-Type — pass
        "text/event-stream" for SSE token streaming."""
        from incubator_brpc_tpu_torch.protocols.http import ProgressiveAttachment

        if self._progressive_attachment is None:
            self._progressive_attachment = ProgressiveAttachment(
                content_type or "application/octet-stream"
            )
        return self._progressive_attachment
