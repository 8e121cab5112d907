"""InputMessenger — protocol-agnostic read loop + message cutter.

Analog of reference InputMessenger (input_messenger.{h,cpp}):
``on_new_messages`` (OnNewMessages, input_messenger.cpp:317-382) reads
adaptively into the socket's IOBuf, then ``_cut_input_message``
(CutInputMessage, :205-315) tries registered protocol parsers with the
per-socket cached index; each parsed message is dispatched to a new
task, the last one processed in place (QueueMessage batching,
:169-190). First-message auth runs through the protocol's verify
callback (:282-300).
"""

from __future__ import annotations

import time as _time
from typing import List, Optional

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.chaos import injector as _chaos
from incubator_brpc_tpu_torch.protocols import ParseError, Protocol, list_protocols
from incubator_brpc_tpu_torch.runtime import scheduler
from incubator_brpc_tpu_torch.transport import socket as socket_mod
from incubator_brpc_tpu_torch.utils.logging import log_error, log_verbose

_READ_CHUNK = 1 << 16


class InputMessenger:
    def __init__(self, protocols: Optional[List[Protocol]] = None):
        self._protocols = protocols  # None = use global registry at read time

    def protocols(self) -> List[Protocol]:
        return self._protocols if self._protocols is not None else list_protocols()

    # runs inside the socket's single read task
    def on_new_messages(self, sock) -> None:
        eof = False
        pending = None  # held-back last message, flushed at batch end
        while not sock.failed:
            # 1. read until EAGAIN (edge-triggered contract)
            read_chunk = _READ_CHUNK
            drop_round = False
            if _chaos.armed:
                spec = _chaos.check("socket.read", peer=sock.remote)
                if spec is not None:
                    act = spec.action
                    if act == "short_read":
                        # cap this round's recv: a frame bigger than the
                        # cap now completes across many partial reads
                        # (clamped to the normal chunk, matching the
                        # native site — a large arg must never ENLARGE
                        # the read)
                        read_chunk = min(max(1, spec.arg), _READ_CHUNK)
                    elif act == "delay_us":
                        _chaos.sleep_us(spec.arg)
                    elif act == "eagain_storm":
                        # the kernel "has nothing for us" this round:
                        # hold the read loop for arg µs (default 1ms)
                        # then re-evaluate.  A bare `continue` would be
                        # an unobservable no-op burning the hit budget;
                        # a `return` under ET epoll could strand
                        # buffered bytes until the next edge.  Bounded:
                        # specs default max_hits=64 for this action.
                        _chaos.sleep_us(spec.arg or 1000)
                        continue
                    elif act == "drop":
                        drop_round = True
                    elif act == "reset":
                        self._fail_behind_ordered(
                            sock, errors.EFAILEDSOCKET,
                            "chaos: injected reset",
                        )
                        return
            try:
                if drop_round:
                    # read bytes off the wire and discard them: the
                    # stream loses data mid-flight (peer must recover
                    # via deadline/close, parser may see garbage next)
                    from incubator_brpc_tpu_torch.utils.iobuf import IOBuf

                    n = IOBuf().append_from_socket(sock.fd, read_chunk)
                else:
                    n = sock.read_buf.append_from_socket(sock.fd, read_chunk)
                socket_mod.g_in_bytes << n
                if n > 0:
                    sock.last_active_s = _time.monotonic()
                if n == 0:
                    eof = True
            except (BlockingIOError, InterruptedError):
                n = -1
            except OSError as e:
                self._fail_behind_ordered(
                    sock, errors.EFAILEDSOCKET, f"read failed: {e}"
                )
                return
            # 2. cut as many complete messages as the buffer holds
            pending = self._cut_and_queue(sock, eof, pending)
            if eof or n < 0:
                break
        # batch exhausted (EAGAIN/EOF): the LAST message runs in place —
        # only now, so a slow in-place handler can't delay reading
        # requests already queued in the kernel buffer (the reference
        # flushes QueueMessage the same way, input_messenger.cpp:169-190)
        if pending is not None:
            self._stamp(pending[1], "enqueued_us")  # runs in place now
            self._process_safely(*pending)
        if eof and not sock.failed:
            self._fail_behind_ordered(sock, errors.ECLOSE, "remote closed connection")

    def cut_and_dispatch(self, sock, read_eof: bool = False) -> None:
        """Cut + dispatch everything currently buffered, processing the
        last message in place. Entry point for the ICI completion drain
        (one frame per call — the common case pays zero task handoffs)."""
        pending = self._cut_and_queue(sock, read_eof, None)
        if pending is not None:
            self._stamp(pending[1], "enqueued_us")
            self._process_safely(*pending)

    def _cut_and_queue(self, sock, read_eof: bool, pending):
        """Cut every complete message; dispatch each to a fresh task
        except the last, which is returned for the caller to run in
        place at batch end (QueueMessage, input_messenger.cpp:169-190).
        Ordered (process_in_place) protocol frames flush `pending` first
        in place, so cross-protocol arrival order is preserved."""
        while not sock.failed:
            result, proto = self._cut_input_message(sock, read_eof)
            if result is None:
                break
            socket_mod.g_in_messages << 1
            msg = result.message
            # rpcz phase stamps ride on the message to the server span:
            # received = the IN event that carried these bytes (stamped
            # by the dispatcher / fabric delivery), parse_done = now.
            # One fused try/one clock read — this runs per message.
            try:
                now = _time.time_ns() // 1000
                msg.received_us = sock.last_read_event_us or now
                msg.parse_done_us = now
            except AttributeError:
                pass  # message type without stamp slots
            # auth gate on first message of a server connection
            if sock.is_server_side and not sock.auth_done:
                if proto.verify is not None:
                    try:
                        ok = proto.verify(msg, sock)
                    except Exception as e:  # noqa: BLE001
                        # an exception out of verify must CLOSE the
                        # connection, not wedge the read task
                        log_error("%s verify raised: %r", proto.name, e)
                        ok = False
                    if not ok:
                        sock.set_failed(errors.ERPCAUTH, "authentication failed")
                        return None
                elif not proto.auth_in_protocol:
                    # no verify hook and no in-protocol auth: on an
                    # auth-enforcing server this protocol would be a
                    # silent bypass — refuse the connection instead
                    server_auth = getattr(
                        getattr(sock.server, "options", None), "auth", None
                    )
                    if server_auth is not None:
                        sock.set_failed(
                            errors.ERPCAUTH,
                            f"protocol {proto.name} cannot authenticate",
                        )
                        return None
            sock.auth_done = True
            process = (
                proto.process_request if sock.is_server_side else proto.process_response
            )
            if process is None:
                process = proto.process_request or proto.process_response
            if proto.process_in_place:
                # ordered protocols (streaming frames) run here in the
                # read task; anything held back must run FIRST — e.g. the
                # stream-establishing RPC response must precede the first
                # stream DATA frame that follows it in the same batch
                if pending is not None:
                    self._process_safely(*pending)
                    pending = None
                self._stamp(msg, "enqueued_us")  # in place: zero queue wait
                self._process_safely(process, msg, sock)
                continue
            if proto.process_ordered:
                # correlation-less protocols (HTTP/1.x): serialize this
                # connection's messages on its ExecutionQueue so request
                # k's response is written before request k+1's, matching
                # the client's FIFO response matching — without stalling
                # the read task on a slow handler
                if pending is not None:
                    self._process_safely(*pending)
                    pending = None
                # hold the socket in-use per queued item: the queue's
                # consumer runs detached from the read task, and without
                # a hold the slot could be recycled+reborn while items
                # are pending — they'd then run against the new
                # connection occupying the same object
                if sock._inuse_acquire():
                    # inline when idle: the one-outstanding-request case
                    # (the dominant HTTP pattern) pays no task handoff
                    self._stamp(msg, "enqueued_us")
                    self._ordered_queue(sock).execute_or_inline(
                        (process, msg, sock)
                    )
                continue
            if pending is not None:
                self._stamp(pending[1], "enqueued_us")
                scheduler.spawn(self._process_safely, *pending)
            pending = (process, msg, sock)
        return pending

    @staticmethod
    def _stamp(msg, field: str, value: int = 0):
        """Set an rpcz phase stamp on a parsed message; protocols whose
        message types don't carry the slots simply don't get phases."""
        try:
            setattr(msg, field, value or _time.time_ns() // 1000)
        except AttributeError:
            pass

    @staticmethod
    def _fail_behind_ordered(sock, code, text):
        """set_failed, but sequenced AFTER any messages still pending on
        the socket's ordered queue — a response fully received before
        EOF/read-error must reach its RPC, not be erased by the failure
        sweep (set_failed clears pipelined_info and errors waiters)."""
        q = sock.ordered_exec
        if q is not None and sock._inuse_acquire():
            def do_fail(_msg, s):
                s.set_failed(code, text)

            if q.execute_or_inline((do_fail, None, sock)):
                return
            sock._inuse_release()
        sock.set_failed(code, text)

    @staticmethod
    def _ordered_queue(sock):
        q = sock.ordered_exec
        if q is None:
            from incubator_brpc_tpu_torch.observability.latency_breakdown import (
                queue_wait_recorder,
            )
            from incubator_brpc_tpu_torch.runtime.execution_queue import ExecutionQueue

            def consume(batch):
                for process, msg, s in batch:
                    try:
                        InputMessenger._process_safely(process, msg, s)
                    finally:
                        s._inuse_release()

            q = sock.ordered_exec = ExecutionQueue(
                consume, wait_recorder=queue_wait_recorder("ordered_queue")
            )
        return q

    @staticmethod
    def _process_safely(process, msg, sock):
        try:
            process(msg, sock)
        except Exception as e:  # noqa: BLE001
            log_error("protocol process raised: %r", e)

    def _cut_input_message(self, sock, read_eof: bool):
        """Try parsers, starting from the cached per-socket index
        (CutInputMessage, input_messenger.cpp:205-315)."""
        if sock.read_buf.empty():
            return None, None
        protos = self.protocols()
        order = range(len(protos))
        if sock.parse_index is not None and sock.parse_index < len(protos):
            cached = sock.parse_index
            order = [cached] + [i for i in range(len(protos)) if i != cached]
        for idx in order:
            proto = protos[idx]
            if proto.parse is None:
                continue
            result = proto.parse(sock.read_buf, sock, read_eof)
            if result.error == ParseError.OK:
                sock.parse_index = idx
                return result, proto
            if result.error == ParseError.NOT_ENOUGH_DATA:
                sock.parse_index = idx
                return None, None
            if result.error == ParseError.BAD_FORMAT:
                sock.set_failed(errors.EREQUEST, f"bad {proto.name} message")
                return None, None
            # TRY_OTHERS: fall through
        # nothing matched
        if len(sock.read_buf) > 0:
            log_verbose("unknown protocol on socket %x, closing", sock.sid)
            sock.set_failed(errors.EREQUEST, "message matched no protocol")
        return None, None
