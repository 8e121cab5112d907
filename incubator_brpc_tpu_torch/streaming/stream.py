"""Streaming RPC — ordered, flow-controlled, bidirectional streams.

Analog of reference stream.{h,cpp} (stream.h:90-130) and
stream_impl.h:30: a Stream is negotiated inside a normal RPC (the id
rides RpcMeta.stream_settings), then DATA frames flow on the host
connection with consumed-bytes feedback flow control
(min_buf_size/max_buf_size, stream.h:50-67): the writer blocks in
``write`` when the remote's unconsumed backlog would exceed
max_buf_size — the reference's StreamWait semantics — and wakes on the
peer's FEEDBACK.

Beyond the reference skeleton this implementation carries (see
docs/streaming.md for the full contract):

  * per-direction stream-id namespaces — client-created streams take
    odd ids, server-created even (the h2 discipline), so two peers on
    one connection can never mint colliding ids;
  * message segmentation — host payloads larger than the shared wire
    chunk (utils/segmentation.py) are split into DATA_PART frames
    closed by one DATA frame, so one oversized write can neither stall
    the connection's writer role nor deadlock against max_buf_size;
    device payloads are NEVER split here — over an ICI socket the
    fabric's chunked staging-ring pipeline moves them zero-copy
    with chained checksums;
  * feedback batching — a receiver accumulates consumed bytes until
    ``min_buf_size`` before sending FEEDBACK (capped at half the
    peer's max_buf_size so batching can never starve a blocked
    writer);
  * half-close — ``close_write()`` sends HALF_CLOSE: this side stops
    writing but keeps reading; the stream fully closes when both
    directions are done;
  * idle timeout — ``idle_timeout_s`` of no frame traffic fails the
    stream with ERPCTIMEDOUT and RSTs the peer.  This is also the
    deadlock escape when FEEDBACK is lost (chaos site stream.frame):
    a writer blocked on a window that will never reopen is released
    in bounded time;
  * RST isolation — either side's failure resets THE STREAM, never
    the shared socket: other streams and in-flight RPCs on the
    connection are untouched.

Usage (mirrors StreamCreate/StreamAccept/StreamWrite/StreamClose):
    client:  stream = Stream.create(ctrl, handler, opts)
             stub.Method(ctrl, req)           # negotiates the stream
             stream.write(IOBuf(b"chunk"))
    server:  stream = Stream.accept(ctrl, handler, opts)  # in handler
             done()                           # response carries settings
"""

from __future__ import annotations

import itertools
import threading
import time as _time
from dataclasses import dataclass
from typing import List, Optional

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.chaos import injector as _chaos
from incubator_brpc_tpu_torch.protocols import streaming as wire
from incubator_brpc_tpu_torch.protos import rpc_meta_pb2 as pb
from incubator_brpc_tpu_torch.runtime.execution_queue import ExecutionQueue
from incubator_brpc_tpu_torch.runtime.timer_thread import get_timer_thread
from incubator_brpc_tpu_torch.streaming import observe
from incubator_brpc_tpu_torch.utils.iobuf import IOBuf
from incubator_brpc_tpu_torch.utils.logging import log_error
from incubator_brpc_tpu_torch.utils.segmentation import WIRE_CHUNK_BYTES, plan_chunks

# Per-direction id namespaces (the h2 discipline, protocols/h2.py
# next_stream_id): the client mints odd ids, the server even.  Each
# peer draws from its own process's counter, so without the parity
# split two processes on one connection both start at 1 and the
# second stream registered under a colliding id hijacks the first's
# frames.
_client_id_seq = itertools.count(1, 2)
_server_id_seq = itertools.count(2, 2)


class StreamHandler:
    """Analog of brpc::StreamInputHandler."""

    def on_received_messages(self, stream: "Stream", messages: List[IOBuf]):
        pass

    def on_closed(self, stream: "Stream"):
        pass

    def on_failed(self, stream: "Stream", error_code: int, error_text: str):
        pass

    def on_half_close(self, stream: "Stream"):
        """Peer finished writing (HALF_CLOSE); it still reads."""


@dataclass
class StreamOptions:
    # writer blocks past this unconsumed backlog at the peer
    max_buf_size: int = 2 << 20
    # receiver-side feedback batching: consumed bytes accumulate to at
    # least this before a FEEDBACK frame goes out (0 = immediate).
    # Effective threshold is capped at half the PEER's max_buf_size so
    # batching can never park its writer forever.
    min_buf_size: int = 0
    # no frame traffic for this long fails the stream (ERPCTIMEDOUT)
    # and RSTs the peer; 0 disables.  Also the lost-FEEDBACK escape.
    idle_timeout_s: float = 0.0
    # host payloads above this split into DATA_PART chunks (shared
    # wire-chunk policy); device payloads never split here
    write_chunk_bytes: int = WIRE_CHUNK_BYTES
    handler: Optional[StreamHandler] = None


class Stream:
    def __init__(self, options: StreamOptions, is_server: bool):
        self.stream_id = next(_server_id_seq if is_server else _client_id_seq)
        self.options = options
        self.is_server = is_server
        self.remote_stream_id = 0
        self.method = ""  # negotiating RPC's full method name (observe)
        self._ctrl = None  # negotiating controller, held until establish
        self._sock = None
        self._established = threading.Event()
        self._closed = False
        self._failed = (0, "")
        # half-close state machine: OPEN → {local,remote} write-closed
        # → CLOSED once both directions are done
        self._local_write_closed = False
        self._remote_write_closed = False
        # flow control (consumed feedback, stream.h:50-67)
        self._unconsumed = 0
        self._flow_cond = threading.Condition()
        self._peer_max_buf = 0  # peer's advertised max_buf_size
        self._consumed_pending = 0  # receiver-side feedback batching
        # guards the pending-feedback swap: close()/close_write() flush
        # from user threads while the rx consumer flushes post-handler —
        # an unguarded read-then-zero could send the same credit twice,
        # over-crediting the peer's window
        self._fb_lock = threading.Lock()
        # receiver reassembly of segmented messages (DATA_PART…DATA)
        self._part_acc: Optional[IOBuf] = None
        # idle timeout
        self._last_activity_ns = _time.monotonic_ns()
        self._idle_timer = 0
        # stats (rpcz annotations + /status rows)
        self.frames_sent = 0
        self.frames_received = 0
        self.bytes_sent = 0
        self.bytes_received = 0
        self.consumed_bytes = 0  # bytes this side consumed + fed back
        self.writer_blocked_ns = 0
        self._last_data_ns = 0  # feedback-RTT probe: last DATA sent
        self._span = None  # "stream" rpcz span joined to the RPC's trace
        # ordered delivery through an execution queue (stream.cpp uses
        # bthread::ExecutionQueue for exactly this); items are
        # (message, deferred_feedback_bytes), and the close and failure
        # notices queue behind them
        self._rx = ExecutionQueue(self._consume_batch)

    # ---- negotiation --------------------------------------------------------
    @classmethod
    def create(cls, controller, handler: StreamHandler, options=None) -> "Stream":
        """Client side, BEFORE issuing the RPC (StreamCreate, stream.h:90)."""
        opts = options or StreamOptions()
        opts.handler = handler or opts.handler
        stream = cls(opts, is_server=False)
        controller._request_stream = stream
        stream._adopt_controller(controller)
        return stream

    @classmethod
    def accept(cls, controller, handler: StreamHandler, options=None) -> "Stream":
        """Server side, inside the method handler (StreamAccept, stream.h:97)."""
        opts = options or StreamOptions()
        opts.handler = handler or opts.handler
        stream = cls(opts, is_server=True)
        controller._response_stream = stream
        stream._adopt_controller(controller)
        req_settings = controller._remote_stream_settings
        if req_settings is not None:
            stream.establish(
                controller._server_socket, req_settings.stream_id, req_settings
            )
        return stream

    def _adopt_controller(self, controller):
        """Remember the negotiating controller until establish: on the
        client its method spec and rpcz span don't exist yet at
        Stream.create (they are built inside _start_call)."""
        self._ctrl = controller

    def _resolve_identity(self):
        """Pick up the negotiating RPC's identity at establish time:
        method name for the /status table and the trace for the
        stream's rpcz span.  The controller reference is dropped here —
        pooled controllers are released after done() and must not be
        pinned by a long-lived stream."""
        controller, self._ctrl = self._ctrl, None
        if controller is None:
            return
        spec = getattr(controller, "_method_spec", None)
        if spec is not None:
            self.method = spec.full_name
        elif getattr(controller, "service_name", ""):
            self.method = f"{controller.service_name}.{controller.method_name}"
        parent = getattr(controller, "_span", None)
        if parent is not None:
            from incubator_brpc_tpu_torch.observability.span import Span

            # joined to the negotiating RPC's trace: /rpcz?trace= shows
            # the stream's whole life under the RPC that created it
            service, _, method = self.method.partition(".")
            span = Span("stream", service, method)
            span.trace_id = parent.trace_id
            span.parent_span_id = parent.span_id
            span.annotate(f"stream id={self.stream_id} created")
            self._span = span

    def fill_settings(self) -> pb.StreamSettings:
        ss = pb.StreamSettings()
        ss.stream_id = self.stream_id
        ss.need_feedback = True
        ss.max_buf_size = self.options.max_buf_size
        ss.min_buf_size = self.options.min_buf_size
        return ss

    def establish(self, sock, remote_stream_id: int, remote_settings=None):
        """Wire the stream onto the connection once the peer's id is
        known (client: response meta arrived; server: request meta)."""
        self._sock = sock
        self.remote_stream_id = remote_stream_id
        if remote_settings is not None:
            self._peer_max_buf = int(remote_settings.max_buf_size or 0)
        self._resolve_identity()
        sock.stream_map[self.stream_id] = self
        self._touch()
        observe.register(self)
        if self._span is not None:
            self._span.remote_side = str(getattr(sock, "remote", "") or "")
            self._span.annotate(
                f"established remote_id={remote_stream_id} "
                f"peer_max_buf={self._peer_max_buf}"
            )
        self._established.set()
        self._arm_idle_timer()

    def wait_established(self, timeout: float = 5.0) -> bool:
        return self._established.wait(timeout)

    # ---- frame egress (chaos chokepoint) ------------------------------------
    def _send_frame(self, frame_type: int, payload=None) -> int:
        """Every outgoing frame funnels through here: chaos site
        ``stream.frame`` (direction = frame kind) + frame counters."""
        if _chaos.armed:
            spec = _chaos.check(
                "stream.frame",
                peer=getattr(self._sock, "remote", None),
                direction=wire.FRAME_NAMES.get(frame_type),
            )
            if spec is not None:
                act = spec.action
                if act == "delay_us":
                    _chaos.sleep_us(spec.arg)
                elif act == "drop":
                    # the frame silently vanishes — a dropped FEEDBACK
                    # must be survivable via the idle-timeout escape
                    return 0
                elif act == "reorder":
                    stashed = self._swap_reorder_stash(frame_type, payload)
                    if stashed:
                        return 0
                elif act == "reset":
                    # stream-level fault: RST THIS stream, keep the
                    # socket (and its other streams / RPCs) alive
                    self._send_raw(wire.FRAME_RST)
                    self._mark_failed(errors.ECLOSE, "chaos: injected stream reset")
                    return errors.ECLOSE
        return self._send_raw(frame_type, payload)

    def _send_raw(self, frame_type: int, payload=None) -> int:
        sock = self._sock
        if sock is None or sock.failed:
            return errors.EFAILEDSOCKET
        rc = sock.write(wire.pack_frame(self.remote_stream_id, frame_type, payload))
        if rc == 0:
            self.frames_sent += 1
            if payload is not None:
                self.bytes_sent += len(payload)
            observe.frames_out << 1
            self._touch()
        return rc

    def _swap_reorder_stash(self, frame_type: int, payload) -> bool:
        """Chaos reorder (the dcn.send stash-swap shape): hold one
        frame back; the NEXT frame through releases it after itself."""
        stash = getattr(self, "_reorder_stash", None)
        if stash is None:
            self._reorder_stash = (frame_type, payload)
            return True
        self._reorder_stash = None
        self._send_raw(frame_type, payload)  # the newer frame first
        self._send_raw(*stash)  # then the stashed one
        return False

    # ---- writing (StreamWrite + StreamWait flow control) --------------------
    def write(self, data, timeout: Optional[float] = 10.0) -> int:
        if isinstance(data, (bytes, str)):
            data = IOBuf(data)
        rc = self._writable_or_error()
        if rc:
            return rc
        if not self._established.wait(timeout or 10.0):
            return errors.ERPCTIMEDOUT
        size = len(data)
        # effective chunk never exceeds the flow window: with the
        # defaults (4MB wire chunk > 2MB max_buf) an unsegmented 3MB
        # frame could otherwise never satisfy StreamWait
        chunk = min(self.options.write_chunk_bytes, self.options.max_buf_size)
        if size > chunk and not data.has_device_payload():
            return self._write_segmented(data, size, chunk, timeout)
        rc = self._flow_wait(size, timeout)
        if rc:
            return rc
        self._last_data_ns = _time.monotonic_ns()
        return self._send_frame(wire.FRAME_DATA, data)

    def write_device(self, array, timeout: Optional[float] = 10.0) -> int:
        """Stream one HBM-resident array as a single message.  Over an
        ICI socket the payload rides the fabric's chunked staging-ring
        pipeline zero-copy with chained checksums (docs/ici_pipeline.md)
        — this layer never splits or materializes device payloads."""
        buf = IOBuf()
        buf.append_device(array)
        return self.write(buf, timeout)

    def _write_segmented(self, data: IOBuf, size: int, chunk: int, timeout) -> int:
        """Split one host message into DATA_PART frames closed by a
        DATA frame (the shared chunk plan, utils/segmentation.py):
        flow control is exerted PER CHUNK, so a message larger than
        max_buf_size streams through the window instead of deadlocking
        against it, and the socket's writer role is never held for one
        giant frame.  Message boundaries survive — the receiver
        reassembles and delivers ONE message."""
        plan = plan_chunks(size, chunk)
        for idx, (_, length) in enumerate(plan):
            rc = self._flow_wait(length, timeout)
            if rc == 0:
                part = IOBuf()
                data.cutn(part, length)  # ref-sharing cut, no copy
                last = idx == len(plan) - 1
                self._last_data_ns = _time.monotonic_ns()
                rc = self._send_frame(
                    wire.FRAME_DATA if last else wire.FRAME_DATA_PART, part
                )
            if rc:
                if idx > 0 and not self._closed:
                    # chunks 0..idx-1 are already in the peer's
                    # reassembly buffer: the message can never complete,
                    # and leaving the half-message there would splice
                    # its prefix onto the NEXT message.  A mid-message
                    # abort is unrecoverable — reset the stream.
                    self.reset(rc, "segmented write aborted mid-message")
                return rc
            if self._span is not None:
                self._span.chunk_mark("stream", idx, len(plan), length)
        return 0

    def _writable_or_error(self) -> int:
        if self._failed[0]:
            return self._failed[0]
        if self._closed:
            return errors.ECLOSE
        if self._local_write_closed:
            return errors.ECLOSE
        return 0

    def _flow_wait(self, size: int, timeout) -> int:
        """Block while the peer's unconsumed backlog would exceed
        max_buf_size (StreamWait).  Wakes on FEEDBACK, close or
        failure; the idle timer bounds a wait whose FEEDBACK was lost.
        A single frame larger than the whole window (an unsplittable
        device payload) is admitted when the window is EMPTY — at most
        one such message in flight, instead of never."""

        def admissible():
            return (
                self._unconsumed + size <= self.options.max_buf_size
                or self._unconsumed == 0
            )

        with self._flow_cond:
            if not (self._closed or self._failed[0] or admissible()):
                observe.blocked_writers << 1
                t0 = _time.monotonic_ns()
                try:
                    ok = self._flow_cond.wait_for(
                        lambda: self._closed or self._failed[0] or admissible(),
                        timeout,
                    )
                finally:
                    blocked = _time.monotonic_ns() - t0
                    self.writer_blocked_ns += blocked
                    observe.blocked_writers << -1
                if not ok:
                    return errors.ERPCTIMEDOUT  # reference EAGAIN after StreamWait
            if self._failed[0]:
                return self._failed[0]
            if self._closed or self._local_write_closed:
                return errors.ECLOSE
            self._unconsumed += size
        return 0

    # ---- receiving ----------------------------------------------------------
    def on_frame(self, frame: wire.StreamFrame):
        self._touch()
        self.frames_received += 1
        observe.frames_in << 1
        ftype = frame.frame_type
        if ftype == wire.FRAME_DATA or ftype == wire.FRAME_DATA_PART:
            if self._remote_write_closed:
                # data after the peer declared its write side done is a
                # protocol violation: reset the stream, not the socket
                self._send_raw(wire.FRAME_RST)
                self._mark_failed(errors.EREQUEST, "DATA after half-close")
                return
            self.bytes_received += len(frame.payload)
            if ftype == wire.FRAME_DATA_PART:
                if self._part_acc is None:
                    self._part_acc = IOBuf()
                self._part_acc.append(frame.payload)
                # reassembly counts as consumption — a message larger
                # than the writer's max_buf_size must keep flowing
                self._note_consumed(len(frame.payload))
                return
            msg = frame.payload
            deferred = len(msg)
            if self._part_acc is not None:
                acc, self._part_acc = self._part_acc, None
                acc.append(msg)
                msg = acc
            self._rx.execute((msg, deferred))
        elif ftype == wire.FRAME_FEEDBACK:
            consumed = int.from_bytes(frame.payload.to_bytes()[:8], "big")
            if self._last_data_ns:
                rtt_us = (_time.monotonic_ns() - self._last_data_ns) // 1000
                observe.feedback_rtt_us << rtt_us
            with self._flow_cond:
                self._unconsumed = max(0, self._unconsumed - consumed)
                self._flow_cond.notify_all()
        elif ftype == wire.FRAME_HALF_CLOSE:
            self._on_remote_half_close()
        elif ftype == wire.FRAME_CLOSE:
            self._mark_closed()
        elif ftype == wire.FRAME_RST:
            self._mark_failed(errors.ECLOSE, "stream reset by peer")

    def _consume_batch(self, batch):
        # items are (message, deferred_feedback_bytes) or a close/failure
        # notice (a callable): a notice runs after the messages queued
        # before it, so on_closed never overtakes the last DATA batch
        msgs, fed = [], 0
        for item in batch:
            if callable(item):
                self._deliver(msgs, fed)
                msgs, fed = [], 0
                item()
            else:
                msgs.append(item[0])
                fed += item[1]
        self._deliver(msgs, fed)

    def _deliver(self, msgs, fed: int) -> None:
        if not msgs:
            return
        handler = self.options.handler
        if handler is not None:
            try:
                handler.on_received_messages(self, msgs)
            except Exception as e:  # noqa: BLE001
                log_error("stream handler raised: %r", e)
        # consumed-bytes feedback unblocks the remote writer
        self._note_consumed(fed)

    def _note_consumed(self, n: int) -> None:
        """Accumulate consumed bytes; FEEDBACK goes out once the batch
        reaches the min_buf_size threshold (capped so batching can
        never exceed half the peer's window — a starved writer would
        otherwise wait on feedback that is itself waiting on more
        consumption)."""
        if n <= 0:
            return
        self.consumed_bytes += n
        threshold = self.options.min_buf_size
        if self._peer_max_buf:
            threshold = min(threshold, self._peer_max_buf // 2)
        with self._fb_lock:
            # part-arrival (parse thread) and post-handler (rx consumer)
            # credits race here; the lock keeps the accumulator exact
            self._consumed_pending += n
            below = self._consumed_pending < max(1, threshold)
        if below:
            return
        self._flush_feedback()

    def _flush_feedback(self) -> None:
        with self._fb_lock:
            pending, self._consumed_pending = self._consumed_pending, 0
        if pending <= 0:
            return
        if self._sock is not None and not self._sock.failed and not self._closed:
            self._send_frame(
                wire.FRAME_FEEDBACK, IOBuf(pending.to_bytes(8, "big"))
            )

    # ---- idle timeout -------------------------------------------------------
    def _touch(self) -> None:
        self._last_activity_ns = _time.monotonic_ns()

    def _arm_idle_timer(self) -> None:
        t = self.options.idle_timeout_s
        if t <= 0 or self._closed:
            return
        self._idle_timer = get_timer_thread().schedule(self._on_idle_timer, t)

    def _on_idle_timer(self) -> None:
        if self._closed or self._failed[0]:
            return
        idle_s = (_time.monotonic_ns() - self._last_activity_ns) / 1e9
        remaining = self.options.idle_timeout_s - idle_s
        if remaining > 0.001:
            self._idle_timer = get_timer_thread().schedule(
                self._on_idle_timer, remaining
            )
            return
        # never run teardown (socket writes, user callbacks) on the
        # process-wide timer thread
        from incubator_brpc_tpu_torch.runtime import scheduler

        scheduler.spawn(self._fail_idle)

    def _fail_idle(self) -> None:
        if self._closed or self._failed[0]:
            return
        self._send_raw(wire.FRAME_RST)
        self._mark_failed(
            errors.ERPCTIMEDOUT,
            f"stream idle for {self.options.idle_timeout_s:.1f}s",
        )

    # ---- teardown -----------------------------------------------------------
    def close_write(self) -> None:
        """Half-close: no more writes from this side; reads continue
        (HALF_CLOSE frame).  The stream fully closes once the peer
        half-closes too."""
        if self._closed or self._local_write_closed:
            return
        self._local_write_closed = True
        self._flush_feedback()
        self._send_frame(wire.FRAME_HALF_CLOSE)
        with self._flow_cond:
            self._flow_cond.notify_all()  # release writers: ECLOSE
        if self._remote_write_closed:
            self._mark_closed()

    def _on_remote_half_close(self) -> None:
        self._remote_write_closed = True
        handler = self.options.handler
        if handler is not None:
            from incubator_brpc_tpu_torch.runtime import scheduler

            def _notify(h=handler, s=self):
                try:
                    h.on_half_close(s)
                except Exception as e:  # noqa: BLE001
                    log_error("stream on_half_close raised: %r", e)

            scheduler.spawn(_notify)
        if self._local_write_closed:
            self._mark_closed()

    def close(self):
        """StreamClose: notify the peer and tear down."""
        if self._closed:
            return
        self._flush_feedback()
        if self._sock is not None and not self._sock.failed:
            # through the chaos chokepoint: a lost/delayed CLOSE is an
            # injectable fault (direction "close"); RST frames are NOT
            # injectable — they ARE the failure path
            self._send_frame(wire.FRAME_CLOSE)
        self._mark_closed()

    def reset(self, code: int = errors.ECLOSE, text: str = "stream reset"):
        """Abort the stream: RST the peer and fail locally.  The shared
        socket (and every other stream/RPC on it) is untouched — this
        is how an aborted generation or an unrecoverable mid-message
        fault surfaces as an ERROR on the peer, distinguishable from a
        clean CLOSE."""
        if self._closed:
            return
        self._send_raw(wire.FRAME_RST)
        self._mark_failed(code, text)

    def _close_span(self, error_code: int = 0) -> None:
        span = self._span
        if span is None:
            return
        self._span = None
        span.annotate(
            f"frames sent={self.frames_sent} received={self.frames_received} "
            f"bytes sent={self.bytes_sent} received={self.bytes_received} "
            f"consumed={self.consumed_bytes} "
            f"writer_blocked={self.writer_blocked_ns // 1000}us"
        )
        span.end(error_code)

    def _mark_closed(self):
        if self._closed:
            return
        self._closed = True
        if self._idle_timer:
            get_timer_thread().unschedule(self._idle_timer)
            self._idle_timer = 0
        with self._flow_cond:
            self._flow_cond.notify_all()
        if self._sock is not None:
            self._sock.stream_map.pop(self.stream_id, None)
        observe.deregister(self)
        self._close_span(self._failed[0])
        handler = self.options.handler
        if handler is not None:
            # queued, never inline: a CLOSE frame may be processed on
            # the SENDER's thread (ici inline client-port delivery), and
            # user code blocking there would wedge the sender — the
            # reference likewise runs stream callbacks on bthread
            # workers, not the IO thread (stream.cpp on_closed path).
            # The receive queue's consumer runs on a scheduler worker,
            # behind every DATA batch already queued.
            def _notify(h=handler, s=self):
                try:
                    h.on_closed(s)
                except Exception as e:  # noqa: BLE001
                    log_error("stream on_closed raised: %r", e)

            self._rx.execute(_notify)

    def _mark_failed(self, code: int, text: str):
        self._failed = (code, text)
        with self._flow_cond:
            self._flow_cond.notify_all()
        handler = self.options.handler
        if handler is not None:
            # queued behind the pending DATA, as on_closed is above
            def _notify(h=handler, s=self):
                try:
                    h.on_failed(s, code, text)
                except Exception as e:  # noqa: BLE001
                    log_error("stream on_failed raised: %r", e)

            self._rx.execute(_notify)
        self._mark_closed()

    def on_socket_failed(self, code: int, text: str):
        """Called by Socket.set_failed for attached streams."""
        self._mark_failed(code, text)

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def failed_code(self) -> int:
        return self._failed[0]

    def unconsumed(self) -> int:
        """Writer-side view of the peer's unconsumed backlog."""
        with self._flow_cond:
            return self._unconsumed

    def describe(self) -> dict:
        """One /status row."""
        return {
            "id": self.stream_id,
            "remote_id": self.remote_stream_id,
            "server": self.is_server,
            "peer": str(getattr(self._sock, "remote", "") or ""),
            "frames_sent": self.frames_sent,
            "frames_received": self.frames_received,
            "unconsumed": self._unconsumed,
            "consumed_bytes": self.consumed_bytes,
            "writer_blocked_us": self.writer_blocked_ns // 1000,
        }
