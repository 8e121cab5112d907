"""Socket — the central connection abstraction.

Analog of reference brpc::Socket (socket.h:205, socket.cpp): lives in a
ResourcePool addressed by versioned SocketId (socket.h:335), so stale
ids fail address() after recycling; lock-free failure marking
(SetFailed, socket.h:352-364) notifies every queued write's CallId and
hands the socket to health checking.

Write path mirrors StartWrite/KeepWrite (socket.cpp:1584-1790): the
calling task appends to the write queue and, if no writer is active,
becomes the writer and writes inline until EAGAIN or empty; leftover is
drained by a background KeepWrite task that parks on the epollout butex
(WaitEpollOut). The reference achieves this wait-free via an atomic
exchange on _write_head; under the GIL a short lock is the equivalent
(the structural property kept: writers never block each other beyond
queue append, and at most one task writes to the fd at a time).

Read path mirrors StartInputEvent (socket.cpp:2045): ET events bump an
event counter; only the first schedules a read task — the
one-read-task-per-socket invariant.
"""

from __future__ import annotations

import errno as _errno
import socket as _pysocket
import threading
import time as _time
from collections import deque
from typing import Callable, Optional

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.chaos import injector as _chaos
from incubator_brpc_tpu_torch.metrics.reducer import Adder
from incubator_brpc_tpu_torch.runtime import scheduler
from incubator_brpc_tpu_torch.runtime.butex import Butex
from incubator_brpc_tpu_torch.runtime.call_id import default_pool as _id_pool
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint
from incubator_brpc_tpu_torch.utils.iobuf import IOBuf
from incubator_brpc_tpu_torch.utils.logging import log_error, log_verbose
from incubator_brpc_tpu_torch.utils.resource_pool import ResourcePool

import os as _os

# escape hatch: TPUBRPC_NO_INLINE_READ=1 restores spawn-per-read-event
_INLINE_READ_DISABLED = _os.environ.get("TPUBRPC_NO_INLINE_READ") == "1"

# per-iteration write cap: how many bytes one _do_write_once round may
# hand the kernel before re-checking the queue.  The effective cap is
# min(shared wire-chunk policy, 1MB): 1MB is this layer's own fairness
# bound (one oversized writev round holds the writer role — and any
# pipelined peer — longer than it saves), so ENLARGING the policy in
# utils/segmentation.py deliberately does not enlarge this, while
# SHRINKING it below 1MB propagates here so all three bulk layers
# chunk no coarser than the operator asked for.
from incubator_brpc_tpu_torch.utils.segmentation import WIRE_CHUNK_BYTES

WRITE_CHUNK_BYTES = min(WIRE_CHUNK_BYTES, 1 << 20)

# global socket stats (reference SocketVarsCollector, socket.h:123-154)
g_connections = Adder(0)
g_in_bytes = Adder(0)
g_out_bytes = Adder(0)
g_in_messages = Adder(0)
g_out_messages = Adder(0)

DEFAULT_OVERCROWD_LIMIT = 64 << 20  # unwritten bytes before EOVERCROWDED


class SocketOptions:
    def __init__(
        self,
        fd: Optional[_pysocket.socket] = None,
        remote: Optional[EndPoint] = None,
        messenger=None,  # InputMessenger consuming parsed input
        on_edge_triggered_events: Optional[Callable] = None,  # raw IN handler
        server=None,
        user=None,  # SocketUser: health-check hooks
        connection_type: str = "single",
    ):
        self.fd = fd
        self.remote = remote
        self.messenger = messenger
        self.on_edge_triggered_events = on_edge_triggered_events
        self.server = server
        self.user = user
        self.connection_type = connection_type


class Socket:
    _pool: ResourcePool = None  # class-level, initialised below

    def __init__(self):
        # survives slot reuse: one lock per pool OBJECT, so a stale
        # holder and the object's next life serialize on the same lock
        self._life_lock = threading.Lock()
        self._reset_fields()

    def _reset_fields(self):
        self.sid = 0
        self.fd: Optional[_pysocket.socket] = None
        self.remote: Optional[EndPoint] = None
        self.local: Optional[EndPoint] = None
        self.messenger = None
        self.on_edge_triggered_events = None
        self.server = None
        self.user = None
        self.connection_type = "single"
        self.is_server_side = False
        self.failed = False
        self.error_code = 0
        self.error_text = ""
        # read side
        self.read_buf = IOBuf()
        # wall-clock us of the latest IN event (rpcz received_us source;
        # set by the event dispatcher / fabric delivery)
        self.last_read_event_us = 0
        self.parse_index: Optional[int] = None  # cached protocol index
        self.last_protocol = ""  # protocol of the last request sent
        # HTTP per-connection parse state: MUST reset on slot reuse or a
        # reborn socket resumes the dead connection's chunked body
        self._http_chunk_ctx = None
        self._http_exclusive_stream = False
        self._rtmp_conn = None  # RTMP handshake/chunk state
        self._read_events = 0
        self._read_active = False
        self._read_lock = threading.Lock()
        # write side
        self._write_q: deque = deque()  # (IOBuf, notify_cid, rpcz span|None)
        # reentrant: an ICI inline response delivered on the sending
        # thread re-enters accumulate_pipelined under this lock
        self._write_lock = threading.RLock()
        self._writing = False
        self._unwritten = 0
        # deferred graceful close: (code, text) once the write queue
        # drains (close_after_flush)
        self._close_after_flush = None
        self._epollout = Butex(0)
        # ICI mode (fd is None): frames ride the fabric, not a kernel fd
        self.ici_port = None
        self.ici_peer_coords = None
        # health / lifecycle
        self._closed = False
        # in-use guard (SocketUniquePtr-lite, reference socket.h:335-343):
        # long-running holders of this OBJECT (read task, KeepWrite,
        # accept loop) take a count; recycle() defers slot reuse until
        # they drain, so a stale holder can never close/poison a REBORN
        # socket occupying the same pool slot (the ABA the reference's
        # refcounted SocketUniquePtr exists to prevent)
        self._inuse = 0
        self._recycle_pending = False
        self._dying = False  # set under _life_lock once recycle is chosen
        # correlation ids awaiting a response on this socket (reference
        # notifies in-flight RPCs on SetFailed so they don't wait for the
        # deadline when the connection breaks)
        self.waiting_cids: set = set()
        self.pipelined_info: deque = deque()  # (cid, count) for pipelined protos
        self._pipelined_acc = []  # partial replies of the FIFO-front RPC
        self._preamble_done = False  # connection preamble (AUTH) written
        self.stream_map = {}  # stream_id -> Stream (streaming RPC)
        self.auth_done = False
        self.auth_context = None  # set by a passing verify_credential
        self.h2_ctx = None  # per-connection HTTP/2 state (protocols/h2.py)
        self.ordered_exec = None  # per-connection in-order processing queue
        # draining (h2 GOAWAY): in-flight work finishes on this
        # connection but SocketMap stops handing it to new RPCs
        self.draining = False
        # last read/write activity (idle-connection reaper,
        # reference acceptor.cpp:130 ListConnections idle check)
        self.last_active_s = _time.monotonic()
        # Read-dispatch policy. True: run the read/cut/process loop
        # inline in the event-dispatcher thread (two fewer scheduler
        # handoffs per message — the dominant per-RPC cost in this
        # runtime). Client sockets default to inline: the sync response
        # path never blocks (user done callbacks are spawned by
        # _finalize_locked). Server sockets stay spawned unless
        # ServerOptions.usercode_in_dispatcher opts in — the analog of
        # the reference's threading-model tuning (docs/cn/benchmark.md),
        # inverse of -usercode_in_pthread.
        self.inline_read = False

    # ---- creation / addressing (Socket::Create/Address, socket.h:335-343) --
    @classmethod
    def create(cls, options: SocketOptions) -> int:
        sid, sock = cls._pool.get_resource()
        sock._reset_fields()
        sock.sid = sid
        sock.fd = options.fd
        sock.remote = options.remote
        sock.messenger = options.messenger
        sock.on_edge_triggered_events = options.on_edge_triggered_events
        sock.server = options.server
        sock.user = options.user
        sock.connection_type = options.connection_type
        sock.is_server_side = options.server is not None
        if _INLINE_READ_DISABLED:
            sock.inline_read = False
        elif sock.is_server_side:
            sock.inline_read = bool(
                getattr(options.server.options, "usercode_in_dispatcher", False)
            )
        else:
            sock.inline_read = options.on_edge_triggered_events is None
        if sock.fd is not None:
            sock.fd.setblocking(False)
            from incubator_brpc_tpu_torch.transport.event_dispatcher import get_dispatcher

            fd_no = sock.fd.fileno()
            get_dispatcher(fd_no).add_consumer(fd_no, sock)
        g_connections << 1
        return sid

    @classmethod
    def address(cls, sid: int) -> Optional["Socket"]:
        """Resolve SocketId → Socket; None if recycled. Callers must
        check .failed (reference returns the socket for health checking)."""
        return cls._pool.address(sid)

    # ---- write path (StartWrite socket.cpp:1584, KeepWrite :1685) ----------
    def write(
        self,
        buf: IOBuf,
        notify_cid: int = 0,
        ignore_eovercrowded: bool = False,
        pipelined_entries=None,
        conn_preamble=None,
        span=None,
    ) -> int:
        """Queue buf for writing. Returns 0 or an error code. On socket
        failure, notify_cid receives EFAILEDSOCKET via the CallId pool.
        ``span`` (rpcz) gets write_done() when buf fully reaches the
        kernel/fabric — server spans close there, so their latency
        includes serialization and send."""
        if _chaos.armed:
            spec = _chaos.check("socket.write", peer=self.remote)
            if spec is not None:
                act = spec.action
                if act == "delay_us":
                    _chaos.sleep_us(spec.arg)
                elif act == "drop":
                    # the frame silently vanishes: the peer never sees
                    # it and this RPC must recover via its deadline
                    if span is not None:
                        span.write_done(0)
                    return 0
                elif act == "corrupt":
                    raw = bytearray(buf.to_bytes())
                    if raw:
                        raw[spec.arg % len(raw)] ^= 0xFF
                    buf = IOBuf(bytes(raw))
                elif act == "reset":
                    self.set_failed(
                        errors.EFAILEDSOCKET, "chaos: injected reset"
                    )
        if self.failed:
            if notify_cid:
                _id_pool().error(notify_cid, errors.EFAILEDSOCKET, self.error_text)
            if span is not None:
                span.write_done(errors.EFAILEDSOCKET)
            return errors.EFAILEDSOCKET
        if not ignore_eovercrowded and self._unwritten > DEFAULT_OVERCROWD_LIMIT:
            if notify_cid:
                _id_pool().error(notify_cid, errors.EOVERCROWDED, "write queue full")
            if span is not None:
                span.write_done(errors.EOVERCROWDED)
            return errors.EOVERCROWDED
        if self.ici_port is not None:
            # ICI data path: enqueue on the peer's completion queue; device
            # segments move zero-copy / via device-to-device transfer
            if pipelined_entries or conn_preamble is not None:
                # correlation-less (FIFO) protocols: registration must
                # be atomic with frame order on the fabric, exactly like
                # the TCP branch below
                rc = self._ici_write_pipelined(
                    buf, pipelined_entries, conn_preamble,
                    ignore_eovercrowded,
                )
            else:
                rc = self.ici_port.fabric.send(
                    buf, self.ici_peer_coords, self.ici_port.coords,
                    ignore_eovercrowded=ignore_eovercrowded,
                )
            if rc == errors.EOVERCROWDED:
                # transient receive-window backpressure: the peer port
                # is congested, NOT gone — the connection stays healthy
                # (socket.cpp _overcrowded semantics)
                if notify_cid:
                    _id_pool().error(
                        notify_cid, rc, "ici peer receive window full"
                    )
                if span is not None:
                    span.write_done(rc)
                return rc
            if rc == errors.EINTERNAL:
                # the FRAME failed (a fault mid-placement — e.g. chunk k
                # of a chunked pipeline): the fabric connection is
                # virtual and still healthy, so this RPC gets ONE error
                # and the socket (plus every other in-flight RPC on it)
                # stays up
                if notify_cid:
                    _id_pool().error(
                        notify_cid, rc, "ici frame placement failed"
                    )
                if span is not None:
                    span.write_done(rc)
                return rc
            if rc:
                self.set_failed(rc, "ici send failed: peer gone")
                if notify_cid:
                    _id_pool().error(notify_cid, rc, "ici send failed")
            if span is not None:
                span.write_done(rc)
            return rc
        size = len(buf)
        become_writer = False
        self.last_active_s = _time.monotonic()
        with self._write_lock:
            # Connection preamble (redis AUTH): exactly ONE writer gets
            # to prepend it, decided here under the lock — deciding at
            # pack time would let a concurrent packet overtake it and
            # reach the server's first-message gate un-authenticated.
            if conn_preamble is not None and not self._preamble_done:
                self._preamble_done = True
                pre_buf, pre_entries = conn_preamble
                if pre_entries:
                    self.pipelined_info.extend(pre_entries)
                self._write_q.append((pre_buf, 0, None))
                self._unwritten += len(pre_buf)
            # FIFO registration MUST be atomic with write-queue order:
            # registering outside this lock lets two RPCs enqueue their
            # packets in the opposite order of their pipelined entries,
            # misrouting every response on a correlation-less protocol
            if pipelined_entries:
                self.pipelined_info.extend(pipelined_entries)
            self._write_q.append((buf, notify_cid, span))
            self._unwritten += size
            if not self._writing:
                self._writing = True
                become_writer = True
        if become_writer:
            # First writer writes inline (the reference's fast path);
            # leftovers continue in a KeepWrite task.
            if not self._do_write_once():
                if self._inuse_acquire():
                    scheduler.spawn(self._keep_write_guarded)
        return 0

    def _ici_write_pipelined(
        self, buf, pipelined_entries, conn_preamble, ignore_eovercrowded
    ) -> int:
        """FIFO-correlated frame over the fabric: the whole
        register+send runs under the (reentrant) write lock so two
        RPCs can't ship frames in the opposite order of their
        pipelined entries.  A frame the fabric refuses deregisters its
        entries — the peer never saw it, so leaving them queued would
        misroute every later reply on this socket by one slot."""
        with self._write_lock:
            if conn_preamble is not None and not self._preamble_done:
                self._preamble_done = True
                pre_buf, pre_entries = conn_preamble
                if pre_entries:
                    self.pipelined_info.extend(pre_entries)
                rc = self.ici_port.fabric.send(
                    pre_buf, self.ici_peer_coords, self.ici_port.coords,
                    ignore_eovercrowded=True,
                )
                if rc:
                    for _ in pre_entries or ():
                        self.pipelined_info.pop()
                    return rc
            if pipelined_entries:
                self.pipelined_info.extend(pipelined_entries)
            rc = self.ici_port.fabric.send(
                buf, self.ici_peer_coords, self.ici_port.coords,
                ignore_eovercrowded=ignore_eovercrowded,
            )
            if rc and pipelined_entries:
                for _ in pipelined_entries:
                    self.pipelined_info.pop()
            return rc

    def _keep_write_guarded(self):
        try:
            self._keep_write()
        finally:
            self._inuse_release()

    def _do_write_once(self) -> bool:
        """Drain as much as possible without blocking. Returns True if the
        queue went empty (writer role released), False if a KeepWrite
        task must take over."""
        while True:
            with self._write_lock:
                if not self._write_q:
                    self._writing = False
                    pending_close = self._close_after_flush
                    self._close_after_flush = None
                    drained = True
                else:
                    drained = False
                    head, cid, span = self._write_q[0]
            if drained:
                if pending_close is not None:
                    # graceful close requested while writes were still
                    # queued: the last byte just reached the kernel
                    self.set_failed(pending_close[0], pending_close[1])
                return True
            try:
                while not head.empty():
                    cap = WRITE_CHUNK_BYTES
                    injected_short = False
                    if _chaos.armed:
                        spec = _chaos.check(
                            "socket.write_io", peer=self.remote
                        )
                        if spec is not None:
                            if spec.action == "eagain_storm":
                                # pretend the kernel buffer is full: a
                                # KeepWrite task takes over and parks
                                # on (an immediately ready) epollout
                                return False
                            if spec.action == "short_write":
                                # explicit flag (not a cap sentinel):
                                # arg >= the write chunk must still
                                # divert the remainder to KeepWrite
                                cap = min(max(1, spec.arg), WRITE_CHUNK_BYTES)
                                injected_short = True
                    n = head.cut_into_socket(self.fd, cap)
                    with self._write_lock:
                        self._unwritten -= n
                    g_out_bytes << n
                    if injected_short and not head.empty():
                        # injected partial write: hand the remainder to
                        # the KeepWrite path like a real short write
                        return False
            except (BlockingIOError, InterruptedError):
                return False
            except OSError as e:
                self.set_failed(errors.EFAILEDSOCKET, f"write failed: {e}")
                return True
            with self._write_lock:
                if self._write_q and self._write_q[0][0] is head:
                    self._write_q.popleft()
            if span is not None:
                # the message's last byte reached the kernel: stamp
                # sent_us; server spans close here (rpcz send phase)
                span.write_done(0)
            g_out_messages << 1

    def _keep_write(self):
        """Background writer parked on epollout (KeepWrite loop)."""
        from incubator_brpc_tpu_torch.transport.event_dispatcher import get_dispatcher

        while True:
            if self.failed:
                return
            if self._do_write_once():
                return
            with self._write_lock:
                caf = self._close_after_flush
            if caf is not None and _time.monotonic_ns() > caf[2]:
                # graceful-close drain deadline: the peer stopped
                # reading — stop polling for it and close abortively
                # (frees the fd + this KeepWrite task)
                self.set_failed(caf[0], caf[1] + " (drain timed out)")
                return
            # EAGAIN: wait for epollout
            expected = self._epollout.value
            fd_no = self.fd.fileno()
            get_dispatcher(fd_no).enable_epollout(fd_no)
            self._epollout.wait(expected, timeout=1.0)

    def _on_epoll_out(self):
        from incubator_brpc_tpu_torch.transport.event_dispatcher import get_dispatcher

        fd_no = self.fd.fileno()
        get_dispatcher(fd_no).disable_epollout(fd_no)
        self._epollout.fetch_add(1)
        self._epollout.wake_all()

    # ---- read path (StartInputEvent socket.cpp:2045) -----------------------
    def _on_epoll_in(self):
        if self.on_edge_triggered_events is not None:
            # raw handler (Acceptor's OnNewConnections)
            if self._inuse_acquire():
                scheduler.spawn_urgent(self._run_edge_handler)
            return
        with self._read_lock:
            self._read_events += 1
            if self._read_active:
                return
            self._read_active = True
        # hold the object across the read task so a concurrent recycle
        # can't hand this slot to a new socket mid-read
        if not self._inuse_acquire():
            with self._read_lock:
                self._read_active = False
            return
        if self.inline_read:
            self._process_event_guarded()
        else:
            scheduler.spawn_urgent(self._process_event_guarded)

    def _run_edge_handler(self):
        try:
            self.on_edge_triggered_events(self)
        finally:
            self._inuse_release()

    def _process_event_guarded(self):
        try:
            self._process_event()
        finally:
            self._inuse_release()

    def _process_event(self):
        while True:
            with self._read_lock:
                self._read_events = 0
            if self.messenger is not None:
                self.messenger.on_new_messages(self)
            with self._read_lock:
                if self._read_events == 0 or self.failed:
                    self._read_active = False
                    return

    def _on_epoll_err(self):
        self.set_failed(errors.EFAILEDSOCKET, "epoll error event")

    # ---- failure & lifecycle (SetFailed socket.h:352-364) ------------------
    # graceful close gives the peer this long to drain the response
    # before the close turns abortive — a Connection:-close client that
    # never reads must not pin the fd + a polling KeepWrite forever
    CLOSE_DRAIN_TIMEOUT_S = 15.0

    def close_after_flush(
        self, error_code: int = errors.ECLOSE, error_text: str = ""
    ) -> None:
        """Graceful close: fail the socket only once the write queue
        has fully drained.  ``set_failed`` DROPS queued writes — correct
        for errors, but a protocol-level "respond then close"
        (HTTP ``Connection: close``) must not truncate the response it
        just queued when the write went partial (kernel backpressure or
        an injected short write — caught by driving the HTTP surface
        under a `socket.write_io` chaos plan).  Bounded: a peer that
        stops reading gets CLOSE_DRAIN_TIMEOUT_S, then the close turns
        abortive (KeepWrite enforces the deadline)."""
        deadline_ns = _time.monotonic_ns() + int(
            self.CLOSE_DRAIN_TIMEOUT_S * 1e9
        )
        with self._write_lock:
            if self.failed:
                return
            if self._write_q or self._writing:
                # the active writer (inline or KeepWrite) closes at the
                # drain point in _do_write_once, or at the deadline
                self._close_after_flush = (error_code, error_text, deadline_ns)
                return
        self.set_failed(error_code, error_text)

    def set_failed(self, error_code: int, error_text: str = "") -> bool:
        with self._write_lock:
            if self.failed:
                return False
            self.failed = True
            self.error_code = error_code
            self.error_text = error_text
            pending = list(self._write_q)
            self._write_q.clear()
            self._unwritten = 0
        log_verbose("socket %x set_failed: %s %s", self.sid, error_code, error_text)
        # wake any parked KeepWrite
        self._epollout.fetch_add(1)
        self._epollout.wake_all()
        # fail every pending write's RPC and every in-flight waiter
        pool = _id_pool()
        for _, cid, span in pending:
            if cid:
                pool.error(cid, errors.EFAILEDSOCKET, error_text)
            if span is not None:
                span.write_done(errors.EFAILEDSOCKET)
        with self._write_lock:
            waiters = list(self.waiting_cids)
            self.waiting_cids.clear()
        for cid in waiters:
            pool.error(cid, errors.EFAILEDSOCKET, error_text)
        for cid, _ in list(self.pipelined_info):
            if cid:
                pool.error(cid, errors.EFAILEDSOCKET, error_text)
        self.pipelined_info.clear()
        # fail attached streams
        for stream in list(self.stream_map.values()):
            try:
                stream.on_socket_failed(error_code, error_text)
            except Exception:
                pass
        self._close_fd()
        g_connections << -1
        if self.user is not None:
            try:
                self.user.on_socket_failed(self)
            except Exception as e:  # noqa: BLE001
                log_error("socket user on_failed raised: %r", e)
        return True

    def _close_fd(self):
        if self.fd is not None and not self._closed:
            self._closed = True
            from incubator_brpc_tpu_torch.transport.event_dispatcher import get_dispatcher

            try:
                fd_no = self.fd.fileno()
                get_dispatcher(fd_no).remove_consumer(fd_no)
            except Exception:
                pass
            try:
                self.fd.close()
            except OSError:
                pass

    def _inuse_acquire(self) -> bool:
        """Take a hold on this object; False once recycle was chosen
        (no new tasks may start on a dying socket)."""
        with self._life_lock:
            if self._dying:
                return False
            self._inuse += 1
            return True

    def _inuse_release(self):
        finish = False
        with self._life_lock:
            self._inuse -= 1
            if self._inuse == 0 and self._recycle_pending:
                self._recycle_pending = False
                finish = True
        if finish:
            self._do_recycle()

    def recycle(self):
        """Return to the pool (bumps SocketId version: stale ids die).
        Deferred while any task still holds this object; _dying closes
        the acquire window so the check-then-recycle is race-free."""
        with self._life_lock:
            if self._dying:
                return  # second recycle of the same life: ignore
            self._dying = True
            if self._inuse > 0:
                self._recycle_pending = True
                return
        self._do_recycle()

    def _do_recycle(self):
        self._close_fd()
        Socket._pool.return_resource(self.sid)

    def add_response_waiter(self, cid: int) -> None:
        with self._write_lock:
            if not self.failed:
                self.waiting_cids.add(cid)
                return
        # socket already failed: fail the waiter immediately
        _id_pool().error(cid, errors.EFAILEDSOCKET, self.error_text)

    def remove_response_waiter(self, cid: int) -> bool:
        """Returns whether the waiter was still registered — True means
        no response for `cid` ever arrived on this socket (the
        finalize sweep uses it to spot abandoned hedge/retry attempts
        worth a cancel frame)."""
        with self._write_lock:
            if cid in self.waiting_cids:
                self.waiting_cids.discard(cid)
                return True
        return False

    # ---- client connect ----------------------------------------------------
    @classmethod
    def connect(
        cls,
        remote: EndPoint,
        messenger,
        timeout_s: float = 3.0,
        user=None,
        connection_type: str = "single",
        ssl_params=None,  # (ssl.SSLContext, server_hostname) for TLS
    ) -> tuple[int, int]:
        """Blocking connect (runs on a worker task). Returns (error, sid).
        With ssl_params the TLS handshake also runs here, blocking with
        the same timeout (reference: SSLHandshake inside Socket
        connect/first-write; details/ssl_helper.cpp) — afterwards the
        SSLSocket goes non-blocking like any other fd."""
        try:
            if remote.scheme == "uds":
                fd = _pysocket.socket(_pysocket.AF_UNIX, _pysocket.SOCK_STREAM)
            else:
                fd = _pysocket.socket(_pysocket.AF_INET, _pysocket.SOCK_STREAM)
                fd.setsockopt(_pysocket.IPPROTO_TCP, _pysocket.TCP_NODELAY, 1)
            fd.settimeout(timeout_s)
            fd.connect(remote.sockaddr())
            if ssl_params is not None:
                ctx, hostname = ssl_params
                fd = ctx.wrap_socket(
                    fd, server_hostname=hostname or None,
                    do_handshake_on_connect=True,
                )
            fd.setblocking(False)
        except OSError as e:
            # error level: a failed connect is the start of most
            # "server unreachable" investigations (reference logs it in
            # Socket::Connect too)
            log_error("connect to %s failed: %r", remote, e)
            return (errors.EFAILEDSOCKET, 0)
        sid = cls.create(
            SocketOptions(
                fd=fd, remote=remote, messenger=messenger, user=user,
                connection_type=connection_type,
            )
        )
        return (0, sid)


Socket._pool = ResourcePool(Socket)
