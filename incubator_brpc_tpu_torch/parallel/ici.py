"""ICI fabric transport — the RDMA-endpoint analog, over torch devices.

Port of the JAX package's ``parallel/ici.py``.  Reference template: the
RDMA subsystem (rdma/rdma_endpoint.h:63-227): an alternative data path
under the same Socket abstraction, with pre-registered memory
(block_pool), zerocopy send/recv straight from IOBuf blocks, and
completion polling wired into the same event machinery.  Frames are
IOBufs whose DeviceRef segments are device-resident torch tensors;
"transmission" runs the payload through the hand-written copy+checksum
kernels of ops/transfer.py (same device — one real traversal of device
memory per hop, the receiver gets a fresh buffer + integrity checksum)
or a ``Tensor.to(device)`` transfer (cross device) — host bytes only
ever materialize for the small meta header.  Set
``IciFabric.zero_copy`` for the explicit reference-move fast path.
Completion delivery uses an ExecutionQueue per port, feeding the exact
same protocol parse path as TCP (one framing, two transports).

Coordinates not registered in this process route over the DCN bridge
(parallel/dcn.py) when a bridge connection advertised or learned them,
and fail fast with EFAILEDSOCKET otherwise.
"""

from __future__ import annotations

import contextlib
import threading
import time as _time
import weakref
from collections import deque
from typing import Dict, List, Optional, Tuple

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.chaos import injector as _chaos
from incubator_brpc_tpu_torch.observability.profiling import hbm_account, kernel_section
from incubator_brpc_tpu_torch.observability.span import Span
from incubator_brpc_tpu_torch.utils.segmentation import (
    DEVICE_CHUNK_BYTES,
    MIN_CHUNKS,
)
from incubator_brpc_tpu_torch.runtime.execution_queue import ExecutionQueue
from incubator_brpc_tpu_torch.metrics.reducer import Adder
from incubator_brpc_tpu_torch.transport import socket as socket_mod
from incubator_brpc_tpu_torch.transport.input_messenger import InputMessenger
from incubator_brpc_tpu_torch.transport.socket import Socket, SocketOptions
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint
from incubator_brpc_tpu_torch.utils.iobuf import IOBuf, DeviceRef
from incubator_brpc_tpu_torch.utils.logging import log_error

# thread-local delivery burst (see IciFabric.delivery_burst): while a
# burst is open on this thread, queued (non-inline) deliveries collect
# here and each destination port's completion queue wakes ONCE at
# burst close instead of once per frame — the engine.cpp
# flush_pending_burst read-cycle batching, applied to the fabric.
_BURST_TLS = threading.local()

# Frames at or above this size bypass burst capture and wake the
# destination queue immediately: the wake being amortized costs
# microseconds, so holding a bulk frame (milliseconds of parse +
# placement work the receiver could already be overlapping with the
# sender's next placement) until burst close would trade real pipeline
# overlap for nothing.  Coalescing is a small-RPC optimization.
BURST_BYPASS_BYTES = 256 << 10

# HBM heap profiler tags (observability/profiling.py): ring-resident
# staging slots, and device payloads placed for an in-flight frame
# (charged from placement until the carrying DeviceRef dies)
_STAGING_ACCT = hbm_account("ici.staging")
_INFLIGHT_ACCT = hbm_account("ici.inflight")

# staged-transmit lane counters (chunk_mode="pallas", the names kept
# from the JAX package).  ``frames`` counts staged kernel dispatches —
# a run can pin frames == dispatches so a silent fallback to the
# chunked pipeline fails loudly; ``fallbacks`` counts frames the lane
# declined (non-numeric, untileable) and routed to the per-segment
# transmit instead.
ici_pallas_frames = Adder(0).expose("rpc_ici_pallas_frames")
ici_pallas_bytes = Adder(0).expose("rpc_ici_pallas_bytes")
ici_pallas_fallbacks = Adder(0).expose("rpc_ici_pallas_fallbacks")
ici_pallas_stacked_frames = Adder(0).expose("rpc_ici_pallas_stacked_frames")
ici_pallas_stacked_segments = Adder(0).expose(
    "rpc_ici_pallas_stacked_segments"
)


class _LazyPeer:
    """Defers _fmt() until a chaos spec actually matches on peer — the
    armed-but-unmatched send path pays no string formatting (the
    injector's raw-object contract), while matchers still see the
    ``sliceN/chipM`` label, not the raw tuple repr."""

    __slots__ = ("coords",)

    def __init__(self, coords):
        self.coords = coords

    def __str__(self):
        return _fmt(self.coords)


def _fmt(coords) -> str:
    """ici://-ish label for span methods: (0, 1) → slice0/chip1."""
    try:
        s, c = coords
        if isinstance(s, int) and isinstance(c, int):
            return f"slice{s}/chip{c}"
        return f"{s}:{c}"
    except Exception:  # noqa: BLE001
        return str(coords)


class StagingRing:
    """Ring of persistent per-peer device staging buffers — the RDMA
    block_pool analog (rdma_endpoint.h:63-227 pre-registered memory).

    The pipelined chunked send hands a ring slot to each chunk's
    copy+checksum kernel (ops/transfer.device_copy_with_checksum_chunk_
    into): the kernel writes into the slot's memory, the slot goes
    back into the ring after the frame assembles, and steady-state
    sends perform ZERO per-call device allocation for chunk staging.
    Slots are keyed by (shape, dtype); the ring holds at most ``depth``
    slots per key (2-4 covers the double-buffer plus one in flight) and
    at most ``max_keys`` shapes (LRU-evicted — a port cycling many
    payload shapes degrades to plain allocation, never to unbounded
    HBM)."""

    def __init__(self, depth: int = 4, max_keys: int = 8):
        self.depth = depth
        self.max_keys = max_keys
        self._slots: Dict[Tuple, deque] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def acquire(self, shape, dtype):
        """A reusable buffer of (shape, dtype), or None (caller
        allocates; release() later seeds the ring).  An acquired slot
        leaves the ``ici.staging`` HBM ledger — it is the caller's
        (in-flight frame's) memory until released back."""
        key = (tuple(shape), str(dtype))
        with self._lock:
            q = self._slots.get(key)
            if q:
                # LRU touch: move key to the back of the eviction order
                self._slots[key] = self._slots.pop(key)
                self.hits += 1
                arr, charge = q.popleft()
                _STAGING_ACCT.release(charge)
                return arr
            self.misses += 1
            return None

    def release(self, arr) -> None:
        """Return a frame's staging output to the ring.  Only call for
        buffers nothing downstream holds (the chunked send releases
        chunk outputs only after a concat copied them out)."""
        key = (tuple(arr.shape), str(arr.dtype))
        with self._lock:
            q = self._slots.get(key)
            if q is None:
                while len(self._slots) >= self.max_keys:
                    # LRU eviction: dict preserves insertion order and
                    # acquire() re-inserts on hit, so the first key is
                    # the least recently used
                    evq = self._slots.pop(next(iter(self._slots)))
                    for _, charge in evq:
                        _STAGING_ACCT.release(charge)
                q = self._slots[key] = deque()
            if len(q) < self.depth:
                q.append((arr, _STAGING_ACCT.adopt(arr)))

    def clear(self) -> None:
        with self._lock:
            for q in self._slots.values():
                for _, charge in q:
                    _STAGING_ACCT.release(charge)
            self._slots.clear()


class IciPort:
    """One endpoint on the fabric (analog RdmaEndpoint). Owns the
    completion queue whose consumer parses frames through the shared
    InputMessenger machinery."""

    def __init__(self, fabric: "IciFabric", coords: Tuple[int, int], server=None, device=None):
        self.fabric = fabric
        self.coords = coords
        self.server = server  # non-None = server port (accepts requests)
        self.device = device  # torch device owning this port's memory
        self.messenger = InputMessenger()
        # completion queue: frames arrive here (the "CQ polled instead
        # of epoll"); consumer runs on the runtime like ProcessEvent.
        # Queue wait feeds /latency_breakdown's _runtime/ici_cq row.
        from incubator_brpc_tpu_torch.observability.latency_breakdown import (
            queue_wait_recorder,
        )

        self._cq = ExecutionQueue(
            self._drain_completions,
            wait_recorder=queue_wait_recorder("ici_cq"),
        )
        # receive-window flow control (the RDMA endpoint's sq window /
        # socket _overcrowded analog, rdma_endpoint.h:83-137): bytes
        # delivered but not yet consumed.  A stalled consumer pushes
        # senders into EOVERCROWDED instead of growing the queue
        # without bound.
        self._queued_bytes = 0
        self._qb_lock = threading.Lock()
        self.overcrowded_bytes = 256 << 20
        # per-peer connection sockets (fd-less), keyed by peer coords
        self._conns: Dict[Tuple[int, int], int] = {}
        self._lock = threading.Lock()
        self.closed = False
        # chunk-staging buffer ring for pipelined sends INTO this port
        # (the destination owns the staging memory, like the RDMA
        # endpoint's registered receive blocks)
        self.staging = StagingRing()
        # opt-in inline request dispatch (the usercode_in_dispatcher
        # threading model): a local same-process send may run this
        # server port's handlers on the SENDER's thread, trading the
        # non-blocking send guarantee for two fewer task handoffs per
        # RPC — exactly the tradeoff the TCP path's
        # usercode_in_dispatcher makes
        self.inline_dispatch = bool(
            getattr(getattr(server, "options", None),
                    "usercode_in_dispatcher", False)
        )

    # ---- completion processing ---------------------------------------------
    def _drain_completions(self, batch):
        # window credits release ONCE per batch (the RDMA endpoint's
        # completion-batch accounting): senders blocked at
        # EOVERCROWDED wait at most one batch (batch_max frames) longer
        # than per-frame release, and the steady-state drain pays one
        # lock instead of len(batch)
        released = 0
        # the queue hands an iterable (TaskIterator), not a list: the
        # close path below slices the rest of the batch
        batch = list(batch)
        try:
            for i, (frame, peer_coords) in enumerate(batch):
                released += len(frame)
                if self.closed:
                    # the finally below releases up to THIS frame; the
                    # undrained rest of the batch would leak its window
                    # bytes (and wedge senders at EOVERCROWDED on a
                    # port reopened at these coords) — count them too
                    released += sum(len(f) for f, _ in batch[i + 1:])
                    return
                sock = self._conn_socket(peer_coords)
                if sock is None or sock.failed:
                    continue
                # rpcz received stamp: the fabric CQ's epoll-IN analog
                sock.last_read_event_us = _time.time_ns() // 1000
                sock.read_buf.append(frame)  # ref move, zero-copy
                try:
                    # the SAME cut/dispatch loop as TCP, auth gate
                    # included; parse sees DeviceRefs untouched
                    self.messenger.cut_and_dispatch(sock)
                except Exception as e:  # noqa: BLE001
                    log_error("ici completion processing failed: %r", e)
        finally:
            if released:
                with self._qb_lock:
                    self._queued_bytes -= released

    def deliver(self, frame: IOBuf, from_coords: Tuple[int, int],
                inline_ok: bool = False, force: bool = False) -> bool:
        """Called by the fabric: enqueue a received frame (a completion).

        Server ports and bridge-delivered frames go through the
        completion queue by default: inline dispatch would run user
        service handlers on the SENDER's thread (breaking the
        non-blocking send contract) or block the DCN bridge reader
        mid-stream.  CLIENT ports on a local same-process send may run
        inline (execute_or_inline): response processing is framework
        code plus the done callback, and skipping the queue handoff
        saves one thread wakeup on the sync RPC turnaround — the
        reference likewise runs response processing on the event thread
        that read it (process_response, input_messenger.cpp).  A server
        that opted into ``usercode_in_dispatcher`` extends the same
        inline treatment to request dispatch (``inline_dispatch``).

        Inside a fabric ``delivery_burst`` (ParallelChannel fan-out,
        ``send_batch``), queued deliveries are captured per-port and
        the completion queue wakes once at burst close — except frames
        ≥ BURST_BYPASS_BYTES, which dispatch immediately so bulk
        receive work overlaps the sender's remaining burst."""
        if self.closed:
            # close raced the fabric's port() lookup: refuse before any
            # credit is reserved (and before a burst could capture a
            # frame that would only be refused — silently — at flush)
            return False
        n = len(frame)
        with self._qb_lock:
            if (
                not force
                and self._queued_bytes + n > self.overcrowded_bytes
            ):
                return False  # receive window full → sender gets
                # EOVERCROWDED (socket.h _overcrowded analog)
            self._queued_bytes += n
        socket_mod.g_in_bytes << n
        if inline_ok and (self.server is None or self.inline_dispatch):
            if not self._cq.execute_or_inline((frame, from_coords)):
                # queue already stopped (close raced the send): the
                # frame will never run — release the reservation and
                # tell the sender, exactly like the queued path below
                with self._qb_lock:
                    self._queued_bytes -= n
                return False
            return True
        pending = getattr(_BURST_TLS, "pending", None)
        if pending is not None and n < BURST_BYPASS_BYTES:
            pending.setdefault(self, []).append((frame, from_coords))
            return True
        if not self._cq.execute((frame, from_coords)):
            # queue already stopped (close raced the send): the frame
            # will never drain — give its window bytes back instead of
            # leaking them against a port reopened at these coords
            with self._qb_lock:
                self._queued_bytes -= n
            return False
        return True

    def _flush_burst(self, items: List) -> None:
        """Enqueue a burst's captured deliveries with ONE consumer wake
        (ExecutionQueue.execute_batch).  A stopped queue refuses the
        batch — release those frames' window credits, same reasoning as
        the single-frame path.  The senders were already told 0 at
        capture time, so this close-between-capture-and-flush race
        resolves through their deadlines (the same way an in-flight
        frame lost to a close does on any transport) — deliver()'s
        ``closed`` pre-check keeps the window microscopic, and the drop
        is LOUD here, never silent."""
        if not self._cq.execute_batch(items):
            n = sum(len(f) for f, _ in items)
            with self._qb_lock:
                self._queued_bytes -= n
            log_error(
                "ici port %s closed mid-burst: %d captured frame(s) "
                "dropped; senders recover via deadline", self.coords,
                len(items),
            )

    # ---- connection sockets -------------------------------------------------
    def _conn_socket(self, peer_coords: Tuple[int, int]) -> Optional[Socket]:
        # the whole check-then-create runs under the lock so concurrent
        # callers can't mint duplicate (and leaked) sockets for one peer
        with self._lock:
            sid = self._conns.get(peer_coords)
            if sid is not None:
                sock = Socket.address(sid)
                if sock is not None and not sock.failed:
                    return sock
            sid = Socket.create(
                SocketOptions(
                    fd=None,
                    remote=EndPoint.ici(*peer_coords),
                    messenger=self.messenger,
                    server=self.server,
                )
            )
            sock = Socket.address(sid)
            sock.ici_port = self
            sock.ici_peer_coords = peer_coords
            self._conns[peer_coords] = sid
            return sock

    def connect(self, peer_coords: Tuple[int, int]):
        """Client-side: SocketId for the connection to peer coords,
        or None (note: 0 is a valid SocketId — the first pool slot)."""
        sock = self._conn_socket(peer_coords)
        return sock.sid if sock is not None else None

    def close(self):
        self.closed = True
        self._cq.stop()
        self.staging.clear()
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for sid in conns:
            s = Socket.address(sid)
            if s is not None:
                s.set_failed(errors.ECLOSE, "ici port closed")


class IciFabric:
    """The interconnect: routes frames between registered ports and
    places device payload onto the destination's device (a
    ``Tensor.to(device)`` transfer; a no-op when src and dst share a
    device)."""

    def __init__(self):
        self._ports: Dict[Tuple[int, int], IciPort] = {}
        self._lock = threading.Lock()
        # False (default): same-device delivery runs every device
        # segment through the copy+checksum kernels (ops/transfer.
        # transmit_array) so the payload demonstrably traverses device
        # memory once per hop — the honest model of an ICI
        # transmission. True: move by reference (no device bytes move).
        self.zero_copy = False
        # Large-frame chunk policy (shared with the DCN planner via
        # utils/segmentation.py; docs/ici_pipeline.md):
        #   "fused"     — the K-chunk pipeline as ONE dispatch per hop
        #                 (default — immune to per-launch host latency);
        #                 on the card the same single K1 launch as
        #                 "off", differing only in the chaos walk over
        #                 the chunk plan,
        #   "pipelined" — one launch per chunk over the destination
        #                 port's StagingRing (chunk k's kernel runs
        #                 while chunk k+1's launch stages; per-chunk
        #                 rpcz stamps show the overlap),
        #   "pallas"    — the whole frame as ONE staged kernel launch
        #                 (persistent CTAs keep bulk loads of the next
        #                 stages in flight while a stage is summed and
        #                 stored; ops/transfer.device_copy_with_checksum_dma);
        #                 multi-segment frames additionally coalesce
        #                 into one stacked per-destination transmit,
        #   "off"       — whole-frame transmit (pre-chunking behavior).
        self.chunk_mode = "fused"
        self.chunk_bytes = DEVICE_CHUNK_BYTES

    @contextlib.contextmanager
    def delivery_burst(self):
        """Coalesce this thread's queued fabric deliveries: while the
        context is open, each destination port collects frames in a
        pending list and its completion queue wakes ONCE at close
        (engine.cpp flush_pending_burst read-cycle batching).  Inline
        deliveries are unaffected (they never wake anything).  Nested
        bursts join the outermost one.

        Do NOT block on a fabric response inside the burst — the
        request may be sitting in the un-flushed pending list."""
        if getattr(_BURST_TLS, "pending", None) is not None:
            yield  # nested: the outer burst flushes
            return
        pending: Dict[IciPort, List] = {}
        _BURST_TLS.pending = pending
        try:
            yield
        finally:
            _BURST_TLS.pending = None
            for port, items in pending.items():
                port._flush_burst(items)

    def send_batch(
        self,
        frames,
        dst: Tuple[int, int],
        src: Tuple[int, int],
        zero_copy: Optional[bool] = None,
        ignore_eovercrowded: bool = False,
    ) -> List[int]:
        """Ship several frames to one destination with amortized
        window/credit bookkeeping: per-frame placement and admission
        semantics are identical to ``send``, but the destination's
        completion queue wakes once for the whole batch.  Returns one
        rc per frame (a frame that faults mid-batch fails alone — its
        window credits never linger)."""
        with self.delivery_burst():
            return [
                self.send(
                    f, dst, src, zero_copy=zero_copy,
                    ignore_eovercrowded=ignore_eovercrowded,
                )
                for f in frames
            ]

    def register(self, coords: Tuple[int, int], server=None, device=None) -> IciPort:
        with self._lock:
            if coords in self._ports and not self._ports[coords].closed:
                raise ValueError(f"ici coords {coords} already registered")
            port = IciPort(self, coords, server=server, device=device)
            self._ports[coords] = port
            return port

    def unregister(self, coords: Tuple[int, int]):
        with self._lock:
            port = self._ports.pop(coords, None)
        if port is not None:
            port.close()

    def port(self, coords: Tuple[int, int]) -> Optional[IciPort]:
        port = self._ports.get(coords)
        return port if port is not None and not port.closed else None

    def send(
        self,
        frame: IOBuf,
        dst: Tuple[int, int],
        src: Tuple[int, int],
        zero_copy: Optional[bool] = None,
        _local_only: bool = False,
        ignore_eovercrowded: bool = False,
    ) -> int:
        """Ship a frame. Device segments are re-placed onto the dst
        device if it differs (``Tensor.to`` = the ICI hop); same-device
        segments traverse device memory through the copy+checksum
        kernels unless zero_copy — then they move by reference. Coords
        not registered in this process route over the DCN bridge
        (parallel/dcn.py), the RDMA-TCP-bootstrap analog; a bridged
        inbound frame (``_local_only``) is placed here like any other,
        so its device segments run the receiving hop's kernel."""
        dst_port = self.port(dst)
        if dst_port is None:
            if not _local_only:
                from incubator_brpc_tpu_torch.parallel.dcn import get_bridge

                route = get_bridge().route(dst)
                if route is not None:
                    # the DCN bridge records its own collective leg span
                    rc = route.send_frame(frame, dst, src)
                    if rc == 0:
                        socket_mod.g_out_bytes << len(frame)
                        socket_mod.g_out_messages << 1
                    return rc
            return errors.EFAILEDSOCKET
        close_after_deliver = False
        if _chaos.armed:
            spec = _chaos.check("ici.send", peer=_LazyPeer(dst))
            if spec is not None:
                act = spec.action
                if act == "drop":
                    # the leg silently vanishes (an in-flight hop lost
                    # on the fabric): callers recover via deadlines
                    return 0
                if act == "delay_us":
                    _chaos.sleep_us(spec.arg)
                elif act == "reset":
                    return errors.EFAILEDSOCKET
                elif act == "close_mid_batch":
                    # deliver THIS frame, then close the destination
                    # port so its completion-queue drain observes the
                    # close mid-batch (the receive-window release path)
                    close_after_deliver = True
        # rpcz collective sub-span: one ICI leg (placement + delivery),
        # parented to the active RPC span so fan-out traces show every
        # per-chip hop (skipped entirely outside a traced RPC)
        leg = Span.create_collective("ici", f"{_fmt(src)}->{_fmt(dst)}")
        if leg is not None:
            leg.request_size = len(frame)
        try:
            try:
                if dst_port.device is not None:
                    zc = self.zero_copy if zero_copy is None else zero_copy
                    self._place_segments(frame, dst_port, zc, leg)
            except BaseException as e:
                # close the leg with an error first: the trace must
                # show the hop that failed, not silently lose it
                if leg is not None:
                    leg.end(errors.EINTERNAL)
                if isinstance(e, Exception):
                    # a fault mid-placement (chunk k of a chunked
                    # pipeline, a bad dtype, an injected ici.chunk
                    # reset) happens BEFORE any window credit is
                    # reserved — deliver has not run — so failing the
                    # frame here surfaces ONE ERPC error to the sender
                    # and leaks nothing
                    log_error("ici send %s->%s failed: %r", src, dst, e)
                    return errors.EINTERNAL
                raise
            if leg is not None:
                leg.placed_us = _time.time_ns() // 1000
            if not _local_only:
                # bridged inbound frames (_local_only) are RECEIVED
                # traffic; counting them here would inflate the
                # outbound metrics
                socket_mod.g_out_bytes << len(frame)
                socket_mod.g_out_messages << 1
            try:
                delivered = dst_port.deliver(
                    frame, src, inline_ok=not _local_only,
                    force=ignore_eovercrowded,
                )
            except BaseException:
                # deliver may have reserved window credits before the
                # failure (a raising spawn leaves the frame queued for
                # the close-time drain) — do NOT relabel this as a
                # clean per-frame EINTERNAL; propagate so the anomaly
                # stays loud
                if leg is not None:
                    leg.end(errors.EINTERNAL)
                raise
        finally:
            # an injected close must happen however delivery went
            # (success, window-full, raise): the spec's hit budget is
            # already consumed, so skipping here would record a close
            # that never happened
            if close_after_deliver:
                dst_port.close()
        if not delivered:
            # distinguish WHY delivery was refused: a closed port (or
            # its stopped completion queue) is a dead destination and
            # must read as a connection failure, not as transient
            # receive-window backpressure — retry/circuit-breaker
            # accounting keys on the difference
            rc = (
                errors.EFAILEDSOCKET
                if dst_port.closed
                else errors.EOVERCROWDED
            )
            if leg is not None:
                leg.end(rc)
            return rc
        if leg is not None:
            leg.end(0)
        return 0

    def local_server_coords(self):
        """Server ports registered in THIS process (what the DCN hello
        advertises to peers)."""
        with self._lock:
            items = list(self._ports.items())
        return sorted(
            coords
            for coords, port in items
            if not port.closed
            and port.server is not None
            and isinstance(coords[0], int)
            and isinstance(coords[1], int)
        )

    def local_cuda_devices(self):
        """The CUDA devices of the ports registered in THIS process."""
        with self._lock:
            ports = list(self._ports.values())
        return sorted(
            {
                p.device
                for p in ports
                if not p.closed
                and p.device is not None
                and p.device.type == "cuda"
            },
            key=str,
        )

    def server_coords(self):
        """Every reachable server port: local ones plus those learned
        over DCN bridges (the tpu:// naming service reads this, so a
        cross-process cluster resolves like a local one)."""
        coords = set(self.local_server_coords())
        from incubator_brpc_tpu_torch.parallel.dcn import _bridge

        if _bridge is not None:
            coords.update(
                c
                for c in _bridge.remote_server_coords()
                if isinstance(c[0], int) and isinstance(c[1], int)
            )
        return sorted(coords)

    def routable(self, coords) -> bool:
        """True if coords are a local port or reachable over a bridge."""
        if self.port(coords) is not None:
            return True
        from incubator_brpc_tpu_torch.parallel.dcn import _bridge

        return _bridge is not None and _bridge.route(coords) is not None

    def _place_segments(self, frame: IOBuf, dst_port: IciPort,
                        zero_copy: bool, leg=None):
        device = dst_port.device
        same_chip: List[Tuple] = []  # (ref, arr) headed for transmit
        for ref in frame.device_segments():
            arr = ref.whole_array()
            if arr is None:
                continue  # split segment: materialized as bytes downstream
            if arr.device != device:
                with kernel_section("ici.place"):
                    ref.array = arr.to(device)
                # in-flight ledger: the placed payload is the frame's
                # HBM until the carrying ref dies (receiver adoption —
                # e.g. the cache store — charges its own tag)
                charged = _INFLIGHT_ACCT.adopt(ref.array)
                if charged:
                    weakref.finalize(ref, _INFLIGHT_ACCT.release, charged)
            elif not zero_copy:
                same_chip.append((ref, arr))
        if len(same_chip) > 1 and self.chunk_mode == "pallas":
            # per-destination stacked transmit: same-shape segments of
            # ONE frame (a DMSET bulk, a fan-out leg's tensor set)
            # coalesce into a single stacked DMA kernel dispatch —
            # the bulk-move collective lowering (docs/ici_pipeline.md)
            same_chip = self._transmit_stacked(same_chip, dst_port, leg)
        for ref, arr in same_chip:
            # same-chip hop: the payload traverses HBM once through
            # the fused copy+checksum kernel — receiver gets a fresh
            # buffer plus a device-resident integrity checksum
            ref.array, ref.csum = self._transmit_segment(
                arr, dst_port, leg
            )

    def _transmit_stacked(self, pairs, dst_port: IciPort, leg):
        """Coalesce a frame's same-(shape, dtype) device segments into
        one stacked staged transmit per group — one kernel launch moves
        every segment headed to this destination, and each ref gets its
        row back as a view of the stacked copy.  Integrity is at stack
        granularity: ONE checksum per collective step (the bulk-move
        contract; per-ref ``csum`` stays None).  Segments the stack
        can't take (non-numeric, untileable, singleton shapes) return
        for the per-segment path."""
        import torch

        from incubator_brpc_tpu_torch.ops.transfer import (
            chunk_plan_for,
            device_copy_with_checksum_pallas,
            is_numeric,
        )

        rest: List[Tuple] = []
        groups: Dict[Tuple, List[Tuple]] = {}
        for ref, arr in pairs:
            if is_numeric(arr.dtype):
                key = (tuple(arr.shape), str(arr.dtype))
                groups.setdefault(key, []).append((ref, arr))
            else:
                rest.append((ref, arr))
        for grp in groups.values():
            if len(grp) < 2:
                rest.extend(grp)
                continue
            stacked = torch.stack([a for _, a in grp])
            plan = chunk_plan_for(stacked, self.chunk_bytes)
            if plan[0] is None:
                rest.extend(grp)
                continue
            if _chaos.armed:
                # same pre-dispatch walk as the fused/pallas frame path
                self._chaos_walk_chunks(len(plan[2] or ()), dst_port)
            with kernel_section("ici.pallas"):
                out, _stack_csum = device_copy_with_checksum_pallas(
                    stacked, self.chunk_bytes, plan=plan
                )
            for i, (ref, _) in enumerate(grp):
                ref.array = out[i]
                ref.csum = None  # integrity rides the stack checksum
            ici_pallas_frames << 1
            ici_pallas_bytes << int(stacked.nbytes)
            ici_pallas_stacked_frames << 1
            ici_pallas_stacked_segments << len(grp)
            if leg is not None:
                leg.annotate(
                    f"pallas stacked transmit: {len(grp)} segments, "
                    f"one dispatch"
                )
        return rest

    def _transmit_segment(self, arr, dst_port: IciPort, leg):
        """One device segment through the transmit op, per the fabric's
        chunk policy (docs/ici_pipeline.md)."""
        from incubator_brpc_tpu_torch.ops.transfer import (
            chunk_plan_for,
            transmit_array,
            transmit_array_chunked,
        )

        mode = self.chunk_mode
        if (
            mode == "off"
            or int(arr.nbytes) < MIN_CHUNKS * self.chunk_bytes
        ):
            return transmit_array(arr)
        if mode == "pipelined":
            return self._transmit_pipelined(arr, dst_port, leg)
        if mode == "pallas":
            return self._transmit_pallas(arr, dst_port, leg)
        plan = None
        if _chaos.armed:
            # the fused pipeline is ONE compiled program, so the
            # per-chunk ici.chunk site is walked over the SAME plan
            # before dispatch: a FaultPlan targeting chunk k faults the
            # frame under either chunk mode, with identical traversal
            # indices (chunk_plan_for is the one plan source)
            plan = chunk_plan_for(arr, self.chunk_bytes)
            self._chaos_walk_chunks(len(plan[2] or ()), dst_port)
        return transmit_array_chunked(arr, self.chunk_bytes, plan=plan)

    @staticmethod
    def _chaos_walk_chunks_step(k: int, total_chunks: int, dst_port: IciPort):
        """One consult of the ici.chunk site (armed plans only).
        reset abandons the frame mid-stream — send() turns it into ONE
        ERPC error, and no window credit was reserved yet, so nothing
        leaks (regression-tested under a seeded FaultPlan); delay_us
        stretches one pipeline stage."""
        spec = _chaos.check("ici.chunk", peer=_LazyPeer(dst_port.coords))
        if spec is not None:
            if spec.action == "delay_us":
                _chaos.sleep_us(spec.arg)
            elif spec.action == "reset":
                raise ConnectionResetError(
                    f"chaos: ici chunk {k}/{total_chunks} reset"
                )

    @staticmethod
    def _chaos_walk_chunks(total_chunks: int, dst_port: IciPort):
        """Walk every planned chunk through the ici.chunk site — the
        fused mode's pre-dispatch equivalent of the pipelined mode's
        inline per-chunk consults (identical traversal indices)."""
        for k in range(total_chunks):
            IciFabric._chaos_walk_chunks_step(k, total_chunks, dst_port)

    def _transmit_pallas(self, arr, dst_port: IciPort, leg):
        """Whole-frame transmit as ONE staged kernel launch
        (ops/transfer.device_copy_with_checksum_dma): persistent CTAs
        keep the next stages' bulk loads in flight while a stage is
        summed and stored back — no per-chunk launch gap.  Rides the
        same segmentation plan as the other modes (chunk_plan_for —
        chaos traversal
        indices agree), and writes into a frame-shaped StagingRing slot
        when the ring holds one, so callers that recycle response
        buffers (``dst_port.staging.release``) get allocation-free
        steady state.  Untileable and non-numeric payloads take the
        per-segment transmit (counted in rpc_ici_pallas_fallbacks)."""
        from incubator_brpc_tpu_torch.ops.transfer import (
            chunk_plan_for,
            device_copy_with_checksum_dma,
            device_copy_with_checksum_dma_into,
            is_numeric,
            staged_plan,
            transmit_array,
        )

        shape = arr.shape
        v, block_rows, chunks = chunk_plan_for(arr, self.chunk_bytes)
        if v is None:
            ici_pallas_fallbacks << 1
            return transmit_array(arr)
        total_chunks = len(chunks or ())
        if _chaos.armed:
            # ONE launch per frame, so the per-chunk ici.chunk site
            # walks the SAME plan pre-dispatch — the fused-mode
            # discipline, identical traversal indices
            self._chaos_walk_chunks(total_chunks, dst_port)
        if not is_numeric(arr.dtype):
            ici_pallas_fallbacks << 1
            return transmit_array(arr)
        stage_rows = staged_plan(v, block_rows).stage_rows
        slot = dst_port.staging.acquire(v.shape, v.dtype)
        with kernel_section("ici.pallas"):
            if slot is not None:
                out, csum = device_copy_with_checksum_dma_into(
                    v, slot, block_rows, stage_rows
                )
            else:
                out, csum = device_copy_with_checksum_dma(
                    v, block_rows, stage_rows
                )
        ici_pallas_frames << 1
        ici_pallas_bytes << int(arr.nbytes)
        if leg is not None:
            leg.chunk_mark("ici", 0, 1, int(arr.nbytes))
        return (out.reshape(shape) if out.shape != shape else out), csum

    def _transmit_pipelined(self, arr, dst_port: IciPort, leg):
        """Launch-per-chunk transmit: chunk k's copy+checksum kernels
        are queued on the device while the host stages chunk k+1's
        launch and chunk k-1's staging slot recycles through the
        destination port's StagingRing.  The lane accumulator chains
        through the chunks, so the receiver still verifies ONE
        integrity value for the whole frame (and it equals the
        whole-frame checksum bit-for-bit).  Falls back to the
        whole-frame op for shapes the kernel doesn't tile."""
        import torch

        from incubator_brpc_tpu_torch.ops.transfer import (
            chunk_plan_for,
            device_copy_with_checksum_chunk,
            device_copy_with_checksum_chunk_into,
            fold_checksum,
            is_numeric,
            transmit_array,
        )

        shape = arr.shape
        x, block_rows, chunks = chunk_plan_for(arr, self.chunk_bytes)
        if x is None:
            return transmit_array(arr)  # untileable: whole-frame path
        if len(chunks) < MIN_CHUNKS:
            return transmit_array(arr)
        m, n = x.shape
        row_bytes = n * x.element_size()
        # non-numeric payloads (bool, complex) copy chunk by chunk
        # without a checksum, like the whole-frame path
        use_csum = is_numeric(x.dtype)
        acc = (
            torch.zeros((1, n), dtype=torch.float32, device=x.device)
            if use_csum else None
        )
        ring = dst_port.staging if use_csum else None
        outs = []
        total_chunks = len(chunks)
        if ring is not None:
            # a frame holds every chunk output until the end-of-frame
            # concat, so zero-alloc steady state needs a slot per chunk
            # in flight — grow the ring to this frame's chunk count
            # (bounded: 2 x the default 64MB/8MB plan)
            ring.depth = max(ring.depth, min(total_chunks, 16))
        for k, (off, rows) in enumerate(chunks):
            if _chaos.armed:
                self._chaos_walk_chunks_step(k, total_chunks, dst_port)
            # device-time attribution: one dispatch window per chunk
            # launch (the pipeline's overlap unit)
            with kernel_section("ici.chunk"):
                xc = x[off:off + rows]
                if use_csum:
                    slot = ring.acquire((rows, n), x.dtype)
                    if slot is not None:
                        oc, acc = device_copy_with_checksum_chunk_into(
                            xc, acc, slot, block_rows
                        )
                    else:
                        oc, acc = device_copy_with_checksum_chunk(
                            xc, acc, block_rows
                        )
                else:
                    oc = xc.clone()
            outs.append(oc)
            if leg is not None:
                leg.chunk_mark("ici", k, total_chunks, rows * row_bytes)
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
        if ring is not None and len(outs) > 1:
            # the concat copied the chunk outputs out of the staging
            # slots — they are free to recycle.  (With a single chunk
            # `out` IS the slot-backed array and now belongs to the
            # receiver: never recycle it.)
            for oc in outs:
                ring.release(oc)
        csum = fold_checksum(acc) if use_csum else None
        return (out.reshape(shape) if out.shape != shape else out), csum


_fabric: Optional[IciFabric] = None
_fabric_lock = threading.Lock()


def get_fabric() -> IciFabric:
    global _fabric
    if _fabric is None:
        with _fabric_lock:
            if _fabric is None:
                _fabric = IciFabric()
    return _fabric


import itertools as _itertools
import os as _os

_client_port_seq = _itertools.count(1)


def acquire_client_port(device=None) -> IciPort:
    """Register a uniquely-keyed client port (shared helper for
    Channel and LoadBalancerWithNaming). Keys carry the pid so client
    ports of DIFFERENT processes bridged to one server can't collide in
    its DCN reply-routing table."""
    return get_fabric().register(
        ("client", f"{_os.getpid()}-{next(_client_port_seq)}"),
        server=None,
        device=device,
    )
