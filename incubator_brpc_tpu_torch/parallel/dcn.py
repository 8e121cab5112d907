"""DCN bridge — the cross-process/cross-host leg of the ICI fabric.

Port of the JAX package's ``parallel/dcn.py``.  Analog of the reference
RDMA endpoint's TCP-assisted bootstrap (rdma/rdma_endpoint.h:93-108
handshake state machine, rdma_helper global init): a TCP side channel
carries the fabric hello and every fabric frame between processes.

Bulk path (the RDMA endpoint's windowed send queue analog,
rdma_endpoint.h:83-137):
- device→host staging of ALL device segments starts up front: each
  CUDA segment is copied into a pinned host buffer on a side stream
  before the first wire byte moves, and its producer waits on the
  copy's event;
- a stager thread slices segment bytes into wire chunks and feeds them
  through a BOUNDED queue (the send window) to the socket writer —
  staging of segment k+1 overlaps the kernel send of segment k;
- the receiver streams each segment off the socket; a segment headed
  for a CUDA port lands in pinned memory and uploads with a
  non-blocking copy on the destination device's current stream, so
  the host→device copy of segment k overlaps the read of segment k+1
  and the receiving hop's transmit kernel, queued behind it on the
  same stream, reads the uploaded bytes.  An upload that fails fails
  the frame: the reader logs it and closes the connection; it never
  delivers the segment as host bytes.

The wire format is the JAX package's, dtype strings included
(``"float32"``, ``"bfloat16"``, ``"uint8"``, … — ``_WIRE_DTYPES``), so a
JAX bridge and a port bridge interoperate.

Topology flow:
- server process: ``listen_dcn(port)`` — accepts bridge connections.
- client process: ``connect_dcn(host, port)`` — handshake learns the
  remote fabric's server coords; the local fabric records them as
  remote routes, so ``tpu://`` naming resolves them and
  ``IciFabric.send`` ships frames over the bridge transparently.
- reverse path: a frame's src coords are learned as a route back
  through the connection it arrived on (client ports are created
  lazily, so they cannot be advertised in the hello).

Wire format (all big-endian):
- hello:      b"ICI1" u32(len) json{role, server_coords:[[s,c]..]}
- hello-ack:  same shape from the acceptor
- frame:      b"ICIF" u32(len) json{src, dst, segs:[{k,"n",dtype?,shape?}..]}
              followed by the segments' raw bytes in order
  seg kind "b" = host bytes; "d" = a whole device array (dtype/shape
  re-materialize it on the receiving side).
"""

from __future__ import annotations

import json
import queue as _queue
import select as _select
import socket as _pysocket
import ssl as _ssl
import struct
import threading
from typing import Dict, List, Optional, Tuple

from incubator_brpc_tpu_torch.analysis.device_witness import allowed_transfer
from incubator_brpc_tpu_torch.chaos import injector as _chaos
from incubator_brpc_tpu_torch.observability.span import Span
from incubator_brpc_tpu_torch.utils.segmentation import (
    WIRE_CHUNK_BYTES,
    chunk_buffer,
    chunk_views,
)
from incubator_brpc_tpu_torch.utils.iobuf import DeviceRef, IOBuf
from incubator_brpc_tpu_torch.utils.logging import log_error, log_info

_HELLO_MAGIC = b"ICI1"
_FRAME_MAGIC = b"ICIF"
_MAX_HEADER = 16 << 20
# ~4MB wire chunks (RDMA endpoint frame granularity) — the SHARED
# segmentation policy (utils/segmentation.py), same planner the ICI
# chunked transmit and the kernel-socket write loop use
_WIRE_CHUNK = WIRE_CHUNK_BYTES
_SEND_WINDOW = 8  # staged-but-unsent chunks allowed in flight (32MB)

# the wire's dtype strings: numpy's names, as the JAX package writes
# them (``str(np.dtype(arr.dtype))``); torch dtypes and bfloat16 have
# no numpy dtype, so both directions go through this one map
_WIRE_DTYPES = {
    "bool": "bool",
    "uint8": "uint8",
    "int8": "int8",
    "int16": "int16",
    "int32": "int32",
    "int64": "int64",
    "float16": "float16",
    "bfloat16": "bfloat16",
    "float32": "float32",
    "float64": "float64",
    "complex64": "complex64",
    "complex128": "complex128",
}


def _wire_dtype(dtype) -> str:
    """The wire string of a torch dtype; raises for one the map lacks."""
    name = str(dtype).removeprefix("torch.")
    if name not in _WIRE_DTYPES:
        raise TypeError(f"dtype {dtype} has no DCN wire name")
    return _WIRE_DTYPES[name]


def _torch_dtype(wire: str):
    """The torch dtype of a wire string; raises for an unknown one."""
    import torch

    if wire not in _WIRE_DTYPES:
        raise TypeError(f"unknown DCN wire dtype {wire!r}")
    return getattr(torch, _WIRE_DTYPES[wire])


# one side stream per CUDA device for the senders' device→host staging
_d2h_streams: Dict = {}
_d2h_lock = threading.Lock()


def _d2h_stream(device):
    import torch

    with _d2h_lock:
        stream = _d2h_streams.get(device)
        if stream is None:
            stream = _d2h_streams[device] = torch.cuda.Stream(device=device)
        return stream


def _stage_to_host(arr):
    """Start the device→host copy of a whole tensor: returns (host,
    event) with ``host`` a uint8 tensor of its bytes, complete once
    ``event`` (None for a CPU tensor, whose bytes are read in place)
    has fired.  A CUDA tensor is copied into pinned memory on the
    device's side stream, after the work already queued for it; the
    tensor is kept for the side stream until the copy is done."""
    import torch

    flat = arr.detach().contiguous().reshape(-1)
    raw = flat.view(torch.uint8) if flat.numel() else torch.empty(
        0, dtype=torch.uint8, device=arr.device
    )
    if not arr.is_cuda:
        return raw, None
    dev = arr.device
    host = torch.empty(raw.numel(), dtype=torch.uint8, pin_memory=True)
    stream = _d2h_stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        host.copy_(raw, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    raw.record_stream(stream)
    return host, event


def _upload(seg: dict, buf, pinned, device):
    """A received device segment as a tensor of its dtype and shape on
    ``device``, the destination port's: a non-blocking copy from the
    pinned receive buffer on the device's current stream (the stream
    the receiving hop's transmit kernel runs on), or the received
    bytes themselves when the port is on the CPU or has no device.
    Raises when the segment cannot be placed; the frame then fails."""
    import torch

    dtype = _torch_dtype(seg["dtype"])
    shape = [int(d) for d in seg["shape"]]
    src = pinned if pinned is not None else torch.from_numpy(buf)
    if src.numel():
        t = src.view(dtype).reshape(shape)
    else:
        t = torch.empty(shape, dtype=dtype)
    if device is None or device.type == "cpu":
        return t
    with torch.cuda.device(device):
        return t.to(device, non_blocking=True)


def _coords_to_wire(coords) -> list:
    return list(coords)


def _coords_from_wire(raw, server: bool = False) -> Optional[Tuple]:
    """Validate peer-supplied coords. Port keys are 2-tuples: servers
    are (slice:int, chip:int); client ports are ("client", "pid-seq").
    Anything else is dropped — a malformed peer must not crash the
    naming service or fabric that later consumes these."""
    try:
        if len(raw) != 2:
            return None
        s, c = raw
    except TypeError:
        return None
    ok_types = (int,) if server else (int, str)
    if isinstance(s, bool) or isinstance(c, bool):
        return None
    if not isinstance(s, ok_types) or not isinstance(c, ok_types):
        return None
    return (s, c)


def _plan_frame(frame: IOBuf, src, dst):
    """Plan the wire encoding of an IOBuf: returns (header_bytes,
    producers, total_payload_bytes) where each producer() yields the
    corresponding segment's payload as memoryview chunks of
    ≤ _WIRE_CHUNK bytes.

    Every whole-tensor device segment's D2H copy is started HERE
    (``_stage_to_host``) — all device transfers run concurrently with
    each other and with the socket writes of earlier segments; a copy
    that fails raises, failing the frame."""
    segs = []
    producers = []
    pending_host: List[memoryview] = []  # views into `frame` (alive
    # for the whole send): staging copies nothing

    # chunking comes from the shared segmentation policy
    # (utils/segmentation.py): chunk_buffer for contiguous staging
    # buffers, chunk_views for ref lists
    def flush_host():
        if pending_host:
            views = list(pending_host)
            segs.append({"k": "b", "n": sum(len(v) for v in views)})
            producers.append(
                lambda views=views: chunk_views(views, _WIRE_CHUNK)
            )
            pending_host.clear()

    for ref in frame._refs:
        if isinstance(ref, DeviceRef):
            arr = ref.whole_array()
            if arr is not None:
                flush_host()
                dtype = _wire_dtype(arr.dtype)
                host, event = _stage_to_host(arr)  # start the copy now
                segs.append(
                    {
                        "k": "d",
                        "n": int(host.numel()),
                        "dtype": dtype,
                        "shape": list(arr.shape),
                    }
                )

                def produce(host=host, event=event):
                    # the DCN bridge IS the device/host boundary: the
                    # segment must become contiguous host bytes to hit
                    # the socket (manifested as dcn.wire)
                    with allowed_transfer("dcn.wire"):
                        if event is not None:
                            event.synchronize()
                        wire = host.numpy()
                    return chunk_buffer(wire, _WIRE_CHUNK)

                producers.append(produce)
                continue
            # split device segment: ship its byte window as host bytes
        pending_host.append(ref.view())  # already a memoryview
    flush_host()
    header = json.dumps(
        {"src": _coords_to_wire(src), "dst": _coords_to_wire(dst), "segs": segs}
    ).encode()
    return header, producers, sum(s["n"] for s in segs)


_warmed = False
_warm_lock = threading.Lock()


def _warm_bulk_path():
    """One-time per-process warmup of what a first bulk frame would
    otherwise pay inline (the first-transfer straggler):

    - pre-touch a wire-chunk-sized receive buffer so the allocator
      arenas the first ``recv_into`` faults into are already mapped;
    - when a local port lives on a CUDA device, create that device's
      context and prime the pinned-memory cache with one wire chunk,
      which a fresh process would otherwise pay inside the first
      upload.

    Runs on the calling thread, before listen()'s accept loop or
    connect()'s reader starts: a daemon thread touching CUDA at
    interpreter exit can hang it."""
    global _warmed
    with _warm_lock:
        if _warmed:
            return
        _warmed = True
    import numpy as np

    buf = np.empty(_WIRE_CHUNK, dtype=np.uint8)
    buf[::4096] = 0  # fault every page in
    del buf
    from incubator_brpc_tpu_torch.parallel.ici import get_fabric

    devices = get_fabric().local_cuda_devices()
    if devices:
        import torch

        for dev in devices:
            torch.empty(8, device=dev)  # the context, created synchronously
        torch.empty(_WIRE_CHUNK, dtype=torch.uint8, pin_memory=True)


def _recv_exact(conn, n: int) -> Optional[bytes]:
    """n bytes, or None on EOF or a reset connection (a peer that
    upgraded to UDS resets the TCP link it dropped)."""
    out = bytearray()
    while len(out) < n:
        try:
            chunk = conn.recv(min(1 << 20, n - len(out)))
        except OSError:
            return None
        if not chunk:
            return None
        out += chunk
    return bytes(out)


def _read_header(conn) -> Optional[Tuple[bytes, dict]]:
    """Read one message's magic + JSON header (shared by the handshake
    reader and the streaming frame loop). → (magic, header) or None on
    EOF/garbage."""
    head = _recv_exact(conn, 8)
    if head is None:
        return None
    magic, hlen = head[:4], struct.unpack(">I", head[4:])[0]
    if magic not in (_HELLO_MAGIC, _FRAME_MAGIC) or hlen > _MAX_HEADER:
        return None
    raw = _recv_exact(conn, hlen)
    if raw is None:
        return None
    try:
        header = json.loads(raw)
    except ValueError:
        return None
    return magic, header


def _read_message(conn) -> Optional[Tuple[bytes, dict, bytes]]:
    """→ (magic, header_json, body) or None on EOF/garbage.  Handshake
    use only — frame bodies are drained whole here, not streamed."""
    msg = _read_header(conn)
    if msg is None:
        return None
    magic, header = msg
    body = b""
    if magic == _FRAME_MAGIC:
        total = sum(s["n"] for s in header.get("segs", ()))
        body = _recv_exact(conn, total)
        if body is None:
            return None
    return magic, header, body


class _LockedTlsSocket:
    """Serializes all I/O on one TLS bridge connection.

    OpenSSL's ``SSL*`` is not thread-safe for simultaneous
    SSL_read/SSL_write and CPython's ``_ssl`` adds no per-object lock,
    yet the bridge reads (reader_loop) and writes (send_frame) from
    different threads on the same connection.  Every SSL call holds one
    lock.  Reads do a non-blocking probe under the lock and then park
    in select() OUTSIDE it, so an idle reader costs no SSL/lock churn
    and never starves the writer.  Writes go out in bounded chunks with
    a per-chunk timeout, so a wedged peer fails the send (send_frame
    then closes the bridge) instead of holding the lock forever.
    Plaintext connections bypass this class entirely (kernel sockets
    are full-duplex safe).
    """

    _CHUNK = 64 << 10
    _SEND_TIMEOUT_S = 20.0  # floor rate ~3 KB/s before we declare wedged
    _PARK_S = 0.5

    def __init__(self, sock: _ssl.SSLSocket):
        self._sock = sock
        self._lock = threading.Lock()

    def sendall(self, data) -> None:
        mv = memoryview(data)
        if not len(mv):
            return
        for off in range(0, len(mv), self._CHUNK):
            with self._lock:
                self._sock.settimeout(self._SEND_TIMEOUT_S)
                self._sock.sendall(mv[off : off + self._CHUNK])

    def _recv_op(self, op):
        while True:
            with self._lock:
                self._sock.settimeout(0)  # instant probe: never parks
                try:
                    return op()
                except (
                    _ssl.SSLWantReadError,
                    _ssl.SSLWantWriteError,  # renegotiation mid-read
                    BlockingIOError,
                ):
                    pass
            # park OUTSIDE the lock: select on the fd is safe alongside
            # a concurrent SSL_write, unlike a blocking SSL_read
            _select.select([self._sock], [], [], self._PARK_S)

    def recv(self, n: int) -> bytes:
        return self._recv_op(lambda: self._sock.recv(n))

    def recv_into(self, view, nbytes: int = 0) -> int:
        return self._recv_op(lambda: self._sock.recv_into(view, nbytes))

    def settimeout(self, t) -> None:  # timeouts are managed per-call
        pass

    def close(self) -> None:
        self._sock.close()


class _BridgeConn:
    """One established bridge connection (either direction)."""

    def __init__(self, bridge: "DcnBridge", conn: _pysocket.socket, peer: str):
        if isinstance(conn, _ssl.SSLSocket):
            conn = _LockedTlsSocket(conn)
        else:
            # deep kernel buffers: bulk frames move in multi-MB chunks,
            # and the default ~208KB socket buffers force one syscall
            # per ~200KB on the receive side (best-effort; the kernel
            # clamps to its rmem/wmem limits)
            try:
                conn.setsockopt(
                    _pysocket.SOL_SOCKET, _pysocket.SO_SNDBUF, 8 << 20
                )
                conn.setsockopt(
                    _pysocket.SOL_SOCKET, _pysocket.SO_RCVBUF, 8 << 20
                )
            except OSError:
                pass
        self.bridge = bridge
        self.conn = conn
        self.peer = peer
        self._send_lock = threading.Lock()
        self.closed = False
        self.primed_seen = False  # peer's priming frame arrived
        # chaos "reorder": one held-back frame swapped with its successor
        self._chaos_stash = None
        self._chaos_stash_gen = 0  # ties each backstop timer to ITS stash
        self._chaos_stash_lock = threading.Lock()

    def send_prime(self) -> None:
        """Priming exchange, half of the straggler fix: a zero-segment
        frame sent right after the handshake exercises the peer's whole
        receive path (magic/header read, JSON parse, reader-loop warm)
        before the first real bulk frame, and its arrival proves the
        link full-duplex.  The receiver skips it via the ``prime``
        header key; peers that predate the key would try to route it
        and log one dropped-frame line — wire framing stays intact
        either way."""
        header = json.dumps(
            {"prime": 1, "src": [-1, -1], "dst": [-1, -1], "segs": []}
        ).encode()
        try:
            with self._send_lock:
                self.conn.sendall(
                    _FRAME_MAGIC + struct.pack(">I", len(header)) + header
                )
        except OSError:
            pass  # the reader loop will notice a genuinely dead conn

    def send_frame(self, frame: IOBuf, dst, src) -> int:
        from incubator_brpc_tpu_torch import errors

        if _chaos.armed:
            spec = _chaos.check("dcn.send", peer=self.peer)
            if spec is not None:
                act = spec.action
                if act == "drop":
                    return 0  # frame vanishes on the wide-area hop
                if act == "delay_us":
                    _chaos.sleep_us(spec.arg)
                elif act == "reset":
                    # bridge disconnect mid-traffic: the reader loop
                    # sees EOF and the routing table drops this conn
                    self.close()
                    return errors.EFAILEDSOCKET
                elif act == "reorder":
                    with self._chaos_stash_lock:
                        if self._chaos_stash is None:
                            # hold this frame; it ships AFTER the next
                            # frame on this conn (frame reordering on
                            # the DCN path, deterministic swap).  A
                            # timer backstop flushes it if no successor
                            # ever comes — "reorder" must never degrade
                            # into a silent permanent drop
                            self._chaos_stash = (frame, dst, src)
                            self._chaos_stash_gen += 1
                            gen = self._chaos_stash_gen
                            from incubator_brpc_tpu_torch.runtime.timer_thread import (
                                get_timer_thread,
                            )

                            get_timer_thread().schedule(
                                self._chaos_flush_stash, 0.2, gen
                            )
                            return 0
        stashed = None
        if self._chaos_stash is not None:
            with self._chaos_stash_lock:
                stashed, self._chaos_stash = self._chaos_stash, None
        rc = self._send_frame_now(frame, dst, src)
        if stashed is not None:
            self._send_stashed(*stashed)
        return rc

    def _send_stashed(self, frame, dst, src):
        """Ship a reorder-held frame; a failure here has no caller to
        return to, so it must at least be LOUD (the hold-back comment
        promises reorder never degrades into a silent drop)."""
        rc = self._send_frame_now(frame, dst, src)
        if rc:
            log_error(
                "dcn chaos reorder: held frame for %s lost on re-send "
                "(rc=%s)", dst, rc,
            )

    def _chaos_flush_stash(self, gen):
        """Timer backstop: ship a reorder-held frame that never got a
        successor to swap with (runs spawned off the timer thread —
        send_frame can block on the socket).  The generation check
        drops a stale timer whose stash was already swapped out —
        without it, the timer of stash A would flush a LATER stash C
        early, turning a deterministic swap into a timing-dependent
        plain delay."""
        with self._chaos_stash_lock:
            if gen != self._chaos_stash_gen:
                return
            stashed, self._chaos_stash = self._chaos_stash, None
        if stashed is not None and not self.closed:
            from incubator_brpc_tpu_torch.runtime import scheduler

            scheduler.spawn(self._send_stashed, *stashed)

    def _send_frame_now(self, frame: IOBuf, dst, src) -> int:
        from incubator_brpc_tpu_torch import errors

        # rpcz collective sub-span: the cross-host leg of this frame
        # (parented to the active RPC span; None outside a traced RPC)
        leg = Span.create_collective("dcn", f"{src}->{dst} via {self.peer}")
        if leg is not None:
            leg.request_size = len(frame)
            leg.remote_side = self.peer

        def _done(rc: int) -> int:
            if leg is not None:
                leg.end(rc)
            return rc

        # Planning failures are LOCAL — no wire byte moved, the bridge
        # stays healthy and only this frame fails.
        try:
            header, producers, total = _plan_frame(frame, src, dst)
        except Exception as e:  # noqa: BLE001
            log_error("dcn frame to %s unserializable: %r", self.peer, e)
            return _done(errors.EREQUEST)
        if total > (2 << 30):
            # mirror of the receiver's cap: failing here keeps the
            # bridge alive; streaming it would kill the peer's reader
            log_error("dcn frame to %s too large: %d bytes", self.peer, total)
            return _done(errors.EREQUEST)
        # Once the header is on the wire the stream is committed: ANY
        # failure (socket or stager) desyncs the framing → close.
        try:
            with self._send_lock:
                self.conn.sendall(
                    _FRAME_MAGIC + struct.pack(">I", len(header)) + header
                )
                if producers:
                    self._stream_payloads(producers, leg)
            return _done(0)
        except Exception as e:  # noqa: BLE001 — stager errors included
            log_error("dcn send to %s failed: %r", self.peer, e)
            self.close()
            return _done(errors.EFAILEDSOCKET)

    def _stream_payloads(self, producers, leg=None):
        """Windowed overlap: a stager thread fills a bounded queue with
        wire chunks (staging = D2H fetch + slicing) while this thread
        drains it into the socket.  The queue bound IS the send window
        (reference rdma_endpoint.h:83-137 sq window).  ``leg`` (the
        rpcz collective sub-span) gets a timestamped mark per wire
        chunk, so /rpcz shows the staging/write overlap."""
        nchunk = [0]

        def mark_sent(chunk):
            if leg is not None:
                leg.chunk_mark("dcn wire", nchunk[0], 0, len(chunk))
            nchunk[0] += 1

        if len(producers) == 1:
            # single segment: stage inline (a thread would add handoff
            # cost with nothing to overlap — the fetch happened above)
            for chunk in producers[0]():
                self.conn.sendall(chunk)
                mark_sent(chunk)
            return
        q: _queue.Queue = _queue.Queue(maxsize=_SEND_WINDOW)

        def stage():
            try:
                for p in producers:
                    for chunk in p():
                        q.put(chunk)
                q.put(None)
            except Exception as e:  # noqa: BLE001 — surfaced to writer
                q.put(e)

        t = threading.Thread(target=stage, daemon=True, name="dcn-stager")
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                self.conn.sendall(item)
                mark_sent(item)
        finally:
            # unblock a stager stuck on a full window if we bailed early
            while t.is_alive():
                try:
                    q.get_nowait()
                except _queue.Empty:
                    t.join(0.05)

    def _receive_frame_body(self, header):
        """Stream segment payloads off the socket; a completed device
        segment uploads to its destination port's device with a
        non-blocking copy WHILE later segments are still arriving.
        Returns (frame, src, dst); raises — failing the frame — when a
        segment cannot be placed."""
        import numpy as np

        from incubator_brpc_tpu_torch.parallel.ici import get_fabric

        segs = header.get("segs", ())
        sizes = [int(s["n"]) for s in segs]
        # per-segment validation: a negative size could offset the sum
        # below the cap while another segment demands a huge allocation
        if any(n < 0 for n in sizes):
            raise ValueError("negative segment size")
        total = sum(sizes)
        if total > (2 << 30):
            raise ValueError(f"frame body too large: {total}")
        src = _coords_from_wire(header["src"])
        dst = _coords_from_wire(header["dst"])
        if src is None or dst is None:
            raise ValueError("malformed frame coords")
        port = get_fabric().port(dst)
        device = port.device if port is not None else None
        frame = IOBuf()
        for seg, n in zip(segs, sizes):
            device_seg = seg["k"] == "d"
            if device_seg and device is not None and device.type == "cuda":
                # pinned, so the upload below is a true async copy
                import torch

                pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)
                # the socket fills the pinned staging buffer through a
                # host view of it: the wire boundary, inbound
                with allowed_transfer("dcn.wire"):
                    buf = pinned.numpy()
            else:
                # np.empty skips the memset a bytearray(n) pays; every
                # byte is overwritten by recv_into anyway
                pinned = None
                buf = np.empty(n, dtype=np.uint8)
            view = memoryview(buf)
            got = 0
            while got < n:
                r = self.conn.recv_into(
                    view[got:], min(_WIRE_CHUNK, n - got)
                )
                if r == 0:
                    raise ConnectionError("peer closed mid-frame")
                got += r
            if device_seg:
                frame.append_device(_upload(seg, buf, pinned, device))
            else:
                # zero-copy: the buffer is owned solely by this frame
                # from here on (append() would memcpy it again)
                frame.append_user_data(buf)
        return frame, src, dst

    def reader_loop(self):
        """Frames from the peer: learn reverse routes, deliver locally."""
        from incubator_brpc_tpu_torch.parallel.ici import get_fabric

        fabric = get_fabric()
        while not self.closed:
            msg = _read_header(self.conn)
            if msg is None:
                break
            magic, header = msg
            if magic != _FRAME_MAGIC:
                continue
            if header.get("prime"):
                # the peer's connect-time priming frame: receive path
                # is warm, nothing to deliver
                self.primed_seen = True
                continue
            try:
                frame, src, dst = self._receive_frame_body(header)
            except Exception as e:  # noqa: BLE001
                log_error("dcn frame from %s malformed: %r", self.peer, e)
                break
            # the peer can reach coords `src`: route replies back here
            # (assignment, not setdefault — a reconnected peer's fresh
            # connection must supersede the dead one's stale route)
            with self.bridge._lock:
                self.bridge._routes[src] = self
            # bridged frames force past the local receive window: the
            # remote sender is already bounded by ITS bridge send
            # window, and dropping a delivered frame here would lose it
            # silently mid-protocol (the wire has no NACK)
            rc = fabric.send(
                frame, dst, src, _local_only=True, ignore_eovercrowded=True
            )
            if rc:
                log_error("dcn frame for unknown local coords %s dropped", (dst,))
        self.close()

    def close(self):
        if self.closed:
            return
        self.closed = True
        try:
            self.conn.close()
        except OSError:
            pass
        self.bridge._drop_conn(self)


class DcnBridge:
    """Per-process singleton: listener + outbound connections + routes."""

    def __init__(self):
        self._routes: Dict[Tuple, _BridgeConn] = {}
        self._remote_servers: Dict[Tuple, _BridgeConn] = {}
        self._conns: List[_BridgeConn] = []
        self._lock = threading.Lock()
        self._listener: Optional[_pysocket.socket] = None
        self._uds_listener: Optional[_pysocket.socket] = None
        self._uds_path: Optional[str] = None
        self._uds_dir: Optional[str] = None
        self._ssl_context = None
        self.port = 0

    # ---- routing (used by IciFabric.send) ----------------------------------
    def route(self, coords) -> Optional[_BridgeConn]:
        # check each table independently: a DEAD learned route must not
        # shadow a live advertised one (and vice versa); drop corpses.
        # _lock guards both tables — accept/reader threads insert while
        # the naming service iterates.
        with self._lock:
            for table in (self._routes, self._remote_servers):
                conn = table.get(coords)
                if conn is None:
                    continue
                if conn.closed:
                    table.pop(coords, None)
                    continue
                return conn
        return None

    def remote_server_coords(self) -> List[Tuple]:
        with self._lock:
            items = list(self._remote_servers.items())
        return sorted((c for c, conn in items if not conn.closed), key=str)

    def _drop_conn(self, conn: _BridgeConn):
        with self._lock:
            if conn in self._conns:
                self._conns.remove(conn)

    # ---- server side --------------------------------------------------------
    def listen(self, port: int = 0, host: str = "0.0.0.0",
               ssl_context=None) -> int:
        """Start accepting bridge connections; returns the bound port.
        ssl_context (an ``ssl.SSLContext`` from
        transport/ssl_helper.make_server_context) encrypts every bridge
        link — the cross-HOST leg is the one that actually crosses
        untrusted networks (reference: ssl on the RDMA bootstrap's TCP
        side channel would be the analog)."""
        if self._listener is not None:
            return self.port
        ls = _pysocket.socket()
        ls.setsockopt(_pysocket.SOL_SOCKET, _pysocket.SO_REUSEADDR, 1)
        ls.bind((host, port))
        ls.listen(16)
        _warm_bulk_path()
        self._listener = ls
        self._ssl_context = ssl_context
        self.port = ls.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True).start()
        # same-host fast path: a UDS listener alongside TCP, advertised
        # in the hello.  UDS skips a protocol stack that loopback TCP
        # pays per byte, so
        # a same-host peer upgrades its bridge to the UDS path after
        # the TCP handshake.  Skipped under TLS (the TCP link is the
        # authenticated one; same-host traffic needs no wire crypto,
        # but silently downgrading crypto would surprise operators).
        if ssl_context is None:
            import os as _os
            import tempfile as _tmp

            udir = None
            try:
                # private directory (mkdtemp = 0700) + 0600 socket file,
                # both set BEFORE the path is advertised in the hello:
                # a world-writable /tmp socket would let any local user
                # connect to (or pre-create/squat) the bridge endpoint
                udir = _tmp.mkdtemp(prefix=f"dcnbridge-{_os.getpid()}-")
                upath = _os.path.join(udir, "bridge.sock")
                uls = _pysocket.socket(_pysocket.AF_UNIX)
                uls.bind(upath)
                _os.chmod(upath, 0o600)
                uls.listen(16)
                self._uds_listener = uls
                self._uds_path = upath
                self._uds_dir = udir
                threading.Thread(
                    target=self._accept_loop_uds, daemon=True
                ).start()
            except OSError as e:  # no UDS support: TCP-only is fine
                log_error("DCN UDS listener unavailable: %r", e)
                if udir is not None:  # don't orphan the private dir
                    import shutil as _shutil

                    _shutil.rmtree(udir, ignore_errors=True)
        log_info("DCN bridge listening on %s:%d%s", host, self.port,
                 " (TLS)" if ssl_context else "")
        return self.port

    def _accept_loop(self):
        while self._listener is not None:
            try:
                conn, addr = self._listener.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(conn, f"{addr[0]}:{addr[1]}"),
                daemon=True,
            ).start()

    def _accept_loop_uds(self):
        while self._uds_listener is not None:
            try:
                conn, _ = self._uds_listener.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(conn, f"uds:{self._uds_path}"),
                daemon=True,
            ).start()

    def _serve_conn(self, conn: _pysocket.socket, peer: str):
        from incubator_brpc_tpu_torch.parallel.ici import get_fabric

        if self._ssl_context is not None:
            from incubator_brpc_tpu_torch.transport.ssl_helper import (
                wrap_server_side,
            )

            conn = wrap_server_side(
                conn, self._ssl_context, 5.0, peer, log_error
            )
            if conn is None:
                return
        msg = _read_message(conn)
        if msg is None or msg[0] != _HELLO_MAGIC:
            conn.close()
            return
        bc = _BridgeConn(self, conn, peer)
        with self._lock:
            self._conns.append(bc)
            # the peer's advertised servers are reachable through it
            # (newest connection wins: reconnects supersede dead routes)
            for raw in msg[1].get("server_coords", ()):
                c = _coords_from_wire(raw, server=True)
                if c is not None:
                    self._remote_servers[c] = bc
        self._send_hello(bc, get_fabric())
        bc.send_prime()  # warm the peer's receive path pre-traffic
        bc.reader_loop()

    # ---- client side --------------------------------------------------------
    def connect(self, host: str, port: int, timeout_s: float = 5.0,
                ssl_context=None, server_hostname: str = "") -> List[Tuple]:
        """Dial a remote bridge; returns its advertised server coords.
        ssl_context (from transport/ssl_helper.make_client_context)
        encrypts the link; server_hostname feeds SNI/verification."""
        from incubator_brpc_tpu_torch.parallel.ici import get_fabric

        conn = _pysocket.create_connection((host, port), timeout=timeout_s)
        conn.settimeout(timeout_s)
        if ssl_context is not None:
            conn = ssl_context.wrap_socket(
                conn, server_hostname=server_hostname or None
            )
        # handshake on the raw socket BEFORE _BridgeConn wraps a TLS
        # conn in _LockedTlsSocket: single-threaded here, and the
        # timeout_s bound stays in force (the guard manages timeouts
        # per-call and would unbound this read)
        try:
            conn.sendall(self._hello_bytes(get_fabric()))
            msg = _read_message(conn)
        except OSError:
            msg = None
        if msg is None or msg[0] != _HELLO_MAGIC:
            conn.close()
            raise ConnectionError(f"dcn handshake with {host}:{port} failed")
        conn.settimeout(None)
        # same-host upgrade: a loopback peer advertising a UDS endpoint
        # gets the bridge over AF_UNIX instead (one protocol stack
        # less per byte than loopback TCP).  The TCP
        # connection is discarded after a successful UDS handshake;
        # any failure falls back to the TCP link just established.
        uds_path = msg[1].get("uds")
        if (
            ssl_context is None
            and isinstance(uds_path, str)
            and host in ("127.0.0.1", "localhost", "::1")
        ):
            uconn = None
            try:
                uconn = _pysocket.socket(_pysocket.AF_UNIX)
                uconn.settimeout(timeout_s)
                uconn.connect(uds_path)
                uconn.sendall(self._hello_bytes(get_fabric()))
                umsg = _read_message(uconn)
                if umsg is not None and umsg[0] == _HELLO_MAGIC:
                    uconn.settimeout(None)
                    conn.close()
                    conn = uconn
                    uconn = None  # ownership moved: don't close below
                    msg = umsg
                    port_label = f"uds:{uds_path}"
                else:
                    port_label = f"{host}:{port}"
            except OSError:
                port_label = f"{host}:{port}"
            finally:
                if uconn is not None:
                    try:
                        uconn.close()
                    except OSError:
                        pass
        else:
            port_label = f"{host}:{port}"
        bc = _BridgeConn(self, conn, port_label)
        coords = [
            c
            for raw in msg[1].get("server_coords", ())
            if (c := _coords_from_wire(raw, server=True)) is not None
        ]
        with self._lock:
            for c in coords:
                self._remote_servers[c] = bc
            self._conns.append(bc)
        _warm_bulk_path()
        threading.Thread(target=bc.reader_loop, daemon=True).start()
        bc.send_prime()  # warm the acceptor's receive path pre-traffic
        return coords

    def _hello_bytes(self, fabric) -> bytes:
        body = {
            "role": "fabric",
            "server_coords": [
                _coords_to_wire(c) for c in fabric.local_server_coords()
            ],
        }
        if self._uds_path is not None:
            # same-host peers may upgrade to this UDS endpoint (one
            # protocol stack less than loopback TCP); unknown keys are ignored by old
            # peers, so the wire stays version-compatible
            body["uds"] = self._uds_path
        header = json.dumps(body).encode()
        return _HELLO_MAGIC + struct.pack(">I", len(header)) + header

    def _send_hello(self, bc: _BridgeConn, fabric):
        with bc._send_lock:
            bc.conn.sendall(self._hello_bytes(fabric))

    def close(self):
        ls, self._listener = self._listener, None
        if ls is not None:
            try:
                ls.close()
            except OSError:
                pass
        uls, self._uds_listener = self._uds_listener, None
        if uls is not None:
            try:
                uls.close()
            except OSError:
                pass
        if self._uds_path is not None:
            import os as _os

            try:
                _os.unlink(self._uds_path)
            except OSError:
                pass
            self._uds_path = None
        if getattr(self, "_uds_dir", None) is not None:
            import os as _os

            try:
                _os.rmdir(self._uds_dir)
            except OSError:
                pass
            self._uds_dir = None
        with self._lock:
            conns, self._conns = list(self._conns), []
        for c in conns:
            c.close()
        with self._lock:
            self._routes.clear()
            self._remote_servers.clear()


_bridge: Optional[DcnBridge] = None
_bridge_lock = threading.Lock()


def get_bridge() -> DcnBridge:
    global _bridge
    if _bridge is None:
        with _bridge_lock:
            if _bridge is None:
                _bridge = DcnBridge()
    return _bridge


def listen_dcn(port: int = 0, host: str = "0.0.0.0", ssl_context=None) -> int:
    return get_bridge().listen(port, host, ssl_context=ssl_context)


def connect_dcn(
    host: str, port: int, timeout_s: float = 5.0, ssl_context=None,
    server_hostname: str = "",
) -> List[Tuple]:
    return get_bridge().connect(
        host, port, timeout_s, ssl_context=ssl_context,
        server_hostname=server_hostname,
    )
