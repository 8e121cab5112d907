"""IOBuf — zero-copy, non-contiguous, refcounted segmented buffer.

PyTorch port of butil::IOBuf (reference: butil/iobuf.h:61-111,
iobuf.cpp); the JAX package's ``utils/iobuf.py`` is its reference. The universal payload type of the framework: every wire
message, attachment, and stream chunk is an IOBuf.

Design (kept from the reference):
- A buffer is a sequence of *block refs*; each ref is a (block, offset,
  length) window into a shared, refcounted block. Slicing (``cutn``,
  ``pop_front``) moves refs, never bytes.
- Blocks come from a thread-local block cache (reference iobuf.cpp
  per-thread block list); CPython object refcounting plays the role of
  the reference's manual block refcounts.
- ``cut_into_socket`` / ``append_from_socket`` do vectored IO
  (reference cut_into_file_descriptor / append_from_file_descriptor).

Device extension: a ref may be a *DeviceRef* holding a device-resident
``torch.Tensor`` instead of host bytes. Device refs flow through the
framework untouched; the ICI transport hands the tensor to its transmit
kernels without ever materializing host bytes, while host transports
materialize lazily on first byte access.
"""

from __future__ import annotations

import ssl as _ssl
import threading
from collections import deque
from typing import Iterable, List, Optional, Tuple

DEFAULT_BLOCK_SIZE = 8192  # reference IOBUF_BLOCK_SIZE = 8KB (iobuf.cpp)
MAX_BLOCKS_PER_CACHE = 64
_SSL_LOCK_GUARD = threading.Lock()  # creation guard for per-socket locks


class Block:
    """A refcounted byte block.

    CPython refcounting stands in for the reference's manual block
    refcounts; when the last IOBuf ref drops, ``__del__`` recycles the
    backing bytearray into a thread-local cache (the storage, not the
    Block object, so recycling keeps working across GC generations).
    """

    __slots__ = ("data", "size", "cap")

    def __init__(self, cap: int = DEFAULT_BLOCK_SIZE, data: Optional[bytearray] = None):
        self.data = data if data is not None else bytearray(cap)
        self.size = 0  # bytes filled; [size, cap) is writable tail space
        self.cap = cap

    @property
    def left_space(self) -> int:
        return self.cap - self.size

    def __del__(self):
        try:
            if self.cap == DEFAULT_BLOCK_SIZE:
                cache = _tl_cache
                if len(cache.storages) < MAX_BLOCKS_PER_CACHE:
                    cache.returned += 1
                    cache.storages.append(self.data)
        except Exception:
            pass  # interpreter shutdown


class _TLBlockCache(threading.local):
    def __init__(self):
        self.storages: List[bytearray] = []
        self.got = 0
        self.returned = 0


_tl_cache = _TLBlockCache()


def acquire_block(min_cap: int = DEFAULT_BLOCK_SIZE) -> Block:
    cache = _tl_cache
    if min_cap <= DEFAULT_BLOCK_SIZE and cache.storages:
        cache.got += 1
        return Block(DEFAULT_BLOCK_SIZE, data=cache.storages.pop())
    return Block(max(min_cap, DEFAULT_BLOCK_SIZE))


class BlockRef:
    """A (block, offset, length) window. Analog of butil::IOBuf::BlockRef."""

    __slots__ = ("block", "offset", "length")

    def __init__(self, block: Block, offset: int, length: int):
        self.block = block
        self.offset = offset
        self.length = length

    def view(self) -> memoryview:
        return memoryview(self.block.data)[self.offset : self.offset + self.length]


class UserRef:
    """Zero-copy ref over user-owned bytes/memoryview (append_user_data)."""

    __slots__ = ("mv", "offset", "length")

    def __init__(self, data, offset: int = 0, length: Optional[int] = None):
        mv = memoryview(data)
        if mv.ndim != 1 or mv.itemsize != 1:
            mv = mv.cast("B")
        self.mv = mv
        self.offset = offset
        self.length = len(mv) - offset if length is None else length

    def view(self) -> memoryview:
        return self.mv[self.offset : self.offset + self.length]


class DeviceRef:
    """A device-resident payload segment: a torch.Tensor standing in for
    bytes.

    The ICI transport ships the tensor device to device; a host
    transport (TCP) materializes bytes lazily. ``offset/length``
    window into the array's byte representation so cutn/pop_front keep
    zero-copy semantics at the ref level even for device payloads.
    """

    # __weakref__: the ICI fabric pins a weakref.finalize on placed
    # refs so the HBM profiler's in-flight charge releases with the ref
    __slots__ = ("array", "offset", "length", "_host", "csum", "__weakref__")

    def __init__(self, array, offset: int = 0, length: Optional[int] = None):
        self.array = array
        nbytes = int(array.nbytes)
        self.offset = offset
        self.length = nbytes - offset if length is None else length
        self._host = None
        # device-resident transmit checksum, set by the ICI fabric's
        # copy+verify delivery (ops/transfer.transmit_array); never
        # fetched on the hot path
        self.csum = None

    def _materialize(self) -> memoryview:
        if self._host is None:
            import torch

            from incubator_brpc_tpu_torch.analysis.device_witness import (
                allowed_transfer,
            )

            # the one sanctioned host-materialization choke point for
            # device segments: every wire serializer funnels through
            # here (manifested as iobuf.host-view).  The uint8 view
            # keeps dtypes numpy lacks (bfloat16) byte-exact.
            with allowed_transfer("iobuf.host-view"):
                t = self.array.detach().contiguous().reshape(-1)
                host = t.view(torch.uint8).cpu().numpy()
                self._host = memoryview(host).cast("B")
        return self._host

    def view(self) -> memoryview:
        return self._materialize()[self.offset : self.offset + self.length]

    def whole_array(self):
        """The underlying array iff this ref covers it fully (zero-copy path)."""
        if self.offset == 0 and self.length == int(self.array.nbytes):
            return self.array
        return None


class IOBuf:
    """Segmented zero-copy buffer (analog butil::IOBuf, iobuf.h:61)."""

    __slots__ = ("_refs", "_size")

    def __init__(self, data=None):
        self._refs: deque = deque()
        self._size = 0
        if data is not None:
            self.append(data)

    # ---- size & inspection ------------------------------------------------
    def __len__(self) -> int:
        return self._size

    @property
    def size(self) -> int:
        return self._size

    def empty(self) -> bool:
        return self._size == 0

    def backing_block_count(self) -> int:
        return len(self._refs)

    def has_device_payload(self) -> bool:
        return any(isinstance(r, DeviceRef) for r in self._refs)

    def device_segments(self) -> List["DeviceRef"]:
        """All device refs (possibly windowed), in order."""
        return [r for r in self._refs if isinstance(r, DeviceRef)]

    def iter_refs(self) -> Tuple:
        """Snapshot of the live ref sequence (BlockRef/UserRef/DeviceRef)
        in order.  Device-aware protocol parsers walk host bytes AROUND
        device segments with this instead of ``copy_to`` — the latter
        would materialize every DeviceRef just to frame the reply.  The
        refs stay owned by this buffer; callers must not mutate them."""
        return tuple(self._refs)

    def device_arrays(self) -> List[object]:
        """Whole tensors carried by this buffer, in order (ICI fast path).

        Raises ValueError if any device segment has been split by a
        cut/pop — callers must then fall back to device_segments() or
        byte materialization rather than silently losing payload.
        """
        out = []
        for r in self._refs:
            if isinstance(r, DeviceRef):
                a = r.whole_array()
                if a is None:
                    raise ValueError(
                        "IOBuf carries a partially-cut device segment; "
                        "use device_segments() or to_bytes()"
                    )
                out.append(a)
        return out

    # ---- append -----------------------------------------------------------
    def append(self, data) -> None:
        if isinstance(data, IOBuf):
            # Block sharing, no byte copy (IOBuf::append(const IOBuf&)).
            # Ref *objects* are cloned: each IOBuf uniquely owns its refs
            # because cutn/pop_front mutate them in place.
            self._refs.extend(_slice_ref(r, 0, r.length) for r in data._refs)
            self._size += data._size
            return
        if isinstance(data, str):
            data = data.encode()
        # large immutable payloads append BY REFERENCE: copying a 64MB
        # attachment into 1MB blocks costs ~50ms and shatters it into
        # refs the wire chunker then re-joins (bytes are immutable, so
        # the ref stays valid; mutable buffers still copy below)
        if isinstance(data, bytes) and len(data) >= 64 * 1024:
            self.append_user_data(data)
            return
        mv = memoryview(data)
        if mv.ndim != 1 or mv.itemsize != 1:
            mv = mv.cast("B")
        n = len(mv)
        if n == 0:
            return
        pos = 0
        # copy into tail block / fresh blocks (IOBuf::append(void const*, size_t))
        while pos < n:
            blk = self._writable_tail(n - pos)
            take = min(blk.left_space, n - pos)
            blk.data[blk.size : blk.size + take] = mv[pos : pos + take]
            last = self._refs[-1] if self._refs else None
            if (
                isinstance(last, BlockRef)
                and last.block is blk
                and last.offset + last.length == blk.size
            ):
                last.length += take
            else:
                self._refs.append(BlockRef(blk, blk.size, take))
            blk.size += take
            pos += take
            self._size += take

    def append_user_data(self, data) -> None:
        """Zero-copy append of caller-owned memory (IOBuf::append_user_data)."""
        ref = UserRef(data)
        if ref.length:
            self._refs.append(ref)
            self._size += ref.length

    def append_device(self, array) -> None:
        """Zero-copy append of a device-resident torch.Tensor."""
        ref = DeviceRef(array)
        if ref.length:
            self._refs.append(ref)
            self._size += ref.length

    def push_back(self, byte: int) -> None:
        self.append(bytes((byte,)))

    def _writable_tail(self, hint: int) -> Block:
        if self._refs:
            last = self._refs[-1]
            if (
                isinstance(last, BlockRef)
                and last.offset + last.length == last.block.size
                and last.block.left_space > 0
            ):
                return last.block
        return acquire_block(min(max(hint, DEFAULT_BLOCK_SIZE), 1 << 20))

    # ---- cut / pop (zero-copy slicing) ------------------------------------
    def cutn(self, out: Optional["IOBuf"], n: int) -> int:
        """Move first n bytes into `out` (or drop if None). Returns moved count.

        Ref-moving only — no byte copies (IOBuf::cutn, iobuf.cpp).
        """
        n = max(0, min(n, self._size))
        left = n
        while left > 0:
            ref = self._refs[0]
            if ref.length <= left:
                self._refs.popleft()
                if out is not None:
                    out._refs.append(ref)
                    out._size += ref.length
                left -= ref.length
            else:
                if out is not None:
                    head = _slice_ref(ref, 0, left)
                    out._refs.append(head)
                    out._size += left
                ref.offset += left
                ref.length -= left
                left = 0
        self._size -= n
        return n

    def pop_front(self, n: int) -> int:
        return self.cutn(None, n)

    def pop_back(self, n: int) -> int:
        n = max(0, min(n, self._size))
        left = n
        while left > 0:
            ref = self._refs[-1]
            if ref.length <= left:
                self._refs.pop()
                left -= ref.length
            else:
                ref.length -= left
                left = 0
        self._size -= n
        return n

    def clear(self) -> None:
        self._refs.clear()
        self._size = 0

    def swap(self, other: "IOBuf") -> None:
        self._refs, other._refs = other._refs, self._refs
        self._size, other._size = other._size, self._size

    # ---- materialization --------------------------------------------------
    def copy_to(self, n: int = -1, pos: int = 0) -> bytes:
        """Copy up to n bytes starting at pos into a new bytes object."""
        if n < 0:
            n = self._size
        out = bytearray()
        remaining_skip = pos
        remaining = n
        for ref in self._refs:
            if remaining <= 0:
                break
            v = ref.view()
            if remaining_skip >= len(v):
                remaining_skip -= len(v)
                continue
            if remaining_skip:
                v = v[remaining_skip:]
                remaining_skip = 0
            take = min(len(v), remaining)
            out += v[:take]
            remaining -= take
        return bytes(out)

    def to_bytes(self) -> bytes:
        if len(self._refs) == 1:
            return bytes(self._refs[0].view())  # single copy, no bytearray
        return self.copy_to()

    def as_view(self):
        """Contiguous zero-copy view when the buffer is one segment,
        else a single-copy bytes. Hot-path input for pb ParseFromString."""
        if len(self._refs) == 1:
            return self._refs[0].view()
        return self.copy_to()

    def fetch(self, n: int) -> Optional[bytes]:
        """First n bytes without consuming, or None if fewer available."""
        if self._size < n:
            return None
        if self._refs and self._refs[0].length >= n:
            return bytes(self._refs[0].view()[:n])
        return self.copy_to(n)

    def cut_bytes(self, n: int) -> bytes:
        """Consume and return exactly min(n, len) front bytes as bytes —
        the one-copy fast path for small wire fields (headers, meta);
        equivalent to cutn into a scratch IOBuf + to_bytes without the
        intermediate ref bookkeeping."""
        n = min(n, self._size)
        if not n:
            return b""
        ref = self._refs[0]
        if ref.length > n:  # fully inside the first segment: slice in place
            out = bytes(ref.view()[:n])
            ref.offset += n
            ref.length -= n
            self._size -= n
            return out
        if ref.length == n:
            out = bytes(ref.view())
            self._refs.popleft()
            self._size -= n
            return out
        out = self.copy_to(n)
        self.pop_front(n)
        return out

    def views(self) -> List[memoryview]:
        return [r.view() for r in self._refs]

    # ---- vectored socket IO (cut_into_file_descriptor analog) -------------
    @staticmethod
    def _ssl_io_lock(sock) -> threading.Lock:
        """Per-socket lock serializing SSL_read/SSL_write: OpenSSL's
        ``SSL*`` is not thread-safe for concurrent read/write from
        different threads (the epoll dispatcher recv_into races the
        inline-writer/KeepWrite send on pipelined traffic) and CPython's
        ``_ssl`` adds no per-object lock.  Transport TLS sockets are
        non-blocking, so holds are momentary."""
        lock = getattr(sock, "_tpu_ssl_io_lock", None)
        if lock is None:
            with _SSL_LOCK_GUARD:
                lock = getattr(sock, "_tpu_ssl_io_lock", None)
                if lock is None:
                    lock = threading.Lock()
                    sock._tpu_ssl_io_lock = lock
        return lock

    def cut_into_socket(self, sock, max_bytes: int = 1 << 20) -> int:
        """Vectored non-blocking write; consumes written bytes. Returns count
        or raises BlockingIOError when the socket would block immediately.
        TLS sockets (no scatter/gather; want-read/want-write signal EAGAIN)
        take the send() path — the SSLSocket equivalent of the reference's
        SSL_write branch in Socket::DoWrite."""
        if isinstance(sock, _ssl.SSLSocket):
            # coalesce refs into one buffer → one TLS record + syscall
            # per call instead of one per fragment (the ssl module sets
            # SSL_MODE_ACCEPT_MOVING_WRITE_BUFFER, so a rebuilt buffer
            # across WANT_* retries is fine). Cap well under the 1MB
            # plaintext budget: records are ~16KB anyway.
            budget = min(max_bytes, 256 << 10)
            first = next(iter(self._refs), None)
            if first is None:
                return 0
            v = first.view()[:budget]
            if len(v) < budget and len(self._refs) > 1:
                parts = [v]
                total = len(v)
                for ref in list(self._refs)[1:]:
                    w = ref.view()[: budget - total]
                    parts.append(w)
                    total += len(w)
                    if total >= budget:
                        break
                v = b"".join(parts)
            try:
                with self._ssl_io_lock(sock):
                    written = sock.send(v)
            except (_ssl.SSLWantReadError, _ssl.SSLWantWriteError) as e:
                raise BlockingIOError(str(e)) from e
            self.pop_front(written)
            return written
        iov = []
        total = 0
        for ref in self._refs:
            v = ref.view()
            if total + len(v) > max_bytes:
                v = v[: max_bytes - total]
            if len(v):
                iov.append(v)
                total += len(v)
            if total >= max_bytes or len(iov) >= 64:
                break
        if not iov:
            return 0
        written = sock.sendmsg(iov)
        self.pop_front(written)
        return written

    def append_from_socket(self, sock, max_bytes: int = DEFAULT_BLOCK_SIZE) -> int:
        """Non-blocking read into tail block space. Returns bytes read
        (0 = EOF), raises BlockingIOError on EAGAIN (including the TLS
        want-read/want-write signals — SSLError subclasses OSError, so
        without the translation they would read as hard failures)."""
        blk = self._writable_tail(max_bytes)
        space = min(blk.left_space, max_bytes)
        try:
            if isinstance(sock, _ssl.SSLSocket):
                with self._ssl_io_lock(sock):
                    nread = sock.recv_into(
                        memoryview(blk.data)[blk.size : blk.size + space]
                    )
            else:
                nread = sock.recv_into(
                    memoryview(blk.data)[blk.size : blk.size + space]
                )
        except (_ssl.SSLWantReadError, _ssl.SSLWantWriteError) as e:
            raise BlockingIOError(str(e)) from e
        if nread > 0:
            last = self._refs[-1] if self._refs else None
            if (
                isinstance(last, BlockRef)
                and last.block is blk
                and last.offset + last.length == blk.size
            ):
                last.length += nread
            else:
                self._refs.append(BlockRef(blk, blk.size, nread))
            blk.size += nread
            self._size += nread
        return nread

    # ---- dunder -----------------------------------------------------------
    def __eq__(self, other) -> bool:
        if isinstance(other, (bytes, bytearray)):
            return self._size == len(other) and self.to_bytes() == bytes(other)
        if isinstance(other, IOBuf):
            return self._size == other._size and self.to_bytes() == other.to_bytes()
        return NotImplemented

    def __repr__(self) -> str:
        head = self.copy_to(min(32, self._size))
        return f"IOBuf(size={self._size}, head={head!r})"


def _slice_ref(ref, offset: int, length: int):
    if isinstance(ref, BlockRef):
        return BlockRef(ref.block, ref.offset + offset, length)
    if isinstance(ref, UserRef):
        r = UserRef(ref.mv, ref.offset + offset, length)
        return r
    if isinstance(ref, DeviceRef):
        r = DeviceRef(ref.array, ref.offset + offset, length)
        r._host = ref._host
        if r.whole_array() is not None:
            # the transmit checksum describes the whole tensor: it
            # follows the tensor into every buffer that carries it whole
            r.csum = ref.csum
        return r
    raise TypeError(ref)


class IOBufCutter:
    """Fast sequential parser over an IOBuf (analog butil::IOBufCutter).

    Used by protocol parse callbacks to peek fixed headers and cut
    payloads without flattening the buffer.
    """

    def __init__(self, buf: IOBuf):
        self._buf = buf

    def remaining(self) -> int:
        return self._buf.size

    def peek(self, n: int) -> Optional[bytes]:
        return self._buf.fetch(n)

    def cut_bytes(self, n: int) -> Optional[bytes]:
        if self._buf.size < n:
            return None
        out = IOBuf()
        self._buf.cutn(out, n)
        return out.to_bytes()

    def cut_buf(self, n: int) -> Optional[IOBuf]:
        if self._buf.size < n:
            return None
        out = IOBuf()
        self._buf.cutn(out, n)
        return out
