"""One chunk-segmentation policy for every bulk data path.

The ICI fabric (same-chip Pallas transmit, parallel/ici.py), the DCN
bridge wire encoder (parallel/dcn.py) and the kernel-socket write loop
(transport/socket.py) all move large payloads in bounded chunks; before
this module each carried its own ad-hoc constant and slicer.  The
reference's RDMA endpoint segments its send queue the same single way
for every transport (rdma_endpoint.h:83-137 sq window entries), which
is what makes its credit accounting composable — so the chunk PLANNER
lives here, and the transports only decide what to do per chunk.

Three knobs, one per layer:

- ``WIRE_CHUNK_BYTES``   — host-byte wire chunks (DCN bridge streaming;
  also the kernel-socket per-iteration write cap).  ~4MB: large enough
  to amortize per-chunk syscall/staging cost, small enough that the
  send window (a handful of chunks) bounds memory and a mid-stream
  fault loses little.
- ``DEVICE_CHUNK_BYTES`` — device-payload chunks for the chunked
  copy+checksum transmit (ops/transfer.py): the unit the pipelined ICI
  send double-buffers.  ~8MB: a 64MB frame becomes 8 chunks, enough
  overlap stages to hide per-chunk launch/staging latency without
  shrinking each Pallas grid below its efficient size.
- ``MIN_CHUNKS`` — frames smaller than this many chunks skip chunking
  entirely (whole-frame path): pipelining needs at least two stages in
  flight to overlap anything.

The Pallas DMA transmit (``chunk_mode="pallas"``) adds one on-chip
knob: its double-buffered VMEM staging slots are sized here too
(``PALLAS_STAGE_BYTES``/``fit_stage_rows``), so the kernel's DMA stage
plan is a pure function of the SAME row/block decomposition the fused
and pipelined modes chunk by — one planner, three transports.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Tuple

WIRE_CHUNK_BYTES = 4 << 20
DEVICE_CHUNK_BYTES = 8 << 20
MIN_CHUNKS = 2

# Pallas DMA transmit staging (ops/transfer.py device_copy_with_
# checksum_dma): each VMEM staging slot holds up to this many bytes and
# PALLAS_DB_DEPTH slots double-buffer each direction (in + out), so the
# kernel's resident VMEM footprint is ≤ 2 * depth * PALLAS_STAGE_BYTES
# — comfortably inside the ~16MB VMEM the pipelined grids already
# assume, while keeping individual DMAs ≥~2MB (large enough that the
# HBM controller runs at line rate instead of descriptor rate).
PALLAS_STAGE_BYTES = 2 << 20
PALLAS_DB_DEPTH = 2


def fit_stage_rows(rows: int, row_bytes: int, align_rows: int,
                   budget_bytes: int = PALLAS_STAGE_BYTES) -> int:
    """Rows per DMA stage for the Pallas double-buffered transmit.

    The stage is a multiple of ``align_rows`` (the checksum kernel's
    block rows — compute granularity can never straddle a stage) that
    DIVIDES ``rows`` (every stage identical, so the kernel's DMA loop
    has static sizes) and fits ``budget_bytes``.  Falls back to one
    block per stage when nothing larger fits — correctness never
    depends on the budget, only DMA efficiency does."""
    if align_rows <= 0 or rows % align_rows:
        raise ValueError(
            f"rows={rows} not a multiple of align_rows={align_rows}"
        )
    nblocks = rows // align_rows
    k = max(1, budget_bytes // max(1, align_rows * row_bytes))
    k = min(k, nblocks)
    while nblocks % k:
        k -= 1
    return k * align_rows


def plan_chunks(total: int, chunk_bytes: int = WIRE_CHUNK_BYTES) -> List[Tuple[int, int]]:
    """(offset, length) chunk windows covering ``total`` bytes in order.
    The tail chunk may be as small as 1 byte; every other chunk is
    exactly ``chunk_bytes``.  Empty payloads plan zero chunks."""
    if chunk_bytes <= 0:
        raise ValueError(f"chunk_bytes must be positive, got {chunk_bytes}")
    return [
        (off, min(chunk_bytes, total - off))
        for off in range(0, total, chunk_bytes)
    ]


def plan_row_chunks(
    rows: int, row_bytes: int, chunk_bytes: int, align_rows: int = 1
) -> List[Tuple[int, int]]:
    """(row_offset, row_count) chunks for a 2D device payload.

    Chunk boundaries are aligned to ``align_rows`` (the Pallas grid's
    block rows) so a chunked copy+checksum decomposes into the SAME
    block sequence as the whole-frame kernel — the property that makes
    the chained chunk checksum bit-identical to the whole-frame one
    (ops/transfer.device_copy_with_checksum_chunked).  ``rows`` must be
    a multiple of ``align_rows`` (the caller derives align_rows as a
    divisor of rows)."""
    if align_rows <= 0 or rows % align_rows:
        raise ValueError(f"rows={rows} not a multiple of align_rows={align_rows}")
    rows_per = max(1, chunk_bytes // max(1, row_bytes))
    rows_per = max(align_rows, (rows_per // align_rows) * align_rows)
    return [
        (off, min(rows_per, rows - off))
        for off in range(0, rows, rows_per)
    ]


def chunk_buffer(buf, chunk_bytes: int = WIRE_CHUNK_BYTES) -> Iterator[memoryview]:
    """Slice one contiguous buffer into ≤chunk_bytes memoryviews
    (zero-copy)."""
    mv = memoryview(buf)
    for i in range(0, len(mv), chunk_bytes):
        yield mv[i : i + chunk_bytes]


def chunk_views(
    views: Iterable[memoryview], chunk_bytes: int = WIRE_CHUNK_BYTES
) -> Iterator:
    """Emit ~chunk_bytes wire chunks from a list of memoryviews.

    Large views (user/device byte windows) slice zero-copy; runs of
    small views (8KB block refs from IOBuf.append) coalesce via join —
    copying only sub-chunk refs keeps big-payload staging copy-free
    while avoiding one sendall (and, under TLS, one record) per tiny
    ref.  Chunk sizes are approximate: a pending small-ref batch
    flushes early rather than ever swallowing the head of a large
    view."""
    batch, size = [], 0
    for mv in views:
        if len(mv) >= chunk_bytes and batch:
            yield batch[0] if len(batch) == 1 else b"".join(batch)
            batch, size = [], 0
        while len(mv):
            take = mv[: chunk_bytes - size]
            batch.append(take)
            size += len(take)
            mv = mv[len(take):]
            if size >= chunk_bytes:
                yield batch[0] if len(batch) == 1 else b"".join(batch)
                batch, size = [], 0
    if batch:
        yield batch[0] if len(batch) == 1 else b"".join(batch)
