"""Bulk payload movement on the device — the ICI engine's copy path.

Port of the JAX package's ``ops/transfer.py``.  The fabric "transmits"
a same-device payload by copying it and checksumming it in one pass
over device memory: the receiver gets a fresh buffer plus a
device-resident integrity value, and nothing syncs to the host.

The kernels are written by hand for Hopper in ``ops/csrc/transfer.cu``
(built by ``ops/_build.py``, bound with ctypes):

- K1 ``copy_csum_blocks`` — the whole-frame, carried chunk and
  donated-slot kernels (the JAX package's three grid kernels);
- K2 ``copy_csum_staged`` — the whole frame in one launch of persistent
  CTAs whose bulk-copy engine (TMA) rings 512-byte-wide tiles through
  shared memory while eight warps sum them (the JAX package's
  double-buffered DMA kernel, ``chunk_mode="pallas"``); its geometry is
  planned here, by :func:`staged_plan`;
- ``copy_blocks`` — the plain copy on the same engine, :func:`device_copy`
  (the JAX package's ``device_copy``; no path of either package calls
  it).

K1 and K2 fold the per-block column sums onto the carry in their own
tail (the last CTA to finish a column tile folds it; in K2 the last warp
to finish its slice of one), so each transmit is one launch.

Every wrapper dispatches on the tensor's device: a CPU tensor runs the
plain PyTorch version (:func:`copy_csum_plain`), a CUDA tensor launches
the kernel or raises, any other device raises.  The kernels count their
launches in :data:`launches`; the plain version is not counted.

Checksum contract: the lane accumulator is ``carry + Σ_b colsum(block_b)``
with the blocks of ``_fit_block_rows`` added in block order, and each
block's column summed in one fixed order (8 strided row groups, then
the groups in order).  Every mode (whole frame, chained chunks, slot,
staged) and the plain version perform the same f32 additions in the
same order, so they yield the same bits, on the card and on the CPU.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from incubator_brpc_tpu_torch.utils.segmentation import (
    MIN_CHUNKS,
    plan_row_chunks,
)

_LANE = 128

# dtype → code of the element type in transfer.cu's DISPATCH_DTYPE
_DTYPE_CODES = {
    torch.float32: 0,
    torch.float16: 1,
    torch.bfloat16: 2,
    torch.float64: 3,
    torch.uint8: 4,
    torch.int8: 5,
    torch.int16: 6,
    torch.int32: 7,
    torch.int64: 8,
}

_ROW_GROUPS = 8

# K2's and copy_blocks' bulk-copy rings (transfer.cu's constants of the
# same names): a column tile is _TILE_BYTES of a row whatever the dtype,
# moved as 8-byte words; a stage is at most _STAGE_BYTES of one tile;
# _STAGES stages, K2's two buffers of one item's group sums (_RED_BYTES)
# and two 8-byte mbarriers a stage fill a K2 CTA's shared memory, and
# _COPY_STAGES chunks of _COPY_CHUNK bytes and two mbarriers each a copy CTA's
# (_STAGED_SMEM, _COPY_SMEM, each with _SMEM_ALIGN of slack); the grids
# are so many persistent CTAs an SM.  The stages, their bytes and the CTAs
# an SM were chosen by timing variants on an H100 (chip_smoke.py --tune)
_TILE_BYTES = 512
_STAGE_BYTES = 32768
_STAGES = 6
_RED_BYTES = 2 * _ROW_GROUPS * _TILE_BYTES * 4
_SMEM_ALIGN = 1024
_STAGED_SMEM = _SMEM_ALIGN + _STAGES * _STAGE_BYTES + _RED_BYTES + 2 * _STAGES * 8
_COPY_STAGES = 12
_COPY_CHUNK = 16384
_COPY_SMEM = _SMEM_ALIGN + _COPY_STAGES * _COPY_CHUNK + 2 * _COPY_STAGES * 8
_SMEM_PER_SM = 232448  # what one CTA may opt into on an H100
_STAGED_CTAS_PER_SM = 1
_COPY_CTAS_PER_SM = 1

# K1's column tile (K1_TW in transfer.cu): one arrival counter per tile
_K1_TILE = 64

#: kernel name → launches on CUDA tensors since the last reset
launches: Dict[str, int] = {
    "copy_csum_blocks": 0,
    "copy_csum_staged": 0,
    "copy_blocks": 0,
}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def is_numeric(dtype: torch.dtype) -> bool:
    """The JAX package's ``jnp.issubdtype(dtype, jnp.number)``."""
    return dtype != torch.bool and not dtype.is_complex


def _fit_block_rows(m: int, cap: int = 256) -> int:
    """Largest grid-block row count ≤ cap that divides m — the ONE place
    the copy/checksum kernels derive their block layout, so every mode
    decomposes a payload into the SAME block sequence."""
    rows = min(cap, m)
    while m % rows:
        rows //= 2
    return max(rows, 1)


def lanes_view(arr: torch.Tensor) -> Optional[torch.Tensor]:
    """2D lane-aligned view of ``arr`` for the copy/checksum kernels, or
    None when no tiling fits (or the tensor is not contiguous).  The ONE
    place the lane decomposition is decided."""
    if not arr.is_contiguous():
        return None
    if arr.ndim == 2 and arr.shape[1] % _LANE == 0 and arr.shape[0] > 0:
        return arr
    total = arr.numel()
    if total <= 0 or total % _LANE:
        return None
    lanes = next(
        m for m in (4096, 2048, 1024, 512, 256, 128) if total % m == 0
    )
    return arr.reshape(total // lanes, lanes)


# ---------------------------------------------------------------------------
# the plain version (CPU path; the card's reference)
# ---------------------------------------------------------------------------


def copy_csum_plain(
    x: torch.Tensor,
    carry: Optional[torch.Tensor],
    block_rows: int,
    out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1 and K2: copy ``x`` (into ``out`` when
    given) and fold its per-block column sums onto ``carry`` ((1, n)
    f32, zeros when None) in block order.  Returns (copy, acc).

    It adds in the kernels' exact sequence, as vectorised float32 adds
    over all blocks and columns at once: in each block, row group g sums
    rows g, g+8, ... from 0.0 (a ragged group is padded with +0.0, which
    is exact: a sum that starts from +0.0 never becomes -0.0), then the
    first min(8, block_rows) group sums are added in group order, then
    the blocks in order onto the carry.  ``.float()`` rounds each element
    to nearest, as the kernels' conversion does."""
    m, n = x.shape
    g = _ROW_GROUPS
    nb = m // block_rows
    xf = x.float().reshape(nb, block_rows, n)
    pad = -block_rows % g
    if pad:
        xf = torch.cat([xf, xf.new_zeros((nb, pad, n))], dim=1)
    rows = xf.reshape(nb, -1, g, n)  # rows[:, k, j] is block row k * 8 + j
    group = torch.zeros((nb, g, n), dtype=torch.float32, device=x.device)
    for k in range(rows.shape[1]):
        group = group + rows[:, k]
    block = group[:, 0]
    for j in range(1, min(g, block_rows)):
        block = block + group[:, j]
    acc = (torch.zeros((1, n), dtype=torch.float32, device=x.device)
           if carry is None else carry.clone())
    for b in range(nb):
        acc = acc + block[b:b + 1]
    if out is None:
        out = x.clone()
    else:
        _check_operand(out, "out", x)
        out.copy_(x)
    return out, acc


# ---------------------------------------------------------------------------
# the Hopper kernels (ops/csrc/transfer.cu)
# ---------------------------------------------------------------------------

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_sm_counts: Dict[int, int] = {}
_counters_lock = threading.Lock()
_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a library built from transfer.cu."""
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.copy_csum_blocks.argtypes = [p, p, p, p, p, p, i64, i64, i32, i32, p]
    lib.copy_csum_blocks.restype = i32
    lib.copy_csum_staged.argtypes = [p, p, p, p, p, i64, i64, i32, i32, i32, i32, p]
    lib.copy_csum_staged.restype = i32
    lib.copy_blocks.argtypes = [p, p, i64, i32, p]
    lib.copy_blocks.restype = i32
    lib.transfer_error_string.argtypes = [i32]
    lib.transfer_error_string.restype = ctypes.c_char_p
    return lib


def _kernels() -> ctypes.CDLL:
    """transfer.cu's library, built on first use, with its signatures."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                from incubator_brpc_tpu_torch.ops import _build

                _lib = bind(_build.load("transfer"))
    return _lib


def _check_rc(lib: ctypes.CDLL, rc: int, name: str) -> None:
    if rc != 0:
        text = lib.transfer_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({text})")


def _check_operand(t: torch.Tensor, what: str, like: torch.Tensor) -> None:
    if t.device != like.device:
        raise ValueError(f"{what} on {t.device}, payload on {like.device}")
    if t.dtype != like.dtype or t.shape != like.shape:
        raise ValueError(
            f"{what} is {t.dtype}{tuple(t.shape)}, payload is "
            f"{like.dtype}{tuple(like.shape)}"
        )
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what} must be contiguous and 16-byte aligned")


def _check_payload(x: torch.Tensor, block_rows: int) -> int:
    """Validate a kernel payload; returns its dtype code."""
    if x.device.type != "cuda":
        raise ValueError(f"kernel payload must be on CUDA, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"copy+checksum kernels do not take {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"payload must be 2D, got shape {tuple(x.shape)}")
    m, n = x.shape
    if m <= 0 or n <= 0 or n % _LANE:
        raise ValueError(f"payload shape {(m, n)} does not lane-tile")
    if block_rows <= 0 or m % block_rows:
        raise ValueError(f"block_rows={block_rows} does not divide m={m}")
    if (m // block_rows) * (n // _LANE) >= 2**31:
        raise ValueError(f"payload shape {(m, n)} exceeds one launch grid")
    _check_operand(x, "payload", x)
    return _DTYPE_CODES[x.dtype]


def _check_lanes(t: torch.Tensor, what: str, like: torch.Tensor) -> None:
    """``t`` must be a contiguous (1, n) float32 lane vector beside ``like``."""
    n = like.shape[1]
    if (t.dtype != torch.float32 or t.numel() != n or t.device != like.device
            or not t.is_contiguous()):
        raise ValueError(
            f"{what} must be a contiguous (1, {n}) float32 tensor on {like.device}"
        )


def _sm_count(device: torch.device) -> int:
    idx = device.index
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            device
        ).multi_processor_count
    return _sm_counts[idx]


def _arrival_counters(device: torch.device, stream: int,
                      ntiles: int) -> torch.Tensor:
    """The fold tails' per-column-tile arrival counters for launches on
    ``stream`` of ``device``: int32, zeroed when allocated, and left at 0
    by every launch (a tile's last CTA resets its counter).  Launches on
    one stream run in order, so they may share the buffer; a stream of
    its own keeps two concurrent streams apart.  Grown (anew, zeroed, on
    the current stream) under a lock to the largest ``ntiles`` asked."""
    key = (device.index, stream)
    with _counters_lock:
        buf = _counters.get(key)
        if buf is None or buf.numel() < ntiles:
            buf = _counters[key] = torch.zeros(
                ntiles, dtype=torch.int32, device=device
            )
        return buf


def _launch_copy_csum_blocks(x, out, carry: Optional[torch.Tensor],
                             acc: torch.Tensor, block_rows: int) -> None:
    """K1 on the current stream: copy x → out and write acc = carry
    (zeros when None) + the per-block column sums in block order, the
    fold being the kernel's tail."""
    code = _check_payload(x, block_rows)
    _check_operand(out, "out", x)
    if carry is not None:
        _check_lanes(carry, "carry", x)
    _check_lanes(acc, "acc", x)
    lib = _kernels()
    m, n = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        partial = torch.empty(
            (m // block_rows, n), dtype=torch.float32, device=x.device
        )
        counters = _arrival_counters(x.device, stream, n // _K1_TILE)
        rc = lib.copy_csum_blocks(
            x.data_ptr(), out.data_ptr(), partial.data_ptr(),
            carry.data_ptr() if carry is not None else None, acc.data_ptr(),
            counters.data_ptr(), m, n, block_rows, code, stream,
        )
    _check_rc(lib, rc, "copy_csum_blocks")
    launches["copy_csum_blocks"] += 1


def _launch_copy_csum_staged(x, out, acc: torch.Tensor, block_rows: int,
                             stage_rows: int) -> None:
    """K2 on the current stream: the same outputs as K1 from a zero
    carry, from ONE launch of persistent CTAs."""
    code = _check_payload(x, block_rows)
    _check_operand(out, "out", x)
    _check_lanes(acc, "acc", x)
    plan = staged_plan(x, block_rows)
    _check_stage_rows(block_rows, stage_rows)
    lib = _kernels()
    m, n = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        partial = torch.empty(
            (m // block_rows, n), dtype=torch.float32, device=x.device
        )
        counters = _arrival_counters(
            x.device, stream, plan.ntiles * _ROW_GROUPS
        )
        rc = lib.copy_csum_staged(
            x.data_ptr(), out.data_ptr(), partial.data_ptr(), acc.data_ptr(),
            counters.data_ptr(), m, n, block_rows, stage_rows, code,
            plan.grid(_sm_count(x.device)), stream,
        )
    _check_rc(lib, rc, "copy_csum_staged")
    launches["copy_csum_staged"] += 1


def _copy_csum(x, carry, block_rows: int, out=None):
    """K1 on CUDA, the plain version on the CPU.  Returns (copy, acc)."""
    if x.device.type == "cpu":
        return copy_csum_plain(x, carry, block_rows, out)
    if x.device.type != "cuda":
        raise ValueError(f"no copy+checksum kernel for device {x.device}")
    if out is None:
        out = torch.empty_like(x)
    acc = torch.empty((1, x.shape[1]), dtype=torch.float32, device=x.device)
    _launch_copy_csum_blocks(x, out, carry, acc, block_rows)
    return out, acc


def _launch_copy_blocks(x: torch.Tensor, out: torch.Tensor) -> None:
    """copy_blocks on the current stream: out = x, byte for byte, by at
    most _COPY_CTAS_PER_SM persistent CTAs an SM."""
    _check_operand(x, "payload", x)
    _check_operand(out, "out", x)
    lib = _kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.copy_blocks(
            x.data_ptr(), out.data_ptr(), x.nbytes,
            _COPY_CTAS_PER_SM * _sm_count(x.device), stream,
        )
    _check_rc(lib, rc, "copy_blocks")
    launches["copy_blocks"] += 1


# ---------------------------------------------------------------------------
# entry points (same names and contracts as the JAX package's)
# ---------------------------------------------------------------------------


def device_copy_plain(x: torch.Tensor,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of ``copy_blocks``: a fresh copy of ``x``,
    or ``x`` copied into ``out``."""
    if out is None:
        return torch.empty_like(x).copy_(x)
    _check_operand(out, "out", x)
    return out.copy_(x)


def device_copy(x: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Device-to-device copy of a 2D ``(m, n)`` tensor of any dtype, n a
    multiple of 128 — the JAX package's ``device_copy``, into a fresh
    tensor or ``out``.  That one's ``chunk_rows`` only paced the TPU's
    VMEM pipeline and changed no byte of the output, so it has no
    counterpart here."""
    if x.ndim != 2 or x.shape[0] <= 0 or x.shape[1] % _LANE:
        raise ValueError(
            f"device_copy takes a 2D (m, n) tensor with n % {_LANE} == 0, "
            f"got shape {tuple(x.shape)}"
        )
    if x.device.type == "cpu":
        return device_copy_plain(x, out)
    if x.device.type != "cuda":
        raise ValueError(f"no copy kernel for device {x.device}")
    if out is None:
        out = torch.empty_like(x)
    _launch_copy_blocks(x, out)
    return out


def device_copy_with_checksum(x: torch.Tensor, chunk_rows: int = 256):
    """Fused transmit-and-verify of a 2D lane-aligned payload: one pass
    over device memory copies it and produces the lane checksum.
    Returns (copy, csum) with csum a device-resident f32 scalar."""
    m, _ = x.shape
    out, acc = _copy_csum(x, None, _fit_block_rows(m, chunk_rows))
    return out, fold_checksum(acc)


def device_copy_with_checksum_chunk(x: torch.Tensor, carry: torch.Tensor,
                                    block_rows: int):
    """One chunk of a chunked transmit: copy ``x`` and fold its lane
    sums onto ``carry`` ((1, n) f32).  Returns (copy, new_carry); finish
    a frame with ``fold_checksum(new_carry)``."""
    return _copy_csum(x, carry, block_rows)


def device_copy_with_checksum_chunk_into(x: torch.Tensor, carry: torch.Tensor,
                                         slot: torch.Tensor, block_rows: int):
    """``device_copy_with_checksum_chunk`` writing into ``slot`` (same
    shape and dtype as ``x``) — the StagingRing's allocation-free path
    (the JAX package donates the slot; here the kernel writes into it).
    Returns (slot, new_carry)."""
    return _copy_csum(x, carry, block_rows, out=slot)


def fold_checksum(carry: torch.Tensor) -> torch.Tensor:
    """Fold a (1, n) lane accumulator to the frame's checksum scalar."""
    return torch.sum(carry)


def chunk_plan_for(arr: torch.Tensor, chunk_bytes: int):
    """(lane_view, block_rows, chunks) the chunked transmit paths use for
    ``arr`` — fused, pipelined, pallas and the chaos walk all consume
    THIS plan.  Returns (None, 0, None) when the tensor doesn't tile."""
    v = lanes_view(arr)
    if v is None:
        return None, 0, None
    m, n = v.shape
    block_rows = _fit_block_rows(m)
    chunks = plan_row_chunks(m, n * v.element_size(), chunk_bytes, block_rows)
    return v, block_rows, chunks


def _chunked_copy_csum(x: torch.Tensor, chunks, block_rows: int):
    """Fused chunked transmit.  The chunks are consecutive row ranges of
    one frame, aligned to its blocks, so ONE K1 launch over the frame
    runs them all: the JAX package's fused program is likewise one
    dispatch per hop, and on the card one launch of 64 MB takes less
    device time than eight of 8 MB (PERF.md).  The checksum is the
    chained chunks' bit for bit (same blocks, same order).  So on the
    card this is the whole-frame transmit of ``chunk_mode="off"``: the
    same single K1 launch.  The chunk plan is only checked here; what
    the fused mode adds is the fabric's pre-dispatch chaos walk over
    it.  Returns (copy, csum)."""
    if chunks[0][0] != 0 or sum(rows for _, rows in chunks) != x.shape[0]:
        raise ValueError(f"chunk plan {chunks} does not cover {x.shape[0]} rows")
    out, acc = _copy_csum(x, None, block_rows)
    return out, fold_checksum(acc)


def device_copy_with_checksum_chunked(x: torch.Tensor,
                                      chunk_bytes: int = 8 << 20):
    """Chunked copy+checksum over a lane-tileable tensor: ~chunk_bytes
    row chunks aligned to the block layout; the checksum equals
    ``device_copy_with_checksum(x)[1]`` bit for bit."""
    v, block_rows, chunks = chunk_plan_for(x, chunk_bytes)
    if v is None:
        raise ValueError(f"tensor of shape {tuple(x.shape)} does not lane-tile")
    out, csum = _chunked_copy_csum(v, chunks, block_rows)
    return (out if v is x else out.reshape(x.shape)), csum


# ---------------------------------------------------------------------------
# the staged whole-frame transmit (chunk_mode="pallas")
# ---------------------------------------------------------------------------


class StagedPlan(NamedTuple):
    """K2's geometry for one lane view: ``tile_cols`` columns a tile
    (``_TILE_BYTES`` of a row), ``ntiles`` tiles across a row (the last
    one clipped when the row is not a whole number of tiles),
    ``stage_rows`` rows a shared-memory stage and ``items`` (row block,
    tile) work items."""

    tile_cols: int
    ntiles: int
    stage_rows: int
    items: int

    def grid(self, sms: int) -> int:
        """Persistent CTAs of one launch on a card of ``sms`` SMs."""
        return min(self.items, _STAGED_CTAS_PER_SM * sms)


def staged_plan(v: torch.Tensor, block_rows: int) -> StagedPlan:
    """K2's tiles, stages and work items for lane view ``v`` with blocks
    of ``block_rows`` rows: the ONE place they are decided (transfer.cu
    checks what it is given).  A tile is ``_TILE_BYTES`` of a row, so
    every dtype moves the same bytes a stage; a stage holds whole row
    groups of one tile, as many as ``_STAGE_BYTES`` takes and no more than
    the block needs, or the whole block when it has fewer than 8 rows.
    Raises ValueError where the bulk-copy engine cannot describe ``v``:
    a base that is not 16-byte aligned (a view at an odd offset)."""
    m, n = v.shape
    if v.data_ptr() % 16:
        raise ValueError(
            f"payload base {v.data_ptr():#x} is not 16-byte aligned: the "
            f"bulk-copy engine cannot describe it"
        )
    tile_cols = _TILE_BYTES // v.element_size()
    ntiles = -(-n // tile_cols)
    if block_rows < _ROW_GROUPS:
        stage_rows = block_rows
    else:
        stage_rows = min(_STAGE_BYTES // _TILE_BYTES,
                         -(-block_rows // _ROW_GROUPS) * _ROW_GROUPS)
    items = (m // block_rows) * ntiles
    if items >= 2**31:
        raise ValueError(f"payload shape {(m, n)} exceeds one launch's items")
    return StagedPlan(tile_cols, ntiles, stage_rows, items)


def _check_stage_rows(block_rows: int, stage_rows: int) -> None:
    """``stage_rows`` must be whole row groups (or the whole block of
    fewer than 8 rows) that fit one stage."""
    whole = stage_rows % _ROW_GROUPS == 0 or (
        stage_rows == block_rows < _ROW_GROUPS
    )
    if not (0 < stage_rows and whole
            and stage_rows * _TILE_BYTES <= _STAGE_BYTES):
        raise ValueError(
            f"stage_rows={stage_rows} is not whole row groups of a "
            f"{_STAGE_BYTES}-byte stage for block_rows={block_rows}"
        )


def _staged_copy_csum(x, block_rows: int, stage_rows: int, out=None):
    """K2 on CUDA, the plain version on the CPU, each after the staging's
    checks (so an unaligned view or a bad stage is refused on both).
    Returns (copy, acc)."""
    if x.device.type == "cpu":
        staged_plan(x, block_rows)
        _check_stage_rows(block_rows, stage_rows)
        return copy_csum_plain(x, None, block_rows, out)
    if x.device.type != "cuda":
        raise ValueError(f"no copy+checksum kernel for device {x.device}")
    if out is None:
        out = torch.empty_like(x)
    acc = torch.empty((1, x.shape[1]), dtype=torch.float32, device=x.device)
    _launch_copy_csum_staged(x, out, acc, block_rows, stage_rows)
    return out, acc


def device_copy_with_checksum_dma(x: torch.Tensor, block_rows: int,
                                  stage_rows: int):
    """Whole-frame transmit as ONE staged kernel launch (K2, its fold
    in its tail); the checksum is bit-identical to
    :func:`device_copy_with_checksum`'s on the same device."""
    out, acc = _staged_copy_csum(x, block_rows, stage_rows)
    return out, fold_checksum(acc)


def device_copy_with_checksum_dma_into(x: torch.Tensor, slot: torch.Tensor,
                                       block_rows: int, stage_rows: int):
    """:func:`device_copy_with_checksum_dma` writing into a frame-shaped
    ``slot`` (a StagingRing buffer): a ring hit makes the whole-frame
    transmit allocation-free."""
    out, acc = _staged_copy_csum(x, block_rows, stage_rows, out=slot)
    return out, fold_checksum(acc)


def device_copy_with_checksum_pallas(x: torch.Tensor,
                                     chunk_bytes: int = 8 << 20,
                                     plan=None, slot=None):
    """Frame-level entry for the staged transmit: plans the layout
    (``chunk_plan_for``), sizes the stages, and issues ONE K2 launch.
    ``slot`` is an optional frame-shaped output buffer.  Returns
    (copy, csum); raises ValueError for tensors that don't lane-tile."""
    v, block_rows, _ = plan if plan is not None else chunk_plan_for(
        x, chunk_bytes
    )
    if v is None:
        raise ValueError(f"tensor of shape {tuple(x.shape)} does not lane-tile")
    stage_rows = staged_plan(v, block_rows).stage_rows
    if slot is not None:
        out, csum = device_copy_with_checksum_dma_into(
            v, slot, block_rows, stage_rows
        )
    else:
        out, csum = device_copy_with_checksum_dma(v, block_rows, stage_rows)
    return (out if v is x else out.reshape(x.shape)), csum


# ---------------------------------------------------------------------------
# per-segment transmit (what the fabric calls)
# ---------------------------------------------------------------------------


def transmit_array_chunked(arr: torch.Tensor, chunk_bytes: int = 8 << 20,
                           plan=None):
    """Chunked flavor of :func:`transmit_array` — the fabric's
    large-frame path.  Frames big enough for ≥2 chunks run the fused
    chunked copy+checksum; everything else goes to transmit_array.
    ``plan`` is an optional precomputed ``chunk_plan_for`` result."""
    if is_numeric(arr.dtype) and int(arr.nbytes) >= MIN_CHUNKS * chunk_bytes:
        v, block_rows, chunks = (
            plan if plan is not None else chunk_plan_for(arr, chunk_bytes)
        )
        if v is not None:
            out, csum = _chunked_copy_csum(v, chunks, block_rows)
            return (out if v is arr else out.reshape(arr.shape)), csum
    return transmit_array(arr)


def _xla_copy(x: torch.Tensor) -> torch.Tensor:
    """The copy for what the kernels do not tile: non-numeric dtypes
    and sizes that are not a multiple of 128 elements."""
    return x.clone()


def transmit_array(arr: torch.Tensor):
    """One ICI "transmission" of a device payload: the copy+checksum
    kernel when the tensor tiles onto 128 lanes, a plain copy otherwise.
    Returns ``(new_tensor, checksum_or_None)``; nothing syncs to host."""
    if is_numeric(arr.dtype) and arr.is_contiguous():
        if arr.ndim == 2 and arr.shape[1] % _LANE == 0 and arr.shape[0] > 0:
            return device_copy_with_checksum(arr)
        total = arr.numel()
        if total > 0 and total % _LANE == 0:
            return _transmit_reshaped(arr)
    return _xla_copy(arr), None


def _transmit_reshaped(x: torch.Tensor):
    out, csum = device_copy_with_checksum(lanes_view(x))
    return out.reshape(x.shape), csum
