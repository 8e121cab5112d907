"""Bulk payload movement on the device — the ICI engine's copy path.

Port of the JAX package's ``ops/transfer.py``.  The fabric "transmits"
a same-device payload by copying it and checksumming it in one pass
over device memory: the receiver gets a fresh buffer plus a
device-resident integrity value, and nothing syncs to the host.

The kernels are written by hand for Hopper in ``ops/csrc/transfer.cu``
(built by ``ops/_build.py``, bound with ctypes):

- K1 ``copy_csum_blocks`` + ``fold_blocks`` — the whole-frame, carried
  chunk and donated-slot kernels (the JAX package's three grid kernels);
- K2 ``copy_csum_staged`` + ``fold_blocks`` — the whole frame in one
  launch of persistent CTAs staging tiles through shared memory (the
  JAX package's double-buffered DMA kernel, ``chunk_mode="pallas"``).

Every wrapper dispatches on the tensor's device: a CPU tensor runs the
plain PyTorch version (:func:`copy_csum_plain`), a CUDA tensor launches
the kernel or raises, any other device raises.  The kernels count their
launches in :data:`launches`; the plain version is not counted.

Checksum contract: the lane accumulator is ``carry + Σ_b colsum(block_b)``
with the blocks of ``_fit_block_rows`` added in block order, so every
mode (whole frame, chained chunks, slot, staged) performs the same f32
additions in the same order and yields the same bits as every other
mode on the same device.  Inside a block the kernels sum in their own
fixed order and the plain version in torch's, so card and CPU agree
within f32 rounding, not bit for bit.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

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

# K2's shared-memory stage: at most this many bytes of one 128-column tile
# (STAGE_BYTES in transfer.cu), a multiple of its 8 row groups
_STAGE_BYTES = 32768
_ROW_GROUPS = 8

#: kernel name → launches on CUDA tensors since the last reset
launches: Dict[str, int] = {
    "copy_csum_blocks": 0,
    "fold_blocks": 0,
    "copy_csum_staged": 0,
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
    f32, zeros when None) in block order.  Returns (copy, acc)."""
    m, n = x.shape
    if carry is None:
        acc = torch.zeros((1, n), dtype=torch.float32, device=x.device)
    else:
        acc = carry.clone()
    for off in range(0, m, block_rows):
        acc = acc + x[off:off + block_rows].float().sum(0, keepdim=True)
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


def _kernels() -> ctypes.CDLL:
    """transfer.cu's library, built on first use, with its signatures."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                from incubator_brpc_tpu_torch.ops import _build

                lib = _build.load("transfer")
                p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
                lib.copy_csum_blocks.argtypes = [p, p, p, i64, i64, i32, i32, p]
                lib.copy_csum_blocks.restype = i32
                lib.fold_blocks.argtypes = [p, p, p, i64, i64, p]
                lib.fold_blocks.restype = i32
                lib.copy_csum_staged.argtypes = [
                    p, p, p, i64, i64, i32, i32, i32, i32, p,
                ]
                lib.copy_csum_staged.restype = i32
                lib.transfer_error_string.argtypes = [i32]
                lib.transfer_error_string.restype = ctypes.c_char_p
                _lib = lib
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


def _launch_copy_csum_blocks(x, out, partial, block_rows: int) -> None:
    """K1 pass 1 on the current stream: copy x → out, per-block column
    sums → partial ((m / block_rows, n) f32)."""
    code = _check_payload(x, block_rows)
    _check_operand(out, "out", x)
    lib = _kernels()
    m, n = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.copy_csum_blocks(
            x.data_ptr(), out.data_ptr(), partial.data_ptr(),
            m, n, block_rows, code, stream,
        )
    _check_rc(lib, rc, "copy_csum_blocks")
    launches["copy_csum_blocks"] += 1


def _launch_copy_csum_staged(x, out, partial, block_rows: int,
                             stage_rows: int) -> None:
    """K2 on the current stream: the same outputs as K1 pass 1 from ONE
    launch of persistent CTAs."""
    code = _check_payload(x, block_rows)
    _check_operand(out, "out", x)
    lib = _kernels()
    m, n = x.shape
    idx = x.device.index
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            x.device
        ).multi_processor_count
    items = (m // block_rows) * (n // _LANE)
    grid = min(items, 2 * _sm_counts[idx])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.copy_csum_staged(
            x.data_ptr(), out.data_ptr(), partial.data_ptr(),
            m, n, block_rows, stage_rows, code, grid, stream,
        )
    _check_rc(lib, rc, "copy_csum_staged")
    launches["copy_csum_staged"] += 1


def _launch_fold_blocks(partial, carry: Optional[torch.Tensor]) -> torch.Tensor:
    """Pass 2 on the current stream: acc = carry (zeros when None) plus
    partial's rows in order.  Returns acc, (1, n) f32."""
    nblocks, n = partial.shape
    acc = torch.empty((1, n), dtype=torch.float32, device=partial.device)
    if carry is not None:
        if (carry.dtype != torch.float32 or carry.numel() != n
                or carry.device != partial.device
                or not carry.is_contiguous()):
            raise ValueError(
                f"carry must be a contiguous (1, {n}) float32 tensor on "
                f"{partial.device}"
            )
    lib = _kernels()
    with torch.cuda.device(partial.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fold_blocks(
            partial.data_ptr(),
            carry.data_ptr() if carry is not None else None,
            acc.data_ptr(), nblocks, n, stream,
        )
    _check_rc(lib, rc, "fold_blocks")
    launches["fold_blocks"] += 1
    return acc


def _partial_for(x: torch.Tensor, block_rows: int) -> torch.Tensor:
    m, n = x.shape
    return torch.empty(
        (m // block_rows, n), dtype=torch.float32, device=x.device
    )


def _copy_csum(x, carry, block_rows: int, out=None):
    """K1 (both passes) on CUDA, the plain version on the CPU.
    Returns (copy, acc)."""
    if x.device.type == "cpu":
        return copy_csum_plain(x, carry, block_rows, out)
    if x.device.type != "cuda":
        raise ValueError(f"no copy+checksum kernel for device {x.device}")
    if out is None:
        out = torch.empty_like(x)
    partial = _partial_for(x, block_rows)
    _launch_copy_csum_blocks(x, out, partial, block_rows)
    return out, _launch_fold_blocks(partial, carry)


# ---------------------------------------------------------------------------
# entry points (same names and contracts as the JAX package's)
# ---------------------------------------------------------------------------


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
    dispatch per hop, and on the card one launch keeps every SM busy
    where an 8 MB chunk alone fills 64 CTAs.  The checksum is the
    chained chunks' bit for bit (same blocks, same order).  So on the
    card this is the whole-frame transmit of ``chunk_mode="off"``: the
    same single K1 launch and fold.  The chunk plan is only checked
    here; what the fused mode adds is the fabric's pre-dispatch chaos
    walk over it.  Returns (copy, csum)."""
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


def pallas_stage_rows(v: torch.Tensor, block_rows: int) -> int:
    """Rows of one K2 shared-memory stage for lane view ``v``: as many
    rows of a 128-column tile as fit the stage, a multiple of the 8 row
    groups, and no more than a block needs."""
    fit = _STAGE_BYTES // (_LANE * v.element_size())
    need = -(-block_rows // _ROW_GROUPS) * _ROW_GROUPS
    return min(fit, need)


def _staged_copy_csum(x, block_rows: int, stage_rows: int, out=None):
    """K2 + the fold on CUDA, the plain version on the CPU.
    Returns (copy, acc)."""
    if x.device.type == "cpu":
        return copy_csum_plain(x, None, block_rows, out)
    if x.device.type != "cuda":
        raise ValueError(f"no copy+checksum kernel for device {x.device}")
    if out is None:
        out = torch.empty_like(x)
    partial = _partial_for(x, block_rows)
    _launch_copy_csum_staged(x, out, partial, block_rows, stage_rows)
    return out, _launch_fold_blocks(partial, None)


def device_copy_with_checksum_dma(x: torch.Tensor, block_rows: int,
                                  stage_rows: int):
    """Whole-frame transmit as ONE staged kernel launch (K2, then the
    fold); the checksum is bit-identical to
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
    stage_rows = pallas_stage_rows(v, block_rows)
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
