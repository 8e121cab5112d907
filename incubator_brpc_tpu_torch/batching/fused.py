"""Padded-stack device fusion for batch handlers.

Port of the JAX package's ``batching/fused.py``.  ``fused_stack_rows``
turns N same-shape device rows into ONE stacked device tensor: stack
along a new leading axis, pad the batch dim up to the policy bucket,
hand each row its slice back.  Device payloads never detour through
host bytes — the inputs are the tensors the IOBuf ``DeviceRef``
segments already hold.

Padding rows come from the caller's freelist (the Batcher's per-method
StagingRing): steady state pads with recycled buffers instead of
allocating, and every pad returns to the ring right after the stack
copies it.  Pad VALUES are never read (their output rows are
discarded), so recycled contents are fine.

There is no ``jax.jit`` here: kernels run eagerly, with no
``torch.compile`` (the batch kernels are one op each; compiling per
bucket would put seconds of compile time inside serving).  What JAX
counts as a trace — one per new input specialization — the port counts
once per first-seen argument signature, each argument's (shape, dtype,
device).  Padding to buckets keeps that count at the bucket count, and
``trace_count()`` exposes the running total so tests can assert the
bound exactly as they do against the JAX package.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

import torch

from incubator_brpc_tpu_torch.observability.profiling import kernel_section

_trace_count = [0]
_stack_seen: set = set()
# guards the first-seen signature sets (the stack's and every
# FusedKernel's): two racing first calls of one shape must count one
# trace, or the retraces <= buckets bound would break
_init_lock = threading.Lock()


def trace_count() -> int:
    """Total traces of fused kernels so far (monotonic; tests diff it
    around a workload to assert padding bounds retraces).  Shared by the
    stack below and every ``FusedKernel``."""
    return _trace_count[0]


def promoted_matmul(w, x):
    """``x @ w``, promoting mixed operand types as ``jnp`` does
    (``torch.matmul`` refuses them): the batched product of the PS and
    of each chip of the sharded kernel."""
    if x.dtype != w.dtype:
        t = torch.promote_types(x.dtype, w.dtype)
        return x.to(t) @ w.to(t)
    return x @ w


def _signature(args) -> tuple:
    """What a JAX trace specializes on: each argument's shape, dtype
    and device."""
    return tuple(
        (tuple(getattr(a, "shape", ())), str(getattr(a, "dtype", type(a).__name__)),
         str(getattr(a, "device", "")))
        for a in args
    )


def _first_seen(seen: set, sig) -> bool:
    """Record ``sig`` in ``seen``; True when it was new (one trace)."""
    if sig in seen:
        return False
    with _init_lock:
        if sig in seen:
            return False
        seen.add(sig)
        _trace_count[0] += 1
        return True


class FusedKernel:
    """A user batch kernel with the module's shared trace counter, so
    padding-bucket retrace bounds are assertable for custom fused ops
    exactly like for the built-in stack.

        _FWD = FusedKernel(lambda w, x: x @ w)
        y = _FWD(W, X_padded)   # ONE device execution per call;
                                # a "trace" only per new padded shape

    ``label``/``batch_buckets`` opt the kernel into the retrace counter
    (analysis/device_witness.py): each trace is attributed to a shape
    *family* — argument shapes/dtypes with the batch arg's (last
    positional, by fused convention) leading dim wildcarded — and a
    family tracing more than ``len(batch_buckets)`` times contradicts
    the padding bound.
    """

    __slots__ = ("_fn", "label", "batch_buckets", "_traces", "_seen",
                 "_families", "_section")

    def __init__(self, fn: Callable, label: Optional[str] = None,
                 batch_buckets=None):
        self._fn = fn
        self.label = label or getattr(fn, "__name__", "fused")
        self.batch_buckets = (
            tuple(batch_buckets) if batch_buckets is not None else None
        )
        self._traces = [0]
        self._seen: set = set()
        self._families = {}
        # device-time attribution family (observability/profiling.py):
        # precomputed so the hot path never formats a string
        self._section = f"fused.{self.label}"

    def trace_count(self) -> int:
        """Traces of THIS kernel so far (the module-level
        ``trace_count()`` stays the shared total)."""
        return self._traces[0]

    def __call__(self, *args):
        if _first_seen(self._seen, _signature(args)):
            self._traces[0] += 1
            if self.batch_buckets is not None:
                self._note_retrace(args)
        # the section times the launch window (kernels are asynchronous
        # on the card; paths with a manifested pull add their own wider
        # family, e.g. ps.forward) — it never syncs the device
        with kernel_section(self._section):
            return self._fn(*args)

    def _note_retrace(self, args) -> None:
        fam = []
        for i, a in enumerate(args):
            shape = tuple(getattr(a, "shape", ()) or ())
            if i == len(args) - 1 and shape:
                shape = ("*",) + shape[1:]
            fam.append((shape, str(getattr(a, "dtype", ""))))
        fam = tuple(fam)
        with _init_lock:
            n = self._families.get(fam, 0) + 1
            self._families[fam] = n
        from incubator_brpc_tpu_torch.analysis import device_witness

        device_witness.note_trace(
            self.label, fam, n, len(self.batch_buckets)
        )


def fused_stack_rows(arrays: List, pad_to: int, freelist=None) -> List:
    """One stack over ``arrays`` (same shape/dtype/device), padded to
    ``pad_to`` rows.  Returns len(arrays) per-row outputs.

    ``freelist`` is a StagingRing-shaped pool (acquire(shape, dtype) /
    release(tensor)); None pads with fresh zeros."""
    n = len(arrays)
    if n == 0:
        return []
    proto = arrays[0]
    pad_to = max(pad_to, n)
    pads = []
    for _ in range(pad_to - n):
        slot = freelist.acquire(proto.shape, proto.dtype) if freelist is not None else None
        if slot is None:
            slot = torch.zeros(proto.shape, dtype=proto.dtype, device=proto.device)
        pads.append(slot)
    # one trace per (bucket, row shape, dtype, device), as jit's cache
    _first_seen(_stack_seen, (pad_to,) + _signature((proto,)))
    with kernel_section("fused.stack"):
        out = torch.stack(list(arrays) + pads)
    # the stack copied every pad into the batch tensor.  JAX may recycle
    # the slots at once because its arrays are immutable; here it is safe
    # because the port runs on one CUDA stream, so every later writer of
    # a recycled slot is ordered after this stack's read of it
    if freelist is not None:
        for s in pads:
            freelist.release(s)
    return [out[i] for i in range(n)]
