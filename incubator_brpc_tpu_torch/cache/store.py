"""Device-resident KV store: the cache tier's HBM value plane.

Port of the JAX package's ``cache/store.py``.  Every value is ONE
exact-length tensor of its own (never a slab row: the ICI placement
path ships whole tensors, and RESP/memcache framing needs nbytes ==
value length exactly).  SETs ingest host bytes with a single
host->device copy (``torch.from_numpy(...).to(device)``) — or adopt
the tensor of an arriving DeviceRef without any copy at all (the ICI
SET path).  GETs return the stored tensor untouched: the hot path does
zero device ops and zero device->host pulls.  Host-client reads funnel
through ``get_host``, the one sanctioned spill choke point (manifested
``cache.host-spill``).

Capacity is a device byte budget with LRU eviction.  Metrics:
``rpc_cache_{hits,misses,evictions,hbm_bytes}``.  The chaos site
``cache.lookup`` faults individual lookups: drop = forced miss for a
present key, delay_us = straggler replica.

Multi-GET fusion: same-length hit groups stack through ONE fused
gather (``fused_stack`` below: one ``torch.stack`` through a
``batching.FusedKernel`` with padding buckets), so a DMGET of N keys
leaves as a single device execution and one stacked wire segment
instead of N.

Where the port differs from the JAX package:

- **An explicit device.**  ``HBMCacheStore(device=None)`` places host
  bytes on the card of chip 0 (the port's ``parallel/mesh.py`` helper);
  with no card and no device it raises.  The JAX store lets
  ``jax.device_put`` pick its default device.
- **Values pin no more than they are charged for.**  Indexing a jax
  array makes a new array; indexing a tensor makes a view that keeps
  its whole base alive.  A prefill layer ``stack[layer, i]``, a DMGET
  row ``stacked[i]`` or a decode state ``out[i]`` would pin the whole
  (bucket, ...) buffer while the budget and ``cache.values`` charge
  only the row.  ``set`` therefore stores a compact copy of any tensor
  whose storage is larger than its own bytes; a whole tensor is
  adopted by identity.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from incubator_brpc_tpu_torch.analysis.device_witness import allowed_transfer
from incubator_brpc_tpu_torch.batching.fused import FusedKernel
from incubator_brpc_tpu_torch.chaos import injector as _chaos
from incubator_brpc_tpu_torch.metrics.reducer import Adder
from incubator_brpc_tpu_torch.observability.profiling import hbm_account
from incubator_brpc_tpu_torch.parallel.mesh import device_for_chip
from incubator_brpc_tpu_torch.utils.iobuf import DeviceRef

cache_hits = Adder(0).expose("rpc_cache_hits")
cache_misses = Adder(0).expose("rpc_cache_misses")
cache_evictions = Adder(0).expose("rpc_cache_evictions")
cache_hbm_bytes = Adder(0).expose("rpc_cache_hbm_bytes")

# HBM ledger tags (observability/profiling.py): stored values hold
# their adopt charge on the entry; fused-gather stacks are transient
# (bucket, L) buffers released when the tensor is collected
_VALUES_ACCT = hbm_account("cache.values")
_GATHER_ACCT = hbm_account("cache.gather")

DEFAULT_HBM_BUDGET = 64 << 20

# padding buckets for the fused multi-GET gather: each new stacked
# leading dim is one trace (a first-seen signature), so padding the hit
# count up to a bucket bounds traces at len(buckets) per value length
MGET_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def _stack_rows(*rows):
    return torch.stack(rows)


_mget_gather = FusedKernel(
    _stack_rows, label="cache.mget_gather", batch_buckets=MGET_BUCKETS
)


def _pad_bucket(n: int) -> int:
    for b in MGET_BUCKETS:
        if n <= b:
            return b
    return n


def fused_stack(rows: Sequence) -> torch.Tensor:
    """Stack same-shape device rows into one (bucket, L) tensor via a
    single fused execution; rows beyond ``len(rows)`` are padding
    (repeats of row 0 — their contents ride along but are never read)."""
    bucket = _pad_bucket(len(rows))
    padded = list(rows) + [rows[0]] * (bucket - len(rows))
    out = _mget_gather(*padded)
    charged = _GATHER_ACCT.adopt(out)
    if charged:
        # release rides GC: the stack lives exactly as long as the
        # response holding it (pad rows included — they pin HBM too)
        weakref.finalize(out, _GATHER_ACCT.release, charged)
    return out


def _compact(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when it owns its storage; else a copy that does,
    so a stored value pins exactly the bytes it is charged for."""
    if t.is_contiguous() and t.untyped_storage().nbytes() == t.nbytes:
        return t
    return t.clone(memory_format=torch.contiguous_format)


class _Entry:
    __slots__ = ("array", "length", "host", "charge")

    def __init__(self, array, length: int, host: Optional[bytes] = None,
                 charge: int = 0):
        self.array = array  # exact-length tensor (device mode)
        self.length = length
        self.host = host  # bytes (disabled mode only)
        self.charge = charge  # hbm_account adopt return (release this)


class HBMCacheStore:
    """LRU KV store of device-resident values, byte-budgeted.

    ``enabled=False`` degrades to a plain host-bytes dict with the same
    surface — the cache-disabled overhead baseline.  ``device`` is
    where host bytes are placed (default: the card of chip 0; raises
    without a card unless given)."""

    def __init__(self, hbm_budget_bytes: int = DEFAULT_HBM_BUDGET,
                 device=None, enabled: bool = True):
        self.budget = int(hbm_budget_bytes)
        self.device = device_for_chip(0, device)
        self.enabled = enabled
        self._d: "OrderedDict[bytes, _Entry]" = OrderedDict()
        self._used = 0
        self._lock = threading.RLock()

    # ---- ingest -----------------------------------------------------------
    def _to_device(self, value):
        """→ (tensor, nbytes).  DeviceRef whole tensors ADOPT (zero-copy:
        the ICI transport already delivered the value into local device
        memory); host bytes take one h2d copy (never witness-guarded)."""
        if isinstance(value, DeviceRef):
            arr = value.whole_array()
            if arr is None:
                # windowed ref: no identity to adopt; materialize the
                # window (manifested iobuf.host-view) and re-ingest
                value = bytes(value.view())
            else:
                arr = _compact(arr)
                return arr, int(arr.nbytes)
        if isinstance(value, (bytes, bytearray, memoryview)):
            host = np.frombuffer(bytearray(value), dtype=np.uint8)
            return torch.from_numpy(host).to(self.device), host.nbytes
        # raw tensor (in-process producer)
        arr = _compact(value)
        return arr, int(arr.nbytes)

    def set(self, key: bytes, value) -> bool:
        """Insert/replace.  False = value alone exceeds the budget."""
        key = bytes(key)
        if not self.enabled:
            if isinstance(value, DeviceRef):
                value = bytes(value.view())
            elif not isinstance(value, (bytes, bytearray, memoryview)):
                value = bytes(DeviceRef(value).view())
            with self._lock:
                self._d[key] = _Entry(None, len(value), bytes(value))
                self._d.move_to_end(key)
            return True
        arr, nbytes = self._to_device(value)
        if nbytes > self.budget:
            return False
        with self._lock:
            old = self._d.pop(key, None)
            if old is not None:
                self._used -= old.length
                cache_hbm_bytes << -old.length
                _VALUES_ACCT.release(old.charge)
            while self._used + nbytes > self.budget and self._d:
                _, ev = self._d.popitem(last=False)
                self._used -= ev.length
                cache_evictions << 1
                cache_hbm_bytes << -ev.length
                _VALUES_ACCT.release(ev.charge)
            self._d[key] = _Entry(arr, nbytes, charge=_VALUES_ACCT.adopt(nbytes))
            self._used += nbytes
            cache_hbm_bytes << nbytes
        return True

    # ---- lookup -----------------------------------------------------------
    def _chaos_drop(self, key: bytes) -> bool:
        if not _chaos.armed:
            return False
        spec = _chaos.check("cache.lookup", method=key.decode("latin1"))
        if spec is None:
            return False
        if spec.action == "delay_us":
            _chaos.sleep_us(spec.arg)
            return False
        return spec.action == "drop"

    def get(self, key: bytes):
        """The hot path: the stored device tensor (or host bytes when
        disabled), None on miss.  NO device ops, NO pulls."""
        key = bytes(key)
        forced_miss = self._chaos_drop(key)
        with self._lock:
            ent = None if forced_miss else self._d.get(key)
            if ent is None:
                cache_misses << 1
                return None
            self._d.move_to_end(key)
            cache_hits << 1
            return ent.host if ent.array is None else ent.array

    def get_host(self, key: bytes) -> Optional[bytes]:
        """Host-client read: device values SPILL to bytes here, under
        the manifested ``cache.host-spill`` scope — the only sanctioned
        device->host exit of the cache tier."""
        v = self.get(key)
        if v is None or isinstance(v, bytes):
            return v
        with allowed_transfer("cache.host-spill"):
            flat = v.detach().contiguous().reshape(-1).view(torch.uint8)
            return flat.cpu().numpy().tobytes()

    def get_many(self, keys: Sequence[bytes]) -> Tuple[List, Optional[object]]:
        """Batched lookup → (values, stacked).  ``values`` has one
        entry per key (tensor/bytes or None).  When every hit is a
        device value of ONE common length and there are ≥2 hits, they
        additionally coalesce through the fused gather into ``stacked``
        ((bucket, L)) — one device execution, one wire segment."""
        values = [self.get(k) for k in keys]
        hits = [v for v in values if v is not None]
        if (
            len(hits) >= 2
            and all(not isinstance(v, bytes) for v in hits)
            and len({int(v.nbytes) for v in hits}) == 1
        ):
            return values, fused_stack(hits)
        return values, None

    def keys(self) -> List[bytes]:
        """Snapshot of live keys (LRU order, oldest first) — the
        re-sharding coordinator's key census.  Does NOT touch recency:
        enumerating for a migration must not distort eviction order."""
        with self._lock:
            return list(self._d)

    # ---- maintenance ------------------------------------------------------
    def delete(self, key: bytes) -> bool:
        with self._lock:
            ent = self._d.pop(bytes(key), None)
            if ent is None:
                return False
            if ent.array is not None:
                self._used -= ent.length
                cache_hbm_bytes << -ent.length
                _VALUES_ACCT.release(ent.charge)
            return True

    def flush(self) -> int:
        with self._lock:
            n = len(self._d)
            if self._used:
                cache_hbm_bytes << -self._used
            charged = [e.charge for e in self._d.values() if e.charge]
            if charged:
                _VALUES_ACCT.release(sum(charged), allocs=len(charged))
            self._d.clear()
            self._used = 0
            return n

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return bytes(key) in self._d

    @property
    def hbm_used(self) -> int:
        return self._used

    def stats(self) -> dict:
        """Snapshot for the /cache builtin."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "entries": len(self._d),
                "hbm_used": self._used,
                "hbm_budget": self.budget,
                "hits": cache_hits.get_value(),
                "misses": cache_misses.get_value(),
                "evictions": cache_evictions.get_value(),
            }
