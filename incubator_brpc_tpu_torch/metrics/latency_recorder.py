"""LatencyRecorder — qps + avg + max + log-bucketed percentiles.

Analog of bvar::LatencyRecorder (latency_recorder.h:75) built on the
same parts as the reference: an IntRecorder for the windowed average, a
Maxer for windowed max, an Adder+PerSecond for qps, and a log-bucketed
Percentile (reference detail/percentile.h, the "79.4%-effort"
log-interval design) for p50/p90/p99/p99.9.

expose(prefix) registers the same derived variable names the reference
emits: <prefix>_latency, _latency_50/90/99/999, _max_latency, _qps,
_count — these names feed /vars and the Prometheus exporter.
"""

from __future__ import annotations

import math
import operator
import threading
from collections import deque
from typing import List

from incubator_brpc_tpu_torch.metrics.variable import Variable
from incubator_brpc_tpu_torch.metrics.reducer import Adder, Maxer
from incubator_brpc_tpu_torch.metrics.recorder import IntRecorder
from incubator_brpc_tpu_torch.metrics.window import PerSecond, Window, _sampler_thread
from incubator_brpc_tpu_torch.metrics.passive_status import PassiveStatus

_NUM_BUCKETS = 512  # 32 octaves × 16 sub-buckets, covers 1us..~4e9us (>1h)


def _bucket_of(us: int) -> int:
    # exact below 16us; 16 log sub-buckets per octave above (monotonic)
    if us < 0:
        us = 0
    if us < 16:
        return us
    e = us.bit_length() - 1  # >= 4
    sub = (us >> (e - 4)) & 0xF
    return min(e * 16 + sub, _NUM_BUCKETS - 1)


# first latency value belonging to the NEXT bucket (exclusive upper
# bound of bucket idx) — powers run-length folding in update_sorted
def _bucket_hi_of(idx: int) -> int:
    if idx < 16:
        return idx + 1
    e, sub = divmod(idx, 16)
    if e < 4:  # indices 16..63 are unreachable (us>=16 → e>=4)
        return idx + 1
    return (17 + sub) << (e - 4)


_BUCKET_HI = [_bucket_hi_of(i) for i in range(_NUM_BUCKETS - 1)] + [1 << 62]


def _bucket_mid(idx: int) -> float:
    if idx < 16:
        return float(idx)
    e, sub = divmod(idx, 16)
    lo = (16 + sub) << (e - 4)
    hi = (17 + sub) << (e - 4)
    return (lo + hi) / 2.0


def percentile_from_buckets(buckets, ratio: float) -> float:
    """The percentile read over raw bucket counts — THE algorithm
    (Percentile.get_percentile delegates here).  `buckets` is either a
    dense list indexed by bucket or a sparse {index: count} mapping.
    Because bucketing each sample is deterministic and this walk sees
    only counts, running it over the elementwise SUM of several
    processes' buckets yields exactly the percentile of the pooled
    samples — the mergeable-aggregation invariant /cluster relies on
    (and tests prove)."""
    if isinstance(buckets, dict):
        dense = [0] * _NUM_BUCKETS
        for i, c in buckets.items():
            dense[int(i)] += c
        buckets = dense
    total = sum(buckets)
    if total == 0:
        return 0.0
    target = math.ceil(total * ratio)
    acc = 0
    for i, c in enumerate(buckets):
        acc += c
        if acc >= target:
            return _bucket_mid(i)
    return _bucket_mid(_NUM_BUCKETS - 1)


def merge_latency_snapshots(snaps) -> dict:
    """Fold several LatencyRecorder.mergeable_snapshot() dicts into one
    of the same shape: counts/sums add, maxes max, histogram buckets
    add elementwise.  Never merges pre-computed percentiles — read
    them from the merged buckets via percentile_from_buckets."""
    out = {
        "count": 0,
        "latency_sum": 0,
        "latency_num": 0,
        "max_latency": 0.0,
        "qps": 0.0,
        "buckets": {},
    }
    merged_buckets = out["buckets"]
    for snap in snaps:
        if not snap:
            continue
        out["count"] += int(snap.get("count", 0))
        out["latency_sum"] += int(snap.get("latency_sum", 0))
        out["latency_num"] += int(snap.get("latency_num", 0))
        out["max_latency"] = max(
            out["max_latency"], float(snap.get("max_latency", 0))
        )
        out["qps"] += float(snap.get("qps", 0.0))
        for i, c in (snap.get("buckets") or {}).items():
            i = str(int(i))
            merged_buckets[i] = merged_buckets.get(i, 0) + int(c)
    return out


def snapshot_stats(snap: dict) -> dict:
    """Human stats {count, avg_us, p50_us, p90_us, p99_us, max_us} from
    one (possibly merged) mergeable snapshot."""
    num = snap.get("latency_num", 0)
    buckets = snap.get("buckets") or {}
    return {
        "count": snap.get("count", 0),
        "avg_us": (snap.get("latency_sum", 0) / num) if num else 0.0,
        "p50_us": percentile_from_buckets(buckets, 0.5),
        "p90_us": percentile_from_buckets(buckets, 0.9),
        "p99_us": percentile_from_buckets(buckets, 0.99),
        "max_us": float(snap.get("max_latency", 0)),
    }


class Percentile:
    """Log-bucketed percentile estimator (reference detail/percentile.h).

    Thread-local bucket counters merged on read; a ring of per-second
    snapshots gives windowed percentiles.  ``_window`` is the running
    total of the ring's snapshots, kept by each tick under the lock that
    guards the live second, so a read is one pass and sees a tick whole.
    """

    def __init__(self, window_size: int = 10):
        self._lock = threading.Lock()
        self._buckets = [0] * _NUM_BUCKETS
        self._ring: deque = deque(maxlen=window_size)
        self._window = [0] * _NUM_BUCKETS

    def update(self, latency_us: int):
        idx = _bucket_of(int(latency_us))
        with self._lock:
            self._buckets[idx] += 1

    def update_bulk(self, latency_us: int, n: int):
        idx = _bucket_of(int(latency_us))
        with self._lock:
            self._buckets[idx] += n

    def update_sorted(self, items: List[int]):
        """Fold a pre-sorted batch: one bucket increment per bucket RUN
        instead of per item (the batched write path's flush)."""
        import bisect

        with self._lock:
            b = self._buckets
            i, n = 0, len(items)
            while i < n:
                idx = _bucket_of(items[i])
                j = bisect.bisect_left(items, _BUCKET_HI[idx], i + 1)
                b[idx] += j - i
                i = j

    def take_sample(self):
        # an idle second (most recorders, most ticks) costs two any()
        # scans, and the sums run in C: the 1 Hz sampler ticks every
        # recorder of the process
        with self._lock:
            snap = self._buckets
            self._buckets = [0] * _NUM_BUCKETS
            ring = self._ring
            if len(ring) == ring.maxlen and any(ring[0]):  # the append evicts it
                self._window = list(map(operator.sub, self._window, ring[0]))
            if any(snap):
                self._window = list(map(operator.add, self._window, snap))
            ring.append(snap)

    def bucket_totals(self) -> List[int]:
        """Windowed bucket counts (ring snapshots + the current partial
        second) — the raw histogram state mergeable_snapshot exports."""
        with self._lock:
            return list(map(operator.add, self._window, self._buckets))

    def get_percentile(self, ratio: float) -> float:
        """ratio in (0,1], e.g. 0.99."""
        return percentile_from_buckets(self.bucket_totals(), ratio)


class LatencyRecorder(Variable):
    def __init__(self, window_size: int = 10):
        super().__init__()
        self._latency = IntRecorder()
        self._max_latency = Maxer()
        self._count = Adder(0)
        self._qps = PerSecond(self._count, window_size)
        self._max_window = Window(self._max_latency, window_size)
        self._percentile = Percentile(window_size)
        self._win_sum = deque(maxlen=window_size)
        # a tick's two moves (the live buckets and the live sum into the
        # window) and a reader's reads of both happen under this lock, so
        # a read sees the window before a tick or after it
        self._window_lock = threading.Lock()
        self._wtls = threading.local()  # fused write-path agent cache
        self.bulk_folded = False  # ever fed by update_bulk (mean folds)
        # batched write path: per-thread append-only buffers, folded by
        # the 1 Hz sampler (or any read) — see update_batched
        self._batches: List[List[int]] = []
        self._batch_reg_lock = threading.Lock()
        self._flush_lock = threading.Lock()
        self._derived: List[Variable] = []
        # optional lazy source: called before any read/sampler fold so
        # observations kept OUTSIDE Python (e.g. the native mux client's
        # C atomics, engine.cpp nc_mux_stats) flow in with ZERO per-call
        # Python work.  The source calls update_bulk/note_max itself.
        self._pull_source = None
        self._in_pull = False
        # ride the global 1 Hz sampler for percentile + windowed avg snapshots
        self._psampler = _PercentileSampler(self)
        _sampler_thread.add(self._psampler)

    def set_pull_source(self, fn) -> None:
        """fn() harvests externally-kept observations into this recorder
        (via update_bulk/note_max); invoked lazily before reads and at
        each sampler tick."""
        self._pull_source = fn

    def note_max(self, latency_us: int) -> None:
        """Fold an externally-observed max (no count/sum contribution)."""
        ma = self._max_latency._my_agent()
        us = int(latency_us)
        with ma.lock:
            if us > ma.value:
                ma.value = us

    # -- write path (hot): called once per finished RPC. Fused: one TLS
    # lookup caches this thread's component agents, updates go inline
    # (the layered component update() calls cost ~8us/RPC, measured) --
    def update(self, latency_us: int) -> "LatencyRecorder":
        us = int(latency_us)
        tls = self._wtls
        agents = getattr(tls, "agents", None)
        if agents is None:
            agents = (
                self._latency._my_agent(),
                self._max_latency._my_agent(),
                self._count._my_agent(),
            )
            tls.agents = agents
        la, ma, ca = agents
        with la.lock:
            la.sum += us
            la.num += 1
        with ma.lock:
            if us > ma.value:
                ma.value = us
        with ca.lock:
            ca.value += 1
        self._percentile.update(us)
        return self

    __lshift__ = update

    def update_batched(self, latency_us: int) -> None:
        """O(list-append) hot-path record (~0.15us vs ~1.6us for
        update): observations buffer in a per-thread list and fold into
        the real components at the next 1 Hz sampler tick or read.
        Windowed reads already lag by design; the native RPC paths use
        this because every microsecond of per-call GIL-held work caps
        aggregate qps at 1s/that on one core."""
        tls = self._wtls
        buf = getattr(tls, "batch", None)
        if buf is None:
            buf = tls.batch = []
            with self._batch_reg_lock:
                self._batches.append((threading.current_thread(), buf))
        buf.append(latency_us)

    def _flush_batches(self) -> None:
        """Fold all per-thread batch buffers into the components.
        Concurrent-writer safe under the GIL: we only remove the first
        n items we copied; appends racing in land in a later flush."""
        pull = self._pull_source
        if pull is not None:
            # under _flush_lock: the pull's read-diff-fold of external
            # counters is a read-modify-write — two concurrent readers
            # (sampler tick + a /vars read; the ctypes stats call drops
            # the GIL) would otherwise fold the same delta twice.
            # _in_pull guards recursion only (the source's update_bulk
            # path must not re-enter the pull).
            with self._flush_lock:
                if not self._in_pull:
                    self._in_pull = True
                    try:
                        pull()
                    finally:
                        self._in_pull = False
        if not self._batches:
            return
        with self._flush_lock:
            total = 0
            s = 0
            mx = 0
            dead = None
            for entry in self._batches:
                thread, buf = entry
                n = len(buf)
                if not n:
                    if not thread.is_alive():  # drained + writer gone:
                        dead = dead or []  # prune (thread-churny apps
                        dead.append(entry)  # would leak a list each)
                    continue
                items = buf[:n]
                del buf[:n]
                items.sort()
                total += n
                s += sum(items)
                if items[-1] > mx:
                    mx = items[-1]
                self._percentile.update_sorted(items)
            if dead:
                with self._batch_reg_lock:
                    for entry in dead:
                        self._batches.remove(entry)
            if not total:
                return
            la = self._latency._my_agent()
            ma = self._max_latency._my_agent()
            ca = self._count._my_agent()
            with la.lock:
                la.sum += s
                la.num += total
            with ma.lock:
                if mx > ma.value:
                    ma.value = mx
            with ca.lock:
                ca.value += total

    def update_bulk(self, latency_us: int, n: int) -> "LatencyRecorder":
        """Record `n` observations of `latency_us` at O(1) cost.  Used
        to harvest native-engine fast-path completions, which arrive as
        (count, latency sum) deltas: every harvested call lands in the
        average's bucket, so percentiles over harvested traffic read as
        the mean rather than the true spread."""
        if n <= 0:
            return self
        self.bulk_folded = True  # /status flags percentiles as approx
        us = int(latency_us)
        tls = self._wtls
        agents = getattr(tls, "agents", None)
        if agents is None:
            agents = (
                self._latency._my_agent(),
                self._max_latency._my_agent(),
                self._count._my_agent(),
            )
            tls.agents = agents
        la, ma, ca = agents
        with la.lock:
            la.sum += us * n
            la.num += n
        with ma.lock:
            if us > ma.value:
                ma.value = us
        with ca.lock:
            ca.value += n
        self._percentile.update_bulk(us, n)
        return self

    # -- reads (all fold pending batched writes first) --
    def latency(self) -> float:
        """Windowed average latency in us."""
        self._flush_batches()
        return self._window_average(*self._read_window(buckets=False)[1:])

    def _read_window(self, buckets: bool = True) -> tuple:
        """(bucket totals or None, the ticks' latency sum and count, the
        live second's sum and count), read whole across a tick."""
        with self._window_lock:
            totals = self._percentile.bucket_totals() if buckets else None
            s = n = 0
            for ws, wn in self._win_sum:
                s += ws
                n += wn
            cs, cn = self._latency.sum_num()
        return totals, s, n, cs, cn

    @staticmethod
    def _window_average(s: int, n: int, cs: int, cn: int) -> float:
        if n == 0:
            return cs / cn if cn else 0.0
        return s / n

    def latency_percentile(self, ratio: float) -> float:
        self._flush_batches()
        return self._percentile.get_percentile(ratio)

    def max_latency(self) -> float:
        self._flush_batches()
        return self._max_window.get_value()

    def stats(self, ratios=(0.5, 0.99)) -> tuple:
        """(count, windowed average, [percentile at each ratio]): what
        count(), latency() and latency_percentile() return, read after
        ONE fold of the batched writes and one sum of the window's
        buckets.  An exposition that reads many recorders (the /metrics
        page's rpc_phase_latency_us family) pays one fold a recorder."""
        self._flush_batches()
        buckets, *sums = self._read_window()
        return (
            self._count.get_value(),
            self._window_average(*sums),
            [percentile_from_buckets(buckets, r) for r in ratios],
        )

    def qps(self) -> float:
        self._flush_batches()
        return self._qps.get_value()

    def count(self) -> int:
        self._flush_batches()
        return self._count.get_value()

    def get_value(self) -> float:
        return self.latency()

    def mergeable_snapshot(self) -> dict:
        """Export the aggregation STATE (counts, sums, histogram
        buckets), never computed percentiles: elementwise merging of
        these dicts across replicas (merge_latency_snapshots) then
        percentile_from_buckets is exactly the percentile of the
        pooled samples.  Buckets are sparse {index: count} with string
        keys so the dict survives a JSON round-trip unchanged."""
        self._flush_batches()
        buckets, s, n, cs, cn = self._read_window()
        # read after the one fold above (count(), max_latency() and qps()
        # would each fold again)
        return {
            "count": self._count.get_value(),
            "latency_sum": s + cs,
            "latency_num": n + cn,
            "max_latency": self._max_window.get_value(),
            "qps": self._qps.get_value(),
            "buckets": {
                str(i): c for i, c in enumerate(buckets) if c
            },
        }

    def describe(self) -> str:
        return (
            f"latency={self.latency():.0f}us p50={self.latency_percentile(0.5):.0f} "
            f"p99={self.latency_percentile(0.99):.0f} max={self.max_latency():.0f} "
            f"qps={self.qps():.1f} count={self.count()}"
        )

    def expose(self, name: str, prefix: str = "") -> "LatencyRecorder":
        super().expose(f"{name}_latency", prefix)
        base = self._name[: -len("_latency")]
        mk = lambda fn: PassiveStatus(fn)  # noqa: E731
        for suffix, fn in [
            ("latency_50", lambda: self.latency_percentile(0.5)),
            ("latency_90", lambda: self.latency_percentile(0.9)),
            ("latency_99", lambda: self.latency_percentile(0.99)),
            ("latency_999", lambda: self.latency_percentile(0.999)),
            ("max_latency", self.max_latency),
            ("qps", self.qps),
            ("count", self.count),
        ]:
            v = mk(fn).expose(f"{base}_{suffix}")
            self._derived.append(v)
        return self

    def hide(self):
        super().hide()
        for v in self._derived:
            v.hide()
        self._derived.clear()


class _PercentileSampler:
    def __init__(self, rec: LatencyRecorder):
        self._rec = rec
        self.window_size = rec._win_sum.maxlen

    def take_sample(self):
        rec = self._rec
        rec._flush_batches()  # fold batched writes into this tick
        with rec._window_lock:
            rec._percentile.take_sample()
            rec._win_sum.append(rec._latency.reset())
