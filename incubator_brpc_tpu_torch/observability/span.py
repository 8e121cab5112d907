"""rpcz tracing — per-RPC spans through the bvar Collector.

Analog of reference Span (span.h:47, span.cpp 801 LoC): created per
client call (channel.cpp:478-485) and per server request
(baidu_rpc_protocol.cpp:382-394); trace_id/span_id/parent_span_id
propagate inside the request meta; annotations and phase timestamps
ride along; submission goes through the bvar Collector sampling
pipeline (bounded overhead) into an in-memory SpanDB (the reference
persists to leveldb; /rpcz browses it either way). The parent span for
nested client calls lives in task-local storage (reference
bthread::tls_bls, span.h:75-78).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import List, Optional

from incubator_brpc_tpu_torch.metrics.collector import Collected
from incubator_brpc_tpu_torch.runtime import local as task_local
from incubator_brpc_tpu_torch.utils import flags as _flags_mod
from incubator_brpc_tpu_torch.utils.flags import get_flag
from incubator_brpc_tpu_torch.utils.hashes import fast_rand

_TLS_KEY = "rpcz_parent_span"


def format_trace_id(trace_id: int) -> str:
    """The ONE printable form of a trace/span id: lowercase hex, no
    prefix. Every surface that renders or transports an id as text
    (/rpcz pages, x-trace-id/x-span-id HTTP headers, /rpcz/export
    JSON) goes through this pair so ids copy-paste across them."""
    return f"{trace_id:x}"


def parse_trace_id(text: str) -> int:
    """Inverse of format_trace_id; raises ValueError on junk."""
    return int(text, 16)

# the rpcz_enabled Flag OBJECT, bound once: span creation runs per RPC
# and get_flag's dict lookup is measurable there (flag objects are
# permanent — /flags?setvalue mutates .value in place)
_RPCZ_FLAG = _flags_mod._flags["rpcz_enabled"]

_SPAN_RATE_FLAG = _flags_mod.define_flag(
    "rpcz_max_spans_per_second",
    500,
    "rpcz trace-creation budget per second; traffic beyond it is not "
    "traced (sampling, like the reference Collector speed limit — "
    "moved to creation so untraced requests pay nothing). 500 new "
    "traces/s saturates the /rpcz ring in ~4s; raise it for "
    "higher-fidelity capture at a hot-path cost",
    validator=lambda v: v > 0,
)

# Creation-side sampling window. The Collector always enforced a
# 1000/s admission at SUBMIT time; under load that meant most spans
# were created, stamped through every layer, then dropped. Applying
# the same budget at creation bounds rpcz's hot-path overhead by
# construction: over-budget RPCs skip span work entirely. Dirty
# (unlocked) counters — sampling is approximate by design, and the
# GIL keeps the list ops safe.
#
# Joined (trace-id-propagated) spans get their own counter with a 4x
# ceiling: sampled traces should stay complete across the pod, but the
# trace id is WIRE-CONTROLLED — without a bound, an upstream (or a
# hostile caller) stamping ids on every request would re-open the
# unbounded create-stamp-drop path the budget exists to close.
_JOIN_MULTIPLIER = 4
_window = [0.0, 0, 0]  # [window_start, roots_created, joined_created]


def _admit(joined: bool) -> bool:
    now = time.monotonic()
    w = _window
    if now - w[0] >= 1.0:
        w[0] = now
        w[1] = 0
        w[2] = 0
    if joined:
        if w[2] >= _SPAN_RATE_FLAG.value * _JOIN_MULTIPLIER:
            return False
        w[2] += 1
        return True
    if w[1] >= _SPAN_RATE_FLAG.value:
        return False
    w[1] += 1
    return True

# Phase timestamps an RPC picks up as it crosses the stack (the
# reference Span's received/start-parse/start-callback/sent stamps,
# span.h:47): every field is a wall-clock us, 0 = never reached.
#   received_us        bytes hit the event dispatcher / fabric CQ
#   enqueued_us        parsed message handed to a worker queue
#   parse_done_us      protocol parse produced the message
#   callback_start_us  user method entered
#   callback_done_us   user method ran its done()
#   response_write_us  serialized response queued on the socket
#   sent_us            response bytes flushed to the kernel/fabric
PHASE_FIELDS = (
    "received_us",
    "enqueued_us",
    "parse_done_us",
    "callback_start_us",
    "callback_done_us",
    "response_write_us",
    "sent_us",
    # device window inside the callback: stamped around kernel dispatch
    # + the sanctioned completion pull (models/parameter_server.py
    # Forward), so /latency_breakdown shows host-vs-device per method
    "device_start_us",
    "device_done_us",
    # ICI leg: the frame's device segments placed on the destination
    # (parallel/ici.py IciFabric.send), before delivery
    "placed_us",
    # batched server row: its batch left the micro-batcher's queue
    # (batching/batcher.py Batcher._flush)
    "batch_flush_us",
)

# Named deltas derived from the stamps (what /latency_breakdown
# aggregates): (phase, from_field, to_field); a tuple of from-fields
# takes the first one stamped.  "queue" splits into the micro-batcher's
# wait and the dispatch to the handler (the whole queue phase on an
# unbatched method).
PHASE_DELTAS = (
    ("parse", "received_us", "parse_done_us"),
    ("batch_wait", "enqueued_us", "batch_flush_us"),
    ("queue", "enqueued_us", "callback_start_us"),
    ("dispatch", ("batch_flush_us", "enqueued_us"), "callback_start_us"),
    ("callback", "callback_start_us", "callback_done_us"),
    ("device", "device_start_us", "device_done_us"),
    ("write", "callback_done_us", "response_write_us"),
    ("send", "response_write_us", "sent_us"),
)


class Span(Collected):
    __slots__ = (
        "trace_id",
        "span_id",
        "parent_span_id",
        "kind",
        "service",
        "method",
        "start_us",
        "end_us",
        "error_code",
        "remote_side",
        "annotations",
        "request_size",
        "response_size",
        "_open",  # one-shot close guard (see _try_close)
    ) + PHASE_FIELDS

    def __init__(self, kind: str, service: str = "", method: str = ""):
        self.kind = kind  # "client" | "server" | "collective"
        self.service = service
        self.method = method
        self.trace_id = 0
        self.span_id = fast_rand() & 0x7FFFFFFFFFFF
        self.parent_span_id = 0
        self.start_us = time.time_ns() // 1000
        self.end_us = 0
        self.error_code = 0
        self.remote_side = ""
        self.annotations: Optional[List] = None  # lazy: most spans have none
        self.request_size = 0
        self.response_size = 0
        self._open = True
        # phase fields are intentionally NOT initialised: spans are
        # created per RPC and 7 slot stores per span are measurable on
        # the hot path. Readers go through phase() / phase_deltas(),
        # which default unset slots to 0.  batch_flush_us is the one
        # exception: set on batched rows alone, phase_deltas() reads it
        # on every span, and an unset slot's read costs the collector
        # more than this store costs the call
        self.batch_flush_us = 0

    def phase(self, field: str) -> int:
        """Phase stamp value; 0 when never reached (unset slot)."""
        return getattr(self, field, 0)

    def _try_close(self) -> bool:
        """GIL-atomic one-shot close: slot deletion is a single
        bytecode, so exactly one of two racing closers (write
        completion vs set_failed sweep) wins — no double submit."""
        try:
            del self._open
            return True
        except AttributeError:
            return False

    @classmethod
    def create_client(cls, service: str, method: str) -> Optional["Span"]:
        if not _RPCZ_FLAG.value:
            return None
        parent: Optional[Span] = task_local.get_local(_TLS_KEY)
        if not _admit(joined=parent is not None):
            return None  # over the creation budget: not traced
        span = cls("client", service, method)
        if parent is not None:
            span.trace_id = parent.trace_id
            span.parent_span_id = parent.span_id
        else:
            span.trace_id = fast_rand() & 0x7FFFFFFFFFFF
        return span

    @classmethod
    def create_server(cls, service: str, method: str, trace_id: int, parent_span_id: int):
        """Server span with a propagated trace. The caller scopes it as
        the task-local parent (swap_current_span) around the handler
        invocation and restores after — leaving it installed would
        misparent later unrelated spans from the same task/thread into
        this finished trace."""
        if not _RPCZ_FLAG.value:
            return None
        if not _admit(joined=bool(trace_id)):
            return None  # over the creation budget: not traced
        # propagated trace ids use the (bounded) joined budget so
        # sampled traces stay complete across the pod
        span = cls("server", service, method)
        span.trace_id = trace_id or (fast_rand() & 0x7FFFFFFFFFFF)
        span.parent_span_id = parent_span_id
        return span

    @classmethod
    def create_collective(
        cls, service: str, method: str, require_parent: bool = True
    ) -> Optional["Span"]:
        """Sub-span for one collective/fabric leg (kind "collective"),
        parented to the active task-local span so fan-out calls show
        per-chip legs under their RPC. With require_parent (the
        transport paths) a legless context creates nothing — transport
        frames outside any traced RPC would only be ring noise."""
        if not _RPCZ_FLAG.value:
            return None
        parent: Optional[Span] = task_local.get_local(_TLS_KEY)
        if parent is None and require_parent:
            return None
        span = cls("collective", service, method)
        if parent is not None:
            span.trace_id = parent.trace_id
            span.parent_span_id = parent.span_id
        else:
            span.trace_id = fast_rand() & 0x7FFFFFFFFFFF
        return span

    def annotate(self, text: str):
        if self.annotations is None:
            self.annotations = []
        self.annotations.append((time.time_ns() // 1000, text))

    def stamp(self, phase: str):
        """Record a phase timestamp (one of PHASE_FIELDS) as now."""
        setattr(self, phase, time.time_ns() // 1000)

    # per-leg chunk annotations are capped so a pathological
    # thousand-chunk frame can't balloon one span's memory; the cap
    # comfortably covers a 64MB frame at the default 8MB chunks
    MAX_CHUNK_MARKS = 64

    def chunk_mark(self, what: str, idx: int, total: int, nbytes: int):
        """Timestamped per-chunk stamp on a collective leg (chunked
        ICI/DCN transfers): /rpcz?trace= then shows each chunk's launch
        offset inside the leg, i.e. the pipeline's actual overlap."""
        anns = self.annotations
        if anns is not None and len(anns) >= self.MAX_CHUNK_MARKS:
            return
        of = f"/{total}" if total > 0 else ""  # 0 = streaming, count unknown
        self.annotate(f"{what} chunk {idx + 1}{of} {nbytes}B")

    def adopt_message_stamps(self, msg):
        """Copy receive/parse/queue stamps the transport left on the
        parsed message (input_messenger stamps them on objects with the
        matching slots) onto this span. Unrolled: runs once per RPC
        per side."""
        v = getattr(msg, "received_us", 0)
        if v:
            self.received_us = v
        v = getattr(msg, "parse_done_us", 0)
        if v:
            self.parse_done_us = v
        v = getattr(msg, "enqueued_us", 0)
        if v:
            self.enqueued_us = v

    def write_done(self, error_code: int = 0):
        """Socket write-completion hook: the bytes this span queued
        (server response / client request) hit the kernel or fabric.
        Server spans close HERE, so server latency includes
        serialization and send (reference: response_sent stamp)."""
        now = time.time_ns() // 1000
        if error_code == 0:
            self.sent_us = now
        if self.kind == "server" and self._try_close():
            self.end_us = now
            self.error_code = self.error_code or error_code
            self.submit()

    def end(self, error_code: int = 0):
        if not self._try_close():
            return  # already closed (write-completion vs failure race)
        self.end_us = time.time_ns() // 1000
        self.error_code = error_code
        self.submit()  # through the Collector sampling pipeline

    def speed_limit(self) -> int:
        """Submit-side cap for spans. Creation-side admission already
        bounds span WORK; this backstop only has to be generous enough
        that every admitted trace's spans (root + joined + per-chip
        legs) pass, or sampled traces would come back incomplete at
        the Collector — the default 1000/s base limit is far below
        what admission can legitimately produce."""
        return _SPAN_RATE_FLAG.value * 32

    def dump_and_destroy(self):
        _span_db.add(self)
        try:
            from incubator_brpc_tpu_torch.observability import latency_breakdown

            latency_breakdown.record_span(self)
        except Exception:  # noqa: BLE001 — aggregation is best-effort
            pass

    @property
    def latency_us(self) -> int:
        return (self.end_us or self.start_us) - self.start_us

    def phase_deltas(self) -> List:
        """Computable (phase, delta_us) pairs in pipeline order."""
        out = []
        last_to = b = None
        for name, frm, to in PHASE_DELTAS:
            # the to-stamp first, once for neighbours that share it: most
            # are unset on a client or ICI span, and the read of an unset
            # slot is the fold's dearest step
            if to != last_to:
                last_to, b = to, getattr(self, to, 0)
            if not b:
                continue
            if frm.__class__ is tuple:
                for f in frm:
                    a = getattr(self, f, 0)
                    if a:
                        break
            else:
                a = getattr(self, frm, 0)
            if a and b >= a:
                out.append((name, b - a))
        return out

    def describe(self) -> str:
        anns = "".join(
            f"\n    @{t - self.start_us}us {a}"
            for t, a in (self.annotations or ())
        )
        deltas = self.phase_deltas()
        phases = (
            " phases[" + " ".join(f"{n}={d}us" for n, d in deltas) + "]"
            if deltas
            else ""
        )
        return (
            f"{self.kind} {self.service}.{self.method} "
            f"trace={format_trace_id(self.trace_id)} "
            f"span={format_trace_id(self.span_id)} "
            f"parent={format_trace_id(self.parent_span_id)} "
            f"latency={self.latency_us}us error={self.error_code} "
            f"remote={self.remote_side} req={self.request_size}B "
            f"resp={self.response_size}B{phases}{anns}"
        )


class SpanDB:
    """Recent-span store browsed by /rpcz: an in-memory ring always,
    plus durable sqlite persistence when the reloadable flag
    ``rpcz_db_path`` names a file (the reference persists via leveldb,
    span.cpp SpanDB; sqlite is the stdlib equivalent). Persistence
    survives restarts and lets /rpcz answer trace queries older than
    the ring."""

    def __init__(self, capacity: int = 2048):
        self._spans: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._db = None
        self._db_path = None

    def _sqlite(self):
        """(Re)open the sqlite backend when the flag changes. Called
        with self._lock held, only from the Collector drain thread."""
        path = get_flag("rpcz_db_path", "") or None
        if path == self._db_path:
            return self._db
        if self._db is not None:
            try:
                self._db.close()
            except Exception:  # noqa: BLE001
                pass
            self._db = None
        self._db_path = path
        if path:
            import sqlite3

            db = sqlite3.connect(path, check_same_thread=False)
            db.execute(
                "CREATE TABLE IF NOT EXISTS spans ("
                "trace_id INTEGER, span_id INTEGER, parent_span_id INTEGER,"
                "kind TEXT, service TEXT, method TEXT, start_us INTEGER,"
                "latency_us INTEGER, error_code INTEGER, remote TEXT,"
                "description TEXT)"
            )
            db.execute(
                "CREATE INDEX IF NOT EXISTS spans_trace ON spans(trace_id)"
            )
            db.commit()
            self._db = db
        return self._db

    def add(self, span: Span):
        """Called from the Collector drain thread (never the RPC path),
        so the sqlite insert costs nothing on the hot path."""
        with self._lock:
            self._spans.append(span)
            db = self._sqlite()
            if db is not None:
                try:
                    db.execute(
                        "INSERT INTO spans VALUES (?,?,?,?,?,?,?,?,?,?,?)",
                        (
                            span.trace_id,
                            span.span_id,
                            span.parent_span_id,
                            span.kind,
                            span.service,
                            span.method,
                            span.start_us,
                            span.latency_us,
                            span.error_code,
                            str(span.remote_side),
                            span.describe(),
                        ),
                    )
                    db.commit()
                except Exception:  # noqa: BLE001 — persistence is best-effort
                    pass

    def recent(self, n: int = 100) -> List[Span]:
        with self._lock:
            return list(self._spans)[-n:]

    def by_trace(self, trace_id: int) -> List[Span]:
        with self._lock:
            mem = [s for s in self._spans if s.trace_id == trace_id]
        return mem

    def persisted_by_trace(self, trace_id: int) -> List[str]:
        """Descriptions from the sqlite backend (covers spans already
        evicted from the memory ring — and prior process runs)."""
        with self._lock:
            db = self._sqlite()
            if db is None:
                return []
            try:
                rows = db.execute(
                    "SELECT description FROM spans WHERE trace_id=? "
                    "ORDER BY start_us",
                    (trace_id,),
                ).fetchall()
            except Exception:  # noqa: BLE001
                return []
        return [r[0] for r in rows]

    def __len__(self):
        return len(self._spans)


_span_db = SpanDB()


def span_db() -> SpanDB:
    return _span_db


def current_span() -> Optional[Span]:
    """The active task-local span (parent for nested client calls and
    collective sub-spans; reference bthread::tls_bls, span.h:75-78)."""
    return task_local.get_local(_TLS_KEY)


def swap_current_span(span: Optional[Span]) -> Optional[Span]:
    """Install `span` as the task-local parent; returns the previous
    one so the caller can restore it (scoped parenting for fan-out).
    One storage lookup for the get+set pair — this runs per RPC."""
    d = task_local._storage()
    prev = d.get(_TLS_KEY)
    d[_TLS_KEY] = span
    return prev
