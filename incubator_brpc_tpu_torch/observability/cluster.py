"""Cluster observability plane — pod-scope trace stitching, exact
metric merging, and shard straggler attribution.

The span layer makes every process rich locally (rpcz span trees,
/latency_breakdown); trace ids already propagate over tpu_std and
HTTP — but each SpanDB is an island.  This module is the cross-process
half, served by the /cluster builtin family (builtin/__init__.py):

* **Trace stitching** — every process exports its SpanDB's spans for
  one trace as JSON (/rpcz/export?trace=); the stitcher follows the
  peer endpoints recorded on the local trace's client sub-spans
  (Controller._finalize_locked stamps remote_side), pulls each peer's
  spans for the same trace over the builtin HTTP surface (the same
  port that served the RPC — the InputMessenger protocol coexistence),
  and renders ONE tree where every fan-out/hedge/shard leg nests the
  remote server's phase stamps under the client leg, with the
  client-minus-server residual attributed as wire+queue per leg.
* **Mergeable metric aggregation** — replicas export aggregation STATE
  (counts + histogram buckets, metrics.latency_recorder
  mergeable_snapshot), never computed percentiles; merging sums the
  state elementwise so /cluster/metrics and /cluster/latency_breakdown
  serve exactly the percentiles of the pooled samples.
* **Straggler attribution** — fan-out completion (client/combo.py)
  records every leg's (peer, total_us, server_time_us); over a sliding
  window /cluster/stragglers ranks peers by their drag on fan-out tail
  latency, split into server time vs wire+queue residual, so one slow
  shard in an 8-way Forward is named, not inferred.

The wire+queue residual needs the server's own elapsed time:
RpcResponseMeta.server_time_us (protos/rpc_meta.proto), stamped by
tpu_std send_response, read back into Controller.server_time_us.
"""

from __future__ import annotations

import json
import re
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from incubator_brpc_tpu_torch.metrics.latency_recorder import (
    merge_latency_snapshots,
    snapshot_stats,
)
from incubator_brpc_tpu_torch.metrics.multi_dimension import MultiDimension
from incubator_brpc_tpu_torch.metrics.reducer import Adder
from incubator_brpc_tpu_torch.observability import trace as trace_mod
from incubator_brpc_tpu_torch.observability.span import (
    PHASE_FIELDS,
    Span,
    format_trace_id,
    parse_trace_id,
    span_db,
)

# ---------------------------------------------------------------------------
# span JSON export / import (the /rpcz/export wire format)
# ---------------------------------------------------------------------------

# non-phase span state that crosses the export boundary
_SPAN_FIELDS = (
    "kind", "service", "method", "start_us", "end_us", "error_code",
    "remote_side", "request_size", "response_size",
)


def span_to_dict(span: Span) -> dict:
    """One span as a JSON-safe dict.  Ids travel in the canonical
    printable form (span.format_trace_id) so the export endpoint,
    /rpcz pages and x-trace-id headers all show the same string."""
    d = {
        "trace_id": format_trace_id(span.trace_id),
        "span_id": format_trace_id(span.span_id),
        "parent_span_id": format_trace_id(span.parent_span_id),
    }
    for f in _SPAN_FIELDS:
        d[f] = getattr(span, f)
    phases = {}
    for f in PHASE_FIELDS:
        v = span.phase(f)
        if v:
            phases[f] = v
    if phases:
        d["phases"] = phases
    if span.annotations:
        d["annotations"] = [[t, a] for t, a in span.annotations]
    return d


class RemoteSpan(Span):
    """A span reconstructed from another process's export.  Carries the
    peer endpoint it came from (`origin`) for the stitched render, and
    is never ended/submitted — it exists only to be assembled."""

    __slots__ = ("origin",)


def span_from_dict(d: dict, origin: str = "") -> RemoteSpan:
    span = RemoteSpan(
        str(d.get("kind", "server")),
        str(d.get("service", "")),
        str(d.get("method", "")),
    )
    span.trace_id = parse_trace_id(d["trace_id"])
    span.span_id = parse_trace_id(d["span_id"])
    span.parent_span_id = parse_trace_id(d.get("parent_span_id", "0"))
    for f in ("start_us", "end_us", "error_code",
              "request_size", "response_size"):
        setattr(span, f, int(d.get(f, 0)))
    span.remote_side = str(d.get("remote_side", ""))
    for f, v in (d.get("phases") or {}).items():
        if f in PHASE_FIELDS:
            setattr(span, f, int(v))
    anns = d.get("annotations")
    if anns:
        span.annotations = [(int(t), str(a)) for t, a in anns]
    span.origin = origin
    return span


def export_trace(trace_id: int, endpoint: str = "") -> dict:
    """The /rpcz/export?trace= payload: this process's SpanDB spans for
    one trace."""
    spans = span_db().by_trace(trace_id)
    return {
        "endpoint": endpoint,
        "trace": format_trace_id(trace_id),
        "spans": [span_to_dict(s) for s in spans],
    }


# ---------------------------------------------------------------------------
# trace stitching
# ---------------------------------------------------------------------------

# peers worth following are host:port builtin-HTTP surfaces; ICI
# coordinates ("ici://0/1") and empty remotes are skipped gracefully
_HOSTPORT_RE = re.compile(r"^[\w\.\-]+:\d{1,5}$")


def _peer_endpoints(spans) -> List[str]:
    """Peer endpoints recorded on client/collective spans, in first-seen
    order: the remote processes that hold this trace's server spans."""
    out: List[str] = []
    seen = set()
    for s in spans:
        if s.kind == "server":
            continue
        ep = str(s.remote_side or "")
        if ep and ep not in seen and _HOSTPORT_RE.match(ep):
            seen.add(ep)
            out.append(ep)
    return out


def _fetch_remote_spans(
    endpoint: str, trace_id: int, timeout: float, retries: int,
    retry_delay_s: float,
) -> List[RemoteSpan]:
    """Pull one peer's spans for the trace over its builtin surface.
    Remote spans reach the peer's SpanDB through its Collector drain
    (~100ms rounds), so an empty answer right after the RPC retries
    briefly before concluding the peer has nothing."""
    from incubator_brpc_tpu_torch.tools.rpc_view import fetch_page_full

    page = f"rpcz/export?trace={format_trace_id(trace_id)}"
    for attempt in range(retries + 1):
        status, _ctype, body = fetch_page_full(
            endpoint, page, timeout=timeout, retries=1
        )
        if status != 200:
            raise OSError(f"/rpcz/export answered {status}")
        payload = json.loads(body.decode("utf-8"))
        dicts = payload.get("spans") or []
        if dicts or attempt == retries:
            # tag with the endpoint we actually reached, not the peer's
            # self-reported listen address (often a 0.0.0.0 wildcard)
            return [span_from_dict(d, endpoint) for d in dicts]
        time.sleep(retry_delay_s)
    return []


class _StitchDB:
    """by_trace facade over an already-collected span list, so
    trace.assemble works unchanged on the stitched set."""

    def __init__(self, spans):
        self._spans = list(spans)

    def by_trace(self, trace_id: int):
        return [s for s in self._spans if s.trace_id == trace_id]


def collect_stitched(
    trace_id: int,
    db=None,
    max_peers: int = 16,
    timeout: float = 2.0,
    retries: int = 3,
    retry_delay_s: float = 0.15,
    fetch=None,
) -> Tuple[List[Span], Dict[str, int], List[str]]:
    """BFS from the local trace across peer builtin surfaces.

    Returns (spans, origins, errors): the combined span set, per-peer
    fetched-span counts, and one message per peer that could not be
    reached (stitching is best-effort — a dead peer leaves its legs
    rendered from the client side only)."""
    db = db or span_db()
    fetch = fetch or _fetch_remote_spans
    spans: List[Span] = list(db.by_trace(trace_id))
    frontier = deque(_peer_endpoints(spans))
    visited = set()
    origins: Dict[str, int] = {}
    errors: List[str] = []
    while frontier and len(visited) < max_peers:
        ep = frontier.popleft()
        if ep in visited:
            continue
        visited.add(ep)
        try:
            remote = fetch(ep, trace_id, timeout, retries, retry_delay_s)
        except Exception as e:  # noqa: BLE001 — a dead peer degrades, not fails
            errors.append(f"{ep}: {e}")
            continue
        known = {(s.span_id, s.kind) for s in spans}
        added = 0
        for s in remote:
            if (s.span_id, s.kind) not in known:
                spans.append(s)
                added += 1
        origins[ep] = added
        # multi-hop: the peer's own client sub-spans name the next tier
        for nxt in _peer_endpoints(remote):
            if nxt not in visited:
                frontier.append(nxt)
    return spans, origins, errors


def _render_stitched_node(
    node, t0: int, depth: int, out: List[str], parent: Optional[Span]
):
    s = node.span
    pad = "  " * depth
    deltas = s.phase_deltas()
    phases = (
        " [" + " ".join(f"{n}={d}us" for n, d in deltas) + "]"
        if deltas
        else ""
    )
    origin = getattr(s, "origin", "")
    at = f" @{origin}" if origin else ""
    out.append(
        f"{pad}+{s.start_us - t0}us {s.kind} {s.service}.{s.method} "
        f"span={format_trace_id(s.span_id)} latency={s.latency_us}us "
        f"error={s.error_code} req={s.request_size}B "
        f"resp={s.response_size}B remote={s.remote_side}{at}{phases}"
    )
    if parent is not None and s.kind == "server" and parent.kind == "client":
        # the leg's client-observed latency minus the server's own
        # elapsed time: everything the server never saw — wire both
        # ways plus client-side queueing.  Clock-skew safe: both terms
        # are single-process durations, never cross-host differences.
        residual = parent.latency_us - s.latency_us
        if residual >= 0:
            out.append(
                f"{pad}    wire+queue residual={residual}us "
                f"(client {parent.latency_us}us - server {s.latency_us}us)"
            )
    for t, a in s.annotations or ():
        out.append(f"{pad}    @{t - t0}us {a}")
    for child in node.children:
        _render_stitched_node(child, t0, depth + 1, out, s)


def render_stitched(trace_id: int, db=None, **kw) -> Optional[str]:
    """The /rpcz?trace=N&stitch=1 view: one tree for the whole pod.
    None when even the local ring has no spans for the trace."""
    spans, origins, errors = collect_stitched(trace_id, db=db, **kw)
    if not spans:
        return None
    roots = trace_mod.assemble(trace_id, _StitchDB(spans))
    if not roots:
        return None
    t0 = min(n.span.start_us for n in roots)
    remote_total = sum(origins.values())
    head = (
        f"stitched trace {format_trace_id(trace_id)}: "
        f"{len(spans)} spans ({remote_total} remote from "
        f"{len(origins)} peers; times relative to first span)"
    )
    out = [head]
    for ep in sorted(origins):
        out.append(f"  peer {ep}: {origins[ep]} spans")
    for err in errors:
        out.append(f"  [unreachable] {err}")
    for root in roots:
        _render_stitched_node(root, t0, 0, out, None)
    return "\n".join(out)


# ---------------------------------------------------------------------------
# replica scraping + exact merging (/cluster/metrics, /cluster/latency_breakdown)
# ---------------------------------------------------------------------------

def resolve_replicas(spec: str) -> List[str]:
    """A replica list from either an explicit "host:port,host:port"
    string or a naming-service url (list://, file://, tpu://) — the
    same resolvers channels use (client/naming_service.py)."""
    spec = (spec or "").strip()
    if not spec:
        return []
    if "://" not in spec:
        return [s.strip() for s in spec.split(",") if s.strip()]
    from incubator_brpc_tpu_torch.client.naming_service import (
        PeriodicNamingService,
        find_naming_service,
    )

    ns = find_naming_service(spec)
    if ns is None:
        raise ValueError(f"unknown naming scheme in {spec!r}")
    if isinstance(ns, PeriodicNamingService):
        path = spec.split("://", 1)[1]
        nodes = ns.get_servers(path)
    else:
        # one-shot resolution of a push-style service (list://): run
        # with a pre-set stop event — it publishes once and returns
        class _Once:
            nodes: list = []

            def on_servers_changed(self, nodes):
                _Once.nodes = nodes

        ev = threading.Event()
        ev.set()
        ns.run(spec, _Once(), ev)
        nodes = _Once.nodes
    return [str(n.endpoint) for n in nodes]


def scrape_exports(
    replicas: List[str], timeout: float = 3.0
) -> Tuple[List[dict], List[str]]:
    """Fetch /cluster/export from each replica; (payloads, errors)."""
    from incubator_brpc_tpu_torch.tools.rpc_view import fetch_page_full

    payloads: List[dict] = []
    errors: List[str] = []
    for ep in replicas:
        try:
            status, _ctype, body = fetch_page_full(
                ep, "cluster/export", timeout=timeout, retries=1
            )
            if status != 200:
                raise OSError(f"/cluster/export answered {status}")
            payloads.append(json.loads(body.decode("utf-8")))
        except Exception as e:  # noqa: BLE001 — degrade per replica
            errors.append(f"{ep}: {e}")
        cluster_scrapes_total << 1
    return payloads, errors


def _is_latency_state(v) -> bool:
    return isinstance(v, dict) and "buckets" in v


def merge_dim_snapshots(snaps: List[dict]) -> dict:
    """Merge MultiDimension.mergeable_snapshot dicts from N replicas:
    numeric states add, {"sum","num"} recorder states add fieldwise,
    latency states merge through merge_latency_snapshots."""
    labels: List[str] = []
    merged: dict = {}
    for snap in snaps:
        if not snap:
            continue
        labels = labels or list(snap.get("labels") or [])
        for key, state in (snap.get("stats") or {}).items():
            cur = merged.get(key)
            if cur is None:
                if _is_latency_state(state):
                    state = merge_latency_snapshots([state])  # deep copy
                elif isinstance(state, dict):
                    state = dict(state)
                merged[key] = state
            elif _is_latency_state(state):
                merged[key] = merge_latency_snapshots([cur, state])
            elif isinstance(state, dict):
                for k, v in state.items():
                    if isinstance(v, (int, float)):
                        cur[k] = cur.get(k, 0) + v
            elif isinstance(state, (int, float)):
                merged[key] = cur + state
    return {"labels": labels, "stats": merged}


def merge_exports(payloads: List[dict]) -> dict:
    """Fold N /cluster/export payloads into one merged view:
    {"replicas": [...], "methods": {...}, "dims": {...}}."""
    methods: Dict[str, dict] = {}
    dims: Dict[str, List[dict]] = {}
    replicas: List[str] = []
    for p in payloads:
        replicas.append(p.get("endpoint", "?"))
        for name, m in (p.get("methods") or {}).items():
            cur = methods.setdefault(name, {"latency": None, "errors": 0})
            cur["latency"] = merge_latency_snapshots(
                [cur["latency"], m.get("latency")]
                if cur["latency"]
                else [m.get("latency")]
            )
            cur["errors"] += int(m.get("errors", 0))
        for name, snap in (p.get("dims") or {}).items():
            dims.setdefault(name, []).append(snap)
    return {
        "replicas": replicas,
        "methods": methods,
        "dims": {
            name: merge_dim_snapshots(snaps)
            for name, snaps in dims.items()
        },
    }


def merged_breakdown(merged: dict) -> Dict[str, Dict[str, dict]]:
    """The rpc_phase_latency_us family of a merged export, reshaped to
    the {method: {phase: stats}} table latency_breakdown renders."""
    fam = (merged.get("dims") or {}).get("rpc_phase_latency_us") or {}
    out: Dict[str, Dict[str, dict]] = {}
    for key, state in (fam.get("stats") or {}).items():
        if not _is_latency_state(state):
            continue
        method, _, phase = key.partition(MultiDimension._KEY_SEP)
        out.setdefault(method, {})[phase] = snapshot_stats(state)
    return out


def render_merged_metrics(merged: dict, errors: List[str]) -> str:
    """Prometheus-style text over a merged export: counter families
    summed, latency families re-read from merged buckets (exact)."""
    lines = [
        f"# cluster aggregation over {len(merged['replicas'])} replicas: "
        + ",".join(merged["replicas"])
    ]
    for err in errors:
        lines.append(f"# unreachable: {err}")
    for name in sorted(merged.get("methods") or ()):
        m = merged["methods"][name]
        stats = snapshot_stats(m["latency"] or {})
        label = f'method="{name}"'
        for stat in ("count", "avg_us", "p50_us", "p90_us", "p99_us", "max_us"):
            v = stats[stat]
            lines.append(
                f"rpc_method_latency_us{{{label},stat=\"{stat}\"}} {v:g}"
            )
        lines.append(f"rpc_method_errors_total{{{label}}} {m['errors']}")
        qps = (m["latency"] or {}).get("qps", 0.0)
        lines.append(f"rpc_method_qps{{{label}}} {qps:g}")
    for name in sorted(merged.get("dims") or ()):
        fam = merged["dims"][name]
        labels = fam.get("labels") or []
        for key in sorted(fam.get("stats") or ()):
            state = fam["stats"][key]
            parts = key.split(MultiDimension._KEY_SEP)
            label = ",".join(
                f'{k}="{v}"' for k, v in zip(labels, parts)
            )
            if _is_latency_state(state):
                stats = snapshot_stats(state)
                for stat in ("count", "avg_us", "p50_us", "p99_us"):
                    lines.append(
                        f"{name}{{{label},stat=\"{stat}\"}} {stats[stat]:g}"
                    )
            elif isinstance(state, dict):
                num = state.get("num", 0)
                avg = state.get("sum", 0) / num if num else 0.0
                lines.append(f"{name}{{{label},stat=\"num\"}} {num:g}")
                lines.append(f"{name}{{{label},stat=\"avg\"}} {avg:g}")
            else:
                lines.append(f"{name}{{{label}}} {state:g}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# straggler attribution (/cluster/stragglers)
# ---------------------------------------------------------------------------

# peer-labeled fan-out counters for /metrics (bounded label set: a pod
# has a fixed shard count; hostile/unbounded peers collapse to _other)
_MAX_PEERS = 64
cluster_fanout_legs_total = MultiDimension(
    lambda: Adder(0), ["peer"]
).expose("cluster_fanout_legs_total")
cluster_fanout_slowest_total = MultiDimension(
    lambda: Adder(0), ["peer"]
).expose("cluster_fanout_slowest_total")
cluster_scrapes_total = Adder(0).expose("cluster_scrapes_total")


class StragglerTracker:
    """Sliding window of fan-out completions, attributed per peer.

    Each fan-out contributes its slowest leg's DRAG — how much longer
    the fan-out took than it would have at the median leg latency —
    to that leg's peer, split into server time vs wire+queue residual
    by the leg's own server_time_us share.  Ranking by accumulated
    drag names the shard actually stretching the tail, not merely the
    one with the worst mean.
    """

    def __init__(self, window_s: float = 300.0, max_fanouts: int = 2048):
        self.window_s = window_s
        self._lock = threading.Lock()
        # (ts_s, method, legs) where legs = [(peer, total_us, server_us,
        # failed), ...] — only live (non-skipped) legs
        self._fanouts: deque = deque(maxlen=max_fanouts)
        self._peers: set = set()

    def _peer_label(self, peer: str) -> str:
        if peer in self._peers:
            return peer
        if len(self._peers) >= _MAX_PEERS:
            return "_other"
        self._peers.add(peer)
        return peer

    def note_fanout(self, method: str, legs) -> None:
        """Record one completed fan-out (called from the combo-channel
        finish closures).  legs: [(peer, total_us, server_us, failed)].
        Cheap by design — one deque append + two counter bumps."""
        if len(legs) < 2:
            return  # no siblings: straggling is relative
        now = time.time()
        with self._lock:
            legs = [
                (self._peer_label(str(p)), int(t), int(s), bool(f))
                for p, t, s, f in legs
            ]
            self._fanouts.append((now, method, legs))
        slowest = max(legs, key=lambda leg: leg[1])
        for peer, _t, _s, _f in legs:
            cluster_fanout_legs_total.get_stats([peer]) << 1
        cluster_fanout_slowest_total.get_stats([slowest[0]]) << 1

    def report(self, window_s: Optional[float] = None) -> dict:
        """Ranked per-peer attribution over the window."""
        window = window_s if window_s is not None else self.window_s
        cutoff = time.time() - window
        with self._lock:
            fanouts = [f for f in self._fanouts if f[0] >= cutoff]
        peers: Dict[str, dict] = {}

        def agg(peer):
            return peers.setdefault(peer, {
                "peer": peer, "legs": 0, "failed": 0, "slowest": 0,
                "drag_us": 0, "drag_server_us": 0, "drag_wire_us": 0,
                "total_us": 0, "server_us": 0, "wire_us": 0,
                "max_total_us": 0,
            })

        for _ts, _method, legs in fanouts:
            totals = sorted(t for _p, t, _s, _f in legs)
            median = totals[len(totals) // 2]
            slowest = max(legs, key=lambda leg: leg[1])
            for peer, total, server, failed in legs:
                a = agg(peer)
                a["legs"] += 1
                a["failed"] += int(failed)
                a["total_us"] += total
                server = min(server, total)
                wire = total - server if server > 0 else 0
                a["server_us"] += server
                a["wire_us"] += wire
                if total > a["max_total_us"]:
                    a["max_total_us"] = total
            peer, total, server, _failed = slowest
            a = agg(peer)
            a["slowest"] += 1
            drag = max(0, total - median)
            a["drag_us"] += drag
            # split the drag by the slowest leg's own composition:
            # server share = stamped server time, remainder = wire+queue
            if total > 0 and server > 0:
                ds = drag * min(server, total) // total
            else:
                ds = 0
            a["drag_server_us"] += ds
            a["drag_wire_us"] += drag - ds
        ranked = sorted(
            peers.values(),
            key=lambda a: (a["drag_us"], a["slowest"]),
            reverse=True,
        )
        for a in ranked:
            n = a["legs"] or 1
            a["mean_total_us"] = a["total_us"] // n
            a["mean_server_us"] = a["server_us"] // n
            a["mean_wire_us"] = a["wire_us"] // n
        return {
            "window_s": window,
            "fanouts": len(fanouts),
            "peers": ranked,
        }


_tracker = StragglerTracker()


def fanout_tracker() -> StragglerTracker:
    return _tracker


def note_fanout(method: str, legs) -> None:
    """Module-level hook the combo channels call (lazy-imported there:
    a fan-out completion pays one sys.modules lookup)."""
    _tracker.note_fanout(method, legs)
