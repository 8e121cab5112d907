"""Trace assembler — joins SpanDB rows into a hierarchical timeline.

One RPC crossing the pod leaves many spans sharing a trace_id: the
client call, per-chip collective legs, the server span, nested client
calls the handler made. This module reassembles them into the parent/
child tree (span_id ↔ parent_span_id) and renders the indented,
phase-annotated view /rpcz?trace=<id> serves — the reference's span
browsing (span.cpp SpanDB + rpcz_service) with the hierarchy made
explicit.
"""

from __future__ import annotations

from typing import List, Optional

from incubator_brpc_tpu_torch.observability.span import (
    Span,
    format_trace_id,
    span_db,
)

# render order inside one parent: spans sort by start time, with kind
# breaking exact-us ties so client legs precede the server work they
# caused on fast loopback clocks
_KIND_RANK = {"client": 0, "collective": 1, "server": 2}


class TraceNode:
    __slots__ = ("span", "children")

    def __init__(self, span: Span):
        self.span = span
        self.children: List["TraceNode"] = []


def assemble(trace_id: int, db=None) -> List[TraceNode]:
    """Build the span tree for one trace from the in-memory ring.
    Returns the roots (spans whose parent is not in the trace —
    normally one: the originating client call)."""
    db = db or span_db()
    spans = db.by_trace(trace_id)
    nodes = {}
    for s in spans:
        # ring may hold duplicate ids after retries resubmit; last wins
        nodes[s.span_id] = TraceNode(s)
    roots: List[TraceNode] = []
    for node in nodes.values():
        parent = nodes.get(node.span.parent_span_id)
        if parent is not None and parent is not node:
            parent.children.append(node)
        else:
            roots.append(node)
    key = lambda n: (  # noqa: E731
        n.span.start_us, _KIND_RANK.get(n.span.kind, 3)
    )
    for node in nodes.values():
        node.children.sort(key=key)
    roots.sort(key=key)
    return roots


def _render_node(node: TraceNode, t0: int, depth: int, out: List[str]):
    s = node.span
    pad = "  " * depth
    deltas = s.phase_deltas()
    phases = (
        " [" + " ".join(f"{n}={d}us" for n, d in deltas) + "]"
        if deltas
        else ""
    )
    out.append(
        f"{pad}+{s.start_us - t0}us {s.kind} {s.service}.{s.method} "
        f"span={format_trace_id(s.span_id)} latency={s.latency_us}us "
        f"error={s.error_code} req={s.request_size}B "
        f"resp={s.response_size}B remote={s.remote_side}{phases}"
    )
    for t, a in s.annotations or ():
        out.append(f"{pad}    @{t - t0}us {a}")
    for child in node.children:
        _render_node(child, t0, depth + 1, out)


def render(trace_id: int, db=None) -> Optional[str]:
    """Indented timeline for one trace; None when the ring has no spans
    for it (the caller may still consult the sqlite backend)."""
    roots = assemble(trace_id, db)
    if not roots:
        return None
    t0 = min(n.span.start_us for n in roots)
    out = [
        f"trace {format_trace_id(trace_id)} (times relative to first span)"
    ]
    for root in roots:
        _render_node(root, t0, 0, out)
    return "\n".join(out)
