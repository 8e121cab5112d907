"""The canonical lock-order manifest (lock_order.json).

The manifest is the reviewed, checked-in statement of which lock may be
held while which other lock is acquired — every edge carries a one-line
justification.  The check is three-way:

- every STATIC edge must appear in the manifest
  (``lock-order-new-edge`` otherwise: a new cross-lock acquisition is a
  reviewable diff, never silent);
- the union of manifest + static edges must be acyclic
  (``lock-order-cycle``: an inversion);
- WITNESSED runtime edges must not contradict the manifest order
  (checked by analysis.witness.cross_check).

Manifest edges no longer seen statically are reported as stale
warnings so the file cannot rot into fiction.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Set, Tuple

from incubator_brpc_tpu_torch.analysis.findings import Finding, TODO_REVIEW_MARKER
from incubator_brpc_tpu_torch.analysis.lockgraph import GraphResult, find_cycles

DEFAULT_PATH = os.path.join(os.path.dirname(__file__), "lock_order.json")


@dataclass
class Manifest:
    edges: List[dict] = field(default_factory=list)  # {from, to, why}
    path: str = DEFAULT_PATH

    def __post_init__(self):
        for e in self.edges:
            if not e.get("why", "").strip():
                raise ValueError(
                    f"manifest edge {e.get('from')} -> {e.get('to')} in "
                    f"{self.path} has no justification ('why')"
                )

    def pairs(self) -> Set[Tuple[str, str]]:
        return {(e["from"], e["to"]) for e in self.edges}


def load_manifest(path: str = DEFAULT_PATH) -> Manifest:
    if not os.path.exists(path):
        return Manifest([], path)
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return Manifest(data.get("edges", []), path)


def save_manifest(manifest: Manifest, path: str = DEFAULT_PATH) -> None:
    edges = sorted(manifest.edges, key=lambda e: (e["from"], e["to"]))
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"edges": edges}, f, indent=2, sort_keys=True)
        f.write("\n")


def todo_review_findings(manifest: Manifest) -> List[Finding]:
    """Edges whose `why` still contains the ``TODO review`` placeholder
    update_manifest_from_graph writes: the --update-manifest flow says
    'edit before commit', and this is what makes skipping that edit a
    violation instead of a silently permanent non-justification."""
    out: List[Finding] = []
    for e in manifest.edges:
        if TODO_REVIEW_MARKER in e.get("why", ""):
            out.append(
                Finding(
                    rule="todo-review-why",
                    key=f"lock-order/{e.get('from')}->{e.get('to')}",
                    message=(
                        f"manifest edge {e.get('from')} -> {e.get('to')} "
                        f"still carries a '{TODO_REVIEW_MARKER}' "
                        f"placeholder why — review the edge and write the "
                        f"real justification"
                    ),
                    file=manifest.path,
                )
            )
    return out


def check_graph_against_manifest(
    graph: GraphResult, manifest: Manifest
) -> Tuple[List[Finding], List[str]]:
    """→ (findings, stale_warnings)."""
    findings: List[Finding] = []
    static_pairs = graph.edge_pairs()
    manifest_pairs = manifest.pairs()

    for e in sorted(graph.edges, key=lambda e: (e.src, e.dst)):
        if (e.src, e.dst) not in manifest_pairs:
            via = f" via {e.via}" if e.via else ""
            findings.append(
                Finding(
                    rule="lock-order-new-edge",
                    key=f"{e.src}->{e.dst}",
                    message=(
                        f"new lock-order edge {e.src} -> {e.dst}"
                        f" (first seen {e.module}:{e.line}{via}) — review "
                        f"it, then add it to lock_order.json with a 'why' "
                        f"or restructure the acquisition"
                    ),
                    file=e.module,
                    line=e.line,
                )
            )

    union = static_pairs | manifest_pairs
    for cyc in find_cycles(union):
        findings.append(
            Finding(
                rule="lock-order-cycle",
                key="->".join(cyc),
                message=f"lock-order inversion: {' -> '.join(cyc)}",
            )
        )

    # witness-sourced edges are invisible to the static pass by nature
    # (dynamic dispatch, data-driven calls) — only static-sourced edges
    # can go stale
    static_sourced = {
        (e["from"], e["to"])
        for e in manifest.edges
        if e.get("source") != "witness"
    }
    stale = [
        f"manifest edge {a} -> {b} no longer observed statically"
        for (a, b) in sorted(static_sourced - static_pairs)
    ]
    return findings, stale


def update_manifest_from_graph(
    graph: GraphResult, manifest: Manifest, path: str = DEFAULT_PATH
) -> int:
    """Add missing static edges with a placeholder why (to be edited by
    hand before commit).  Returns the number added."""
    manifest_pairs = manifest.pairs()
    added = 0
    for e in sorted(graph.edges, key=lambda e: (e.src, e.dst)):
        if (e.src, e.dst) in manifest_pairs:
            continue
        via = f" via {e.via}" if e.via else " (direct nested acquisition)"
        manifest.edges.append(
            {
                "from": e.src,
                "to": e.dst,
                "why": f"TODO review: first seen {e.module}:{e.line}{via}",
            }
        )
        manifest_pairs.add((e.src, e.dst))
        added += 1
    if added:
        save_manifest(manifest, path)
    return added
