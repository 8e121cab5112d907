"""Stack sampling + self-contained SVG flamegraph rendering.

Analog of the reference's /hotspots visualization (hotspots_service.cpp
:733-796 bundles pprof + flot JS to draw profiles in the browser).  The
equivalent here needs no bundled JS: a wall-clock sampler over
``sys._current_frames()`` (the managed-runtime stand-in for gperftools'
SIGPROF sampling) aggregates stacks, and the renderer emits a single
static SVG — rect layout identical to Brendan Gregg's flamegraph.pl,
hover detail via native ``<title>`` tooltips.
"""

from __future__ import annotations

import hashlib
import sys
import threading
import time
from html import escape
from typing import Dict, List, Tuple

Stack = Tuple[str, ...]  # root-first frame labels


def sample_stacks(
    seconds: float, hz: int = 100, skip_current: bool = True
) -> Dict[Stack, int]:
    """Sample every thread's Python stack for `seconds` at `hz`.
    Returns {root-first stack: sample count}.  The sampling thread
    itself (and, optionally, the calling handler's thread) is excluded
    so the profile shows the server's work, not the profiler's."""
    agg: Dict[Stack, int] = {}
    me = threading.get_ident()
    deadline = time.monotonic() + seconds
    period = 1.0 / hz
    while time.monotonic() < deadline:
        for tid, frame in sys._current_frames().items():
            if skip_current and tid == me:
                continue
            stack: List[str] = []
            f = frame
            while f is not None:
                code = f.f_code
                stack.append(f"{code.co_name} ({code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno})")
                f = f.f_back
            key = tuple(reversed(stack))
            agg[key] = agg.get(key, 0) + 1
        time.sleep(period)
    return agg


class _Node:
    __slots__ = ("name", "value", "children")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self.children: Dict[str, _Node] = {}


def _build_trie(stacks: Dict[Stack, float]) -> _Node:
    root = _Node("all")
    for stack, weight in stacks.items():
        root.value += weight
        node = root
        for frame in stack:
            child = node.children.get(frame)
            if child is None:
                child = node.children[frame] = _Node(frame)
            child.value += weight
            node = child
    return root


def _color(name: str) -> str:
    # stable warm palette per frame name (flamegraph.pl hash colors)
    h = hashlib.md5(name.encode()).digest()
    r = 205 + h[0] % 50
    g = 60 + h[1] % 130
    b = h[2] % 60
    return f"rgb({r},{g},{b})"


def render_flamegraph(
    stacks: Dict[Stack, float],
    title: str = "flame graph",
    unit: str = "samples",
    width: int = 1200,
) -> str:
    """Aggregated stacks → standalone SVG string."""
    root = _build_trie(stacks)
    if root.value <= 0:
        return (
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
            f'height="40"><text x="8" y="24">no samples</text></svg>'
        )
    row_h = 17
    # depth of the trie bounds the image height
    def depth(n: _Node) -> int:
        return 1 + max((depth(c) for c in n.children.values()), default=0)

    levels = depth(root)
    height = (levels + 2) * row_h + 28
    out = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" font-family="monospace" font-size="11">',
        '<style>rect:hover{stroke:#000;stroke-width:1}</style>',
        f'<text x="8" y="18" font-size="14">{escape(title)} '
        f'— {root.value:.0f} {escape(unit)}</text>',
    ]
    min_w = 0.5  # px: below this a frame (and its children) is elided

    def emit(node: _Node, x: float, y: int, w: float):
        if w < min_w:
            return
        pct = 100.0 * node.value / root.value
        label = node.name if w > 60 else ""
        out.append(
            f'<g><title>{escape(node.name)} — {node.value:.0f} '
            f"{escape(unit)} ({pct:.2f}%)</title>"
            f'<rect x="{x:.2f}" y="{y}" width="{max(w - 0.3, 0.3):.2f}" '
            f'height="{row_h - 1}" fill="{_color(node.name)}" rx="1"/>'
            + (
                f'<text x="{x + 3:.2f}" y="{y + 12}" '
                f'clip-path="inset(0)">{escape(label[: int(w // 7)])}</text>'
                if label
                else ""
            )
            + "</g>"
        )
        cx = x
        for child in sorted(
            node.children.values(), key=lambda c: -c.value
        ):
            cw = w * child.value / node.value
            emit(child, cx, y - row_h, cw)
            cx += cw

    base_y = height - row_h - 4
    emit(root, 0.0, base_y, float(width))
    out.append("</svg>")
    return "".join(out)
