"""Streaming observability — process-wide live-stream registry and the
``rpc_stream_*`` variables.

One registry serves three consumers:

  * ``/metrics``  — ``rpc_stream_live`` (live streams right now),
    ``rpc_stream_blocked_writers`` (writers currently parked in
    StreamWait), ``rpc_stream_feedback_rtt_us`` (time from the last
    DATA write to the FEEDBACK that acknowledged it — the flow-control
    loop's round trip), and frame counters in/out.
  * ``/status``   — the per-method live-stream table
    (:func:`streams_by_method`).
  * tests/bench   — the same numbers, read directly.

Registration is owned by streaming.stream: a Stream registers at
establish() and deregisters at close, so a stream that never
establishes (failed negotiation) never appears here.
"""

from __future__ import annotations

import threading
from typing import Dict, List

from incubator_brpc_tpu_torch.metrics.passive_status import PassiveStatus
from incubator_brpc_tpu_torch.metrics.recorder import IntRecorder
from incubator_brpc_tpu_torch.metrics.reducer import Adder

_lock = threading.Lock()
_live: dict = {}  # stream_id -> Stream (weak coupling: read-only views)

# frames that reached the wire / were routed to a stream, all methods
frames_out = Adder(0).expose("rpc_stream_frames_out_total")
frames_in = Adder(0).expose("rpc_stream_frames_in_total")
# writers currently blocked past the remote's unconsumed backlog
blocked_writers = Adder(0).expose("rpc_stream_blocked_writers")
# last-DATA→FEEDBACK round trip, microseconds (approximate by
# construction: feedback acknowledges consumption, not one frame)
feedback_rtt_us = IntRecorder().expose("rpc_stream_feedback_rtt_us")


def _live_count() -> int:
    return len(_live)


live_streams = PassiveStatus(_live_count).expose("rpc_stream_live")


def register(stream) -> None:
    with _lock:
        _live[stream.stream_id] = stream


def deregister(stream) -> None:
    with _lock:
        _live.pop(stream.stream_id, None)


def live() -> List:
    with _lock:
        return list(_live.values())


def streams_by_method() -> Dict[str, List[dict]]:
    """Live streams grouped by the negotiating RPC's full method name
    (the /status table)."""
    out: Dict[str, List[dict]] = {}
    for s in live():
        out.setdefault(s.method or "?", []).append(s.describe())
    return out
