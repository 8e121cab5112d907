"""Process-wide ring fast-path counters (docs/fastpath.md).

Step-log counters for the submission/response ring lanes, exposed on
/metrics (module listed in analysis.invariants.METRIC_MODULES so the
metrics lint render-checks them).  Counts, never timing — the proof
that the windowed paths aren't silently degraded is arithmetic:

- ``rpc_ring_crossings``   Python↔C boundary crossings on the ring
  lane: client submit windows + harvest batches + windowed shard
  fan-out sub-windows.  A healthy windowed workload shows
  crossings ≪ calls.
- ``rpc_ring_windows``     submission windows flushed (client side,
  one ``mux_submit_many`` each) + shard fan-out windows (one per
  SHARD, not per key).
- ``rpc_ring_flush_bursts`` server response-ring bursts: each is one
  ``ns_send_burst`` → one writev burst flushing a harvested window's
  replies for one connection.

Import-light and jax-free by construction (the lint imports this
module in a bare interpreter).
"""

from __future__ import annotations

from incubator_brpc_tpu_torch.metrics.reducer import Adder

rpc_ring_crossings = Adder(0).expose("rpc_ring_crossings")
rpc_ring_windows = Adder(0).expose("rpc_ring_windows")
rpc_ring_flush_bursts = Adder(0).expose("rpc_ring_flush_bursts")


def snapshot() -> dict:
    """Current counter values (the /status ``ring:`` line reads this)."""
    return {
        "crossings": rpc_ring_crossings.get_value(),
        "windows": rpc_ring_windows.get_value(),
        "flush_bursts": rpc_ring_flush_bursts.get_value(),
    }
