"""Disaggregated-serving metrics (``rpc_serving_*``; registered at
import — module listed in analysis.invariants.METRIC_MODULES so the
metrics lint render-checks them; docs/serving.md).

Counts, never timing — the proofs the serving tier makes are
arithmetic:

- ``rpc_serving_sessions``       sessions opened through the router
  (one per ``SessionChannel.generate``; a session that migrates N
  times still counts ONCE here).
- ``rpc_serving_migrations``     completed decode-replica hops: the
  target replica re-pulled the SAME cached KV and resumed emission.
- ``rpc_serving_kv_bytes``       KV bytes shipped HBM→HBM into the
  cache tier (prefill ships + migration checkpoints; adds read
  ``.nbytes`` metadata only — never the arrays).
- ``rpc_serving_prefill_reuse``  decode admissions that pulled
  EXISTING KV instead of recomputing prefill — every admission beyond
  a session's first.  ``prefill_reuse ≥ migrations`` on a healthy
  tier; a reuse count stuck at 0 under migration load means prefill
  is silently re-executing.

Import-light and jax-free by construction (the lint imports this
module in a bare interpreter).
"""

from __future__ import annotations

from incubator_brpc_tpu_torch.metrics.reducer import Adder

serving_sessions = Adder(0).expose("rpc_serving_sessions")
serving_migrations = Adder(0).expose("rpc_serving_migrations")
serving_kv_bytes = Adder(0).expose("rpc_serving_kv_bytes")
serving_prefill_reuse = Adder(0).expose("rpc_serving_prefill_reuse")


def snapshot() -> dict:
    """Current counter values (the /status ``serving:`` line and the
    ``/serving`` builtin read this)."""
    return {
        "sessions": serving_sessions.get_value(),
        "migrations": serving_migrations.get_value(),
        "kv_bytes": serving_kv_bytes.get_value(),
        "prefill_reuse": serving_prefill_reuse.get_value(),
    }
