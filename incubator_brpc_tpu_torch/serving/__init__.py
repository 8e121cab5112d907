"""Disaggregated LLM serving: prefill/decode split with HBM-resident
KV state and live session migration (docs/serving.md).

Three planes:

* ``serving/prefill.py`` — ``PrefillService``: batched (optionally
  mesh-sharded) prompt prefill; ships per-session KV stacks HBM→HBM
  into the cache tier under ``kv:<session>@<epoch>#<layer>`` keys.
* ``serving/decode.py`` — ``DecodeService``: admits a session by
  pulling its KV epoch in one fused DMGET and joining the continuous-
  batched ``DecodeLoop`` mid-stream; streamed-RPC + SSE token fronts;
  EOVERCROWDED shed at ``max_sessions``.
* ``serving/router.py`` — ``SessionChannel``: routes prefill → prefill
  tier, decode → a locality-picked replica; migrates live sessions on
  overload/death/request, re-pulling the SAME cached KV (prefill runs
  exactly once per session, proven by step log).

Plus ``serving/session.py`` (the kv naming grammar + per-session
state/registry, jax-free) and ``serving/metrics.py`` (the
``rpc_serving_*`` exposed variables).

Import-light: nothing here pulls jax — the engines import it lazily
inside device paths, and the builtin/metrics surfaces only touch the
jax-free modules.
"""

from incubator_brpc_tpu_torch.serving.session import (  # noqa: F401
    SessionRecord,
    format_kv_key,
    kv_layer_keys,
    open_session,
    parse_kv_key,
    sessions_snapshot,
)

__all__ = [
    "SessionRecord",
    "format_kv_key",
    "kv_layer_keys",
    "open_session",
    "parse_kv_key",
    "sessions_snapshot",
]
