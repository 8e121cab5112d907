"""Disaggregated LLM serving: prefill/decode split with HBM-resident
KV state and live session migration (docs/serving.md).

One prefill tier batches prompt prefills and ships each session's KV
stack into the HBM cache under ``kv:<session>@<epoch>#<layer>`` keys;
two decode replicas admit sessions by pulling that KV with one fused
DMGET and join their continuous-batched decode loops mid-stream.  The
SessionChannel router then demonstrates both migration shapes:

  * graceful — an operator rebalance checkpoints the live decode state
    under a new KV epoch and re-admits the session elsewhere;
  * crash    — a replica dies mid-generation and the session re-pulls
    the last complete KV epoch on a survivor, fast-forwarding past the
    tokens it already emitted.

Either way the session completes its exact token sequence with prefill
executed ONCE — migration re-uses the cached KV, never the prompt.

    python examples_torch/disagg_serving.py                # on the card
    python examples_torch/disagg_serving.py --device cpu   # the plain versions
"""

import os
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from incubator_brpc_tpu_torch.cache.store import HBMCacheStore
from incubator_brpc_tpu_torch.parallel.mesh import device_for_chip
from incubator_brpc_tpu_torch.serving.decode import DecodeService
from incubator_brpc_tpu_torch.serving.prefill import PrefillService
from incubator_brpc_tpu_torch.serving.router import SessionChannel
from incubator_brpc_tpu_torch.streaming.generate import DecodeLoop

DIM = 16
TOKENS = 40


def monolithic_reference(prompt, n, device):
    """The token sequence a single-box decode loop emits — disagg must
    match it exactly."""
    loop = DecodeLoop(dim=DIM, device=device)
    tokens, done = [], threading.Event()
    loop.admit(prompt, n, lambda t, r: tokens.append(t),
               lambda r, ok: done.set())
    assert done.wait(30)
    loop.stop()
    return tokens


def main():
    # the card of chip 0 unless --device names another; raises without one
    device = device_for_chip(0, sys.argv[sys.argv.index("--device") + 1]
                             if "--device" in sys.argv else None)
    store = HBMCacheStore(hbm_budget_bytes=1 << 24, device=device)
    prefill = PrefillService(store, dim=DIM, n_layers=3, device=device)
    replicas = [
        DecodeService(store, DecodeLoop(dim=DIM, step_delay_s=0.01, device=device),
                      name=f"decode-{i}")
        for i in range(2)
    ]
    ch = SessionChannel(prefill, replicas)
    try:
        # -- a plain session: prefill once, decode on one replica
        ref = monolithic_reference("the quick brown fox", 12, device)
        res = ch.generate("chat-1", "the quick brown fox", 12)
        assert res.tokens == ref, "disagg diverged from monolithic"
        print(f"chat-1: {len(res.tokens)} tokens == monolithic reference "
              f"(prefill executions: {res.prefill_executions})")

        # -- graceful migration: rebalance a session mid-generation
        first = threading.Event()
        out = {}

        def run():
            out["res"] = ch.generate(
                "chat-2", "tell me a story", TOKENS,
                on_token=lambda i, t: first.set(),
            )

        t = threading.Thread(target=run)
        t.start()
        assert first.wait(30)
        assert ch.migrate("chat-2", reason="operator rebalance")
        t.join(60)
        r2 = out["res"]
        log = [(m["kind"], m["from"]) for m in r2.record.migration_log]
        print(f"chat-2: migrated live with prefill reused — "
              f"{len(r2.tokens)} tokens, {r2.migrations} migration(s), "
              f"prefill executions: {r2.prefill_executions}, log: {log}")

        # -- crash migration: kill the owning replica mid-generation
        first2 = threading.Event()

        def run3():
            out["res3"] = ch.generate(
                "chat-3", "survive this", TOKENS,
                on_token=lambda i, t: first2.set(),
            )

        t3 = threading.Thread(target=run3)
        t3.start()
        assert first2.wait(30)
        owner = next(r for r in replicas if "chat-3" in
                     [e.session for e in r._entries.values()])
        owner.kill()
        t3.join(60)
        r3 = out["res3"]
        kinds = [m["kind"] for m in r3.record.migration_log]
        print(f"chat-3: survived replica death — {len(r3.tokens)} tokens, "
              f"migration kinds: {kinds}, "
              f"prefill executions: {r3.prefill_executions}")
        assert len(r3.tokens) == TOKENS
        assert r3.prefill_executions == 1
    finally:
        for r in replicas:
            r.close()


if __name__ == "__main__":
    main()
