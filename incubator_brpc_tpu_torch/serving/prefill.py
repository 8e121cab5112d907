"""Prefill plane — batched sharded prompt prefill producing
HBM-resident KV state (docs/serving.md).

``PrefillService`` runs prompt prefill as ONE padded batched device
execution (the batchers' bucket discipline; a mesh upgrades the layer GEMMs
to ``batching/sharded.py`` ShardedFusedKernel executions with one
collective merge each) and ships the resulting per-session KV stack
HBM→HBM into the cache tier under ``kv:<session>@<epoch>#<layer>``
keys (serving/session.py grammar).  Three load-bearing properties:

* **Zero host crossings.**  Layer arrays go kernel → ``store.set``;
  the HBM store adopts raw device arrays by identity and the
  CacheChannel ships them as DeviceRef segments — witness-armed tests
  prove the whole prefill→cache→decode path pulls nothing to host.
* **Layer 0 IS the decode state.**  The KV stack's first layer is the
  prompt-derived recurrence state ``DecodeLoop.admit`` would compute,
  so a decode pod admitting with pulled KV continues the EXACT token
  sequence the monolithic ``GenerateService`` would emit — the
  disagg-vs-monolith equivalence tests ride this.
* **A KV epoch is complete or absent.**  Layers ship in order and a
  failed ship (the ``kv.ship`` chaos site, budget overflow, a cache
  error) deletes the epoch's already-shipped keys before surfacing
  ONE ERPC error to the client — never a silent recompute, and never
  a partial key set a decode admission could half-pull.

Port of the JAX package's ``serving/prefill.py``.  ``PrefillService``
takes an explicit ``device`` (default: the card of chip 0, raising
without one).  The layer stack is ``torch.matmul`` + ``torch.tanh`` in
float32 with TF32 off, one eager call through ``FusedKernel`` per
padded window; layer 0 is the seed state itself, bit-identical to the
decode loop's.  The layer rows handed to the store are views of the
(n_layers, bucket, dim) stack: the store keeps a compact copy of each,
so the stack is freed once shipped.  With ``mesh=`` the n_layers - 1
layer products run through ``batching/sharded.ShardedFusedKernel``
(label ``PrefillService.Prefill``): W row-sharded over the mesh's
"chip" axis, one product per chip and one chip-order psum per layer,
``torch.tanh`` on the merged result; the device then defaults to the
mesh's first chip's.
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.batching.fused import FusedKernel
from incubator_brpc_tpu_torch.batching.policy import BatchPolicy
from incubator_brpc_tpu_torch.chaos import injector as _chaos
from incubator_brpc_tpu_torch.observability.profiling import hbm_account, kernel_section
from incubator_brpc_tpu_torch.observability.span import Span
from incubator_brpc_tpu_torch.parallel.mesh import device_for_chip
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest, EchoResponse
from incubator_brpc_tpu_torch.server.service import Service, ServiceStub, rpc_method
from incubator_brpc_tpu_torch.serving import metrics as _metrics
from incubator_brpc_tpu_torch.serving.session import kv_layer_keys

# Prefill-window contract: fuse up to 32 concurrent prompts per padded
# execution (same buckets as the decode loop's GenPolicy).
PrefillPolicy = BatchPolicy(
    max_batch_size=32,
    max_wait_us=0,
    padding_buckets=(1, 2, 4, 8, 16, 32),
)

# the shipped KV stacks charge the HBM ledger under their own tag
# until the cache store adopts them (the store re-charges under
# cache.values) — /hotspots/hbm shows what prefill pins in flight
_KV_ACCT = hbm_account("serving.prefill_kv")


class KvShipError(RuntimeError):
    """A KV SET into the cache tier failed (chaos drop, budget, cache
    error).  Callers surface it as ONE ERPC failure — never a silent
    local recompute."""


def prompt_seed_state(prompt: str, dim: int) -> np.ndarray:
    """EXACTLY ``DecodeLoop.admit``'s prompt-derived init — layer 0 of
    the KV stack must be bit-identical so decode-with-pulled-KV
    continues the monolithic token sequence."""
    seed = int.from_bytes(
        hashlib.blake2s(prompt.encode(), digest_size=8).digest(), "big"
    )
    rng = np.random.default_rng(seed)
    return rng.standard_normal(dim).astype(np.float32)


def ship_kv_layers(store, keys: Sequence[bytes], layers: Sequence) -> int:
    """Ship one complete epoch key set into the cache tier, in layer
    order, each SET gated by the ``kv.ship`` chaos site.  Returns the
    bytes shipped.  On ANY failure the already-shipped keys of this
    epoch are deleted first (complete-or-absent), then KvShipError
    raises — the caller maps it to an ERPC error."""
    span = Span.create_collective("Serving", "kv.ship")
    shipped: List[bytes] = []
    nbytes = 0
    try:
        for key, arr in zip(keys, layers):
            if _chaos.armed:
                spec = _chaos.check("kv.ship", method=key.decode("latin1"))
                if spec is not None:
                    if spec.action == "delay_us":
                        _chaos.sleep_us(spec.arg)
                    elif spec.action == "drop":
                        raise KvShipError(
                            f"kv.ship dropped for {key.decode('latin1')}"
                        )
            try:
                ok = store.set(key, arr)
            except Exception as e:  # noqa: BLE001 — cache-tier error
                raise KvShipError(f"kv set failed for {key!r}: {e}") from e
            if ok is False:  # HBM store: value over budget
                raise KvShipError(f"kv value over cache budget: {key!r}")
            shipped.append(key)
            nbytes += int(arr.nbytes)
        if span is not None:
            span.annotate(f"shipped {len(shipped)} layers {nbytes}B")
        _metrics.serving_kv_bytes << nbytes
        return nbytes
    except KvShipError:
        for key in shipped:
            try:
                store.delete(key)
            except Exception:  # noqa: BLE001 — best-effort unship; a
                # leftover key from a dead epoch is garbage, not a
                # correctness hazard (admissions pull complete sets)
                pass
        raise
    finally:
        if span is not None:
            span.end()


class PrefillService(Service):
    """The prefill pod's RPC surface + in-process engine.

    ``store`` is the cache tier: an ``HBMCacheStore`` (co-resident
    pod; raw-array identity adoption) or a ``CacheChannel`` (remote
    tier; DeviceRef zero-copy over ICI) — anything with
    ``set/delete``.  ``mesh`` upgrades the layer GEMMs to sharded
    executions (``ShardedFusedKernel``); without one the fused
    single-card kernel runs the same math.  ``device`` holds the seeds
    and the KV stack (default: the mesh's first chip's device with a
    mesh, else the card of chip 0; raises without a card unless
    given).

    EchoRequest.message = JSON ``{"session", "prompt"}``;
    EchoResponse.message = JSON ``{"session", "epoch", "n_layers",
    "dim", "kv_bytes", "prefill_executions"}``.
    """

    SERVICE_NAME = "PrefillService"

    def __init__(
        self,
        store,
        dim: int = 16,
        n_layers: int = 4,
        mesh=None,
        policy: Optional[BatchPolicy] = None,
        device=None,
    ):
        if n_layers < 1:
            raise ValueError("n_layers must be >= 1")
        if device is None and mesh is not None:
            device = mesh.devices.flat[0]
        self.device = device_for_chip(0, device)
        self.store = store
        self.dim = dim
        self.n_layers = n_layers
        self.policy = policy or PrefillPolicy
        self._lock = threading.Lock()
        # deterministic toy "model": same W as the decode loop (seeded
        # 1234) so layer hops and decode steps share one recurrence
        rng = np.random.default_rng(1234)
        self._w = (rng.standard_normal((dim, dim)) / np.sqrt(dim)).astype(
            np.float32
        )
        self._w_dev = None
        self._sharded = None
        if mesh is not None:
            from incubator_brpc_tpu_torch.batching.sharded import ShardedFusedKernel

            self._sharded = ShardedFusedKernel(
                mesh, label="PrefillService.Prefill"
            )
            self._w_dev = self._sharded.shard_param(self._w)
        self._kernel = FusedKernel(
            self._layers_fn(n_layers),
            label="prefill.layers",
            batch_buckets=self.policy.padding_buckets or None,
        )
        # -- step log (tests + /serving assertions; counts, not time) --
        self.batches = 0  # padded prefill executions
        self.sessions_prefilled = 0
        self.prefill_executions: Dict[str, int] = {}  # per session id
        self.ship_failures = 0

    # ---- the batched layer stack -------------------------------------------
    @staticmethod
    def _layers_fn(n_layers: int):
        def layers(w, s):
            out = [s]
            cur = s
            for _ in range(n_layers - 1):
                cur = torch.tanh(cur @ w)
                out.append(cur)
            return torch.stack(out)  # (n_layers, bucket, dim)

        return layers

    def _ensure_w(self):
        if self._w_dev is None:
            self._w_dev = torch.from_numpy(self._w).to(self.device)
        return self._w_dev

    def prewarm(self) -> None:
        """Trace the prefill kernel at every bucket so no jit compile
        lands inside a serving (or measured) window."""
        if self._sharded is not None:
            return  # sharded products count their traces on first use
        w = self._ensure_w()
        for b in self.policy.padding_buckets or (self.policy.max_batch_size,):
            self._kernel(w, torch.zeros((b, self.dim), device=self.device))

    def _layer_stack(self, seeds: np.ndarray):
        """(B, dim) host seeds → (n_layers, bucket, dim) device stack,
        ONE padded fused execution (one h2d copy of the seeds), or
        n_layers-1 sharded product+merge executions on a mesh."""
        n = seeds.shape[0]
        pad_to = self.policy.bucket_for(n)
        if pad_to > n:
            seeds = np.concatenate(
                [seeds, np.zeros((pad_to - n, self.dim), np.float32)]
            )
        with kernel_section("prefill.layers"):
            if self._sharded is not None:
                cur = torch.from_numpy(seeds).to(self.device)
                out = [cur]
                for _ in range(self.n_layers - 1):
                    cur = torch.tanh(self._sharded(self._w_dev, cur))
                    out.append(cur)
                return torch.stack(out)
            return self._kernel(
                self._ensure_w(), torch.from_numpy(seeds).to(self.device)
            )

    # ---- the engine ---------------------------------------------------------
    def prefill_sessions(
        self, requests: Sequence[Tuple[str, str]], epoch: int = 0
    ) -> Dict[str, dict]:
        """Prefill a window of (session, prompt) pairs as ONE batched
        execution, ship each session's KV stack, return per-session
        ``{"epoch", "n_layers", "dim", "kv_bytes", "prefill_executions"}``.
        Raises KvShipError on a failed ship (after unshipping the
        failed session's partial epoch) — the RPC surface maps it to
        EINTERNAL, and the router NEVER retries it silently."""
        if not requests:
            return {}
        seeds = np.stack(
            [prompt_seed_state(prompt, self.dim) for _, prompt in requests]
        )
        stack = self._layer_stack(seeds)
        charge = _KV_ACCT.adopt(stack)
        try:
            with self._lock:
                self.batches += 1
            out: Dict[str, dict] = {}
            for i, (session, _prompt) in enumerate(requests):
                keys = kv_layer_keys(session, epoch, self.n_layers)
                layers = [stack[layer, i] for layer in range(self.n_layers)]
                try:
                    nbytes = ship_kv_layers(self.store, keys, layers)
                except KvShipError:
                    with self._lock:
                        self.ship_failures += 1
                    raise
                with self._lock:
                    self.sessions_prefilled += 1
                    count = self.prefill_executions.get(session, 0) + 1
                    self.prefill_executions[session] = count
                out[session] = {
                    "session": session,
                    "epoch": epoch,
                    "n_layers": self.n_layers,
                    "dim": self.dim,
                    "kv_bytes": nbytes,
                    "prefill_executions": count,
                }
            return out
        finally:
            _KV_ACCT.release(charge)

    # ---- RPC surface --------------------------------------------------------
    @rpc_method(EchoRequest, EchoResponse)
    def Prefill(self, controller, request, response, done):
        try:
            req = json.loads(request.message)
            session = str(req["session"])
            prompt = str(req["prompt"])
        except (ValueError, KeyError, TypeError) as e:
            controller.set_failed(errors.EREQUEST, f"bad prefill request: {e}")
            done()
            return
        try:
            result = self.prefill_sessions(
                [(session, prompt)], epoch=int(req.get("epoch", 0))
            )
        except KvShipError as e:
            # the ERPC-not-silent-recompute contract: the client hears
            # about the failed ship and decides (docs/serving.md)
            controller.set_failed(errors.EINTERNAL, str(e))
            done()
            return
        response.message = json.dumps(result[session])
        done()


def prefill_stub(channel) -> ServiceStub:
    return ServiceStub(channel, PrefillService)
