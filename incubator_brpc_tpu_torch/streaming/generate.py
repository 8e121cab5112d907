"""Continuous-batched token-streaming inference — the streaming
subsystem's flagship workload (docs/streaming.md).

Two pieces:

``DecodeLoop`` — the serving engine.  One decode thread runs decode
STEPS: every step stacks the states of all live rows into ONE padded
device execution (batching.fused.FusedKernel, padded up to the
policy's bucket so jit retraces stay bounded exactly like the
micro-batchers), derives one token per row, and emits it.  This is
continuous batching:

  * a request ADMITTED while others are mid-generation joins the very
    next step's fused window (no waiting for the batch to drain);
  * a row that finishes (max_tokens) or cancels (client disconnect,
    slow-consumer eviction, emit failure) RETIRES between steps,
    freeing its slot within one step;
  * one row's emit failure never poisons its step-mates (the per-row
    isolation contract mirrors the batcher's _Scatter).

``GenerateService`` — the RPC surface, three shapes over one loop:

  * ``Generate`` with a negotiated stream: one token FRAME per step on
    the stream, final frame then server-side CLOSE.  Tokens traverse a
    per-row outbox (ExecutionQueue) so a slow consumer's flow-control
    backpressure blocks ITS writer task, never the decode loop; past
    ``outbox_max_tokens`` the row is evicted.
  * ``Generate`` without a stream: unary fallback — the full
    generation (still continuously batched) returns in one response.
  * ``GenerateSSE`` (HTTP): ``data: <token>\\n\\n`` events on a
    chunked ``text/event-stream`` response — a browser-shaped client
    observes tokens progressively with zero framework code.

The "model" is a deterministic toy recurrence (state = tanh(S @ W),
token = f(state)): real transformer decode plugs into ``step_fn``
without touching the serving machinery.

Port of the JAX package's ``streaming/generate.py``.  Where it differs:

- **An explicit device.**  ``DecodeLoop(device=None)`` runs on the card
  of chip 0 (the port's ``parallel/mesh.py`` helper) and raises without
  one; pass ``torch.device("cpu")`` for the plain CPU run.  W (drawn
  from ``default_rng(1234)`` exactly as the JAX loop draws it) and each
  prompt's seed state are placed there once, at first use and at
  admission.
- **The step is torch.**  ``tanh(S @ W)`` is ``torch.matmul`` in
  float32 with TF32 off (PyTorch's default): the JAX package leaves the
  product to XLA, so it is no TPU kernel.  Summation order differs
  from XLA's, so states agree with the JAX loop within a float32
  tolerance, not bit for bit; tokens agree unless a row's sum lies
  within that tolerance of a token boundary.
- **Row states are views.**  ``row.state = out[i]`` keeps the step's
  (pad, dim) output alive until every row of the step has moved on;
  the cache store compacts such a view before it stores it.
- **The SSE front.**  ``GenerateSSE`` streams the same host token
  strings ``emit`` hands the stream path, as ``data:`` events on the
  http protocol's progressive attachment.
"""

from __future__ import annotations

import hashlib
import itertools
import threading
import time as _time
from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.analysis.device_witness import allowed_transfer
from incubator_brpc_tpu_torch.batching.fused import FusedKernel
from incubator_brpc_tpu_torch.batching.policy import BatchPolicy
from incubator_brpc_tpu_torch.observability.profiling import hbm_account, kernel_section
from incubator_brpc_tpu_torch.parallel.mesh import device_for_chip
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest, EchoResponse
from incubator_brpc_tpu_torch.runtime.execution_queue import ExecutionQueue
from incubator_brpc_tpu_torch.server.service import Service, ServiceStub, rpc_method
from incubator_brpc_tpu_torch.streaming.stream import Stream, StreamHandler, StreamOptions
from incubator_brpc_tpu_torch.utils.logging import log_error

# Default decode-window contract: fuse up to 32 live rows per step,
# padded to power-of-two buckets so the step kernel retraces at most
# 6 times (the batchers' bucket discipline applied to the decode loop).
GenPolicy = BatchPolicy(
    max_batch_size=32,
    max_wait_us=0,
    padding_buckets=(1, 2, 4, 8, 16, 32),
)

_row_uid = itertools.count(1)

# HBM heap profiler (observability/profiling.py): each live row's
# device-resident state row charges here from its first device step
# until retire — /hotspots/hbm shows what continuous batching pins
_ROW_ACCT = hbm_account("decode.rows")


class _Row:
    __slots__ = (
        "uid", "slot", "prompt", "state", "max_tokens", "tokens_done",
        "emit", "on_finish", "cancelled", "cancel_reason", "admitted_step",
        "loop", "hbm_charge",
    )

    def __init__(self, prompt: str, max_tokens: int, emit, on_finish, loop):
        self.uid = next(_row_uid)
        self.slot = -1
        self.prompt = prompt
        self.state = None
        self.max_tokens = max_tokens
        self.tokens_done = 0
        self.emit = emit
        self.on_finish = on_finish
        self.cancelled = False
        self.cancel_reason = ""
        self.admitted_step = -1
        self.loop = loop
        self.hbm_charge = 0  # _ROW_ACCT adopt return (released at retire)

    def cancel(self, reason: str = "cancelled") -> None:
        """Retire this row at the next step boundary (frees its slot
        within one step).  Callable from any thread — the stream's
        on_closed/on_failed path calls it on client disconnect."""
        if self.cancelled:
            return
        self.cancelled = True
        self.cancel_reason = reason
        loop = self.loop
        if loop is not None:
            loop._kick()


class DecodeLoop:
    """One process-wide decode engine; see the module docstring."""

    def __init__(
        self,
        policy: Optional[BatchPolicy] = None,
        dim: int = 16,
        vocab: int = 32000,
        step_delay_s: float = 0.0,
        step_fn: Optional[Callable] = None,
        device=None,
    ):
        self.policy = policy or GenPolicy
        self.device = device_for_chip(0, device)
        self.dim = dim
        self.vocab = vocab
        # artificial inter-step pacing (tests/examples that need to
        # observe mid-stream admission deterministically); 0 in prod
        self.step_delay_s = step_delay_s
        # the step kernel returns (new_states, per-row sums) so token
        # derivation needs ONE tiny (pad,) pull per step instead of the
        # full padded state matrix; buckets arm the retrace witness
        self._kernel = FusedKernel(
            self._with_token_sums(step_fn or self._default_step),
            label="decode.step",
            batch_buckets=self.policy.padding_buckets or None,
        )
        rng = np.random.default_rng(1234)
        self._w = (rng.standard_normal((dim, dim)) / np.sqrt(dim)).astype(
            np.float32
        )
        self._w_dev = None  # device-resident weights (placed lazily)
        self._pad_row = None  # cached device zero row for padding
        self._cv = threading.Condition()
        self._pending: deque = deque()
        self._live: List[_Row] = []
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        # -- stats (tests + bench + /status assertions) --
        self.steps = 0
        self.rows_admitted = 0
        self.rows_retired = 0
        self.rows_cancelled = 0
        # rows that joined a step while others were already live — the
        # continuous-batching signature the bench guard pins
        self.mid_stream_joins = 0
        self.max_fused = 0
        # (step_idx, (row uids fused)) ring for the sharing assertions
        self.step_log: deque = deque(maxlen=1024)

    @staticmethod
    def _default_step(w, s):
        return torch.tanh(s @ w)

    @staticmethod
    def _with_token_sums(fn):
        """Fuse the per-row sum the token hash needs into the step
        kernel itself, so the host only ever pulls a (pad,) vector."""

        def step(w, s):
            new = fn(w, s)
            return new, torch.sum(new, dim=-1)

        return step

    def _ensure_w(self):
        """Weights live on device once: without this, the numpy `_w`
        would re-cross host→device on EVERY step dispatch."""
        if self._w_dev is None:
            self._w_dev = torch.from_numpy(self._w).to(self.device)
        return self._w_dev

    # ---- admission ----------------------------------------------------------
    def admit(
        self,
        prompt: str,
        max_tokens: int,
        emit: Callable,
        on_finish: Optional[Callable] = None,
        state=None,
    ) -> _Row:
        """Queue one generation request; it joins the next decode
        step's fused window (or waits for a free slot under full load).
        ``emit(token, row)`` runs on the decode thread per token and
        MUST NOT block; ``on_finish(row, ok)`` runs once at retire.

        ``state`` injects a (dim,) device-resident starting state
        instead of the prompt-derived init — the disaggregated path
        (serving/decode.py) admits with KV pulled from the cache tier,
        so the array joins the fused window without ever crossing to
        host."""
        row = _Row(prompt, max(1, int(max_tokens)), emit, on_finish, self)
        if state is not None:
            row.state = state
        else:
            seed = int.from_bytes(
                hashlib.blake2s(prompt.encode(), digest_size=8).digest(),
                "big",
            )
            rng = np.random.default_rng(seed)
            row.state = torch.from_numpy(
                rng.standard_normal(self.dim).astype(np.float32)
            ).to(self.device)
        with self._cv:
            if self._stopped:
                row.cancelled = True
                row.cancel_reason = "decode loop stopped"
            else:
                self._pending.append(row)
                self._ensure_thread_locked()
            self._cv.notify_all()
        if row.cancelled and row.on_finish is not None:
            row.on_finish(row, False)
        return row

    def _ensure_thread_locked(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._drive, name="decode-loop", daemon=True
            )
            self._thread.start()

    def _kick(self) -> None:
        with self._cv:
            self._cv.notify_all()

    def live_rows(self) -> int:
        with self._cv:
            return len(self._live)

    def pending_rows(self) -> int:
        with self._cv:
            return len(self._pending)

    def describe(self) -> dict:
        return {
            "steps": self.steps,
            "live": self.live_rows(),
            "pending": self.pending_rows(),
            "admitted": self.rows_admitted,
            "retired": self.rows_retired,
            "cancelled": self.rows_cancelled,
            "mid_stream_joins": self.mid_stream_joins,
            "max_fused": self.max_fused,
        }

    def prewarm(self) -> None:
        """Trace the step kernel at every padding bucket so no jit
        compile lands inside a serving (or measured) window; on the card
        this also settles cuBLAS's choice for each bucket's product."""
        w = self._ensure_w()
        for b in self.policy.padding_buckets or (self.policy.max_batch_size,):
            self._kernel(w, torch.zeros((b, self.dim), device=self.device))

    def stop(self) -> None:
        """Cancel everything and stop the decode thread (idempotent)."""
        with self._cv:
            self._stopped = True
            rows = list(self._pending) + list(self._live)
            self._cv.notify_all()
            thread = self._thread
        for row in rows:
            row.cancel("decode loop stopped")
        if thread is not None and thread.is_alive():
            thread.join(timeout=5.0)

    # ---- the decode thread --------------------------------------------------
    def _drive(self) -> None:
        while True:
            with self._cv:
                while not self._stopped and not self._pending and not self._live:
                    self._cv.wait()
                stopped = self._stopped
                if stopped:
                    to_finish = list(self._pending) + list(self._live)
                    self._pending.clear()
                    self._live = []
                else:
                    to_finish = self._admit_and_retire_locked()
                rows = list(self._live)
            # user callbacks (socket writes, done()) never run under
            # the loop lock — they may be slow or re-enter admit()
            for row in to_finish:
                self._finish_row(row, ok=False)
            if stopped:
                return
            if not rows:
                continue
            try:
                self._step(rows)
            except Exception as e:  # noqa: BLE001 — a step-level fault
                # (kernel failure) retires the whole window as failed,
                # but the loop itself survives for future admissions
                log_error("decode step raised: %r", e)
                for row in rows:
                    row.cancel(f"decode step failed: {e}")
            if self.step_delay_s:
                _time.sleep(self.step_delay_s)

    def _admit_and_retire_locked(self) -> List[_Row]:
        """Runs under the cv.  Returns rows to finish OUTSIDE the lock.
        Retire runs before admit so freed slots are admittable in the
        SAME pass — "a cancel at step k frees the slot within one
        step"."""
        to_finish = []
        kept = []
        for row in self._live:
            (to_finish if row.cancelled else kept).append(row)
        self._live = kept
        while self._pending and len(self._live) < self.policy.max_batch_size:
            row = self._pending.popleft()
            if row.cancelled:
                to_finish.append(row)
                continue
            row.admitted_step = self.steps
            if self._live:
                self.mid_stream_joins += 1
            self._live.append(row)
            self.rows_admitted += 1
        return to_finish

    def _finish_row(self, row: _Row, ok: bool) -> None:
        if row.hbm_charge:
            _ROW_ACCT.release(row.hbm_charge)
            row.hbm_charge = 0
        self.rows_retired += 1
        if not ok:
            self.rows_cancelled += 1
        fin, row.on_finish = row.on_finish, None
        if fin is not None:
            try:
                fin(row, ok)
            except Exception as e:  # noqa: BLE001
                log_error("generate on_finish raised: %r", e)

    def _step(self, rows: List[_Row]) -> None:
        """ONE fused padded device execution for every live row, one
        token emitted per row."""
        n = len(rows)
        pad_to = self.policy.bucket_for(n)
        # states stay device-resident across steps: stack on device, run
        # the fused kernel, keep the new states on device — only the
        # (pad,) token sums cross to the host, under a manifested scope
        states = [row.state for row in rows]
        if pad_to > n:
            if self._pad_row is None or self._pad_row.shape[0] != self.dim:
                self._pad_row = torch.zeros((self.dim,), device=self.device)
            states.extend([self._pad_row] * (pad_to - n))
        # device window: stack + fused step + the manifested (pad,)
        # token-sums pull is the sanctioned completion point
        with kernel_section("decode.step"):
            stacked = torch.stack(states)
            out, sums = self._kernel(self._ensure_w(), stacked)
            with allowed_transfer("decode.token-sums"):
                sums_host = sums.cpu().numpy()
        step_idx = self.steps
        self.steps += 1
        self.step_log.append((step_idx, tuple(r.uid for r in rows)))
        if n > self.max_fused:
            self.max_fused = n
        finished = []
        for i, row in enumerate(rows):
            if row.cancelled:
                continue
            row.state = out[i]
            if not row.hbm_charge:
                # first device-resident state: one (dim,) row joins the
                # ledger (adopt reads .nbytes — metadata only)
                row.hbm_charge = _ROW_ACCT.adopt(row.state)
            token = f"t{int(abs(float(sums_host[i])) * 1e4) % self.vocab}"
            row.tokens_done += 1
            try:
                row.emit(token, row)  # ← per-row sink; must not block
            except Exception as e:  # noqa: BLE001 — isolation: one
                # row's sink failure never poisons its step-mates
                log_error("generate emit raised: %r", e)
                row.cancel(f"emit failed: {e}")
                continue
            if row.tokens_done >= row.max_tokens:
                finished.append(row)
        if finished:
            with self._cv:
                for row in finished:
                    if row in self._live:
                        self._live.remove(row)
            for row in finished:
                self._finish_row(row, ok=True)


class _StreamSession(StreamHandler):
    """Per-request glue between one decode row and its stream: a
    bounded outbox (ExecutionQueue) keeps token ORDER while moving the
    flow-control blocking off the decode thread — the decode loop
    emits into the queue and returns immediately; the queue's consumer
    task does the (possibly StreamWait-blocked) stream.write.  Client
    disconnect (CLOSE/RST/socket death) cancels the row; an outbox
    deeper than ``max_tokens_queued`` evicts the slow consumer."""

    def __init__(self, service: "GenerateService", max_tokens_queued: int):
        self._service = service
        self._max_queued = max_tokens_queued
        self._q = ExecutionQueue(self._drain)
        self._lock = threading.Lock()
        self._depth = 0
        self._dead = False
        self.stream: Optional[Stream] = None
        self.row: Optional[_Row] = None

    # -- decode-thread side (never blocks) --
    def emit(self, token: str, row: _Row) -> None:
        with self._lock:
            if self._dead:
                row.cancel("stream gone")
                return
            self._depth += 1
            if self._depth > self._max_queued:
                # slow consumer: its backlog must not pin memory while
                # the decode loop keeps producing for everyone else
                self._dead = True
                row.cancel("slow consumer: outbox overflow")
                return
        self._q.execute(("tok", token))

    def finish(self, row: _Row, ok: bool) -> None:
        self._q.execute(("fin", ok))

    # -- outbox consumer (may block in StreamWait) --
    def _drain(self, batch) -> None:
        for kind, val in batch:
            stream = self.stream
            if kind == "tok":
                with self._lock:
                    self._depth -= 1
                    if self._dead:
                        continue
                rc = stream.write(val) if stream is not None else errors.ECLOSE
                if rc != 0:
                    with self._lock:
                        self._dead = True
                    if self.row is not None:
                        self.row.cancel(f"stream write failed: {rc}")
            else:  # fin — after every queued token, in order
                ok = val
                with self._lock:
                    dead, self._dead = self._dead, True
                if stream is not None and not dead:
                    if ok:
                        stream.close()  # clean close = generation complete
                    else:
                        # truncated generation (decode fault / loop
                        # stopped) must surface as an ERROR on the
                        # client, not a clean end-of-stream
                        stream.reset(
                            errors.ECANCELED,
                            (self.row.cancel_reason if self.row else "")
                            or "generation aborted",
                        )

    # -- peer events --
    def on_closed(self, stream: Stream) -> None:
        with self._lock:
            self._dead = True
        if self.row is not None:
            self.row.cancel("client closed stream")

    def on_failed(self, stream: Stream, code: int, text: str) -> None:
        with self._lock:
            self._dead = True
        if self.row is not None:
            self.row.cancel(f"stream failed: {text}")


class GenerateService(Service):
    """Token-streaming generation over the decode loop (see module
    docstring).  EchoRequest.message = prompt, EchoRequest.code =
    token count (default_tokens when 0)."""

    SERVICE_NAME = "GenerateService"

    def __init__(
        self,
        loop: Optional[DecodeLoop] = None,
        default_tokens: int = 16,
        outbox_max_tokens: int = 1024,
        stream_options: Optional[StreamOptions] = None,
    ):
        self.loop = loop or DecodeLoop()
        self.default_tokens = default_tokens
        self.outbox_max_tokens = outbox_max_tokens
        self._stream_options = stream_options
        # fallback-shape counters (the bench smoke guard pins these: a
        # "streaming" bench whose rows all land here is lying)
        self.streamed_rows = 0
        self.unary_rows = 0
        self.sse_rows = 0

    def close(self) -> None:
        self.loop.stop()

    def _tokens_for(self, request) -> int:
        return int(request.code) if request.code > 0 else self.default_tokens

    @rpc_method(EchoRequest, EchoResponse)
    def Generate(self, controller, request, response, done):
        n_tokens = self._tokens_for(request)
        if controller._remote_stream_settings is None:
            # unary fallback: still continuously batched, one response
            self.unary_rows += 1
            tokens: List[str] = []

            def emit(tok, row):
                tokens.append(tok)

            def finish(row, ok, controller=controller, response=response):
                if not ok:
                    controller.set_failed(
                        errors.ECANCELED, row.cancel_reason or "cancelled"
                    )
                else:
                    response.message = " ".join(tokens)
                    response.code = len(tokens)
                done()

            self.loop.admit(request.message, n_tokens, emit, finish)
            return
        self.streamed_rows += 1
        session = _StreamSession(self, self.outbox_max_tokens)
        opts = self._stream_options or StreamOptions()
        stream = Stream.accept(controller, session, opts)
        session.stream = stream
        response.message = "streaming"
        response.code = n_tokens
        # respond FIRST: the response frame (carrying our stream
        # settings) must precede the first token frame on the wire, or
        # the client would RST the unknown stream id
        done()
        session.row = self.loop.admit(
            request.message, n_tokens, session.emit, session.finish
        )

    @rpc_method(EchoRequest, EchoResponse)
    def GenerateSSE(self, controller, request, response, done):
        """HTTP progressive path: Server-Sent Events on a chunked
        text/event-stream response — ``data: <token>`` per step,
        ``data: [DONE]`` then close at the end."""
        self.sse_rows += 1
        pa = controller.create_progressive_attachment(
            content_type="text/event-stream"
        )
        # slow-consumer bound, mirroring the stream path's outbox
        # eviction: past this many unsent bytes on the connection the
        # row is evicted instead of growing the socket queue forever
        backlog_cap = max(64, self.outbox_max_tokens) * 64

        def emit(tok, row, pa=pa):
            if pa.backlog_bytes() > backlog_cap:
                row.cancel("sse client too slow: backlog over cap")
                return
            if pa.write(f"data: {tok}\n\n") != 0:
                row.cancel("sse client gone")

        def finish(row, ok, pa=pa):
            if ok:
                pa.write("data: [DONE]\n\n")
            pa.close()

        self.loop.admit(request.message, self._tokens_for(request), emit, finish)
        done()


def generate_stub(channel) -> ServiceStub:
    return ServiceStub(channel, GenerateService)
