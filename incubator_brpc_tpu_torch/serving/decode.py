"""Decode plane — KV-pulling session admission over the continuous-
batched DecodeLoop (docs/serving.md).

``DecodeService`` admits a session by pulling its KV stack from the
cache tier in ONE fused DMGET (``get_many`` over the epoch's per-layer
keys), injecting layer 0 as the row's device-resident state
(``DecodeLoop.admit(state=...)``), and joining the continuous-
batched loop mid-stream.  Tokens stream to the client over the
streaming subsystem: a negotiated streamed-RPC front (one
``<idx> <token>`` frame per step) and an SSE front — plus the unary
fallback the bench guard pins at zero on the streamed paths.

Exactly-once across replica hops is BY INDEX: every admission carries
``(ckpt_tokens, start_token)`` — the state it pulls has
``ckpt_tokens`` tokens folded in, and emission is suppressed until
``start_token`` (the crash-migration fast-forward re-derives the
suppressed tokens on device without re-emitting them; a graceful
checkpoint handoff has ``start_token == ckpt_tokens`` and fast-
forwards nothing).

A checkpoint (``checkpoint_session``) drains the row at a step
boundary and publishes the session's CURRENT state as a complete new
KV epoch (layer 0 = live state, upper layers re-adopted by identity —
no copies, no host crossing) before retiring the old epoch's keys:
the crash-resumable handoff discipline — at every instant some
complete epoch is pullable.

Overload is the admission tier's retry-elsewhere contract: a full (or
operator-shed) replica refuses the admission with EOVERCROWDED
(counted through ``server/admission.py note_shed``) and the session
router hops to another replica — the same code path a migration
takes.

Port of the JAX package's ``serving/decode.py``.  A ``DecodeService``
built without a ``loop`` makes a ``DecodeLoop`` on ``device`` (default:
the card of chip 0; raises without one).  A uint8 layer row pulled off
the wire becomes the (dim,) float32 state by a bitcast view on the
device (``Tensor.view(torch.float32)``), never crossing to the host.
The SSE front (``AdmitSSE``) writes ``data: <idx> <token>`` events on
the http protocol's progressive attachment, as the JAX package does.
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest, EchoResponse
from incubator_brpc_tpu_torch.server import admission as _admission
from incubator_brpc_tpu_torch.server.service import Service, ServiceStub, rpc_method
from incubator_brpc_tpu_torch.serving.session import kv_layer_keys
from incubator_brpc_tpu_torch.streaming.generate import DecodeLoop
from incubator_brpc_tpu_torch.streaming.stream import Stream, StreamHandler, StreamOptions


class AdmitError(RuntimeError):
    """Admission refused; ``code`` is the ERPC error the client gets
    (EOVERCROWDED = retry elsewhere, EINTERNAL = KV not pullable,
    ELOGOFF = replica dead)."""

    def __init__(self, code: int, text: str):
        super().__init__(text)
        self.code = code


def _as_state(value, dim: int, device):
    """A pulled layer value → (dim,) float32 device state.  Identity
    for in-process store hits; uint8 wire values (CacheChannel rows)
    BITCAST on device — the pull path never crosses to host.  Host
    bytes (a disabled store) are placed on the decode loop's ``device``."""
    if isinstance(value, (bytes, bytearray)):  # host-mode store only
        host = np.frombuffer(bytearray(value), dtype=np.float32)
        return torch.from_numpy(host).to(device)
    if value.dtype == torch.uint8:
        return value.contiguous().view(torch.float32).reshape(dim)
    return value


class _SessionEntry:
    __slots__ = ("session", "row", "layers", "kv_epoch", "ckpt_base",
                 "produced", "retired")

    def __init__(self, session: str, kv_epoch: int, ckpt_base: int, layers):
        self.session = session
        self.row = None
        self.layers = layers  # pulled device arrays (re-shipped at ckpt)
        self.kv_epoch = kv_epoch
        self.ckpt_base = ckpt_base  # tokens folded into the pulled state
        self.produced = 0  # tokens derived by THIS replica's row
        self.retired = threading.Event()


class DecodeService(Service):
    """One decode replica: RPC surface + in-process engine (the router
    drives either through the same entry points).

    EchoRequest.message = JSON ``{"session", "kv_epoch", "n_layers",
    "max_tokens", "start_token", "ckpt_tokens"}`` for ``Admit`` /
    ``AdmitSSE``; ``{"session", "new_epoch"}`` for ``Checkpoint``.
    """

    SERVICE_NAME = "DecodeService"

    def __init__(
        self,
        store,
        loop: Optional[DecodeLoop] = None,
        name: str = "decode-0",
        dim: int = 16,
        max_sessions: int = 32,
        outbox_max_tokens: int = 1024,
        stream_options: Optional[StreamOptions] = None,
        coords=None,
        device=None,
    ):
        self.store = store
        self.loop = loop or DecodeLoop(dim=dim, device=device)
        self.name = name
        self.dim = self.loop.dim
        self.max_sessions = max_sessions
        self.outbox_max_tokens = outbox_max_tokens
        self._stream_options = stream_options
        self.coords = coords  # (slice, chip) for locality-ordered picks
        self.overloaded = False  # operator/admission-pressure shed knob
        self.dead = False
        self._lock = threading.Lock()
        self._entries: Dict[str, _SessionEntry] = {}
        # -- step log (the exactly-once and fused-pull proofs) --
        self.admitted_sessions = 0
        self.shed_sessions = 0
        self.kv_pulls = 0
        self.fused_pulls = 0  # pulls that rode the fused DMGET gather
        self.checkpoints = 0
        self.streamed_rows = 0
        self.unary_rows = 0
        self.sse_rows = 0

    def close(self) -> None:
        self.loop.stop()

    def kill(self) -> None:
        """Replica death (the breaker-trip test shape): every live row
        retires failed, future admissions refuse with ELOGOFF."""
        self.dead = True
        self.loop.stop()

    def live_sessions(self) -> int:
        with self._lock:
            return len(self._entries)

    # ---- KV pull ------------------------------------------------------------
    def _pull_kv(self, session: str, kv_epoch: int, n_layers: int):
        """One fused DMGET over the epoch's layer keys → the pulled
        device arrays.  AdmitError(EINTERNAL) when the epoch's key set
        is not complete in the cache (nothing to resume from)."""
        keys = kv_layer_keys(session, kv_epoch, n_layers)
        res = self.store.get_many(keys)
        if isinstance(res, tuple):  # HBMCacheStore: (values, stacked)
            values, stacked = res
            fused = stacked is not None
        else:  # CacheChannel MGetResult
            values = [res.row(i) for i in range(len(keys))]
            fused = res.stacked is not None
        if any(v is None for v in values):
            missing = [
                k.decode("latin1")
                for k, v in zip(keys, values)
                if v is None
            ]
            raise AdmitError(
                errors.EINTERNAL,
                f"kv epoch incomplete in cache: missing {missing}",
            )
        with self._lock:
            self.kv_pulls += 1
            if fused:
                self.fused_pulls += 1
        return [_as_state(v, self.dim, self.loop.device) for v in values]

    # ---- admission ----------------------------------------------------------
    def admit_session(
        self,
        session: str,
        kv_epoch: int,
        n_layers: int,
        max_tokens: int,
        start_token: int = 0,
        ckpt_tokens: int = 0,
        emit: Optional[Callable] = None,
        on_finish: Optional[Callable] = None,
    ):
        """Pull the session's KV and join the decode loop.

        ``emit(idx, token)`` fires exactly once per absolute token
        index ≥ ``start_token`` (fast-forward indices are re-derived
        but suppressed); ``on_finish(ok)`` fires once at retire.
        Raises AdmitError — EOVERCROWDED means retry on another
        replica (the admission tier's contract)."""
        if self.dead:
            raise AdmitError(errors.ELOGOFF, f"replica {self.name} is dead")
        if start_token < ckpt_tokens:
            raise AdmitError(
                errors.EREQUEST,
                f"start_token {start_token} < ckpt_tokens {ckpt_tokens}: "
                "would re-emit already-delivered indices",
            )
        with self._lock:
            if self.overloaded or len(self._entries) >= self.max_sessions:
                self.shed_sessions += 1
                shed = True
            else:
                shed = False
        if shed:
            # the unified admission bookkeeping: this shed is visible
            # on /admission and rpc_admission_shed like any tier shed
            _admission.note_shed("DecodeService.Admit", None, "session_cap")
            raise AdmitError(
                errors.EOVERCROWDED,
                f"replica {self.name} overcrowded: retry elsewhere",
            )
        layers = self._pull_kv(session, kv_epoch, n_layers)
        entry = _SessionEntry(session, kv_epoch, ckpt_tokens, layers)
        suppress = start_token - ckpt_tokens

        def loop_emit(tok, row, entry=entry):
            idx = entry.ckpt_base + entry.produced
            entry.produced += 1
            if entry.produced <= suppress:
                return  # fast-forward: re-derived, never re-emitted
            if emit is not None:
                emit(idx, tok)

        def loop_finish(row, ok, entry=entry):
            with self._lock:
                cur = self._entries.get(session)
                if cur is entry:
                    del self._entries[session]
            entry.retired.set()
            if on_finish is not None:
                on_finish(ok)

        with self._lock:
            self._entries[session] = entry
            self.admitted_sessions += 1
        # remaining device steps: one per not-yet-derived token
        entry.row = self.loop.admit(
            session,
            max_tokens - ckpt_tokens,
            loop_emit,
            loop_finish,
            state=layers[0],
        )
        return entry

    # ---- migration drain ----------------------------------------------------
    def checkpoint_session(self, session: str, new_epoch: int) -> dict:
        """Drain the session's row at a step boundary and publish its
        live state as KV epoch ``new_epoch`` (complete set first, THEN
        retire the old epoch's keys — at every instant a complete
        epoch is pullable).  Returns ``{"ckpt_tokens", "kv_epoch",
        "kv_bytes"}``.  AdmitError(EINTERNAL) when the session is not
        here or the checkpoint ship fails (the caller falls back to
        crash-migration from the last complete epoch)."""
        from incubator_brpc_tpu_torch.serving.prefill import (
            KvShipError,
            ship_kv_layers,
        )

        with self._lock:
            entry = self._entries.get(session)
        if entry is None or entry.row is None:
            raise AdmitError(
                errors.EINTERNAL, f"no live session {session!r} on {self.name}"
            )
        entry.row.cancel("migrating: checkpoint handoff")
        if not entry.retired.wait(timeout=30.0):
            raise AdmitError(
                errors.EINTERNAL, f"session {session!r} failed to drain"
            )
        # the drained row's state has ckpt_base + produced tokens
        # folded in; it becomes the new epoch's layer 0, the pulled
        # upper layers re-adopt by identity (zero-copy, zero pulls)
        ckpt_tokens = entry.ckpt_base + entry.produced
        layers = [entry.row.state] + list(entry.layers[1:])
        n_layers = len(entry.layers)
        new_keys = kv_layer_keys(session, new_epoch, n_layers)
        try:
            nbytes = ship_kv_layers(self.store, new_keys, layers)
        except KvShipError as e:
            raise AdmitError(errors.EINTERNAL, str(e)) from e
        for key in kv_layer_keys(session, entry.kv_epoch, n_layers):
            try:
                self.store.delete(key)
            except Exception:  # noqa: BLE001 — stale-epoch garbage is
                # harmless; admissions name their epoch explicitly
                pass
        with self._lock:
            self.checkpoints += 1
        return {
            "ckpt_tokens": ckpt_tokens,
            "kv_epoch": new_epoch,
            "kv_bytes": nbytes,
        }

    def shed_session(self, session: str) -> bool:
        """Admission-pressure eviction of a LIVE session: the row
        retires failed and the client/router hears EOVERCROWDED-shaped
        cancellation — the router's crash-migration path re-homes it
        from the last complete KV epoch."""
        with self._lock:
            entry = self._entries.get(session)
        if entry is None or entry.row is None:
            return False
        entry.row.cancel("shed: replica overcrowded")
        return True

    def describe(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "dead": self.dead,
                "overloaded": self.overloaded,
                "live_sessions": len(self._entries),
                "admitted": self.admitted_sessions,
                "shed": self.shed_sessions,
                "kv_pulls": self.kv_pulls,
                "fused_pulls": self.fused_pulls,
                "checkpoints": self.checkpoints,
                "loop": self.loop.describe(),
            }

    # ---- RPC surface --------------------------------------------------------
    @staticmethod
    def _parse_admit(request):
        req = json.loads(request.message)
        return {
            "session": str(req["session"]),
            "kv_epoch": int(req.get("kv_epoch", 0)),
            "n_layers": int(req.get("n_layers", 1)),
            "max_tokens": int(req.get("max_tokens", 16)),
            "start_token": int(req.get("start_token", 0)),
            "ckpt_tokens": int(req.get("ckpt_tokens", 0)),
        }

    @rpc_method(EchoRequest, EchoResponse)
    def Admit(self, controller, request, response, done):
        try:
            spec = self._parse_admit(request)
        except (ValueError, KeyError, TypeError) as e:
            controller.set_failed(errors.EREQUEST, f"bad admit request: {e}")
            done()
            return
        if controller._remote_stream_settings is None:
            # unary fallback: the whole remaining generation, one
            # response of "<idx> <token>" lines
            self.unary_rows += 1
            lines: List[str] = []

            def emit(idx, tok):
                lines.append(f"{idx} {tok}")

            def finish(ok, controller=controller, response=response):
                if not ok:
                    controller.set_failed(errors.ECANCELED, "decode aborted")
                else:
                    response.message = "\n".join(lines)
                    response.code = len(lines)
                done()

            try:
                self.admit_session(emit=emit, on_finish=finish, **spec)
            except AdmitError as e:
                controller.set_failed(e.code, str(e))
                done()
            return
        outbox = _TokenStream(self.outbox_max_tokens)
        # admission errors must fail the RPC itself, so refuse BEFORE
        # accepting the stream
        try:
            entry = self.admit_session(
                emit=outbox.emit, on_finish=outbox.finish, **spec
            )
        except AdmitError as e:
            controller.set_failed(e.code, str(e))
            done()
            return
        self.streamed_rows += 1
        opts = self._stream_options or StreamOptions()
        stream = Stream.accept(controller, outbox, opts)
        outbox.stream = stream
        outbox.row = entry.row
        response.message = "streaming"
        response.code = spec["max_tokens"]
        done()  # response (stream settings) precedes the first frame
        outbox.release()

    @rpc_method(EchoRequest, EchoResponse)
    def AdmitSSE(self, controller, request, response, done):
        """SSE front: ``data: <idx> <token>`` per step on a chunked
        text/event-stream response, ``data: [DONE]`` then close."""
        try:
            spec = self._parse_admit(request)
        except (ValueError, KeyError, TypeError) as e:
            controller.set_failed(errors.EREQUEST, f"bad admit request: {e}")
            done()
            return
        self.sse_rows += 1
        pa = controller.create_progressive_attachment(
            content_type="text/event-stream"
        )
        backlog_cap = max(64, self.outbox_max_tokens) * 64

        def emit(idx, tok, pa=pa):
            if pa.backlog_bytes() > backlog_cap:
                raise RuntimeError("sse client too slow: backlog over cap")
            if pa.write(f"data: {idx} {tok}\n\n") != 0:
                raise RuntimeError("sse client gone")

        def finish(ok, pa=pa):
            if ok:
                pa.write("data: [DONE]\n\n")
            pa.close()

        try:
            self.admit_session(emit=emit, on_finish=finish, **spec)
        except AdmitError as e:
            controller.set_failed(e.code, str(e))
        done()

    @rpc_method(EchoRequest, EchoResponse)
    def Checkpoint(self, controller, request, response, done):
        try:
            req = json.loads(request.message)
            session = str(req["session"])
            new_epoch = int(req["new_epoch"])
        except (ValueError, KeyError, TypeError) as e:
            controller.set_failed(errors.EREQUEST, f"bad checkpoint: {e}")
            done()
            return
        try:
            out = self.checkpoint_session(session, new_epoch)
        except AdmitError as e:
            controller.set_failed(e.code, str(e))
            done()
            return
        response.message = json.dumps(out)
        done()


class _TokenStream(StreamHandler):
    """Streamed-Admit glue: the same bounded-outbox discipline as
    ``streaming/generate._StreamSession`` (order-preserving queue, flow
    -control blocking off the decode thread), carrying ``<idx> <tok>``
    frames.  Emissions before the stream is accepted buffer in the
    queue and drain at ``release()``."""

    def __init__(self, max_tokens_queued: int):
        from incubator_brpc_tpu_torch.runtime.execution_queue import ExecutionQueue

        self._max_queued = max_tokens_queued
        self._q = ExecutionQueue(self._drain)
        self._lock = threading.Lock()
        self._depth = 0
        self._dead = False
        self._ready = threading.Event()
        self.stream: Optional[Stream] = None
        self.row = None

    def release(self) -> None:
        self._ready.set()
        self._q.execute(("nop", None))

    def emit(self, idx: int, token: str) -> None:
        with self._lock:
            if self._dead:
                if self.row is not None:
                    self.row.cancel("stream gone")
                return
            self._depth += 1
            if self._depth > self._max_queued:
                self._dead = True
                if self.row is not None:
                    self.row.cancel("slow consumer: outbox overflow")
                return
        self._q.execute(("tok", f"{idx} {token}"))

    def finish(self, ok: bool) -> None:
        self._q.execute(("fin", ok))

    def _drain(self, batch) -> None:
        self._ready.wait(timeout=30.0)
        for kind, val in batch:
            stream = self.stream
            if kind == "nop":
                continue
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
            else:
                ok = val
                with self._lock:
                    dead, self._dead = self._dead, True
                if stream is not None and not dead:
                    if ok:
                        stream.close()
                    else:
                        reason = (
                            getattr(self.row, "cancel_reason", "")
                            or "decode aborted"
                        )
                        code = (
                            errors.EOVERCROWDED
                            if "overcrowded" in reason
                            else errors.ECANCELED
                        )
                        stream.reset(code, reason)

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


def decode_stub(channel) -> ServiceStub:
    return ServiceStub(channel, DecodeService)
