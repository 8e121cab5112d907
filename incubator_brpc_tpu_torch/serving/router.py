"""Session router — prefill→decode orchestration with live migration
(docs/serving.md).

``SessionChannel`` is the client-side combo plane for disaggregated
serving: it routes a session's PREFILL to the prefill tier (once,
ever), its DECODE to a replica picked mesh_locality-style (same-slice
replicas first), and — on decode-replica overload (EOVERCROWDED shed),
death (loop stop / breaker-shaped failure) or an operator ``migrate``
— re-homes the session WITHOUT recomputing prefill:

* **graceful handoff** (``migrate()``): the source replica checkpoints
  — drains the row at a step boundary and publishes the live state as
  a complete NEW KV epoch before retiring the old one — and the target
  admits from the new epoch with ``start_token == ckpt_tokens``
  (nothing re-derived, nothing re-emitted).  The handoff is gated by
  the ``session.migrate`` chaos site: a drop aborts the handoff and
  the session STAYS ON THE SOURCE, epoch un-bumped.
* **crash migration** (automatic): the target re-pulls the LAST
  COMPLETE KV epoch and fast-forwards — tokens past the checkpoint are
  re-derived on device but suppressed below ``start_token``, so the
  client stream resumes at exactly the next index.

Exactly-once is enforced at the point of record: every admission bumps
the session's OWNERSHIP epoch and ``SessionRecord.accept_token``
rejects emissions from a stale epoch or at a non-next index.  The
step-log tests read ``prefill_executions == 1`` and contiguous token
indices straight off the record.

rpcz: one client span ("Serving"/"Session") roots the whole session;
the prefill leg, every ``kv.ship`` (prefill AND checkpoint) and each
``decode.hop.<replica>`` join it as collective sub-spans — /rpcz shows
a migrated session as one trace with its hops laid end to end.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.chaos import injector as _chaos
from incubator_brpc_tpu_torch.observability.span import Span, swap_current_span
from incubator_brpc_tpu_torch.serving import metrics as _metrics
from incubator_brpc_tpu_torch.serving import session as _session
from incubator_brpc_tpu_torch.serving.decode import AdmitError, DecodeService
from incubator_brpc_tpu_torch.serving.prefill import KvShipError, PrefillService
from incubator_brpc_tpu_torch.utils.logging import log_error


class SessionError(RuntimeError):
    """A session failed for good; ``code`` is the ERPC error class the
    caller records (EOVERCROWDED = every replica shed, ELOGOFF = tier
    dead, EINTERNAL = KV ship/pull failure)."""

    def __init__(self, code: int, text: str):
        super().__init__(text)
        self.code = code


class SessionResult:
    __slots__ = ("session", "tokens", "migrations", "prefill_executions",
                 "record")

    def __init__(self, record: _session.SessionRecord):
        self.session = record.session
        self.tokens = list(record.tokens)
        self.migrations = record.migrations
        self.prefill_executions = record.prefill_executions
        self.record = record


class _LegCtl:
    """Driver↔migrate coordination for ONE decode leg: ``pending`` is
    installed BEFORE the source row is cancelled, so when the drive loop
    wakes on retire it knows a graceful handoff is in flight and waits
    for its checkpoint outcome."""

    __slots__ = ("pending", "handoff", "ckpt", "done", "ok")

    def __init__(self):
        self.pending: Optional[str] = None  # migration reason, or None
        self.handoff = threading.Event()
        self.ckpt = None  # checkpoint dict | AdmitError
        self.done = threading.Event()
        self.ok = False


class SessionChannel:
    """One router over a prefill service and N decode replicas (the
    in-process topology the tests and bench stand up; remote tiers
    swap ``DecodeService`` for its stub behind the same entry points).

    ``coords=(slice, chip)`` orders replica picks mesh_locality-style:
    same-slice replicas are tried first, the admission shed
    (EOVERCROWDED) walks to the next — the same locality preference
    ``client/load_balancer.MeshLocalityLB`` applies to cache shards.
    """

    def __init__(
        self,
        prefill: PrefillService,
        replicas: Sequence[DecodeService],
        coords=None,
        max_hops_per_leg: Optional[int] = None,
    ):
        if not replicas:
            raise ValueError("SessionChannel needs at least one replica")
        self.prefill = prefill
        self.replicas: List[DecodeService] = list(replicas)
        self.coords = coords
        self.max_hops_per_leg = max_hops_per_leg or (4 * len(self.replicas))
        self._lock = threading.Lock()
        self._legs = {}  # session -> (_LegCtl, source DecodeService)
        self.migrations_requested = 0
        self.migrations_aborted = 0

    # ---- replica pick (mesh_locality flavored) ------------------------------
    def _ordered(self, exclude: Optional[DecodeService]) -> List[DecodeService]:
        def rank(r: DecodeService):
            local = (
                self.coords is not None
                and r.coords is not None
                and r.coords[0] == self.coords[0]
            )
            return (0 if local else 1, r.live_sessions())

        return sorted(
            (r for r in self.replicas if not r.dead and r is not exclude),
            key=rank,
        )

    # ---- the blocking drive loop ---------------------------------------------
    def generate(
        self,
        session: str,
        prompt: str,
        max_tokens: int,
        on_token: Optional[Callable[[int, str], None]] = None,
    ) -> SessionResult:
        """Run one session end to end: prefill ONCE, then decode with
        as many replica hops as overload/death/migration demand.
        Returns the completed SessionResult; raises SessionError when
        the tier cannot finish it (KV unshippable, every replica
        dead/shed)."""
        rec = _session.open_session(session, prompt, max_tokens)
        root = Span.create_client("Serving", "Session")
        prev = swap_current_span(root)
        code = 0
        try:
            self._prefill(rec)
            _metrics.serving_sessions << 1
            self._drive(rec, on_token)
            return SessionResult(rec)
        except SessionError as e:
            code = e.code
            rec.state = _session.FAILED
            rec.error = str(e)
            raise
        finally:
            with self._lock:
                self._legs.pop(session, None)
            swap_current_span(prev)
            if root is not None:
                root.annotate(
                    f"session={session} tokens={len(rec.tokens)} "
                    f"migrations={rec.migrations}"
                )
                root.end(code)

    def _prefill(self, rec: _session.SessionRecord) -> None:
        leg = Span.create_collective("Serving", "prefill")
        try:
            out = self.prefill.prefill_sessions(
                [(rec.session, rec.prompt)], epoch=0
            )[rec.session]
        except KvShipError as e:
            # the no-silent-recompute contract: the ship failure is THE
            # session failure, surfaced as one ERPC-class error
            if leg is not None:
                leg.end(errors.EINTERNAL)
            raise SessionError(
                errors.EINTERNAL, f"prefill KV ship failed: {e}"
            ) from e
        rec.state = _session.PREFILLED
        rec.kv_epoch = out["epoch"]
        rec.n_layers = out["n_layers"]
        rec.kv_bytes = out["kv_bytes"]
        rec.prefill_executions = out["prefill_executions"]
        if leg is not None:
            leg.annotate(f"kv_bytes={out['kv_bytes']}")
            leg.end()

    def _admit(
        self,
        rec: _session.SessionRecord,
        replica: DecodeService,
        on_token,
        start_token: int,
    ) -> _LegCtl:
        """One decode leg: bump the ownership epoch, admit on
        ``replica`` pulling the session's live KV epoch.  Raises
        AdmitError (EOVERCROWDED/ELOGOFF/EINTERNAL) without bumping
        state when the replica refuses."""
        ctl = _LegCtl()
        epoch = rec.epoch + 1  # committed by bump_epoch below on success

        def emit(idx, tok):
            if rec.accept_token(idx, tok, epoch):
                if on_token is not None:
                    on_token(idx, tok)

        def on_finish(ok):
            ctl.ok = ok
            ctl.done.set()

        replica.admit_session(
            session=rec.session,
            kv_epoch=rec.kv_epoch,
            n_layers=rec.n_layers,
            max_tokens=rec.max_tokens,
            start_token=start_token,
            ckpt_tokens=rec.ckpt_tokens,
            emit=emit,
            on_finish=on_finish,
        )
        assert rec.bump_epoch(replica.name) == epoch
        rec.state = _session.DECODING
        with self._lock:
            self._legs[rec.session] = (ctl, replica)
        return ctl

    def _drive(self, rec: _session.SessionRecord, on_token) -> None:
        source: Optional[DecodeService] = None
        hops = 0
        last_refusal = "no live replica"
        first_leg = True
        while True:
            candidates = self._ordered(exclude=source)
            if source is not None and not source.dead:
                candidates.append(source)  # last resort: stay home
            ctl = None
            for replica in candidates:
                if hops >= self.max_hops_per_leg:
                    break
                hops += 1
                leg = Span.create_collective(
                    "Serving", f"decode.hop.{replica.name}"
                )
                try:
                    ctl = self._admit(
                        rec, replica, on_token, start_token=len(rec.tokens)
                    )
                except AdmitError as e:
                    last_refusal = f"{replica.name}: {e}"
                    if leg is not None:
                        leg.end(e.code)
                    continue
                if not first_leg:
                    rec.migrations += 1
                    _metrics.serving_migrations << 1
                    _metrics.serving_prefill_reuse << 1
                first_leg = False
                ctl.done.wait()
                if leg is not None:
                    leg.annotate(
                        f"tokens={len(rec.tokens)}/{rec.max_tokens} "
                        f"ok={ctl.ok}"
                    )
                    leg.end(0 if ctl.ok else errors.ECANCELED)
                source = replica
                break
            if ctl is None:
                raise SessionError(
                    errors.EOVERCROWDED
                    if hops < self.max_hops_per_leg
                    else errors.ETOOMANYFAILS,
                    f"session {rec.session!r}: no replica admitted "
                    f"after {hops} hops (last: {last_refusal})",
                )
            # leg retired — finished, migrating, or crashed?
            if ctl.ok and len(rec.tokens) >= rec.max_tokens:
                rec.state = _session.DONE
                return
            if ctl.pending is not None:
                # graceful handoff: wait for the checkpoint outcome the
                # migrate() caller is publishing
                rec.state = _session.MIGRATING
                ctl.handoff.wait(timeout=60.0)
                if isinstance(ctl.ckpt, dict):
                    rec.kv_epoch = ctl.ckpt["kv_epoch"]
                    rec.ckpt_tokens = ctl.ckpt["ckpt_tokens"]
                    rec.kv_bytes = ctl.ckpt["kv_bytes"]
                    rec.log_migration(
                        {
                            "kind": "graceful",
                            "reason": ctl.pending,
                            "from": source.name,
                            "kv_epoch": rec.kv_epoch,
                            "ckpt_tokens": rec.ckpt_tokens,
                        }
                    )
                else:
                    # checkpoint ship failed: the OLD epoch is intact
                    # (complete-or-absent), fall back to crash-style
                    # re-pull + fast-forward from it
                    rec.log_migration(
                        {
                            "kind": "graceful-fallback",
                            "reason": ctl.pending,
                            "from": source.name,
                            "error": str(ctl.ckpt),
                            "kv_epoch": rec.kv_epoch,
                        }
                    )
            else:
                rec.state = _session.MIGRATING
                rec.log_migration(
                    {
                        "kind": "crash",
                        "from": source.name,
                        "kv_epoch": rec.kv_epoch,
                        "resume_token": len(rec.tokens),
                    }
                )

    # ---- operator/overload-triggered migration ------------------------------
    def migrate(self, session: str, reason: str = "operator") -> bool:
        """Gracefully hand the session off its current replica.  False
        when the handoff was aborted (``session.migrate`` chaos drop,
        or no live leg) — the session stays on the source, ownership
        epoch un-bumped, stream uninterrupted."""
        with self._lock:
            self.migrations_requested += 1
            leg = self._legs.get(session)
        if leg is None:
            return False
        ctl, source = leg
        rec = _session.get_session(session)
        if rec is None:
            return False
        if _chaos.armed:
            spec = _chaos.check("session.migrate", method=session)
            if spec is not None:
                if spec.action == "delay_us":
                    _chaos.sleep_us(spec.arg)
                elif spec.action == "drop":
                    with self._lock:
                        self.migrations_aborted += 1
                    rec.log_migration(
                        {
                            "kind": "aborted",
                            "reason": reason,
                            "from": source.name,
                            "chaos": "session.migrate drop",
                        }
                    )
                    return False
        ctl.pending = reason
        ctl.handoff.clear()
        try:
            ctl.ckpt = source.checkpoint_session(session, rec.kv_epoch + 1)
        except AdmitError as e:
            ctl.ckpt = e
            log_error(
                f"session {session!r} checkpoint on {source.name} failed "
                f"({e}); crash-migrating from epoch {rec.kv_epoch}"
            )
        finally:
            ctl.handoff.set()
        return True

    def describe(self) -> dict:
        with self._lock:
            live = {s: src.name for s, (_c, src) in self._legs.items()}
        return {
            "replicas": [r.describe() for r in self.replicas],
            "live_legs": live,
            "migrations_requested": self.migrations_requested,
            "migrations_aborted": self.migrations_aborted,
        }
