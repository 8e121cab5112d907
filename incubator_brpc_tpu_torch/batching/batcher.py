"""Batcher — per-method accumulation of concurrent requests into one
fused handler execution.

Sits between protocol dispatch and user code: ``tpu_std`` hands a
parsed (controller, request, response, done) row to ``submit`` instead
of ``run_user_method``; the Batcher accumulates rows under one lock
(a burst delivered through ``IciFabric.delivery_burst`` →
``ExecutionQueue.execute_batch`` drains its frames on ONE consumer
task, so the whole burst lands here with zero extra wakes), then
flushes when any trigger fires:

  size       pending == policy.max_batch_size → flush now;
  wait       max_wait_us after the oldest row enqueued (timer);
  deadline   the guard keeps flush no later than any row's
             (deadline - expected batch service time), so a row's
             remaining budget always covers the batch execution.

At flush, rows already past their deadline are SHED — ELIMIT through
the normal per-row done(), before user code runs, feeding the method's
concurrency limiter (server/method_status.py) like any errored
response — and the survivors run through the user's batch handler
ONCE.  The handler's done() scatters: each row's protocol done() sends
its own response, so per-row failures (``controller.set_failed``) map
to per-controller ERPC errors without poisoning batch-mates.

Metrics count REQUESTS, not batches: every row's done() drives the
method's LatencyRecorder/qps/limiter individually; the per-batch shape
lands in ``rpc_batch_size_<method>`` (IntRecorder) and
``rpc_batch_occupancy_<method>`` (PassiveStatus), both on /metrics.
"""

from __future__ import annotations

import threading
import time as _time
from collections import deque
from typing import Callable, List, Optional

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.batching.policy import BatchPolicy
from incubator_brpc_tpu_torch.chaos import injector as _chaos
from incubator_brpc_tpu_torch.server import admission as _admission
from incubator_brpc_tpu_torch.metrics.passive_status import PassiveStatus
from incubator_brpc_tpu_torch.metrics.recorder import IntRecorder
from incubator_brpc_tpu_torch.metrics.reducer import Adder
from incubator_brpc_tpu_torch.utils.logging import log_error

_tls = threading.local()


def current_batch() -> Optional["BatchContext"]:
    """The BatchContext of the batch currently executing on this
    thread, or None (single-request fallback / unbatched dispatch).
    Batch handlers read it for the pad target and the padding freelist."""
    return getattr(_tls, "ctx", None)


class BatchContext:
    """What a batch handler may want to know about its invocation."""

    __slots__ = ("full_name", "batch_size", "pad_to", "_batcher", "policy")

    def __init__(self, full_name, batch_size, pad_to, batcher, policy):
        self.full_name = full_name
        self.batch_size = batch_size
        self.pad_to = pad_to
        self._batcher = batcher
        self.policy = policy

    @property
    def freelist(self):
        """The method's padding freelist (lazily built: only handlers
        that actually fuse device payloads pay for the ring)."""
        return self._batcher.pad_freelist

    @property
    def pad_fraction(self) -> float:
        return (self.pad_to - self.batch_size) / self.pad_to if self.pad_to else 0.0


class _Row:
    __slots__ = ("controller", "request", "response", "done",
                 "enqueue_ns", "deadline_ns")

    def __init__(self, controller, request, response, done,
                 enqueue_ns, deadline_ns):
        self.controller = controller
        self.request = request
        self.response = response
        self.done = done
        self.enqueue_ns = enqueue_ns
        self.deadline_ns = deadline_ns


class _Scatter:
    """The single done() a batch handler receives: first call fans out
    to every row's protocol done() (each serializes + sends its own
    response); later calls are no-ops (same contract as a single
    method's done)."""

    __slots__ = ("_rows", "called", "_on_done", "_once")

    def __init__(self, rows: List[_Row], on_done: Callable[[], None]):
        self._rows = rows
        self.called = False
        self._on_done = on_done
        self._once = threading.Lock()

    def __call__(self):
        # atomic check-and-set: a handler's async completion racing its
        # own synchronous exception fence must not fan out twice (a
        # double _finish_window would chain two concurrent batches)
        with self._once:
            if self.called:
                return
            self.called = True
        # rows first: every response is on its way to the wire before
        # on_done may chain straight into the next fused execution.
        # Multi-row fan-outs on a native conn open a server response
        # ring scope so the whole window leaves as one writev burst
        # per connection (no-op off the native path, and deferred to
        # the enclosing scope when a read-burst window already staged).
        ring_flush = None
        if len(self._rows) > 1:
            try:
                from incubator_brpc_tpu_torch.server.server import (
                    resp_ring_begin,
                    resp_ring_flush,
                )

                ring_token = resp_ring_begin()
                if ring_token:
                    ring_flush = lambda: resp_ring_flush(ring_token)  # noqa: E731
            except Exception:  # noqa: BLE001 — staging is optional
                ring_flush = None
        try:
            for r in self._rows:
                try:
                    r.done()
                except Exception as e:  # noqa: BLE001 — one row's send
                    # failure must not strand its batch-mates
                    log_error("batched done() for one row raised: %r", e)
        finally:
            if ring_flush is not None:
                ring_flush()
        self._on_done()


class Batcher:
    """One method's micro-batcher (see module docstring)."""

    def __init__(
        self,
        full_name: str,
        batch_fn: Callable,
        policy: BatchPolicy,
        inline: bool = False,
    ):
        if not policy.enabled:
            raise ValueError(
                f"Batcher({full_name}) needs max_batch_size >= 2 "
                f"(got {policy.max_batch_size}); the off config takes "
                f"the existing dispatch path"
            )
        self.full_name = full_name
        self._batch_fn = batch_fn
        self.policy = policy
        # inline: flush runs on the submitting thread when the size /
        # overdue trigger fires (the usercode_in_dispatcher threading
        # model — no handoff, but a slow batch stalls that loop).
        # Timer-fired flushes always hop to the scheduler: user code
        # must never run on the process-wide timer thread.
        self._inline = inline
        self._lock = threading.Lock()
        self._pending: List[_Row] = []
        self._due_ns = 0  # earliest flush-by time of the pending window
        # continuous-batching discipline: at most ONE batch executes per
        # method at a time.  Rows arriving during an execution
        # accumulate; the finishing flush chains straight into the next
        # window.  Without this, the wait timer fires mid-execution and
        # fragments a saturated stream into small concurrent batches —
        # heavy padding waste and overlapping device executions instead
        # of full back-to-back ones.
        self._in_flight = False
        self._timer_id = 0
        # ownership token of the live timer: unschedule is best-effort,
        # so a popped-but-not-yet-run timer can still fire — the token
        # lets _on_timer recognize itself as stale instead of touching
        # a newer window's timer state
        self._timer_token = None
        self._stopped = False
        # batch service time EMA (us) the deadline guard subtracts
        self._service_ema_us = float(policy.expected_service_us)
        # padding freelist: donated device rows for pad slots, the
        # StagingRing shape from the ICI pipeline reused verbatim
        # (keyed by (shape, dtype), LRU-bounded); built lazily via the
        # pad_freelist property — host-padding handlers never touch it
        self._pad_freelist = None
        # -- stats / exposed variables --
        safe = full_name.replace(".", "_").lower()
        self.batch_size_rec = IntRecorder().expose(f"rpc_batch_size_{safe}")
        self._occ_var = PassiveStatus(self.occupancy).expose(
            f"rpc_batch_occupancy_{safe}"
        )
        self.shed = Adder(0).expose(f"rpc_batch_shed_{safe}")
        self.batches = 0
        self.rows = 0
        # sum over every live row flushed of (its batch taken off the
        # queue - the row's enqueue), monotonic ns: the batcher's wait
        self.wait_ns = 0
        self._wait_var = PassiveStatus(lambda: self.wait_ns).expose(
            f"rpc_batch_wait_ns_{safe}"
        )
        self.max_batch_seen = 0
        self._recent: deque = deque(maxlen=64)

    # ---- admission ---------------------------------------------------------
    def _row_cap(self, controller) -> int:
        """Tier-aware queue cap (docs/overload.md): a sub-1.0 tier stops
        queueing at cap*share, so under sustained overload the bulk
        tier's rows shed here while interactive rows still queue into
        the reserved headroom — same weighted-shedding rule the
        admission gate applies to concurrency."""
        cap = self.policy.queue_cap
        tier = controller.__dict__.get("_admission_tier")
        if tier is not None:
            server = getattr(controller, "server", None)
            adm = getattr(server, "admission", None)
            if adm is not None:
                share = adm.policy.share(tier)
                if share < 1.0:
                    cap = max(1, int(cap * share))
        return cap

    def submit(self, controller, request, response, done) -> bool:
        """Queue one parsed request row.  False = batcher stopped (the
        caller falls back to direct dispatch)."""
        if self._stopped:
            return False
        now = _time.monotonic_ns()
        deadline_ns = getattr(controller, "_batch_deadline_ns", 0)
        if not deadline_ns and self.policy.deadline_us:
            deadline_ns = now + self.policy.deadline_us * 1000
        row = _Row(controller, request, response, done, now, deadline_ns)
        due = self._flush_by(row)
        flush_rows = None
        arm_due = 0
        overflow = False
        cap = self._row_cap(controller)
        with self._lock:
            if self._stopped:
                return False
            if len(self._pending) >= cap:
                overflow = True
            else:
                self._pending.append(row)
                due_moved = self._due_ns == 0 or due < self._due_ns
                if due_moved:
                    self._due_ns = due
                if self._in_flight:
                    # a batch is executing: accumulate — its completion
                    # chain-flushes this window with zero extra wakes
                    pass
                elif len(self._pending) >= self.policy.max_batch_size or self._due_ns <= now:
                    flush_rows = self._take_pending_locked()
                    self._in_flight = True
                elif due_moved or self._timer_id == 0:
                    # (re)aim the flush timer only when the window's
                    # flush-by time actually moved — later-due rows ride
                    # the already-armed timer for free
                    arm_due = self._due_ns
        if overflow:
            # batches execute one at a time per method, so sustained
            # overload accumulates HERE — bound it: shed at admission
            # instead of growing the queue (and queue wait) without limit
            self._shed([row], _admission.shed_code("queue_full"),
                       "batch queue full (max_queue_rows; retry elsewhere)",
                       reason_key="queue_full")
            return True
        if flush_rows is not None:
            self._dispatch(flush_rows, inline_ok=True, taken_ns=now)
        elif arm_due:
            self._arm_timer(arm_due)
        return True

    def submit_many(self, rows_in) -> bool:
        """Queue a whole client submission window as ONE accumulation:
        one lock pass, one flush decision — a `call_many` window of N
        batched calls arriving in one read burst becomes ~one fused
        execution instead of N lock round-trips racing the wait timer.
        rows_in is a list of (controller, request, response, done).
        False = batcher stopped (caller falls back to direct dispatch
        for every row); overflow rows shed internally, like submit."""
        if self._stopped:
            return False
        now = _time.monotonic_ns()
        rows: List[_Row] = []
        for controller, request, response, done in rows_in:
            deadline_ns = getattr(controller, "_batch_deadline_ns", 0)
            if not deadline_ns and self.policy.deadline_us:
                deadline_ns = now + self.policy.deadline_us * 1000
            rows.append(
                _Row(controller, request, response, done, now, deadline_ns)
            )
        overflow: List[_Row] = []
        flush_rows = None
        arm_due = 0
        with self._lock:
            if self._stopped:
                return False
            for row in rows:
                if len(self._pending) >= self._row_cap(row.controller):
                    overflow.append(row)
                    continue
                self._pending.append(row)
                due = self._flush_by(row)
                if self._due_ns == 0 or due < self._due_ns:
                    self._due_ns = due
            if self._pending and not self._in_flight:
                if (
                    len(self._pending) >= self.policy.max_batch_size
                    or self._due_ns <= now
                ):
                    # a window past max_batch_size dequeues one max-size
                    # batch; the completion chain flushes the remainder
                    # back-to-back (continuous-batching discipline)
                    flush_rows = self._take_pending_locked()
                    self._in_flight = True
                else:
                    arm_due = self._due_ns
        if overflow:
            self._shed(overflow, _admission.shed_code("queue_full"),
                       "batch queue full (max_queue_rows; retry elsewhere)",
                       reason_key="queue_full")
        if flush_rows is not None:
            self._dispatch(flush_rows, inline_ok=True, taken_ns=now)
        elif arm_due:
            self._arm_timer(arm_due)
        return True

    def _flush_by(self, row: _Row) -> int:
        """The latest acceptable flush time for one row: max_wait after
        enqueue, clamped so its remaining deadline budget still covers
        the expected batch execution."""
        due = row.enqueue_ns + self.policy.max_wait_us * 1000
        if row.deadline_ns:
            margin_ns = int(self._service_ema_us * 1000)
            if margin_ns == 0:
                # unseeded EMA (a per-request _batch_deadline_ns on a
                # deadline-less policy, before the first measured
                # flush): reserve 10% of the row's budget — a zero
                # margin would aim the flush exactly AT the deadline
                # and shed a perfectly viable row at dequeue.  Once
                # measured, the EMA alone governs.
                margin_ns = (row.deadline_ns - row.enqueue_ns) // 10
            due = min(due, row.deadline_ns - margin_ns)
        return due

    def _take_pending_locked(self) -> List[_Row]:
        limit = self.policy.max_batch_size
        if len(self._pending) <= limit:
            rows, self._pending = self._pending, []
        else:
            # rows kept accumulating during an execution: dequeue one
            # max-size window FIFO, leave the rest for the next chain
            rows = self._pending[:limit]
            self._pending = self._pending[limit:]
        self._due_ns = (
            0
            if not self._pending
            else min(self._flush_by(r) for r in self._pending)
        )
        if self._timer_id:
            # best-effort: a fired-but-superseded timer recognizes the
            # dropped token and no-ops
            from incubator_brpc_tpu_torch.runtime.timer_thread import get_timer_thread

            get_timer_thread().unschedule(self._timer_id)
            self._timer_id = 0
            self._timer_token = None
        return rows

    def _arm_timer(self, due_ns: int) -> None:
        from incubator_brpc_tpu_torch.runtime.timer_thread import get_timer_thread

        tt = get_timer_thread()
        with self._lock:
            if not self._pending or self._due_ns != due_ns:
                return  # flushed or re-aimed while we were outside
            if self._timer_id:
                tt.unschedule(self._timer_id)
            token = object()
            self._timer_token = token
            delay_s = max(0.0, (due_ns - _time.monotonic_ns()) / 1e9)
            self._timer_id = tt.schedule(self._on_timer, delay_s, token)

    def _on_timer(self, token) -> None:
        with self._lock:
            if token is not self._timer_token:
                return  # stale: a newer timer owns the window
            self._timer_id = 0
            self._timer_token = None
            if not self._pending or self._stopped:
                return
            if self._in_flight:
                # a batch is executing: its completion chain-flushes
                # (or re-arms) this window — nothing to do here
                return
            now = _time.monotonic_ns()
            if self._due_ns > now + 50_000:  # re-aimed later: rearm
                due = self._due_ns
                rows = None
            else:
                rows = self._take_pending_locked()
                self._in_flight = True
        if rows:
            # never run user code on the process-wide timer thread
            self._dispatch(rows, inline_ok=False, taken_ns=now)
        else:
            self._arm_timer(due)

    def _dispatch(self, rows: List[_Row], inline_ok: bool, taken_ns: int) -> None:
        if self._inline and inline_ok:
            self._flush(rows, taken_ns)
            return
        from incubator_brpc_tpu_torch.runtime import scheduler

        scheduler.spawn(self._flush, rows, taken_ns)

    # ---- execution ---------------------------------------------------------
    def _flush(self, rows: List[_Row], taken_ns: int = 0) -> None:
        """Run one batch.  ``taken_ns`` (monotonic) is when its rows left
        the queue; 0 = now (stop()'s drain)."""
        if _chaos.armed:
            spec = _chaos.check("batch.flush", method=self.full_name)
            if spec is not None:
                if spec.action == "delay_us":
                    _chaos.sleep_us(spec.arg)
                elif spec.action == "drop":
                    # the flush decision is lost: shed the whole window
                    # cleanly — every controller gets exactly one ERPC
                    # completion, nothing waits on a flush that will
                    # never come
                    self._shed(rows, _admission.shed_code("chaos"),
                               "chaos: batch flush dropped",
                               reason_key="chaos")
                    self._finish_window()
                    return
        now = _time.monotonic_ns()
        taken_ns = taken_ns or now
        live: List[_Row] = []
        dead: List[_Row] = []
        cancelled: List[_Row] = []
        for r in rows:
            if r.controller.__dict__.get("_cancel_requested"):
                # hedge loser (cancel frame beat the flush): the row
                # never reaches device work; its done() completes the
                # server bookkeeping but the response is suppressed
                cancelled.append(r)
            elif r.deadline_ns and now > r.deadline_ns:
                dead.append(r)
            else:
                live.append(r)
        if cancelled:
            self._shed(cancelled, _admission.shed_code("cancelled"),
                       "cancelled by caller (hedge loser)",
                       reason_key="cancelled")
        if dead:
            # the request itself expired: the DROP code — retrying it
            # anywhere is wasted work (docs/overload.md code mapping)
            self._shed(dead, _admission.shed_code("deadline"),
                       "batch deadline exceeded while queued (drop)",
                       reason_key="deadline")
        if not live:
            self._finish_window()
            return
        n = len(live)
        pad_to = self.policy.bucket_for(n)
        self.batch_size_rec << n
        with self._lock:
            # occupancy() snapshots this deque from scrape threads;
            # unsynchronized append vs iteration raises RuntimeError
            self._recent.append(n)
        self.batches += 1
        self.rows += n
        self.wait_ns += taken_ns * n - sum(r.enqueue_ns for r in live)
        if n > self.max_batch_seen:
            self.max_batch_seen = n
        ctx = BatchContext(self.full_name, n, pad_to, self, self.policy)
        wall_us = _time.time_ns() // 1000
        flush_us = wall_us - (_time.monotonic_ns() - taken_ns) // 1000
        first_span = None
        for r in live:
            span = getattr(r.controller, "_span", None)
            if span is not None:
                # per-row rpcz: the batch left the queue (the wall clock
                # of taken_ns), then callback entry is the fused
                # execution's start; the batch shape rides as an
                # annotation so /rpcz shows size / padding waste / queue
                # wait per row
                span.batch_flush_us = flush_us
                span.callback_start_us = wall_us
                span.annotate(
                    f"batch size={n} pad_fraction={ctx.pad_fraction:.2f} "
                    f"queue_wait={(now - r.enqueue_ns) // 1000}us"
                )
                if first_span is None:
                    first_span = span
        t0 = _time.monotonic_ns()
        scatter = _Scatter(live, on_done=lambda: self._on_batch_done(t0))
        from incubator_brpc_tpu_torch.observability.span import swap_current_span

        # parent nested client calls / fabric legs made inside the
        # batch handler to the first row's trace (a batch has N traces;
        # one representative parent beats none)
        prev_parent = swap_current_span(first_span) if first_span else None
        # save/restore like _tls.draining: a nested inline flush into
        # another batcher must not strip the outer handler's context
        prev_ctx = getattr(_tls, "ctx", None)
        _tls.ctx = ctx
        exc = None
        try:
            self._batch_fn(
                [r.controller for r in live],
                [r.request for r in live],
                [r.response for r in live],
                scatter,
            )  # ← USER CODE, once per batch
        except Exception as e:  # noqa: BLE001
            exc = e
            log_error("batched method %s raised: %r", self.full_name, e)
        finally:
            _tls.ctx = prev_ctx
            if first_span is not None:
                swap_current_span(prev_parent)
        if exc is not None and not scatter.called:
            for r in live:
                if not r.controller.failed():
                    r.controller.set_failed(
                        errors.EINTERNAL, f"batched method raised: {exc}"
                    )
            scatter()
        # a handler that neither raised nor called done() is async: the
        # scatter fires (and the service EMA updates) whenever it does

    def _on_batch_done(self, t0_ns: int) -> None:
        self._note_service(t0_ns)
        self._finish_window()

    def _next_window_locked_step(self):
        """One completion step: either take the next ready window
        (chaining, _in_flight stays True) or release the method and
        report the timer deadline to re-arm.  Returns (rows, arm_due,
        the monotonic ns the rows were taken at)."""
        with self._lock:
            if self._stopped:
                # stop() is the sole drainer of whatever remains; the
                # chain just releases the method so it can proceed
                self._in_flight = False
                return None, 0, 0
            now = _time.monotonic_ns()
            if self._pending and (
                len(self._pending) >= self.policy.max_batch_size
                or self._due_ns <= now
            ):
                # _in_flight stays True: back-to-back fused executions
                return self._take_pending_locked(), 0, now
            self._in_flight = False
            return None, self._due_ns if self._pending else 0, 0

    def _finish_window(self) -> None:
        """The in-flight execution (or a fully-shed window) finished:
        chain straight into the next window if its trigger already
        fired, otherwise hand the accumulated rows back to the wait
        timer.  This is what makes the one-batch-per-method discipline
        continuous instead of a one-shot.  Inline chaining drains in a
        loop — a saturated stream must not recurse one stack frame per
        back-to-back batch."""
        tok = getattr(_tls, "draining", None)
        if tok is not None and tok[0] is self:
            tok[1] = True  # tell the draining frame below to continue
            return
        if not self._inline:
            # non-inline chaining hops through scheduler.spawn: each
            # _flush runs as its own task, no recursion possible
            rows, arm_due, taken_ns = self._next_window_locked_step()
            if rows is not None:
                self._dispatch(rows, inline_ok=True, taken_ns=taken_ns)
            elif arm_due:
                self._arm_timer(arm_due)
            return
        prev = tok  # a DIFFERENT batcher's token (nested inline RPC
        # into this one): restore it on exit or the outer drain loop
        # loses its recursion guard
        tok = [self, False]
        _tls.draining = tok
        try:
            while True:
                rows, arm_due, taken_ns = self._next_window_locked_step()
                if rows is None:
                    if arm_due:
                        self._arm_timer(arm_due)
                    return
                tok[1] = False
                self._flush(rows, taken_ns)
                if not tok[1]:
                    # async handler: done() hasn't fired yet — its own
                    # completion (on another thread) continues the chain
                    return
        finally:
            _tls.draining = prev

    def _note_service(self, t0_ns: int) -> None:
        service_us = (_time.monotonic_ns() - t0_ns) / 1000.0
        # EMA, single-writer-ish: racing flushes may interleave but the
        # estimate only steers the deadline guard's flush-by time
        self._service_ema_us = (
            service_us
            if self._service_ema_us == 0.0
            else self._service_ema_us * 0.7 + service_us * 0.3
        )

    def _shed(self, rows: List[_Row], code: int, reason: str,
              reason_key: str = "queue_full") -> None:
        now = _time.monotonic_ns()
        for r in rows:
            self.shed << 1
            _admission.note_shed(
                self.full_name,
                r.controller.__dict__.get("_admission_tier"),
                reason_key,
            )
            span = getattr(r.controller, "_span", None)
            if span is not None:
                # the shed phase, stamped before the span closes via
                # the normal error-response path
                span.annotate(
                    f"batch_shed {reason} "
                    f"queued={(now - r.enqueue_ns) // 1000}us"
                )
            r.controller.set_failed(code, reason)
            try:
                r.done()
            except Exception as e:  # noqa: BLE001
                log_error("batched shed done() raised: %r", e)

    @property
    def pad_freelist(self):
        """Donated device rows for pad slots (see __init__)."""
        if self._pad_freelist is None:
            from incubator_brpc_tpu_torch.parallel.ici import StagingRing

            self._pad_freelist = StagingRing(depth=4, max_keys=8)
        return self._pad_freelist

    # ---- runtime tuning ----------------------------------------------------
    def set_max_wait_us(self, us: int) -> None:
        """Live-tune the wait dial (POST /batching): updates the policy
        AND re-aims the window's flush-by time, so rows already queued
        under the old wait feel the new one immediately — not only the
        next arrival."""
        arm_due = 0
        with self._lock:
            self.policy.max_wait_us = int(us)
            if self._pending:
                self._due_ns = min(self._flush_by(r) for r in self._pending)
                if not self._in_flight:
                    # in-flight: the completion chain reads _due_ns
                    arm_due = self._due_ns
        if arm_due:
            self._arm_timer(arm_due)

    # ---- introspection / lifecycle -----------------------------------------
    def pending(self) -> int:
        return len(self._pending)

    def pending_by_tier(self) -> dict:
        """Queued rows grouped by admission tier (rows dispatched while
        no tiered policy was active count as the default tier) — feeds
        the per-tier queue-depth gauges on /metrics."""
        out: dict = {}
        with self._lock:
            rows = list(self._pending)
        for r in rows:
            tier = (
                r.controller.__dict__.get("_admission_tier")
                or _admission.TIER_INTERACTIVE
            )
            out[tier] = out.get(tier, 0) + 1
        return out

    def occupancy(self) -> float:
        """Recent mean batch size over max_batch_size, 0..1 — how full
        the fused executions actually run."""
        with self._lock:
            recent = list(self._recent)
        if not recent or not self.policy.max_batch_size:
            return 0.0
        return (sum(recent) / len(recent)) / self.policy.max_batch_size

    @property
    def service_ema_us(self) -> float:
        return self._service_ema_us

    def describe(self) -> dict:
        return {
            "policy": self.policy.to_dict(),
            "pending": self.pending(),
            "occupancy": round(self.occupancy(), 4),
            "batches": self.batches,
            "rows": self.rows,
            "wait_ns": self.wait_ns,
            "shed": self.shed.get_value(),
            "max_batch_seen": self.max_batch_seen,
            "service_ema_us": round(self._service_ema_us, 1),
        }

    def stop(self) -> None:
        """Refuse new rows, then drain what is queued (requests already
        admitted deserve execution, not an error), release variables.
        stop() is the SOLE drainer: it waits out any in-flight batch
        first — flushing alongside one would run the user handler
        concurrently with itself, breaking the one-batch-per-method
        guarantee — then flushes the backlog window by window on this
        thread.  A handler stuck past the bounded wait forfeits the
        backlog: remaining rows are shed so no client waits forever on
        a flush that will never come."""
        with self._lock:
            self._stopped = True
        deadline_ns = _time.monotonic_ns() + 5_000_000_000
        while True:
            with self._lock:
                busy = self._in_flight
                rows = (None if busy or not self._pending
                        else self._take_pending_locked())
                if rows is not None:
                    # completion (sync or async) clears this through the
                    # stopped branch of _next_window_locked_step; an
                    # async handler keeps the loop waiting here instead
                    # of overlapping it with the next window
                    self._in_flight = True
            if busy:
                if _time.monotonic_ns() > deadline_ns:
                    with self._lock:
                        stale = []
                        while self._pending:
                            stale.extend(self._take_pending_locked())
                    if stale:
                        self._shed(stale, _admission.shed_code("stopping"),
                                   "batcher stopping (retry elsewhere)",
                                   reason_key="stopping")
                    break
                _time.sleep(0.001)
                continue
            if rows is None:
                break
            self._flush(rows)
        self.batch_size_rec.hide()
        self._occ_var.hide()
        self.shed.hide()
        self._wait_var.hide()
        if self._pad_freelist is not None:
            self._pad_freelist.clear()
