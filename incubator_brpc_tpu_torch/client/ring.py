"""Submission/completion ring — vectorized client calls.

io_uring's cure for syscall-bound IO, applied to the Python↔C boundary:
the sync fast path (docs/fastpath.md) costs one boundary crossing per
RPC, which caps the Python API well below what the native engine
sustains.  A :class:`SubmissionRing` amortizes that crossing over a
WINDOW: Python stages N same-method calls and crosses ONCE
(``mux_submit_many`` — one C lock pass, one staging append, one reactor
wake), the C mux pipelines the frames onto the socket in one writev
burst, and completions come back in bursts through ``mux_harvest`` into
a PREALLOCATED completion ring (zero per-call Python allocation; the
7-slot lists are reused across harvests).

Correlation-slot lifecycle (exactly-once by construction):

1. ``submit()`` assigns a slot id and stages the call.
2. ``flush()`` reserves a contiguous ring-tag block (bit 63 set — the
   engine routes these completions to a ring-only queue the channel's
   background harvester can never steal from) and maps tag → slot.
3. The engine completes every registered cid exactly once: response,
   timeout sweep (-110), connection reset (-EPIPE), or client destroy
   (-ECANCELED).
4. ``harvest()`` pops the tag mapping and resolves the slot exactly
   once; transport errors may first resubmit under the remaining global
   deadline (a fresh single-call window, same slot).  A slot failed by
   the backstop drops its tag into a zombie set so a late completion is
   discarded instead of double-resolving.

Fallback matrix (degradation is byte-for-byte the existing per-call
path — literally ``channel.call_method``):

=====================================  =================================
call shape                             path taken
=====================================  =================================
plain call, native channel             ring (vectorized)
caller-provided Controller             per-call ``call_method`` (which
(tenant-tagged, attachment, stream,    itself picks the fused native
compression, per-call overrides)       path or the Python path per its
                                       own gate — the tenant
                                       quota rule rides along for free)
non-native channel (incl. fan-out/     per-call ``call_method`` with
combo subclasses)                      pooled controllers
=====================================  =================================

Error semantics are ERPC-only in every lane: a failed slot yields a
:class:`RingFailure` carrying the same (error_code, error_text) the
equivalent ``call_method`` would have put on the controller, and pooled
controllers are wiped on recycle exactly as on the fast path.
"""

from __future__ import annotations

import itertools
import threading
from time import monotonic_ns as _monotonic_ns
from typing import List, Optional

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.chaos import injector as _chaos
from incubator_brpc_tpu_torch.client.controller import (
    acquire_controller,
    release_controller,
)

# default completion-ring depth == the C harvest batch cap
RING_DEPTH = 128
# hard per-window cap enforced by the extension; flush() chunks to it
WINDOW_MAX = 1024

# process-wide /metrics counters (lazy: the first flush binds them so a
# bare `import client.ring` stays metrics-free)
_metrics = None


def _ring_metrics():
    global _metrics
    if _metrics is None:
        from incubator_brpc_tpu_torch.metrics import ring_metrics

        _metrics = ring_metrics
    return _metrics


class _FanoutLog:
    """Process-wide step log for windowed shard fan-out (docs/fastpath.md
    "server ring" → shard windows).  Counts only — the proof that a
    64-key get_many or a PS fan-out crossed the C boundary once per
    SHARD (not once per key) is ``keys_per_crossing`` ≫ 1 with
    ``crossings == shards`` per window."""

    def __init__(self):
        self._lock = threading.Lock()
        self.windows = 0         # fan-out windows issued
        self.crossings = 0       # per-shard sub-window submissions
        self.keys = 0            # keys/requests carried by those windows
        self.fallback_calls = 0  # per-call degradations inside fan-outs

    def record(self, crossings: int, keys: int,
               fallback_calls: int = 0) -> None:
        with self._lock:
            self.windows += 1
            self.crossings += crossings
            self.keys += keys
            self.fallback_calls += fallback_calls

    def counters(self) -> dict:
        with self._lock:
            crossings = self.crossings
            return {
                "windows": self.windows,
                "crossings": crossings,
                "keys": self.keys,
                "fallback_calls": self.fallback_calls,
                "keys_per_crossing": (
                    self.keys / crossings if crossings else 0.0
                ),
            }


fanout_log = _FanoutLog()


class RingFailure:
    """A failed ring slot: the (error_code, error_text) pair the
    equivalent per-call path would have set on its Controller."""

    __slots__ = ("error_code", "error_text")

    def __init__(self, error_code: int, error_text: str):
        self.error_code = error_code
        self.error_text = error_text

    def failed(self) -> bool:
        return True

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"RingFailure({self.error_code}, {self.error_text!r})"


class RingReply(bytes):
    """A ring slot's reply that carried an attachment: the response
    message bytes themselves (so it parses and compares as ``bytes``),
    plus ``attachment``, the reply's attachment as an :class:`IOBuf`
    taken off the controller before the pool wipes it.  A reply without
    an attachment stays plain ``bytes``."""

    def __new__(cls, message: bytes, attachment):
        obj = super().__new__(cls, message)
        obj.attachment = attachment
        return obj

    @property
    def message(self) -> bytes:
        return bytes(self)


class SubmissionRing:
    """One caller's submission window + completion ring over a native
    channel's mux client.  NOT thread-safe: a ring belongs to one
    submitting thread (create one per pipeline; ``Channel.call_many``
    serializes on the channel's internal ring with a lock).

    ``harvest()``/``drain()`` hand out ``(slot, result)`` pairs; a result
    is the response bytes, a :class:`RingReply` (the bytes plus their
    ``attachment``) when the reply carried an attachment, or a
    :class:`RingFailure`.
    """

    def __init__(self, channel, depth: int = RING_DEPTH):
        self._channel = channel
        self.depth = max(1, min(int(depth), RING_DEPTH))
        # preallocated completion ring: 7-slot lists reused across
        # harvests (mux_harvest fills them in place)
        self._ring = [[None] * 7 for _ in range(RING_DEPTH)]
        self._slot_iter = itertools.count(1)
        # slot id -> [key, method_name, payload, timeout_ms, log_id,
        #             retries_left, deadline_ns]
        self._state = {}
        self._tag2slot = {}
        self._staged: List[int] = []  # slot ids awaiting flush()
        # (key, timeout) shared by everything staged, or None when
        # nothing is staged; _staged_mixed records that two different
        # pairs were staged so flush() must group slot-by-slot.  The
        # common case (one submit_all window) skips the grouping pass.
        self._staged_kt = None
        self._staged_mixed = False
        self._done: List[tuple] = []  # (slot_id, result) ready to hand out
        self._done_slots = set()      # O(1) mirror of _done's slot ids
        # ---- step-log counters (the "fails loudly" contract):
        # a silently-degraded ring shows up as boundary_crossings ≈
        # submissions or fallback_calls > 0, not just as lower qps
        self.submissions = 0          # calls staged onto the ring
        self.windows = 0              # submit_many crossings
        self.harvest_batches = 0      # non-empty harvest crossings
        self.boundary_crossings = 0   # windows + harvests (+ retries)
        self.completions = 0          # ring completions consumed
        self.fallback_calls = 0       # calls degraded to call_method
        self.retries = 0              # transport-error resubmits
        self.double_resolves = 0      # MUST stay 0 (exactly-once guard)

    # ---- submission --------------------------------------------------------
    def submit(self, method_spec, request, timeout_ms: Optional[int] = None,
               controller=None) -> int:
        """Stage one call; returns its slot id.  The call crosses into C
        on the next ``flush()`` (or immediately, per-call, when it is not
        ring-eligible — see the fallback matrix above)."""
        slot = next(self._slot_iter)
        ch = self._channel
        if controller is not None or not ch._native_fast:
            self._fallback_call(slot, method_spec, request, timeout_ms,
                                controller)
            return slot
        mux = ch._native_mux()
        if mux is None:
            self._fallback_call(slot, method_spec, request, timeout_ms, None)
            return slot
        payload = (
            request if type(request) is bytes else request.SerializeToString()
        )
        if timeout_ms is None:
            timeout_ms = ch.options.timeout_ms
        key = method_spec.__dict__.get("_native_key")
        if key is None:
            key = (
                method_spec.service_name.encode(),
                method_spec.method_name.encode(),
            )
            method_spec._native_key = key
        max_retry = max(0, ch.options.max_retry)
        tmo = timeout_ms if timeout_ms and timeout_ms > 0 else -1
        deadline_ns = (
            _monotonic_ns() + tmo * 1_000_000 if tmo > 0 else None
        )
        self._state[slot] = [
            key, method_spec.method_name, payload, tmo,
            0, max_retry, deadline_ns,
        ]
        kt = (key, tmo)
        if self._staged_kt is None:
            self._staged_kt = kt
        elif self._staged_kt != kt:
            self._staged_mixed = True
        self._staged.append(slot)
        self.submissions += 1
        if len(self._staged) >= self.depth:
            self.flush()
        return slot

    def submit_all(self, method_spec, requests,
                   timeout_ms: Optional[int] = None) -> List[int]:
        """Bulk-stage N same-method calls; returns their slot ids in
        order.  The per-call constants (native key, timeout, deadline,
        retry budget) are computed ONCE per window, so the per-call
        Python cost drops to one state row and two appends — this is
        the staging half of the ≥2x-sync budget.  Degrades to per-call
        submit() (same fallback matrix) off the native lane."""
        ch = self._channel
        if not ch._native_fast or ch._native_mux() is None:
            return [self.submit(method_spec, r, timeout_ms)
                    for r in requests]
        if timeout_ms is None:
            timeout_ms = ch.options.timeout_ms
        key = method_spec.__dict__.get("_native_key")
        if key is None:
            key = (
                method_spec.service_name.encode(),
                method_spec.method_name.encode(),
            )
            method_spec._native_key = key
        mname = method_spec.method_name
        tmo = timeout_ms if timeout_ms and timeout_ms > 0 else -1
        max_retry = max(0, ch.options.max_retry)
        deadline_ns = (
            _monotonic_ns() + tmo * 1_000_000 if tmo > 0 else None
        )
        kt = (key, tmo)
        if self._staged_kt is None:
            self._staged_kt = kt
        elif self._staged_kt != kt:
            self._staged_mixed = True
        state = self._state
        staged = self._staged
        nxt = self._slot_iter.__next__
        depth = self.depth
        slots = []
        for req in requests:
            payload = (
                req if type(req) is bytes else req.SerializeToString()
            )
            slot = nxt()
            state[slot] = [key, mname, payload, tmo, 0, max_retry,
                           deadline_ns]
            if self._staged_kt is None:  # re-arm after a mid-loop flush
                self._staged_kt = kt
            staged.append(slot)
            slots.append(slot)
            if len(staged) >= depth:
                self.flush()
        self.submissions += len(slots)
        return slots

    def _fallback_call(self, slot, method_spec, request, timeout_ms,
                       controller) -> None:
        """Per-call degradation: EXACTLY the existing path.  call_method
        applies its own native/Python gate (tenant, streams, attachments,
        compression), so semantics — including the tenant-quota
        rule and ERPC error codes — are byte-for-byte the old path."""
        self.fallback_calls += 1
        ctrl = controller
        pooled = ctrl is None
        if pooled:
            ctrl = acquire_controller()
        if timeout_ms is not None and ctrl.timeout_ms is None:
            ctrl.timeout_ms = timeout_ms
        try:
            # a real response object, not bytes-mode: response_bytes is
            # a native-lane contract and the whole point here is that
            # the call may take the pure Python path (tenant, non-native
            # channel) — which only fills a message.  Re-serializing
            # normalizes the return type; it costs one pb round trip on
            # the (rare) fallback lane only.
            resp = method_spec.response_class()
            self._channel.call_method(method_spec, ctrl, request, resp)
            if ctrl.error_code:
                result = RingFailure(ctrl.error_code, ctrl.error_text())
            else:
                result = resp.SerializeToString()
                att = ctrl.__dict__.get("response_attachment")
                if att:
                    result = RingReply(result, att)
        finally:
            if pooled:
                release_controller(ctrl)  # wiped on recycle
        self._resolve(slot, result)

    def flush(self) -> None:
        """Cross the boundary ONCE per (method, timeout) group: reserve
        a ring-tag block, stage the whole window via mux_submit_many.
        Calls the engine refuses to stage (shutdown / dead conn with a
        deep backlog) fail immediately with the transport error the
        per-call path maps to EFAILEDSOCKET."""
        if not self._staged:
            return
        staged, self._staged = self._staged, []
        kt, self._staged_kt = self._staged_kt, None
        mixed, self._staged_mixed = self._staged_mixed, False
        if kt is not None and not mixed:
            # uniform window (the submit_all case): skip the per-slot
            # grouping pass entirely
            groups = {kt: staged}
        else:
            groups = {}
            for slot in staged:
                st = self._state[slot]
                groups.setdefault((st[0], st[3]), []).append(slot)
        mux = self._channel._native_mux()
        for (key, timeout_ms), slots in groups.items():
            if _chaos.armed:
                spec = _chaos.check(
                    "ring.submit",
                    method=self._state[slots[0]][1],
                    direction="submit",
                )
                if spec is not None:
                    if spec.action == "delay_us":
                        _chaos.sleep_us(spec.arg)
                    elif spec.action == "drop":
                        # the window never reaches the mux: every slot
                        # completes exactly once with the transport
                        # error, no stranded waiter
                        for slot in slots:
                            self._state.pop(slot, None)
                            self._resolve(slot, RingFailure(
                                errors.EFAILEDSOCKET,
                                "chaos: ring window dropped",
                            ))
                        continue
            for base in range(0, len(slots), WINDOW_MAX):
                chunk = slots[base:base + WINDOW_MAX]
                payloads = [self._state[s][2] for s in chunk]
                tag_base = mux.reserve_ring_tags(len(chunk))
                for i, slot in enumerate(chunk):
                    self._tag2slot[tag_base + i] = slot
                self.windows += 1
                self.boundary_crossings += 1
                m = _ring_metrics()
                m.rpc_ring_windows << 1
                m.rpc_ring_crossings << 1
                n = mux.submit_window(
                    key[0], key[1], payloads, timeout_ms, 0, tag_base
                )
                for i in range(n, len(chunk)):
                    slot = chunk[i]
                    self._tag2slot.pop(tag_base + i, None)
                    self._state.pop(slot, None)
                    self._resolve(slot, RingFailure(
                        errors.EFAILEDSOCKET,
                        "native transport error rc=-32 (ring submit)",
                    ))

    # ---- completion --------------------------------------------------------
    def harvest(self, timeout_ms: int = 0) -> List[tuple]:
        """Burst-harvest ring completions into the preallocated ring
        and resolve their slots.  Returns every newly resolved
        (slot_id, result) pair — including fallback and failed-at-flush
        results queued since the last call.  result is response bytes
        or a RingFailure.

        All rings on one channel share the mux's C-side completion
        lane.  LEADER/FOLLOWER: the ring holding the mux's harvest lock
        drains the lane and routes every completion — its own resolve
        in place, a SIBLING's parks in the stash with a condition
        notify.  A ring that loses the lock waits on that condition
        instead of contending for the lane, so a completion harvested
        by a sibling costs its owner one wakeup, not a harvest timeout
        (the 860-vs-200k-qps difference under 8 concurrent rings)."""
        out = self._take_done()
        if not self._tag2slot:
            return out
        mux = self._channel._native_mux()
        deadline = _monotonic_ns() + max(0, timeout_ms) * 1_000_000
        while True:
            self._claim_stash(mux)
            if self._done:
                break  # resolved from the stash: no crossing needed
            if mux._ring_harvest_lock.acquire(blocking=False):
                try:
                    remaining_ms = max(
                        0, (deadline - _monotonic_ns()) // 1_000_000
                    )
                    self._harvest_lane(mux, int(remaining_ms))
                finally:
                    mux._ring_harvest_lock.release()
                break
            # follower: a sibling is draining the lane on our behalf;
            # sleep until it stashes something for us or the lane frees
            # up (bounded so a departing leader can't strand us)
            wait_s = (deadline - _monotonic_ns()) / 1e9
            if wait_s <= 0:
                break
            with mux._ring_lock:
                if not any(t in mux._ring_stash for t in self._tag2slot):
                    mux._ring_stash_cv.wait(min(wait_s, 0.05))
        out.extend(self._take_done())
        return out

    def _claim_stash(self, mux) -> None:
        """Consume any of our completions a sibling ring parked."""
        if not mux._ring_stash:
            return
        with mux._ring_lock:
            claimed = [
                mux._ring_stash.pop(t)
                for t in list(self._tag2slot)
                if t in mux._ring_stash
            ]
        for comp in claimed:
            self._consume(mux, comp)

    def _harvest_lane(self, mux, timeout_ms: int) -> None:
        """One boundary crossing as the lane leader: drain the C-side
        completion queue and route every tuple to its owner."""
        self.boundary_crossings += 1
        _ring_metrics().rpc_ring_crossings << 1
        n = mux.harvest_window(timeout_ms, self._ring)
        if n > 0:
            self.harvest_batches += 1
            self.completions += n
        stashed = False
        t2s = self._tag2slot
        state = self._state
        done_slots = self._done_slots
        done = self._done
        for i in range(n):
            row = self._ring[i]
            slot = t2s.get(row[0])
            if (slot is not None and row[1] == 0 and not row[4]
                    and not row[3] and not row[6]):
                # inlined common shape (success, no error/attachment/
                # compression): the body bytes are an owned object, so
                # handing row[2] out is safe even though the 7-slot
                # list itself is reused by the next harvest
                del t2s[row[0]]
                state.pop(slot, None)
                if slot in done_slots:
                    self.double_resolves += 1
                else:
                    done_slots.add(slot)
                    done.append((slot, row[2]))
                continue
            # copy out of the preallocated slot: a stashed tuple must
            # survive the slot being overwritten by the next harvest
            comp = tuple(row)
            if slot is not None:
                self._consume(mux, comp)
            else:
                with mux._ring_lock:
                    if comp[0] in mux._ring_zombie:
                        # late completion for a backstop-failed slot:
                        # already resolved; drop it (exactly-once)
                        mux._ring_zombie.discard(comp[0])
                    else:
                        mux._ring_stash[comp[0]] = comp
                        stashed = True
        if stashed:
            with mux._ring_lock:
                mux._ring_stash_cv.notify_all()

    def _consume(self, mux, comp) -> None:
        """Resolve one completion tuple against its slot — exactly once
        (tag→slot single-pop); transport errors may first resubmit."""
        tag, rc, body, att_size, ec, etext, ctype = comp
        slot = self._tag2slot.pop(tag, None)
        if slot is None:
            return
        st = self._state[slot]
        if rc not in (0, -110) and st[5] > 0:
            # transport error with retry budget: resubmit within the
            # remaining global deadline (mirrors _call_native_slow's
            # retry-on-global-deadline loop), as a single-call window
            remaining_ms = -1
            if st[6] is not None:
                remaining_ms = (st[6] - _monotonic_ns()) // 1_000_000
            if st[6] is None or remaining_ms > 0:
                st[5] -= 1
                st[4] += 1
                self.retries += 1
                self.windows += 1
                self.boundary_crossings += 1
                m = _ring_metrics()
                m.rpc_ring_windows << 1
                m.rpc_ring_crossings << 1
                self._tag2slot[tag] = slot
                k = mux.submit_window(
                    st[0][0], st[0][1], [st[2]],
                    int(remaining_ms) if remaining_ms > 0 else -1,
                    0, tag,
                )
                if k == 1:
                    return
                self._tag2slot.pop(tag, None)
            else:
                rc = -110  # deadline exhausted mid-retry
        self._state.pop(slot, None)
        self._resolve(slot, self._map_completion(
            rc, body, att_size, ec, etext, ctype
        ))

    def _map_completion(self, rc, body, att_size, ec, etext, ctype):
        """rc/ec → result, with EXACTLY the per-call path's semantics:
        the common shape short-circuits to bytes; everything else runs
        through _finish_native_response on a pooled controller so error
        mapping, attachment split, and decompression stay one copy.  An
        attachment leaves with the message as a RingReply, taken before
        release_controller wipes the controller."""
        if rc == 0 and not ec and not att_size and not ctype:
            return body
        ctrl = acquire_controller()
        try:
            self._channel._finish_native_response(
                ctrl, None, rc, body if body is not None else b"",
                att_size, ec, etext, ctype,
            )
            if ctrl.error_code:
                return RingFailure(ctrl.error_code, ctrl.error_text())
            rb = ctrl.__dict__.get("response_bytes")
            rb = rb if rb is not None else b""
            att = ctrl.__dict__.get("response_attachment")
            return RingReply(rb, att) if att else rb
        finally:
            release_controller(ctrl)

    def _take_done(self) -> List[tuple]:
        out, self._done = self._done, []
        self._done_slots.clear()
        return out

    def _resolve(self, slot: int, result) -> None:
        if slot in self._done_slots:
            self.double_resolves += 1  # must never happen
            return
        self._done_slots.add(slot)
        self._done.append((slot, result))

    def outstanding(self) -> int:
        """Slots submitted but not yet handed out by harvest()."""
        return len(self._tag2slot) + len(self._staged) + len(self._done)

    def drain(self, extra_ms: int = 2000) -> List[tuple]:
        """Flush, then harvest until every slot resolves.  The engine's
        timeout sweep delivers -110 at each call's deadline; the
        extra_ms backstop only guards against a wedged reactor — expired
        slots fail with ERPCTIMEDOUT and their tags go to the zombie set
        so a late completion cannot double-resolve."""
        self.flush()
        results = []
        deadline = None
        for st in self._state.values():
            d = st[6]
            if d is None:
                deadline = None
                break
            deadline = d if deadline is None else max(deadline, d)
        backstop = (
            _monotonic_ns() + (extra_ms + 3_600_000 if deadline is None
                               else extra_ms) * 1_000_000
            if deadline is None
            else deadline + extra_ms * 1_000_000
        )
        while True:
            results.extend(self.harvest(timeout_ms=50))
            if not self._tag2slot and not self._done:
                break
            if _monotonic_ns() > backstop:
                mux = self._channel._native_mux()
                for tag, slot in list(self._tag2slot.items()):
                    self._tag2slot.pop(tag, None)
                    with mux._ring_lock:
                        mux._ring_zombie.add(tag)
                    self._state.pop(slot, None)
                    self._resolve(slot, RingFailure(
                        errors.ERPCTIMEDOUT, "reached timeout"
                    ))
                results.extend(self.harvest(timeout_ms=0))
                break
        return results

    def counters(self) -> dict:
        """Python-side step-log counters; pair with the C side's
        mux.ring_stats() when proving the ring isn't degraded."""
        return {
            "submissions": self.submissions,
            "windows": self.windows,
            "harvest_batches": self.harvest_batches,
            "boundary_crossings": self.boundary_crossings,
            "completions": self.completions,
            "fallback_calls": self.fallback_calls,
            "retries": self.retries,
            "double_resolves": self.double_resolves,
        }


def call_many(channel, method_spec, requests, timeout_ms=None,
              controllers=None):
    """Vectorized call: N same-method requests, results in order —
    response bytes per success (a :class:`RingReply` when the reply
    carried an attachment), :class:`RingFailure` per failure.  See
    ``Channel.call_many`` for the public contract."""
    n = len(requests)
    if controllers is not None and len(controllers) != n:
        raise ValueError("controllers must match requests 1:1")
    ring = channel._submission_ring()
    if controllers is None:
        slots = ring.submit_all(method_spec, requests, timeout_ms)
    else:
        slots = [
            ring.submit(method_spec, requests[i], timeout_ms,
                        controllers[i])
            for i in range(n)
        ]
    pos = {slot: i for i, slot in enumerate(slots)}
    results = [None] * n
    for slot, result in ring.drain():
        idx = pos.get(slot)
        if idx is not None:
            results[idx] = result
    for i in range(n):
        if results[i] is None:  # unreachable unless a slot was lost
            results[i] = RingFailure(
                errors.EINTERNAL, "ring slot never resolved"
            )
    return results


def call_many_grouped(legs, method_spec, timeout_ms=None):
    """Windowed shard fan-out: each leg is ``(ring, rows)`` with rows a
    list of ``(orig_index, request)`` routed to that leg's shard.  Every
    leg's group is staged and FLUSHED before any leg is harvested, so
    all shard sub-windows are in flight concurrently and the C boundary
    is crossed once per SHARD, not once per key (submit side; harvests
    batch per the normal completion lane).  Returns
    ``{orig_index: result}`` — response bytes or :class:`RingFailure`,
    the same per-slot contract as :func:`call_many`.

    Off the native lane a leg's ring degrades per call inside
    ``submit_all`` (byte-identical ERPC semantics via ``call_method``);
    the step log records those as fan-out fallback_calls, so a degraded
    shard path is proven by counts, never guessed from timing."""
    staged = []
    total_keys = 0
    fallback_before = 0
    for ring, rows in legs:
        fallback_before += ring.fallback_calls
        slots = ring.submit_all(
            method_spec, [req for _, req in rows], timeout_ms
        )
        ring.flush()
        staged.append((ring, rows, slots))
        total_keys += len(rows)
    results = {}
    fallback_after = 0
    for ring, rows, slots in staged:
        pos = {slot: i for i, slot in enumerate(slots)}
        seen = set()
        for slot, result in ring.drain():
            i = pos.get(slot)
            if i is not None:
                results[rows[i][0]] = result
                seen.add(i)
        for i, (orig, _) in enumerate(rows):
            if i not in seen:  # unreachable unless a slot was lost
                results[orig] = RingFailure(
                    errors.EINTERNAL, "ring slot never resolved"
                )
        fallback_after += ring.fallback_calls
    fanout_log.record(
        crossings=len(staged),
        keys=total_keys,
        fallback_calls=fallback_after - fallback_before,
    )
    return results
