"""Process-wide fault-injection registry (the chaos/ runtime core).

Injection sites are fixed, named points in the transport/runtime where
a fault can be applied.  Wired sites check the module-level ``armed``
flag inline — one global load on the hot path while disarmed — and
only call :func:`check` when a plan is armed.  ``check`` resolves the
site's specs (prebuilt at arm time), applies match + the seeded
deterministic schedule, records the hit (per-site log +
``chaos_injected_total{site,action}``), and returns the firing spec
for the site to interpret.

Site catalog (see docs/chaos.md for the action matrix):

  socket.write        Socket.write queue-time   drop|delay_us|reset|corrupt
  socket.write_io     per write chunk           short_write|eagain_storm
  socket.read         read loop, per round      short_read|drop|delay_us|
                                                reset|eagain_storm
  dispatcher.dispatch epoll IN hand-off         delay_us
  scheduler.callback  task run                  delay_us
  ici.send            fabric leg                drop|delay_us|reset|
                                                close_mid_batch
  ici.chunk           chunked-send pipeline,    delay_us|reset
                      per chunk
  dcn.send            bridge frame              drop|delay_us|reset|reorder
  stream.frame        streaming frame egress,   drop|delay_us|reorder|reset
                      per frame kind
  batch.flush         micro-batcher flush       delay_us|drop
  collective.merge    sharded-batch merge       delay_us|reset
  admission.decide    admission at dispatch     reject|delay_us
  replica.lease       lease grant/renewal       drop|delay_us
  replica.ack         follower quorum ack       drop|delay_us
  kv.ship             prefill KV SET into the   drop|delay_us
                      cache tier, per layer key
  session.migrate     decode-session handoff    drop|delay_us
  native.srv_read     engine.cpp worker read    short_read|eagain_storm|
                                                reset|delay_us
  native.srv_write    engine.cpp burst flush    short_write|eagain_storm|
                                                reset|delay_us

The two ``native.*`` sites live in C (engine.cpp ``ns_set_fault``):
arming a plan containing them programs the engine's per-site atomics
(action/arg/probability/seed/max_hits) so faults hit the in-place
partial-frame completion and burst-flush paths that never touch
Python.  Their hit counts are harvested back into
``chaos_injected_total`` whenever :func:`site_hits` runs (the
``/chaos`` builtin calls it per render).
"""

from __future__ import annotations

import threading
import time as _time
from typing import Dict, List, Optional, Tuple

from incubator_brpc_tpu_torch.chaos.plan import FaultPlan, FaultSpec, spec_seed
from incubator_brpc_tpu_torch.metrics.multi_dimension import MultiDimension
from incubator_brpc_tpu_torch.metrics.reducer import Adder

# THE hot-path gate: wired sites do `if injector.armed:` inline and
# nothing else while no plan is armed.
armed = False

#: Prometheus-facing hit counter, labeled {site, action}
chaos_injected_total = MultiDimension(Adder, ["site", "action"]).expose(
    "chaos_injected_total"
)

# site → match keys the wired call site actually supplies to check().
# arm() validates against this: a matcher no site feeds (e.g. method
# on socket.write) would compare against None forever and the spec
# would silently never fire.
SITE_MATCH_KEYS: Dict[str, frozenset] = {
    "socket.write": frozenset({"peer"}),
    "socket.write_io": frozenset({"peer"}),
    "socket.read": frozenset({"peer"}),
    "dispatcher.dispatch": frozenset(),
    "scheduler.callback": frozenset(),
    "ici.send": frozenset({"peer"}),
    "ici.chunk": frozenset({"peer"}),
    "dcn.send": frozenset({"peer"}),
    # direction carries the FRAME KIND ("data"/"data_part"/"feedback"/
    # "close"/"half_close") so a plan can fault exactly one frame
    # class (e.g. FEEDBACK loss without touching DATA).  RST frames
    # are not injectable — they ARE the failure path
    "stream.frame": frozenset({"peer", "direction"}),
    "batch.flush": frozenset({"method"}),
    # method carries the batched method whose fused sharded execution
    # is about to dispatch its cross-shard merge (batching/sharded.py)
    "collective.merge": frozenset({"method"}),
    # tier carries the ADMISSION TIER the request resolved to, so a
    # storm plan can reject exactly one tier's traffic
    "admission.decide": frozenset({"method", "tier"}),
    # method carries the RPC method of the submission window about to
    # cross the boundary (client/ring.py SubmissionRing.flush);
    # direction selects the ring HALF — "submit" is the client window
    # flush, "flush" the server response-ring flush (server/server.py
    # resp_ring_flush), so a plan can fault exactly one side
    "ring.submit": frozenset({"method", "direction"}),
    # method carries the CACHE KEY being looked up (cache/store.py
    # HBMCacheStore.get), so a plan can fault exactly one key's reads
    "cache.lookup": frozenset({"method"}),
    # method carries the KEY being copied shard→shard by the live
    # re-sharding coordinator (resharding/migration.py), so a plan can
    # fault exactly one key's copy attempts
    "reshard.copy": frozenset({"method"}),
    # method carries the migration NAME about to bump its epoch
    "reshard.cutover": frozenset({"method"}),
    # method carries the replica GROUP whose lease is being granted or
    # renewed (replication/lease.py LeaseBoard) — drop forces a
    # failover by losing the grant/renewal
    "replica.lease": frozenset({"method"}),
    # method carries the replica GROUP, peer the FOLLOWER whose quorum
    # ack is in flight (replication/group.py ReplicaNode.apply) — a
    # plan can degrade exactly one follower's acks
    "replica.ack": frozenset({"method", "peer"}),
    # deep device-profile capture (observability/profiling.py
    # device_capture) — no match keys, the capture path is singular
    "profile.capture": frozenset(),
    # method carries the per-layer KV KEY being shipped into the cache
    # tier by prefill or a migration checkpoint (serving/prefill.py,
    # serving/decode.py), so a plan can fault exactly one session's —
    # or one layer's — ship
    "kv.ship": frozenset({"method"}),
    # method carries the SESSION id whose decode handoff is about to
    # run (serving/router.py SessionChannel), so a plan can abort
    # exactly one session's migration
    "session.migrate": frozenset({"method"}),
    "native.srv_read": frozenset(),  # native match is rejected anyway
    "native.srv_write": frozenset(),
}

# site → actions it actually applies.  arm() validates against this:
# an unsupported pair would otherwise count hits (budget, metrics,
# /chaos) while injecting nothing — a plan that silently tests nothing.
SITE_ACTIONS: Dict[str, frozenset] = {
    "socket.write": frozenset({"drop", "delay_us", "reset", "corrupt"}),
    "socket.write_io": frozenset({"short_write", "eagain_storm"}),
    "socket.read": frozenset(
        {"short_read", "drop", "delay_us", "reset", "eagain_storm"}
    ),
    "dispatcher.dispatch": frozenset({"delay_us"}),
    "scheduler.callback": frozenset({"delay_us"}),
    "ici.send": frozenset(
        {"drop", "delay_us", "reset", "close_mid_batch"}
    ),
    # per-chunk site inside the pipelined chunked send: "reset" faults
    # chunk k mid-stream (the frame fails with ONE ERPC error and its
    # window credits never leak — regression-tested), "delay_us"
    # stretches one pipeline stage
    "ici.chunk": frozenset({"delay_us", "reset"}),
    "dcn.send": frozenset({"drop", "delay_us", "reset", "reorder"}),
    # streaming-RPC frame egress (streaming/stream.py _send_frame):
    # "drop" loses one frame (a lost FEEDBACK must not deadlock a
    # blocked writer — the idle-timeout escape is regression-tested),
    # "reorder" stash-swaps adjacent frames, "reset" RSTs the STREAM
    # while the shared socket stays up
    "stream.frame": frozenset({"drop", "delay_us", "reorder", "reset"}),
    # micro-batcher flush decision (batching/batcher.py): "drop" loses
    # the flush — the whole window sheds cleanly, every queued
    # controller completes exactly once with EOVERCROWDED (the recovery
    # harness proves no window-credit or freelist-slot leak); "delay_us"
    # stretches one flush (queue_wait grows, deadline sheds may follow)
    "batch.flush": frozenset({"delay_us", "drop"}),
    # cross-shard collective merge of a fused sharded batch
    # (batching/sharded.py ShardedFusedKernel): "delay_us" stretches
    # the merge dispatch, "reset" fails it — the whole batch surfaces
    # ONE exception that the handler maps to per-row ERPC errors while
    # other key-groups in the same batch still execute
    "collective.merge": frozenset({"delay_us", "reset"}),
    # admission decision point (server/admission.py): "reject" forces
    # a shed (EOVERCROWDED, the retry-elsewhere code) — the storm
    # suite's deterministic admission-pressure knob; "delay_us"
    # stretches the decision itself
    "admission.decide": frozenset({"reject", "delay_us"}),
    # client submission-ring window about to cross into the C mux
    # (client/ring.py): "drop" loses the whole window BEFORE it reaches
    # the engine — every slot must still complete exactly once with
    # EFAILEDSOCKET (no stranded waiter, no registered cid leaked);
    # "delay_us" stretches the boundary crossing
    "ring.submit": frozenset({"drop", "delay_us"}),
    # HBM cache store lookup (cache/store.py): "drop" forces a miss
    # for a present key (the client's spill/refill path under a healthy
    # server), "delay_us" stretches the lookup (straggler replica —
    # the locality LB's shed-aware ordering is regression-tested
    # against it)
    "cache.lookup": frozenset({"drop", "delay_us"}),
    # live re-sharding per-key copy attempt (resharding/migration.py
    # ReshardCoordinator): "drop" skips this attempt (the key stays
    # pending and is retried next round — the complete-or-rollback
    # proof rides this), "corrupt" flips the post-copy checksum so the
    # range re-copies (counted in rpc_reshard_checksum_failures),
    # "delay_us" stretches one copy (widens the kill-mid-COPY window)
    "reshard.copy": frozenset({"drop", "delay_us", "corrupt"}),
    # the single epoch-bump publication that cuts traffic over to the
    # new scheme: "drop" aborts the cutover (the migration must roll
    # back to the old scheme cleanly), "delay_us" stretches the window
    # where in-flight fan-outs race the bump
    "reshard.cutover": frozenset({"drop", "delay_us"}),
    # leader-lease grant/renewal decision (replication/lease.py
    # LeaseBoard.acquire/renew): "drop" loses the grant or renewal —
    # the lease lapses and the group fails over within the TTL budget
    # (the RecoveryHarness leader-kill acceptance rides this);
    # "delay_us" stretches the decision (slow board)
    "replica.lease": frozenset({"drop", "delay_us"}),
    # a follower's quorum ack (replication/group.py ReplicaNode.apply):
    # "drop" loses the ack AFTER the follower applied the write — the
    # write is durable there but uncounted, so quorum degrades while
    # readable data does not (regression-tested); "delay_us" stretches
    # the ack (slow follower — the write waits, never wedges)
    "replica.ack": frozenset({"drop", "delay_us"}),
    # deep-capture entry (observability/profiling.py device_capture):
    # "drop" fails the capture before any profiler session arms (the
    # page degrades to an error response; serving and the trace-session
    # state must be untouched — regression-tested), "delay_us"
    # stretches the capture start (a slow capture must not stall
    # serving: it runs on the caller's worker only)
    "profile.capture": frozenset({"delay_us", "drop"}),
    # prefill's (or a checkpoint's) per-layer KV SET into the cache
    # tier (serving/prefill.py _ship_kv): "drop" fails the ship — the
    # prefill RPC surfaces ONE ERPC error to the client, NEVER a
    # silent recompute (a later retry re-executes prefill explicitly
    # and counts in prefill_executions); "delay_us" stretches one
    # layer's ship (slow cache replica)
    "kv.ship": frozenset({"drop", "delay_us"}),
    # the decode-session handoff decision (serving/router.py): "drop"
    # aborts the handoff — the session STAYS on its source replica and
    # keeps streaming there (ownership epoch does not bump);
    # "delay_us" stretches the handoff window (tokens drain, target
    # admission waits)
    "session.migrate": frozenset({"drop", "delay_us"}),
    "native.srv_read": frozenset(
        {"short_read", "eagain_storm", "reset", "delay_us"}
    ),
    "native.srv_write": frozenset(
        {"short_write", "eagain_storm", "reset", "delay_us"}
    ),
}

SITES: Dict[str, str] = {
    "socket.write": "Socket.write queue-time (drop/delay_us/reset/corrupt)",
    "socket.write_io": "per-chunk socket write (short_write/eagain_storm)",
    "socket.read": "transport read loop (short_read/drop/delay_us/reset/"
                   "eagain_storm)",
    "dispatcher.dispatch": "event-dispatcher IN hand-off (delay_us)",
    "scheduler.callback": "runtime task run (delay_us)",
    "ici.send": "ICI fabric leg (drop/delay_us/reset/close_mid_batch)",
    "ici.chunk": "chunked ICI send, per pipeline chunk (delay_us/reset)",
    "dcn.send": "DCN bridge frame (drop/delay_us/reset/reorder)",
    "stream.frame": "streaming-RPC frame egress, per frame kind "
                    "(drop/delay_us/reorder/reset→stream RST)",
    "batch.flush": "micro-batcher flush decision (delay_us/drop→shed)",
    "collective.merge": "cross-shard merge of a fused sharded batch "
                        "(delay_us/reset→per-row ERPC)",
    "admission.decide": "admission decision at dispatch "
                        "(reject→EOVERCROWDED shed/delay_us)",
    "ring.submit": "ring window crossing into C — direction=submit is "
                   "the client window (drop→whole window EFAILEDSOCKET"
                   "/delay_us), direction=flush the server response-"
                   "ring flush (drop→window's replies lost, clients "
                   "recover by timeout/retry)",
    "cache.lookup": "HBM cache store lookup, per key "
                    "(drop→forced miss/delay_us)",
    "reshard.copy": "live re-sharding per-key copy, shard→shard "
                    "(drop→retry next round/delay_us/corrupt→re-copy)",
    "reshard.cutover": "re-sharding epoch-bump publication "
                       "(drop→rollback/delay_us)",
    "replica.lease": "leader-lease grant/renewal, per replica group "
                     "(drop→forced failover/delay_us)",
    "replica.ack": "follower quorum ack, per group+follower "
                   "(drop→ack lost after apply/delay_us)",
    "profile.capture": "deep device-profile capture entry "
                       "(drop→error page, no armed trace leaked/delay_us)",
    "kv.ship": "prefill/checkpoint KV SET into the cache tier, per "
               "layer key (drop→ERPC to client, never a silent "
               "recompute/delay_us)",
    "session.migrate": "decode-session handoff, per session "
                       "(drop→handoff aborted, session stays on "
                       "source/delay_us)",
    "native.srv_read": "engine.cpp server read (short_read/eagain_storm/"
                       "reset/delay_us)",
    "native.srv_write": "engine.cpp server write/burst flush (short_write/"
                        "eagain_storm/reset/delay_us)",
}

_NATIVE_SITE_IDS = {"native.srv_read": 0, "native.srv_write": 1}
# engine.cpp FaultAction enum: 1=short 2=eagain 3=reset 4=delay
_NATIVE_ACTIONS = {
    "short_read": 1,
    "short_write": 1,
    "eagain_storm": 2,
    "reset": 3,
    "delay_us": 4,
}

# delays are test instruments, not stress weapons: cap one injected
# sleep so a bad plan can't wedge a dispatcher thread for seconds
MAX_DELAY_US = 200_000

_lock = threading.Lock()
_count_lock = threading.Lock()  # guards _hit_log/_site_counts updates
_plan: Optional[FaultPlan] = None
_by_site: Dict[str, List[FaultSpec]] = {}
_hit_log: List[Tuple[str, str, int]] = []
# replay-log cap: the determinism suite compares modest logs; a chaos
# load test firing millions of times must not pin memory (counts keep
# accumulating in _site_counts past the cap)
HIT_LOG_MAX = 100_000
# incremental per-(site, action) counters of the current plan — O(1)
# per hit, O(sites) per site_hits() render
_site_counts: Dict[Tuple[str, str], int] = {}
# site -> (action, cumulative hits) already folded into
# chaos_injected_total; kept across disarm (cleared at the next arm)
# so post-run renders still show what the plan did
_native_harvested: Dict[str, Tuple[str, int]] = {}


def sleep_us(us: int) -> None:
    _time.sleep(min(int(us), MAX_DELAY_US) / 1e6)


# ---------------------------------------------------------------------------
# arm / disarm
# ---------------------------------------------------------------------------

def arm(plan: FaultPlan) -> None:
    """Arm `plan` process-wide (replacing any armed plan).  Specs for
    ``native.*`` sites are programmed into the C engine.

    Validation is all-or-nothing and runs BEFORE any state changes: a
    bad plan raises without disarming the currently armed plan and
    without programming any native knob (a half-armed engine whose
    injector reports disarmed would be the worst possible state)."""
    global _plan, armed
    with _lock:
        by_site: Dict[str, List[FaultSpec]] = {}
        for spec in plan.specs:
            if spec.site not in SITES:
                raise ValueError(f"unknown injection site {spec.site!r}")
            if spec.action not in SITE_ACTIONS[spec.site]:
                raise ValueError(
                    f"site {spec.site} does not apply action "
                    f"{spec.action!r} (supported: "
                    f"{sorted(SITE_ACTIONS[spec.site])})"
                )
            bad_keys = set(spec.match) - SITE_MATCH_KEYS[spec.site]
            if bad_keys:
                raise ValueError(
                    f"site {spec.site} does not supply match keys "
                    f"{sorted(bad_keys)} (supported: "
                    f"{sorted(SITE_MATCH_KEYS[spec.site])}) — the spec "
                    f"would silently never fire"
                )
            by_site.setdefault(spec.site, []).append(spec)
        _validate_native(by_site)
        _disarm_locked()
        plan.reset_runtime()
        _arm_native(plan, by_site)
        _by_site.clear()
        _by_site.update(by_site)
        del _hit_log[:]
        _site_counts.clear()
        _native_harvested.clear()
        _plan = plan
        _attach_runtime_hooks()
        armed = True


def disarm() -> None:
    global armed
    with _lock:
        _disarm_locked()


def _disarm_locked() -> None:
    global _plan, armed
    armed = False
    _plan = None
    # fold the engine's final counters into the metric BEFORE clearing
    # the knobs (and before _by_site goes away — the harvest labels
    # hits with the armed spec's action), so post-disarm renders still
    # agree with chaos_injected_total for native sites too
    _harvest_native()
    _clear_native()
    _by_site.clear()
    _detach_runtime_hooks()


def active_plan() -> Optional[FaultPlan]:
    return _plan


# ---------------------------------------------------------------------------
# the per-site decision (hot only while armed)
# ---------------------------------------------------------------------------

def check(
    site: str,
    peer: Optional[str] = None,
    method: Optional[str] = None,
    direction: Optional[str] = None,
    tier: Optional[str] = None,
) -> Optional[FaultSpec]:
    """Evaluate `site` against the armed plan; returns the first spec
    that matches AND fires (recording the hit), else None."""
    plan = _plan
    if plan is None:
        return None
    specs = _by_site.get(site)
    if not specs:
        return None
    for spec in specs:
        if not spec.matches(peer, method, direction, tier):
            continue
        n = spec.should_fire(plan.seed)
        if n >= 0:
            # recording rides a dedicated lock: fires are rare (only
            # actual faults) and the read-modify-write on the counter
            # dict spans bytecodes — racing worker threads would lose
            # increments and break the /chaos == chaos_injected_total
            # agreement
            key = (site, spec.action)
            with _count_lock:
                if len(_hit_log) < HIT_LOG_MAX:
                    _hit_log.append((site, spec.action, n))
                _site_counts[key] = _site_counts.get(key, 0) + 1
            chaos_injected_total.get_stats([site, spec.action]) << 1
            return spec
    return None


def hit_log() -> List[Tuple[str, str, int]]:
    """The (site, action, traversal_index) sequence recorded since the
    last arm() — the replay artifact the determinism suite compares.
    Capped at HIT_LOG_MAX entries; counts keep accumulating in
    site_hits() past the cap."""
    return list(_hit_log)


def site_hits() -> Dict[str, Dict[str, int]]:
    """Per-site per-action hit counts of the CURRENT/most recent plan,
    native sites included (harvesting their C counters as a side
    effect so chaos_injected_total stays in agreement)."""
    _harvest_native()
    out: Dict[str, Dict[str, int]] = {}
    for (site, action), n in list(_site_counts.items()):
        out.setdefault(site, {})[action] = n
    for site, (action, total) in _native_harvested.items():
        if total:
            out.setdefault(site, {})[action] = total
    return out


def describe() -> dict:
    """State dump for the /chaos builtin."""
    plan = _plan
    return {
        "armed": armed,
        "plan": plan.to_dict() if plan is not None else None,
        "sites": site_hits(),
        "catalog": SITES,
    }


# ---------------------------------------------------------------------------
# native (engine.cpp) sites
# ---------------------------------------------------------------------------

def _native_lib():
    from incubator_brpc_tpu_torch import native

    if not native.available():
        return None
    return native


def _native_spec_for(site: str) -> Optional[FaultSpec]:
    specs = _by_site.get(site)
    return specs[0] if specs else None


def _validate_native(by_site: Dict[str, List[FaultSpec]]) -> None:
    """Full validation of every native.* spec, run BEFORE any knob is
    programmed — arm() is all-or-nothing."""
    native_sites = [s for s in by_site if s.startswith("native.")]
    if not native_sites:
        return
    if _native_lib() is None:
        raise RuntimeError(
            "plan names native.* sites but the C engine is not built"
        )
    for site in native_sites:
        specs = by_site[site]
        if len(specs) > 1:
            raise ValueError(f"native site {site} supports one spec per plan")
        spec = specs[0]
        if spec.action not in _NATIVE_ACTIONS:
            raise ValueError(
                f"action {spec.action!r} unsupported on native site {site}"
            )
        # the C side has no every_nth/ttl knobs — refuse rather than
        # silently approximate (a "5s" native plan must not quietly
        # run forever).  match on native sites is already rejected by
        # arm()'s generic SITE_MATCH_KEYS check (they supply no keys).
        if spec.every_nth:
            raise ValueError(f"native site {site} takes probability, "
                             "not every_nth")
        if spec.ttl_s:
            raise ValueError(f"native site {site} has no TTL — bound it "
                             "with max_hits or an explicit disarm")


def _arm_native(plan: FaultPlan, by_site: Dict[str, List[FaultSpec]]) -> None:
    """Program the already-validated native specs into the engine."""
    for site in by_site:
        if not site.startswith("native."):
            continue
        spec = by_site[site][0]
        nat = _native_lib()
        prob_u32 = min(0xFFFFFFFF, int(spec.probability * 4294967296.0))
        nat.set_fault(
            _NATIVE_SITE_IDS[site], _NATIVE_ACTIONS[spec.action], spec.arg,
            prob_u32, spec_seed(plan.seed, spec.spec_id),
            spec.max_hits if spec.max_hits else -1,
        )


def _has_native_sites() -> bool:
    return any(s.startswith("native.") for s in _by_site)


def _clear_native() -> None:
    if not _has_native_sites():
        return  # never touch the engine (a lazy g++ build!) needlessly
    nat = _native_lib()
    if nat is not None:
        nat.clear_faults()


def _harvest_native() -> None:
    """Fold the C engine's per-site hit counters into
    chaos_injected_total (delta against the last harvest).  The armed
    spec's action is recorded WITH the count so post-disarm renders
    (when _by_site is gone) keep the right label.  The delta
    computation is a read-modify-write on _native_harvested: rides
    _count_lock so concurrent harvesters (/chaos renders vs disarm)
    cannot double-count a delta into the metric."""
    if not _has_native_sites():
        # python-only plan (or post-disarm): never touch _native_lib —
        # on a box without the built engine that would run a g++
        # compile inside a /chaos render
        return
    nat = _native_lib()
    if nat is None:
        return
    for site, sid in _NATIVE_SITE_IDS.items():
        spec = _native_spec_for(site)
        if spec is None:
            continue  # site not in the armed plan: counter stays 0
        total = nat.fault_hits(sid)
        with _count_lock:
            _, prev = _native_harvested.get(site, (spec.action, 0))
            if total <= prev:
                continue
            _native_harvested[site] = (spec.action, total)
        chaos_injected_total.get_stats([site, spec.action]) << (total - prev)


# ---------------------------------------------------------------------------
# low-level runtime hooks (scheduler / event dispatcher)
#
# Those modules sit below the metrics stack, so instead of importing
# this module they expose a hook slot the injector fills while armed —
# their disarmed cost is one `is None` check.
# ---------------------------------------------------------------------------

def _scheduler_hook() -> None:
    spec = check("scheduler.callback")
    if spec is not None and spec.action == "delay_us":
        sleep_us(spec.arg)


def _dispatcher_hook() -> None:
    spec = check("dispatcher.dispatch")
    if spec is not None and spec.action == "delay_us":
        sleep_us(spec.arg)


def _attach_runtime_hooks() -> None:
    from incubator_brpc_tpu_torch.runtime import scheduler
    from incubator_brpc_tpu_torch.transport import event_dispatcher

    if "scheduler.callback" in _by_site:
        scheduler.set_chaos_hook(_scheduler_hook)
    if "dispatcher.dispatch" in _by_site:
        event_dispatcher.set_chaos_hook(_dispatcher_hook)


def _detach_runtime_hooks() -> None:
    import sys

    sched = sys.modules.get("incubator_brpc_tpu_torch.runtime.scheduler")
    if sched is not None:
        sched.set_chaos_hook(None)
    disp = sys.modules.get("incubator_brpc_tpu_torch.transport.event_dispatcher")
    if disp is not None:
        disp.set_chaos_hook(None)
