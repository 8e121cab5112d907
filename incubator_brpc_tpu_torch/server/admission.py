"""Admission control — ONE decision point for every server shed path.

The survey's overload story (adaptive_max_concurrency.cpp + backup
requests) previously lived in three unconnected places here: the
per-method concurrency limiter rejected in each protocol's dispatch,
the micro-batcher shed expired rows at flush and overflowing rows at
its queue cap — each with its own error code.  This module unifies
them (docs/overload.md):

* **code mapping** — one table says what each shed means to the
  caller.  ``EOVERCROWDED`` = *this server* is overloaded; the same
  request is fine on a different replica (the client retry policy
  reissues it only against another server).  ``ELIMIT`` = the
  *request* is no longer worth serving (its deadline expired while
  queued); retrying anywhere is wasted work — drop.  ``ECANCELED`` =
  the caller gave up (hedge loser): shed silently, no response.

* **priority tiers + quotas** — tenant identity rides
  ``RpcRequestMeta.tenant``; the policy maps tenants (and methods) to
  tiers.  Each tier has a ``weight`` — its claim on method capacity
  under contention — and lower-priority tiers stop admitting at
  ``limit × share`` while higher tiers run to the full limit, so
  weighted shedding drains the bulk tier before the interactive tier.
  Per-tenant quotas bound one tenant's concurrent rows outright.

* **enforcement at dispatch, before user code** — the protocols call
  :meth:`AdmissionController.admit` where they used to call
  ``status.on_requested()`` directly; the batcher reads the row's tier
  (stamped on the controller) for its tier-aware queue cap and routes
  its shed codes through :func:`shed_code`.

Every shed lands in ``rpc_shed_total{method,tier,reason}``; per-tier
inflight and batch-queue depth are exposed on /metrics; the
``/admission`` builtin live-tunes weights and quotas.  The chaos site
``admission.decide`` (docs/chaos.md) injects forced rejections and
decision delays for the storm suite.

The inactive policy (no tenant/method mappings, no quotas) keeps the
pre-admission fast path: one gate call per request, no ticket object,
no gauge writes — the ``admission_disabled_overhead`` bench pins it
under 1%.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, Optional

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.chaos import injector as _chaos
from incubator_brpc_tpu_torch.metrics.multi_dimension import MultiDimension
from incubator_brpc_tpu_torch.metrics.passive_status import PassiveStatus
from incubator_brpc_tpu_torch.metrics.reducer import Adder

#: canonical tier names (policies may define more)
TIER_INTERACTIVE = "interactive"
TIER_BULK = "bulk"

# ---------------------------------------------------------------------------
# shed-code mapping — THE table (satellite: consistent shed codes)
# ---------------------------------------------------------------------------

#: reason key -> wire error code.  "retry elsewhere" reasons map to
#: EOVERCROWDED, "drop" reasons to ELIMIT, hedge-loser cancellation to
#: ECANCELED (no response at all).  errors.py documents the same split.
SHED_CODES: Dict[str, int] = {
    "overload": errors.EOVERCROWDED,      # concurrency limiter said no
    "tier_share": errors.EOVERCROWDED,    # tier past its capacity share
    "tier_quota": errors.EOVERCROWDED,    # tier past its absolute quota
    "tenant_quota": errors.EOVERCROWDED,  # tenant past its quota
    "queue_full": errors.EOVERCROWDED,    # batch queue cap (max_queue_rows)
    "stopping": errors.EOVERCROWDED,      # batcher draining at stop()
    "chaos": errors.EOVERCROWDED,         # injected admission.decide reject
    "session_cap": errors.EOVERCROWDED,   # decode replica at max_sessions:
    #                                       the session router retries the
    #                                       admission on another replica
    #                                       (serving/decode.py)
    "deadline": errors.ELIMIT,            # expired while queued: drop
    "cancelled": errors.ECANCELED,        # hedge loser: silent shed
}


def shed_code(reason: str) -> int:
    """Wire code for one shed reason — every shed path maps through
    here so a given code always means the same thing to clients."""
    return SHED_CODES.get(reason, errors.EOVERCROWDED)


# ---------------------------------------------------------------------------
# metrics (module-level: names are process-global like every exposed var)
# ---------------------------------------------------------------------------

rpc_shed_total = MultiDimension(Adder, ["method", "tier", "reason"]).expose(
    "rpc_shed_total"
)
rpc_tier_inflight = MultiDimension(Adder, ["tier"]).expose("rpc_tier_inflight")

# live controllers, for the per-tier queue-depth gauges (batch rows
# queued per tier across every server in the process)
_controllers: "weakref.WeakSet[AdmissionController]" = weakref.WeakSet()
_exposed_depth_tiers = set()
_expose_lock = threading.Lock()


def note_shed(method: str, tier: Optional[str], reason: str) -> None:
    rpc_shed_total.get_stats([method, tier or TIER_INTERACTIVE, reason]) << 1


# ---------------------------------------------------------------------------
# per-tier observed latency: the protocols feed
# each completed request's latency here when a tier was stamped, and the
# auto concurrency limiter can derive its pressure signal from a tier's
# OBSERVED p99 instead of a static target (feed_limiter_from_tier_latency)
# ---------------------------------------------------------------------------

_tier_latency: Dict[str, "object"] = {}


def tier_latency_recorder(tier: str):
    """The tier's LatencyRecorder (lazily created + exposed as
    ``rpc_tier_latency_<tier>``) — per-tier qps/p50/p99 on /metrics,
    and the signal source for latency-fed auto limiters."""
    rec = _tier_latency.get(tier)
    if rec is None:
        from incubator_brpc_tpu_torch.metrics.latency_recorder import LatencyRecorder

        with _expose_lock:
            rec = _tier_latency.get(tier)
            if rec is None:
                rec = LatencyRecorder().expose(f"rpc_tier_latency_{tier}")
                _tier_latency[tier] = rec
    return rec


def note_latency(tier: str, latency_us: int) -> None:
    """One completed (non-shed) request's latency for `tier`.  Called
    from the protocol response paths only when a tier was stamped at
    admission, so inactive-policy traffic pays nothing."""
    if latency_us > 0:
        tier_latency_recorder(tier).update(latency_us)


def note_controller_latency(ctrl, latency_us: int) -> None:
    """The one feed point every protocol response path calls (tpu_std,
    HTTP, h2): records `latency_us` for the tier stamped on `ctrl` at
    admission.  Untier-ed (inactive-policy) traffic is one dict miss;
    failed requests (sheds included) stay out of the tail signal —
    fast-fails would deflate the p99 the limiter steers by."""
    tier = ctrl.__dict__.get("_admission_tier")
    if tier is not None and not ctrl.failed():
        note_latency(tier, latency_us)


def _queue_depth(tier: str) -> int:
    total = 0
    for ac in list(_controllers):
        total += ac.queue_depth(tier)
    return total


def _ensure_depth_gauge(tier: str) -> None:
    with _expose_lock:
        if tier in _exposed_depth_tiers:
            return
        PassiveStatus(lambda t=tier: _queue_depth(t)).expose(
            f"rpc_tier_queue_depth_{tier}"
        )
        _exposed_depth_tiers.add(tier)


# default tiers render on /metrics from import time (a metrics
# render lint imports this module)
_ensure_depth_gauge(TIER_INTERACTIVE)
_ensure_depth_gauge(TIER_BULK)


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------


class TierSpec:
    """One priority tier.  ``priority`` 0 is highest (shed last);
    ``weight`` is the tier's claim on method capacity under contention
    — a tier's admission share is (its weight + every lower tier's)
    over the total, so the top tier always sees share 1.0 and lower
    tiers stop admitting earlier.  ``quota`` (0 = unlimited) bounds
    the tier's concurrent rows absolutely, limiter or not."""

    __slots__ = ("name", "priority", "weight", "quota")

    def __init__(self, name: str, priority: int = 0, weight: float = 1.0,
                 quota: int = 0):
        if weight <= 0:
            raise ValueError(f"tier {name!r} weight must be > 0")
        self.name = name
        self.priority = int(priority)
        self.weight = float(weight)
        self.quota = int(quota)

    def to_dict(self) -> dict:
        return {
            "priority": self.priority,
            "weight": self.weight,
            "quota": self.quota,
        }


def _default_tiers() -> Dict[str, TierSpec]:
    # bulk claims 3/4 of capacity under contention; the remaining 1/4
    # is reserved headroom only interactive may use — under overload
    # bulk stops admitting at 75% of the limit while interactive runs
    # to 100%, which is what drains bulk first
    return {
        TIER_INTERACTIVE: TierSpec(TIER_INTERACTIVE, priority=0, weight=1.0),
        TIER_BULK: TierSpec(TIER_BULK, priority=1, weight=3.0),
    }


class AdmissionPolicy:
    """Tier/quota configuration.  Mutable at runtime (the /admission
    builtin live-tunes it); share recomputation happens under the
    policy lock and readers see a consistent snapshot dict."""

    def __init__(
        self,
        tiers: Optional[Dict[str, object]] = None,
        tenant_tiers: Optional[Dict[str, str]] = None,
        method_tiers: Optional[Dict[str, str]] = None,
        tenant_quotas: Optional[Dict[str, int]] = None,
        default_tier: str = TIER_INTERACTIVE,
    ):
        self._lock = threading.Lock()
        self.tiers: Dict[str, TierSpec] = _default_tiers()
        for name, spec in (tiers or {}).items():
            if isinstance(spec, TierSpec):
                self.tiers[name] = spec
            else:
                self.tiers[name] = TierSpec(name, **dict(spec))
        self.tenant_tiers = dict(tenant_tiers or {})
        self.method_tiers = dict(method_tiers or {})
        self.tenant_quotas = {k: int(v) for k, v in (tenant_quotas or {}).items()}
        if default_tier not in self.tiers:
            raise ValueError(f"default_tier {default_tier!r} is not a tier")
        self.default_tier = default_tier
        for t in list(self.tenant_tiers.values()) + list(
            self.method_tiers.values()
        ):
            if t not in self.tiers:
                raise ValueError(f"mapping names unknown tier {t!r}")
        self._shares: Dict[str, float] = {}
        self._recompute_shares()

    @classmethod
    def from_dict(cls, d: dict) -> "AdmissionPolicy":
        known = {"tiers", "tenant_tiers", "method_tiers", "tenant_quotas",
                 "default_tier"}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown admission policy keys {sorted(unknown)} "
                f"(known: {sorted(known)})"
            )
        return cls(**d)

    def _recompute_shares(self) -> None:
        total = sum(t.weight for t in self.tiers.values())
        shares = {}
        for t in self.tiers.values():
            covered = sum(
                u.weight for u in self.tiers.values()
                if u.priority >= t.priority
            )
            shares[t.name] = covered / total if total else 1.0
        self._shares = shares

    def share(self, tier: str) -> float:
        """Fraction of the method limit this tier may fill; 1.0 for
        the highest-priority tier."""
        return self._shares.get(tier, 1.0)

    def tier_of(self, tenant: str, method: str) -> str:
        """Tenant mapping wins, then method mapping, then the default."""
        if tenant:
            t = self.tenant_tiers.get(tenant)
            if t is not None:
                return t
        t = self.method_tiers.get(method)
        return t if t is not None else self.default_tier

    @property
    def active(self) -> bool:
        """False = nothing configured beyond the defaults: every
        request resolves to the default (top) tier with share 1.0 and
        no quota, so admit() may skip tier bookkeeping entirely."""
        return bool(
            self.tenant_tiers
            or self.method_tiers
            or self.tenant_quotas
            or any(t.quota for t in self.tiers.values())
        )

    # ---- live tuning (the /admission builtin posts through these) ----------
    def set_tier(self, name: str, weight: Optional[float] = None,
                 quota: Optional[int] = None,
                 priority: Optional[int] = None) -> TierSpec:
        # validate EVERYTHING before touching state: a failed live-tune
        # must not leave a phantom tier or a half-applied spec behind
        # its 400 response
        if weight is not None:
            weight = float(weight)
            if weight <= 0:
                raise ValueError("weight must be > 0")
        if quota is not None:
            quota = int(quota)
        if priority is not None:
            priority = int(priority)
        created = False
        with self._lock:
            spec = self.tiers.get(name)
            if spec is None:
                created = True
                spec = self.tiers[name] = TierSpec(
                    name, priority=max(
                        (t.priority for t in self.tiers.values()), default=0
                    ) + 1,
                )
            if weight is not None:
                spec.weight = weight
            if quota is not None:
                spec.quota = quota
            if priority is not None:
                spec.priority = priority
            self._recompute_shares()
        if created:
            # a live-created tier gets its queue-depth gauge like tiers
            # declared at construction — otherwise its batch backlog is
            # invisible on /metrics.  Registered OUTSIDE the policy
            # lock: the expose path takes the module gauge lock and
            # nesting it under ours would mint a lock-order edge.
            _ensure_depth_gauge(name)
        return spec

    def set_tenant(self, tenant: str, tier: Optional[str] = None,
                   quota: Optional[int] = None) -> None:
        with self._lock:
            if tier is not None:
                if tier not in self.tiers:
                    raise ValueError(f"unknown tier {tier!r}")
                self.tenant_tiers[tenant] = tier
            if quota is not None:
                if int(quota) <= 0:
                    self.tenant_quotas.pop(tenant, None)
                else:
                    self.tenant_quotas[tenant] = int(quota)

    def set_method_tier(self, method: str, tier: str) -> None:
        with self._lock:
            if tier not in self.tiers:
                raise ValueError(f"unknown tier {tier!r}")
            self.method_tiers[method] = tier

    def snapshot(self):
        """Consistent copies of the mutable maps, under the policy
        lock — renders iterate these while POST /admission mutates the
        originals (an unlocked sorted(...items()) can raise
        'dictionary changed size during iteration')."""
        with self._lock:
            return (
                dict(self.tiers),
                dict(self.tenant_tiers),
                dict(self.method_tiers),
                dict(self.tenant_quotas),
            )

    def to_dict(self) -> dict:
        tiers, tenant_tiers, method_tiers, tenant_quotas = self.snapshot()
        return {
            "tiers": {
                n: dict(t.to_dict(), share=round(self.share(n), 4))
                for n, t in sorted(tiers.items())
            },
            "tenant_tiers": tenant_tiers,
            "method_tiers": method_tiers,
            "tenant_quotas": tenant_quotas,
            "default_tier": self.default_tier,
        }


# ---------------------------------------------------------------------------
# the decision point
# ---------------------------------------------------------------------------


class Admission:
    """One admit() outcome.  ``admitted`` False carries the shed code
    + reason; True may carry a ticket (active policies) that MUST be
    released exactly once when the request completes — the protocols
    release it in their response path."""

    __slots__ = ("admitted", "code", "reason", "tier", "_controller",
                 "_tenant", "_released")

    def __init__(self, admitted: bool, code: int = 0, reason: str = "",
                 tier: Optional[str] = None, controller=None,
                 tenant: str = ""):
        self.admitted = admitted
        self.code = code
        self.reason = reason
        self.tier = tier
        self._controller = controller
        self._tenant = tenant
        self._released = False

    @property
    def ticket(self) -> Optional["Admission"]:
        return self if self._controller is not None else None

    def release(self) -> None:
        """Idempotent: response paths funnel through more than one
        cleanup point and double-decrementing a gauge would corrupt
        the inflight accounting."""
        ac = self._controller
        if ac is None or self._released:
            return
        self._released = True
        ac._on_release(self.tier, self._tenant)


#: shared fast-path outcome for inactive policies — no per-request
#: allocation on the hot path
_ADMIT_PLAIN = Admission(True)


class AdmissionController:
    """Per-Server admission state: the policy plus live per-tier /
    per-tenant inflight counts.  The server owns one; protocols reach
    it via ``server.admission``."""

    def __init__(self, server=None, policy: Optional[AdmissionPolicy] = None):
        # weakref: the module-level gauge registry must not keep dead
        # servers (and their batchers) alive
        self._server_ref = weakref.ref(server) if server is not None else None
        if isinstance(policy, dict):
            policy = AdmissionPolicy.from_dict(policy)
        self.policy = policy or AdmissionPolicy()
        self._lock = threading.Lock()
        self._tier_inflight: Dict[str, int] = {}
        self._tenant_inflight: Dict[str, int] = {}
        # shared outcome for the top-tier short-circuit: carries the
        # policy's default tier (so batcher metrics attribute the rows
        # correctly) but no ticket — default_tier is fixed at policy
        # construction, so one object serves every such request
        self._admit_default = Admission(True, tier=self.policy.default_tier)
        for name in self.policy.tiers:
            _ensure_depth_gauge(name)
        _controllers.add(self)

    # ---- the per-request decision ------------------------------------------
    def admit(self, full_name: str, status, tenant: str = "") -> Admission:
        """Decide one request, before user code.  ``status`` is the
        method's MethodStatus (or None); on admit its concurrency is
        already counted (on_requested ran) — the caller's normal
        on_response accounting is unchanged.  Shed outcomes carry the
        mapped code; the caller answers and returns."""
        policy = self.policy
        if not policy.active:
            # fast path: concurrency gate + code mapping only
            if _chaos.armed:
                denied = self._chaos_check(full_name, policy.default_tier)
                if denied is not None:
                    return denied
            if status is not None and not status.on_requested():
                note_shed(full_name, policy.default_tier, "overload")
                return Admission(
                    False, shed_code("overload"),
                    "method concurrency limit reached (retry elsewhere)",
                    tier=policy.default_tier,
                )
            return _ADMIT_PLAIN
        tier = policy.tier_of(tenant, full_name)
        if _chaos.armed:
            denied = self._chaos_check(full_name, tier)
            if denied is not None:
                return denied
        tspec = policy.tiers.get(tier)
        share = policy.share(tier)
        if (
            share >= 1.0
            and (tspec is None or not tspec.quota)
            and not (tenant and policy.tenant_quotas.get(tenant))
        ):
            # top-tier, quota-free traffic: no tiered rule can shed it,
            # so skip the bookkeeping — an ACTIVE policy costs the
            # unmapped hot path the same as a disabled one (the
            # admission_disabled_overhead bench pins this).  The shared
            # outcome still names the tier so downstream metrics
            # (batch queue depth, shed labels) attribute the rows to
            # the policy's actual default tier, not a hardcoded one.
            if status is not None and not status.on_requested():
                note_shed(full_name, tier, "overload")
                return Admission(
                    False, shed_code("overload"),
                    "method concurrency limit reached (retry elsewhere)",
                    tier=tier,
                )
            return self._admit_default if tier == policy.default_tier else (
                Admission(True, tier=tier)
            )
        limit = 0
        if status is not None and status.limiter is not None:
            limit = status.limiter.max_concurrency()
        # tier share gate: a sub-1.0 tier stops admitting once the
        # method's concurrency would pass limit*share — the reserved
        # headroom above that belongs to higher-priority tiers.  Read
        # before on_requested: approximate under races, exact enough
        # (the hard cap below still holds).
        if limit > 0 and share < 1.0 and status is not None:
            if status.concurrency + 1 > max(1, int(limit * share)):
                note_shed(full_name, tier, "tier_share")
                return Admission(
                    False, shed_code("tier_share"),
                    f"tier {tier} past its {share:.0%} capacity share "
                    f"(retry elsewhere)", tier=tier,
                )
        with self._lock:
            if tspec is not None and tspec.quota:
                if self._tier_inflight.get(tier, 0) + 1 > tspec.quota:
                    deny = ("tier_quota", f"tier {tier} quota "
                            f"{tspec.quota} reached (retry elsewhere)")
                else:
                    deny = None
            else:
                deny = None
            if deny is None and tenant:
                q = policy.tenant_quotas.get(tenant, 0)
                if q and self._tenant_inflight.get(tenant, 0) + 1 > q:
                    deny = ("tenant_quota", f"tenant {tenant!r} quota {q} "
                            f"reached (retry elsewhere)")
            if deny is None:
                self._tier_inflight[tier] = self._tier_inflight.get(tier, 0) + 1
                if tenant:
                    self._tenant_inflight[tenant] = (
                        self._tenant_inflight.get(tenant, 0) + 1
                    )
        if deny is not None:
            reason_key, text = deny
            note_shed(full_name, tier, reason_key)
            return Admission(False, shed_code(reason_key), text, tier=tier)
        rpc_tier_inflight.get_stats([tier]) << 1
        if status is not None and not status.on_requested():
            # the hard concurrency gate; undo the tier bookkeeping the
            # lines above already counted for this request
            self._on_release(tier, tenant)
            note_shed(full_name, tier, "overload")
            return Admission(
                False, shed_code("overload"),
                "method concurrency limit reached (retry elsewhere)",
                tier=tier,
            )
        return Admission(True, tier=tier, controller=self, tenant=tenant)

    def _chaos_check(self, full_name: str, tier: str) -> Optional[Admission]:
        spec = _chaos.check("admission.decide", method=full_name, tier=tier)
        if spec is None:
            return None
        if spec.action == "delay_us":
            _chaos.sleep_us(spec.arg)
            return None
        # action == "reject": a forced shed, the storm suite's
        # deterministic admission-pressure knob
        note_shed(full_name, tier, "chaos")
        return Admission(
            False, shed_code("chaos"),
            "chaos: admission rejected (retry elsewhere)", tier=tier,
        )

    def _on_release(self, tier: Optional[str], tenant: str) -> None:
        tier = tier or self.policy.default_tier
        with self._lock:
            n = self._tier_inflight.get(tier, 0)
            if n > 0:
                self._tier_inflight[tier] = n - 1
            if tenant:
                n = self._tenant_inflight.get(tenant, 0)
                if n > 0:
                    self._tenant_inflight[tenant] = n - 1
        rpc_tier_inflight.get_stats([tier]) << -1

    def feed_limiter_from_tier_latency(
        self, status, tier: str = TIER_INTERACTIVE,
        target_us: int = 100_000, ratio: float = 0.99,
    ):
        """Wire a method's AUTO concurrency limiter to the observed
        per-tier latency (docs/overload.md): the limiter's window
        update reads the tier's live p99 (``ratio``) from the latency
        recorder and, whenever it exceeds ``target_us``, shrinks the
        concurrency limit proportionally — overload pressure measured
        where it hurts (the protected tier's tail) instead of a static
        no-load estimate.  ``status`` is the method's MethodStatus;
        its limiter must support ``set_latency_target`` (the "auto"
        limiter does).  Returns the recorder feeding the signal."""
        limiter = getattr(status, "limiter", None)
        if limiter is None or not hasattr(limiter, "set_latency_target"):
            raise ValueError(
                "feed_limiter_from_tier_latency needs a method whose "
                "limiter supports set_latency_target (max_concurrency="
                '"auto")'
            )
        rec = tier_latency_recorder(tier)
        limiter.set_latency_target(
            lambda: rec.latency_percentile(ratio), target_us
        )
        return rec

    def retire(self) -> None:
        """Detach from the gauge registry and the server (called when a
        replacement controller takes over): in-flight tickets still
        release against this object, but it must stop contributing to
        the per-tier queue-depth gauges — a retired controller summing
        the SAME server's batchers would double-count every queued
        row."""
        _controllers.discard(self)
        self._server_ref = None

    # ---- introspection -----------------------------------------------------
    def tier_inflight(self, tier: str) -> int:
        return self._tier_inflight.get(tier, 0)

    def queue_depths(self) -> Dict[str, int]:
        """Batch rows queued in this server's batchers, grouped by
        tier — ONE pending_by_tier() pass per batcher (renders that
        need several tiers must not re-walk every queue per tier)."""
        server = self._server_ref() if self._server_ref is not None else None
        if server is None:
            return {}
        out: Dict[str, int] = {}
        for batcher in list(getattr(server, "_batchers", {}).values()):
            by_tier = getattr(batcher, "pending_by_tier", None)
            if by_tier is not None:
                for tier, n in by_tier().items():
                    out[tier] = out.get(tier, 0) + n
        return out

    def queue_depth(self, tier: str) -> int:
        """Batch rows queued in this server's batchers for `tier`."""
        return self.queue_depths().get(tier, 0)

    def describe(self) -> dict:
        policy = self.policy
        # snapshot the policy maps under ITS lock (a racing POST
        # /admission mutates them), and take queue depths OUTSIDE the
        # admission lock: they take the batchers' locks, and nesting
        # those under ours would mint a cross-module lock edge for a
        # render
        tier_specs, tenant_tiers, method_tiers, tenant_quotas = (
            policy.snapshot()
        )
        depths = self.queue_depths()
        with self._lock:
            tiers = {}
            for name, spec in sorted(tier_specs.items()):
                tiers[name] = dict(
                    spec.to_dict(),
                    share=round(policy.share(name), 4),
                    inflight=self._tier_inflight.get(name, 0),
                    queue_depth=depths.get(name, 0),
                )
            tenants = {
                t: {
                    "tier": tenant_tiers.get(t, policy.default_tier),
                    "quota": tenant_quotas.get(t, 0),
                    "inflight": self._tenant_inflight.get(t, 0),
                }
                for t in sorted(
                    set(tenant_tiers)
                    | set(tenant_quotas)
                    | set(self._tenant_inflight)
                )
            }
        shed = {}
        for (method, tier, reason), var in rpc_shed_total.items():
            v = var.get_value()
            if v:
                shed[f"{method}|{tier}|{reason}"] = v
        return {
            "active": policy.active,
            "default_tier": policy.default_tier,
            "tiers": tiers,
            "tenants": tenants,
            "method_tiers": method_tiers,
            "shed_total": shed,
            "codes": {k: v for k, v in sorted(SHED_CODES.items())},
        }
