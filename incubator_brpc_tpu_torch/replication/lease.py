"""Leader leases with epoch fencing — the replication tier's whole
consensus budget (docs/replication.md).

No Raft.  One :class:`LeaseBoard` per coordination domain hands out
**epoch-numbered leases**, one per replica group:

* a candidate may acquire a group's lease only while no live lease is
  held by someone else; every successful acquisition bumps the group's
  epoch by one — epochs are totally ordered and never reused;
* the holder renews before the TTL runs out; a lost renewal (network,
  chaos) lets the lease expire, after which any candidate may take the
  next epoch — failover is bounded by the lease TTL;
* every replicated write carries its lease epoch, and replicas reject
  writes whose epoch is older than the newest lease they have seen —
  the **fencing invariant**: a deposed leader can keep writing forever
  and never get a single write acknowledged (ESTALEEPOCH).

Leases are *published* the same way the re-sharding epoch is: through
naming tags.  The tag grammar parallels resharding's ``"i/N@E"``:

    ``"<group>@<epoch>:<holder>"``        e.g. ``"g0@3:ici://slice0/chip1"``

so a naming watcher (or the ``/replication`` builtin) learns the
leader and epoch of every group from the server list alone, and old
clients that only understand ``"i/N"`` partition tags ignore lease
tags entirely (``parse_epoch_tag`` returns None for them — mixed
fleets degrade safely).

Chaos site ``replica.lease`` (docs/chaos.md) fires on every grant and
renewal decision: ``drop`` refuses the grant / loses the renewal — the
seeded forced-failover knob — and ``delay_us`` stretches the decision.
"""

from __future__ import annotations

import threading
import time as _time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from incubator_brpc_tpu_torch.chaos import injector as _chaos


# ---------------------------------------------------------------------------
# lease-in-tag naming grammar:  "<group>@<epoch>:<holder>"
# ---------------------------------------------------------------------------

def format_lease_tag(group: str, epoch: int, holder: str) -> str:
    """The naming-tag publication of a granted lease — the lease-plane
    parallel of resharding's ``format_epoch_tag`` (``"i/N@E"``)."""
    return f"{group}@{int(epoch)}:{holder}"


def parse_lease_tag(tag: str) -> Optional[Tuple[str, int, str]]:
    """``"g0@3:ici://slice0/chip1"`` → ``("g0", 3, "ici://slice0/chip1")``;
    None when the tag is not a lease tag (partition ``"i/N[@E]"`` tags
    and free-form tags both return None — the grammars coexist on one
    naming plane)."""
    base, at, rest = tag.partition("@")
    if not at or not base or "/" in base:
        return None
    epoch_s, colon, holder = rest.partition(":")
    if not colon or not holder:
        return None
    try:
        epoch = int(epoch_s)
    except ValueError:
        return None
    return base, epoch, holder


def max_lease_epoch(nodes, group: str) -> int:
    """The highest epoch any node's tag advertises for ``group`` — what
    a watcher adopts (the failover bump is exactly this going up)."""
    best = 0
    for node in nodes:
        parsed = parse_lease_tag(getattr(node, "tag", "") or "")
        if parsed is not None and parsed[0] == group:
            best = max(best, parsed[1])
    return best


# ---------------------------------------------------------------------------
# the board
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Lease:
    """One granted lease: immutable; renewal returns a NEW Lease with a
    later deadline at the same epoch."""

    group: str
    holder: str
    epoch: int
    deadline: float  # time.monotonic() when the lease lapses
    ttl_s: float

    def remaining(self, now: Optional[float] = None) -> float:
        return self.deadline - (now if now is not None else _time.monotonic())

    def valid(self, now: Optional[float] = None) -> bool:
        return self.remaining(now) > 0.0

    def tag(self) -> str:
        return format_lease_tag(self.group, self.epoch, self.holder)


class LeaseBoard:
    """The serialized grant/renew authority — per-group epoch-numbered
    leases under one lock (the two-candidate race resolves HERE: grants
    are atomic, so exactly one candidate wins each epoch).

    In-process deployments (every test and the single-pod default)
    share one board object; renewals then cost a lock acquisition.  A
    remote board sits behind the same surface over the RPC plane — the
    group only ever calls acquire/renew/release/current, all of which
    are one round trip."""

    def __init__(self, default_ttl_s: float = 0.5, publish=None):
        self._lock = threading.Lock()
        self._leases: Dict[str, Lease] = {}
        # highest epoch ever granted per group — epochs survive expiry
        # so a re-grant after a lapse still moves FORWARD (fencing
        # depends on it)
        self._epochs: Dict[str, int] = {}
        self.default_ttl_s = float(default_ttl_s)
        # publish(lease_or_None, group) — push the lease tag into the
        # naming plane (e.g. retag the holder's ServerNode); optional
        self._publish = publish

    # -- chaos -------------------------------------------------------------
    @staticmethod
    def _chaos_gate(group: str) -> bool:
        """True when the grant/renewal message is LOST (chaos drop)."""
        if not _chaos.armed:
            return False
        spec = _chaos.check("replica.lease", method=group)
        if spec is None:
            return False
        if spec.action == "delay_us":
            _chaos.sleep_us(spec.arg)
            return False
        return spec.action == "drop"

    # -- grant / renew / release -------------------------------------------
    def acquire(self, group: str, candidate: str,
                ttl_s: Optional[float] = None) -> Optional[Lease]:
        """Grant ``candidate`` the next epoch's lease on ``group`` —
        None while a live lease is held by someone else (wait for it to
        lapse), or when chaos drops the grant.  Re-acquiring a lease
        the candidate already holds renews it instead (same epoch)."""
        if self._chaos_gate(group):
            return None
        ttl = float(ttl_s) if ttl_s is not None else self.default_ttl_s
        with self._lock:
            now = _time.monotonic()
            cur = self._leases.get(group)
            if cur is not None and cur.valid(now):
                if cur.holder != candidate:
                    return None  # live lease elsewhere: fencing says wait
                lease = Lease(group, candidate, cur.epoch, now + ttl, ttl)
            else:
                epoch = self._epochs.get(group, 0) + 1
                self._epochs[group] = epoch
                lease = Lease(group, candidate, epoch, now + ttl, ttl)
            self._leases[group] = lease
        if self._publish is not None:
            self._publish(lease, group)
        return lease

    def renew(self, group: str, holder: str, epoch: int,
              ttl_s: Optional[float] = None) -> Optional[Lease]:
        """Extend the lease — only for the CURRENT holder at the
        CURRENT epoch.  None when the renewal is lost (chaos) or the
        lease moved on (another candidate holds a newer epoch): the
        caller must step down and re-elect."""
        if self._chaos_gate(group):
            return None
        ttl = float(ttl_s) if ttl_s is not None else self.default_ttl_s
        with self._lock:
            cur = self._leases.get(group)
            if cur is None or cur.holder != holder or cur.epoch != int(epoch):
                return None
            now = _time.monotonic()
            lease = Lease(group, holder, cur.epoch, now + ttl, ttl)
            self._leases[group] = lease
        return lease

    def release(self, group: str, holder: str, epoch: int) -> bool:
        """Voluntary step-down by the holder's coordinator (e.g. the
        leader's server died under it) — lets the group fail over
        without waiting out the TTL.  Only the matching holder+epoch
        may release; the epoch counter is NOT rolled back."""
        with self._lock:
            cur = self._leases.get(group)
            if cur is None or cur.holder != holder or cur.epoch != int(epoch):
                return False
            del self._leases[group]
        if self._publish is not None:
            self._publish(None, group)
        return True

    # -- reads -------------------------------------------------------------
    def current(self, group: str) -> Optional[Lease]:
        with self._lock:
            return self._leases.get(group)

    def epoch_of(self, group: str) -> int:
        """The newest epoch ever granted for ``group`` (0 = never) —
        what replicas fence stale writes against.  Monotonic even
        across lapses and releases."""
        with self._lock:
            return self._epochs.get(group, 0)

    def validate(self, group: str, holder: str, epoch: int) -> bool:
        """Is (holder, epoch) the LIVE lease right now?  The leader's
        last check before acknowledging a quorum write — never ack
        under a lease the board no longer holds."""
        with self._lock:
            cur = self._leases.get(group)
            return (
                cur is not None
                and cur.holder == holder
                and cur.epoch == int(epoch)
                and cur.valid()
            )

    # -- test / operator instruments ---------------------------------------
    def expire(self, group: str) -> None:
        """Force the group's lease past its deadline (as if the TTL
        elapsed with every renewal lost) — the deterministic partition
        instrument the lease-edge tests use.  The epoch counter keeps
        its value, so the next acquire still moves forward."""
        with self._lock:
            cur = self._leases.get(group)
            if cur is not None:
                self._leases[group] = Lease(
                    cur.group, cur.holder, cur.epoch,
                    _time.monotonic() - 1.0, cur.ttl_s,
                )

    def snapshot(self) -> Dict[str, dict]:
        """Per-group lease state (the ``/replication`` builtin)."""
        with self._lock:
            now = _time.monotonic()
            return {
                g: {
                    "holder": lease.holder,
                    "epoch": lease.epoch,
                    "lease_remaining_s": round(max(0.0, lease.remaining(now)), 3),
                    "tag": lease.tag(),
                }
                for g, lease in self._leases.items()
            }
