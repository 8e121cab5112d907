"""FaultPlan — the declarative, seeded model of a chaos experiment.

A plan is a list of FaultSpecs.  Each spec names an injection SITE
(see chaos/injector.py for the catalog), an ACTION the site knows how
to apply, an optional MATCH on context (peer / method / direction),
and a SCHEDULE: either ``every_nth`` (fire on every Nth traversal of
the site) or ``probability`` driven by a seeded counter-mode PRNG.

Determinism is the load-bearing property: the fire/no-fire decision
for the k-th traversal of a spec is a pure function of
``(plan.seed, spec index, k)`` — no shared global PRNG whose state
interleaves across threads — so a replay of the same plan over the
same traversal sequence yields the identical injection sequence
(the chaos suite replays plans and compares per-site hit logs).

Plans load from dicts/JSON (the wire format of the ``/chaos`` builtin
and ``rpc_press --chaos-plan``) and are armed per-process through
``chaos.injector.arm``.
"""

from __future__ import annotations

import itertools
import json
import threading
import time as _time
from typing import Dict, List, Optional, Sequence

from incubator_brpc_tpu_torch.utils.hashes import GOLDEN64 as _GOLDEN
from incubator_brpc_tpu_torch.utils.hashes import fmix64 as _mix64

_MASK64 = (1 << 64) - 1

#: every action a site may be asked to apply; individual sites support
#: a subset (see docs/chaos.md for the site x action matrix)
ACTIONS = (
    "drop",
    "delay_us",
    "short_read",
    "short_write",
    "corrupt",
    "reset",
    "eagain_storm",
    "close_mid_batch",
    "reorder",
    "reject",
)


def spec_seed(seed: int, spec_id: int) -> int:
    """Per-spec seed derivation — the ONE place it is defined.  The
    native bridge (chaos/injector.py _arm_native) programs engine.cpp
    with this value, and the engine folds the traversal counter and
    mixes exactly like decide().  Each side replays ITS OWN sequence
    bit-identically; across languages the hash is identical but the
    probability compare differs in precision (C quantizes p to 32
    bits; probability=1.0 always fires on both sides)."""
    return (seed + spec_id * 0xBF58476D1CE4E5B9) & _MASK64


def decide(seed: int, spec_id: int, n: int) -> float:
    """Uniform [0,1) for the n-th traversal of spec `spec_id` under
    `seed` — pure, stateless, replayable."""
    return _mix64(spec_seed(seed, spec_id) + n * _GOLDEN) / 2.0**64


class FaultSpec:
    """One fault: site + match + action + schedule + budget.

    Runtime state (traversal counter, hit log) lives on the spec and is
    reset every time its plan is armed, so one plan object can be
    armed repeatedly and each run replays from traversal 0.
    """

    __slots__ = (
        "site", "action", "arg", "probability", "every_nth", "max_hits",
        "ttl_s", "match", "spec_id", "_counter", "_hits", "_deadline",
        "_budget_lock",
    )

    def __init__(
        self,
        site: str,
        action: str,
        arg: int = 0,
        probability: float = 1.0,
        every_nth: int = 0,
        max_hits: int = 0,
        ttl_s: float = 0.0,
        match: Optional[Dict[str, str]] = None,
    ):
        if action not in ACTIONS:
            raise ValueError(f"unknown fault action {action!r}")
        probability = float(probability)
        if not 0.0 < probability <= 1.0:
            # p <= 0 arms successfully but can never fire — a plan
            # that silently tests nothing (a 0.0/negative typo must
            # fail loudly, like every other unusable-spec shape)
            raise ValueError(
                f"probability must be in (0, 1], got {probability}"
            )
        self.site = site
        self.action = action
        self.arg = int(arg)
        self.probability = probability
        self.every_nth = int(every_nth)
        # eagain_storm without a budget would starve the Python read
        # loop forever (it retries the same site until the spec stops
        # firing) — default it to a finite storm
        if action == "eagain_storm" and not max_hits:
            max_hits = 64
        self.max_hits = int(max_hits)
        self.ttl_s = float(ttl_s)
        self.match = dict(match) if match else {}
        if self.every_nth and probability != 1.0:
            raise ValueError(
                "every_nth and probability are alternative schedules — "
                "set one (probability would be silently ignored)"
            )
        self.spec_id = 0  # assigned by the plan
        self._counter = itertools.count()  # GIL-atomic traversal counter
        self._hits = 0
        self._budget_lock = threading.Lock()  # max_hits is a GATE: the
        # read-modify-write must not overshoot under concurrent fires
        self._deadline = 0.0

    # ---- runtime -----------------------------------------------------------
    def reset_runtime(self) -> None:
        self._counter = itertools.count()
        self._hits = 0
        self._deadline = (
            _time.monotonic() + self.ttl_s if self.ttl_s > 0 else 0.0
        )

    def matches(self, peer, method: Optional[str],
                direction: Optional[str],
                tier: Optional[str] = None) -> bool:
        m = self.match
        if not m:
            return True
        want = m.get("peer")
        # peer may be any object (EndPoint, coords); it is stringified
        # HERE, only when a spec actually matches on it — call sites
        # pass the raw object so the no-matcher path never pays str()
        if want and (peer is None or want not in str(peer)):
            return False
        want = m.get("method")
        if want and method != want:
            return False
        want = m.get("direction")
        if want and direction != want:
            return False
        want = m.get("tier")
        if want and tier != want:
            return False
        return True

    def should_fire(self, seed: int) -> int:
        """Advance the traversal counter; return the traversal index
        (>=0) if this traversal fires, else -1."""
        if self._deadline and _time.monotonic() >= self._deadline:
            return -1
        if self.max_hits and self._hits >= self.max_hits:
            return -1  # cheap early-out; the lock below is the gate
        n = next(self._counter)
        if self.every_nth > 0:
            if n % self.every_nth != self.every_nth - 1:
                return -1
        elif self.probability < 1.0:
            if decide(seed, self.spec_id, n) >= self.probability:
                return -1
        with self._budget_lock:
            if self.max_hits and self._hits >= self.max_hits:
                return -1  # a concurrent fire claimed the last slot
            self._hits += 1
        return n

    @property
    def hits(self) -> int:
        return self._hits

    # ---- (de)serialization -------------------------------------------------
    def to_dict(self) -> dict:
        d = {"site": self.site, "action": self.action}
        if self.arg:
            d["arg"] = self.arg
        if self.probability < 1.0:
            d["probability"] = self.probability
        if self.every_nth:
            d["every_nth"] = self.every_nth
        if self.max_hits:
            d["max_hits"] = self.max_hits
        if self.ttl_s:
            d["ttl_s"] = self.ttl_s
        if self.match:
            d["match"] = dict(self.match)
        return d

    _KNOWN_KEYS = frozenset({
        "site", "action", "arg", "probability", "every_nth", "max_hits",
        "ttl_s", "match",
    })

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        unknown = set(d) - cls._KNOWN_KEYS
        if unknown:
            # a typo'd key (max_hit vs max_hits) silently dropped would
            # arm a DIFFERENT experiment than the operator wrote
            raise ValueError(
                f"unknown fault spec keys {sorted(unknown)} "
                f"(known: {sorted(cls._KNOWN_KEYS)})"
            )
        return cls(
            site=d["site"],
            action=d["action"],
            arg=d.get("arg", 0),
            probability=d.get("probability", 1.0),
            every_nth=d.get("every_nth", 0),
            max_hits=d.get("max_hits", 0),
            ttl_s=d.get("ttl_s", 0.0),
            match=d.get("match"),
        )

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"FaultSpec({self.to_dict()!r})"


class FaultPlan:
    """An ordered list of FaultSpecs plus the seed that drives them."""

    def __init__(self, specs: Sequence[FaultSpec] = (), seed: int = 0,
                 name: str = ""):
        self.specs: List[FaultSpec] = list(specs)
        self.seed = int(seed) & _MASK64
        self.name = name
        for i, spec in enumerate(self.specs):
            spec.spec_id = i

    def reset_runtime(self) -> None:
        for spec in self.specs:
            spec.reset_runtime()

    def sites(self) -> List[str]:
        return sorted({s.site for s in self.specs})

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "seed": self.seed,
            "specs": [s.to_dict() for s in self.specs],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        unknown = set(d) - {"name", "seed", "specs"}
        if unknown:
            raise ValueError(
                f"unknown fault plan keys {sorted(unknown)} "
                f"(known: ['name', 'seed', 'specs'])"
            )
        return cls(
            specs=[FaultSpec.from_dict(s) for s in d.get("specs", [])],
            seed=d.get("seed", 0),
            name=d.get("name", ""),
        )

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        return cls.from_dict(json.loads(s))
