"""Device→host transfer justification and the retrace counter — the
port's stand-in for the JAX package's ``analysis/device_witness.py``.

Every sanctioned place that pulls device bytes to the host opens an
``allowed_transfer(key)`` scope.  The scope counts its uses per key, so
a test can show that a path moved no payload through the host (the
ICI echo must leave ``iobuf.host-view`` at zero).

``FusedKernel`` reports each first-seen argument signature through
``note_trace``: the count per shape family of each kernel, and any
family that went past its padding-bucket bound.  The guard that
refuses unmanifested pulls, and the full witness, are ROADMAP.md
queue 1 item 10.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter
from typing import Dict, Iterator, List

_lock = threading.Lock()
_uses: Counter = Counter()
# kernel label -> repr(family) -> {"count", "bound"}
_kernels: Dict[str, Dict[str, dict]] = {}


@contextlib.contextmanager
def allowed_transfer(key: str) -> Iterator[None]:
    """Scope for one manifested device→host transfer named ``key``."""
    with _lock:
        _uses[key] += 1
    yield


def transfer_counts() -> Dict[str, int]:
    """key → number of scopes opened so far in this process."""
    with _lock:
        return dict(_uses)


def note_trace(label: str, family, count: int, bound: int) -> None:
    """Called by FusedKernel on every retrace: ``count`` traces have now
    occurred for ``family`` on the kernel ``label``, whose padding policy
    bounds retraces to ``bound`` per family."""
    fam = repr(family)
    with _lock:
        rec = _kernels.setdefault(label, {}).setdefault(
            fam, {"count": 0, "bound": bound}
        )
        rec["count"] = max(rec["count"], count)
        rec["bound"] = bound


def retrace_contradictions() -> List[dict]:
    """Every family that retraced more often than its bound allows."""
    with _lock:
        return [
            {"kind": "retrace", "kernel": label, "family": fam,
             "count": rec["count"], "bound": rec["bound"]}
            for label, fams in _kernels.items()
            for fam, rec in fams.items()
            if rec["count"] > rec["bound"]
        ]
