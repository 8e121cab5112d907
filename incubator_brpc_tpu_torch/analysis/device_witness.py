"""Device→host transfer justification — the port's stand-in for the
JAX package's ``analysis/device_witness.py``.

Every sanctioned place that pulls device bytes to the host opens an
``allowed_transfer(key)`` scope.  The scope counts its uses per key, so
a test can show that a path moved no payload through the host (the
ICI echo must leave ``iobuf.host-view`` at zero).  The guard that
refuses unmanifested pulls is ROADMAP.md queue 1 item 10.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter
from typing import Dict, Iterator

_lock = threading.Lock()
_uses: Counter = Counter()


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
