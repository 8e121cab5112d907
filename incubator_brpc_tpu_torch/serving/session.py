"""Session state + the ``kv:<session>@<epoch>`` naming-tag grammar.

The serving tier's third naming-tag grammar, alongside resharding's
``i/N@E`` partition tags (resharding/migration.py) and replication's
``group@epoch:holder`` lease tags (replication/lease.py).  A session's
KV state lives in the HBM cache tier under one key per layer:

    kv:<session>@<epoch>#<layer>

``epoch`` is the session's OWNERSHIP epoch: it bumps on every decode
admission (initial admit and each migration), so a stale owner's late
writes/tokens are identifiable and a checkpoint handoff publishes a
complete new-epoch key set before the old one is retired —
crash-resumable exactly like resharding's epoch-tagged COPY.  Each
parser returns None for the other grammars, so mixed naming planes
degrade safely (a partition watcher ignores kv tags and vice versa).

``SessionRecord`` is the per-session state machine the router drives:

    PREFILLING → PREFILLED → DECODING ⇄ MIGRATING → DONE | FAILED

with the step-log fields the exactly-once proofs read
(``prefill_executions``, ``migrations``, ``tokens`` by index,
``migration_log``).  The process-global registry feeds the
``/serving`` builtin and the ``serving:`` /status section.

Import-light and jax-free by construction (the builtin and the
metrics lint import this in a bare interpreter).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

# session lifecycle states (a plain tuple, not enum — the builtin
# renders them as strings)
PREFILLING = "PREFILLING"
PREFILLED = "PREFILLED"
DECODING = "DECODING"
MIGRATING = "MIGRATING"
DONE = "DONE"
FAILED = "FAILED"


# ---------------------------------------------------------------------------
# the kv:<session>@<epoch>[#<layer>] grammar
# ---------------------------------------------------------------------------

def format_kv_key(session: str, epoch: int, layer: Optional[int] = None) -> bytes:
    """Cache key for one session's KV state at one ownership epoch;
    with ``layer`` the per-layer key the fused DMGET pull enumerates."""
    base = f"kv:{session}@{int(epoch)}"
    if layer is not None:
        base += f"#{int(layer)}"
    return base.encode()


def parse_kv_key(tag) -> Optional[Tuple[str, int, Optional[int]]]:
    """``"kv:<session>@<epoch>[#<layer>]"`` → (session, epoch, layer);
    None for anything else — including the OTHER naming grammars
    (``i/N@E`` partition tags, ``group@epoch:holder`` lease tags), so
    a kv watcher scanning a shared naming plane never misroutes."""
    if isinstance(tag, (bytes, bytearray)):
        try:
            tag = bytes(tag).decode()
        except UnicodeDecodeError:
            return None
    if not isinstance(tag, str) or not tag.startswith("kv:"):
        return None
    body = tag[3:]
    sess, sep, rest = body.rpartition("@")
    if not sep or not sess:
        return None
    layer: Optional[int] = None
    ep_s, lsep, layer_s = rest.partition("#")
    try:
        epoch = int(ep_s)
        if lsep:
            layer = int(layer_s)
    except ValueError:
        return None
    if epoch < 0 or (layer is not None and layer < 0):
        return None
    return sess, epoch, layer


def kv_layer_keys(session: str, epoch: int, n_layers: int) -> List[bytes]:
    """The complete per-layer key set one epoch publishes — what the
    decode admission's fused DMGET pulls in ONE batched lookup."""
    return [format_kv_key(session, epoch, layer) for layer in range(n_layers)]


# ---------------------------------------------------------------------------
# per-session record + process-global registry
# ---------------------------------------------------------------------------

class SessionRecord:
    """One session's serving state; the router is the only writer, so
    a single lock per record suffices.  Token bookkeeping is BY INDEX:
    ``tokens[i]`` is the i-th emitted token, and accepting an emission
    requires ``idx == len(tokens)`` — contiguity and exactly-once are
    enforced at the point of record, not proven after the fact."""

    def __init__(self, session: str, prompt: str, max_tokens: int):
        self.session = session
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.state = PREFILLING
        self.epoch = 0  # ownership epoch; bumps per decode admission
        self.replica = ""  # current decode owner
        self.kv_epoch = 0  # epoch whose key set is live in the cache
        self.n_layers = 0
        self.kv_bytes = 0
        self.prefill_executions = 0
        self.migrations = 0
        self.ckpt_tokens = 0  # tokens folded into the live kv_epoch state
        self.tokens: List[str] = []
        self.migration_log: List[dict] = []
        self.error = ""
        self.created_s = time.time()
        self._lock = threading.Lock()

    def accept_token(self, idx: int, token: str, epoch: int) -> bool:
        """Record token ``idx`` iff it is the NEXT index and comes from
        the CURRENT ownership epoch.  A stale owner (aborted source
        still draining) or a duplicate re-emission is rejected here —
        the exactly-once gate."""
        with self._lock:
            if epoch != self.epoch:
                return False
            if idx != len(self.tokens):
                return False
            self.tokens.append(token)
            return True

    def bump_epoch(self, replica: str) -> int:
        with self._lock:
            self.epoch += 1
            self.replica = replica
            return self.epoch

    def log_migration(self, entry: dict) -> None:
        with self._lock:
            self.migration_log.append(entry)

    def describe(self) -> dict:
        with self._lock:
            return {
                "session": self.session,
                "state": self.state,
                "epoch": self.epoch,
                "replica": self.replica,
                "kv_epoch": self.kv_epoch,
                "n_layers": self.n_layers,
                "kv_bytes": self.kv_bytes,
                "prefill_executions": self.prefill_executions,
                "migrations": self.migrations,
                "tokens": len(self.tokens),
                "max_tokens": self.max_tokens,
                "ckpt_tokens": self.ckpt_tokens,
                "migration_log": list(self.migration_log),
                "error": self.error,
                "age_s": round(time.time() - self.created_s, 3),
            }


_registry: Dict[str, SessionRecord] = {}
_registry_lock = threading.Lock()


def open_session(session: str, prompt: str, max_tokens: int) -> SessionRecord:
    """Register a fresh record (replacing a finished prior session of
    the same id — ids are caller-scoped, re-use is legal)."""
    rec = SessionRecord(session, prompt, max_tokens)
    with _registry_lock:
        _registry[session] = rec
    return rec


def get_session(session: str) -> Optional[SessionRecord]:
    with _registry_lock:
        return _registry.get(session)


def sessions_snapshot() -> Dict[str, dict]:
    """Every registered session's describe() — the ``/serving``
    builtin's payload."""
    with _registry_lock:
        recs = list(_registry.values())
    return {rec.session: rec.describe() for rec in recs}


def clear_registry() -> None:
    """Test isolation hook (process-global state)."""
    with _registry_lock:
        _registry.clear()
