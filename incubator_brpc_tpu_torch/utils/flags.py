"""Runtime flags — the gflags analog.

The reference configures everything through ~146 gflags;
BRPC_VALIDATE_GFLAG marks flags hot-reloadable and the /flags builtin
service edits them over HTTP at runtime (reloadable_flags.h:28-60,
builtin/flags_service.h:28). Same model here: define_flag registers a
typed flag; a validator makes it reloadable; /flags lists and sets.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional


@dataclass
class Flag:
    name: str
    value: Any
    default: Any
    help: str = ""
    validator: Optional[Callable[[Any], bool]] = None  # non-None => reloadable

    @property
    def reloadable(self) -> bool:
        return self.validator is not None


_flags: Dict[str, Flag] = {}
_lock = threading.Lock()


def define_flag(name: str, default, help: str = "", validator=None) -> Flag:
    with _lock:
        if name in _flags:
            return _flags[name]
        f = Flag(name, default, default, help, validator)
        _flags[name] = f
        return f


def get_flag(name: str, default=None):
    f = _flags.get(name)
    return f.value if f else default


def set_flag(name: str, value, force: bool = False) -> bool:
    """Runtime update; only reloadable flags accept it (the /flags
    service path). Values are coerced to the default's type.
    ``force=True`` is the PROGRAMMATIC override for non-reloadable
    flags (startup configuration in operator code) — the HTTP /flags
    path never passes it, so security-sensitive flags stay
    operator-only like the reference's non-validated gflags."""
    f = _flags.get(name)
    if f is None or (not f.reloadable and not force):
        return False
    try:
        if isinstance(f.default, bool):
            value = str(value).lower() in ("1", "true", "yes", "on")
        elif isinstance(f.default, int):
            value = int(value)
        elif isinstance(f.default, float):
            value = float(value)
        else:
            value = str(value)
    except (TypeError, ValueError):
        return False
    if f.validator is not None and not f.validator(value):
        return False
    f.value = value
    return True


def list_flags() -> Dict[str, Flag]:
    return dict(_flags)


# framework flags (mirroring commonly-tuned reference gflags)
define_flag(
    "max_body_size", 2 << 30, "max message body bytes", validator=lambda v: v > 0
)
define_flag(
    "health_check_interval_s", 1.0, "failed-node probe interval",
    validator=lambda v: v > 0,
)
define_flag(
    "circuit_breaker_error_rate", 0.5, "EMA error rate that isolates a node",
    validator=lambda v: 0 < v <= 1,
)
define_flag("rpcz_enabled", True, "collect rpcz spans", validator=lambda v: True)
# -event_dispatcher_num analog (event_dispatcher.cpp:30-45).  NOT
# reloadable: the epoll-loop pool is sized once at first socket
# registration — resizing live would strand fds on dead loops.
# Operators set it via set_flag(..., force=True) before any socket.
define_flag(
    "event_dispatcher_num", 1,
    "number of epoll event-dispatcher loops (fd-hashed)",
)
define_flag(
    "enable_dir_service",
    False,
    "serve the /dir filesystem browser (reference -enable_dir_service; "
    "default off: it reads any path with the server's permissions). "
    "NOT hot-reloadable: enabling filesystem read must be operator "
    "code (set_flag(..., force=True)), never a /flags?setvalue request",
)
define_flag(
    "rpcz_db_path",
    "",
    "persist rpcz spans to this sqlite file (reference: SpanDB/leveldb); "
    "empty = in-memory ring only",
    validator=lambda v: True,
)
define_flag(
    "socket_max_unwritten_bytes", 64 << 20, "EOVERCROWDED threshold",
    validator=lambda v: v > 0,
)
