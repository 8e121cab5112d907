"""Variable base + global registry (reference bvar/variable.h:102).

expose()/hide() register into a process-global name→variable map that
powers the /vars builtin service and the Prometheus exporter; dump
supports the reference's wildcard filters (`?`/`*`).
"""

from __future__ import annotations

import fnmatch
import threading
from typing import Dict, List, Optional, Tuple

_registry: Dict[str, "Variable"] = {}
# RLock, deliberately: Variable.__del__ calls hide(), and GC can fire
# inside expose()'s critical section (dict insert allocates) ON THE SAME
# THREAD — a plain Lock self-deadlocks there (seen hanging the full test
# suite). Re-entrant hide() only pops a different (dying) variable's
# key, which every section here tolerates.
_registry_lock = threading.RLock()


class Variable:
    def __init__(self):
        self._name: Optional[str] = None

    # -- subclass interface --
    def get_value(self):
        raise NotImplementedError

    def describe(self) -> str:
        v = self.get_value()
        return f"{v:.6g}" if isinstance(v, float) else str(v)

    # -- registry --
    def expose(self, name: str, prefix: str = "") -> "Variable":
        full = f"{prefix}_{name}" if prefix else name
        full = _sanitize(full)
        with _registry_lock:
            if self._name and _registry.get(self._name) is self:
                _registry.pop(self._name, None)
            _registry[full] = self
            self._name = full
        return self

    def expose_as(self, prefix: str, name: str) -> "Variable":
        return self.expose(name, prefix)

    def hide(self):
        with _registry_lock:
            if self._name:
                # pop only our own registration: a dying variable whose
                # name was re-exposed by a NEWER variable must not
                # unregister the newer one from under it
                if _registry.get(self._name) is self:
                    _registry.pop(self._name, None)
                self._name = None

    @property
    def name(self) -> Optional[str]:
        return self._name

    def __del__(self):
        try:
            self.hide()
        except Exception:
            pass


def _sanitize(name: str) -> str:
    out = []
    last_us = False
    for ch in name.lower():
        if ch.isalnum():
            out.append(ch)
            last_us = False
        elif not last_us and out:
            out.append("_")
            last_us = True
    return "".join(out).strip("_")


def list_exposed() -> List[str]:
    with _registry_lock:
        return sorted(_registry)


def describe_exposed(name: str) -> Optional[str]:
    with _registry_lock:
        var = _registry.get(name)
    return var.describe() if var else None


def dump_exposed(wildcards: str = "*") -> List[Tuple[str, str]]:
    """Dump (name, value) pairs matching `;`/`,`-separated wildcards
    (reference Variable::dump_exposed with WildcardMatcher)."""
    patterns = [w for w in wildcards.replace(";", ",").split(",") if w]
    with _registry_lock:
        names = sorted(_registry)
    out = []
    for n in names:
        if any(fnmatch.fnmatch(n, p) for p in patterns):
            d = describe_exposed(n)
            if d is not None:
                out.append((n, d))
    return out
