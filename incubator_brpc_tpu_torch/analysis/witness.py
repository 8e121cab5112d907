"""Runtime lock-witness mode — validate the static graph by execution.

``enable()`` replaces ``threading.Lock``/``RLock``/``Condition`` with
factories that wrap locks CREATED BY PACKAGE CODE (decided by the
caller's filename) in thin recording proxies; all other creators get
the raw primitive, so pytest/jax/stdlib locks pay nothing.  Each
witnessed lock is keyed by its creation site (``relpath:lineno``) —
exactly the key the static inventory records — so runtime acquisition
orders join 1:1 onto static lock names.

While enabled, every successful acquisition records one edge per
currently-held witnessed lock: *site A was held when site B was
acquired*, with reentrant re-acquisition (RLock/Condition) folded out.
``cross_check()`` then maps the witnessed edges onto canonical lock
names and verifies none CONTRADICTS the checked-in manifest order — a
witnessed B→A where the manifest orders A→B is a runtime-proven
inversion.  Witnessed edges the static pass missed are reported as
``new_edges`` (the analyzer's blind spots, e.g. acquisitions through
dynamically-dispatched calls), not failures.

Enable BEFORE the package creates locks: analysis/pytest_plugin.py does
this when ``BRPC_TORCH_LOCK_WITNESS=1`` is set.  Known limitation: module-level
locks created by importing ``incubator_brpc_tpu_torch`` itself (today only
``utils/iobuf.py:_SSL_LOCK_GUARD``) predate the patch and go
unwitnessed.

Direct factories (``make_lock``/``make_rlock``/``make_condition``) let
tests witness specific locks without patching ``threading`` globally.
"""

from __future__ import annotations

import _thread
import json
import os
import threading
from typing import Dict, List, Optional, Tuple

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# reentrant: a GC finalizer that takes a witnessed lock can run inside
# the witness's own critical section, on the thread that holds it
_state_lock = _thread.RLock()
_enabled = False
_scopes: List[str] = [_PKG_ROOT]
# (src_site, dst_site) -> count
_edges: Dict[Tuple[str, str], int] = {}
_sites_seen: Dict[str, int] = {}
_local = threading.local()


def _held_stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = []
        _local.stack = st
    return st


def _site_of_caller(depth: int = 2) -> Optional[str]:
    import sys

    try:
        frame = sys._getframe(depth)
    except ValueError:
        return None
    fn = frame.f_code.co_filename
    for scope in _scopes:
        if fn.startswith(scope + os.sep) or fn == scope:
            rel = os.path.relpath(fn, scope)
            return f"{rel}:{frame.f_lineno}"
    return None


class _WitnessBase:
    __slots__ = ("_real", "site")

    def __init__(self, real, site: str):
        self._real = real
        self.site = site
        with _state_lock:
            _sites_seen[site] = _sites_seen.get(site, 0) + 1

    def acquire(self, blocking=True, timeout=-1):
        ok = self._real.acquire(blocking, timeout)
        if ok:
            self._note_acquired()
        return ok

    acquire_lock = acquire  # old-style alias some code paths use

    def _note_acquired(self):
        stack = _held_stack()
        if any(e is self for e in stack):
            stack.append(self)  # reentrant: push for balanced release,
            return  # but record no self-edge
        if stack:
            with _state_lock:
                for held in _dedupe(stack):
                    if held.site != self.site:
                        key = (held.site, self.site)
                        _edges[key] = _edges.get(key, 0) + 1
        stack.append(self)

    def release(self):
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        self._real.release()

    release_lock = release

    def locked(self):
        return self._real.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<witness {self.site} of {self._real!r}>"


def _dedupe(stack):
    seen = set()
    out = []
    for e in stack:
        if id(e) not in seen:
            seen.add(id(e))
            out.append(e)
    return out


class _WitnessLock(_WitnessBase):
    __slots__ = ()


class _WitnessRLock(_WitnessBase):
    __slots__ = ()

    def _is_owned(self):  # Condition uses this when available
        return self._real._is_owned()


def make_lock(site: str):
    return _WitnessLock(_REAL_LOCK(), site)


def make_rlock(site: str):
    return _WitnessRLock(_REAL_RLOCK(), site)


def make_condition(site: str, lock=None):
    if lock is None:
        lock = _WitnessRLock(_REAL_RLOCK(), site)
    return _REAL_CONDITION(lock)


# ---------------------------------------------------------------------------
# global patch
# ---------------------------------------------------------------------------


def _lock_factory():
    site = _site_of_caller()
    if site is None:
        return _REAL_LOCK()
    return _WitnessLock(_REAL_LOCK(), site)


def _rlock_factory():
    site = _site_of_caller()
    if site is None:
        return _REAL_RLOCK()
    return _WitnessRLock(_REAL_RLOCK(), site)


def _condition_factory(lock=None):
    if lock is not None:
        return _REAL_CONDITION(lock)
    site = _site_of_caller()
    if site is None:
        return _REAL_CONDITION()
    return _REAL_CONDITION(_WitnessRLock(_REAL_RLOCK(), site))


def enable(extra_scopes: Optional[List[str]] = None) -> None:
    """Patch threading's lock factories.  Idempotent."""
    global _enabled
    if extra_scopes:
        for s in extra_scopes:
            add_scope(s)
    if _enabled:
        return
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    threading.Condition = _condition_factory
    _enabled = True


def disable() -> None:
    global _enabled
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    threading.Condition = _REAL_CONDITION
    _enabled = False


def add_scope(path: str) -> None:
    p = os.path.abspath(path)
    if p not in _scopes:
        _scopes.append(p)


def enabled() -> bool:
    return _enabled


def reset() -> None:
    with _state_lock:
        _edges.clear()
        _sites_seen.clear()


def edges() -> Dict[Tuple[str, str], int]:
    with _state_lock:
        return dict(_edges)


def sites_seen() -> Dict[str, int]:
    with _state_lock:
        return dict(_sites_seen)


# ---------------------------------------------------------------------------
# cross-check against the static manifest
# ---------------------------------------------------------------------------


def cross_check(
    pkg_root: Optional[str] = None,
    manifest_pairs: Optional[set] = None,
) -> dict:
    """Map witnessed edges onto canonical lock names and verify none
    contradicts the manifest partial order.

    Returns {"checked": n, "contradictions": [...], "new_edges": [...],
    "witnessed_sites": n, "unmapped_sites": [...]}.
    """
    from incubator_brpc_tpu_torch.analysis.inventory import build_inventory
    from incubator_brpc_tpu_torch.analysis.manifest import load_manifest

    pkg_root = pkg_root or _PKG_ROOT
    inv = build_inventory(pkg_root)
    if manifest_pairs is None:
        manifest_pairs = load_manifest().pairs()

    # reachability over the manifest order
    adj: Dict[str, set] = {}
    for a, b in manifest_pairs:
        adj.setdefault(a, set()).add(b)

    def reachable(a: str, b: str) -> bool:
        seen, todo = set(), [a]
        while todo:
            n = todo.pop()
            if n == b:
                return True
            if n in seen:
                continue
            seen.add(n)
            todo.extend(adj.get(n, ()))
        return False

    def map_site(site: str) -> Optional[str]:
        rel, _, line = site.rpartition(":")
        try:
            key = (rel, int(line))
        except ValueError:
            return None
        s = inv.by_creation.get(key)
        return s.base() if s is not None else None

    contradictions, new_edges, unmapped = [], [], []
    checked = 0
    for (src_site, dst_site), count in edges().items():
        src, dst = map_site(src_site), map_site(dst_site)
        if src is None or dst is None:
            for site, name in ((src_site, src), (dst_site, dst)):
                if name is None and site not in unmapped:
                    unmapped.append(site)
            continue
        if src == dst:
            continue  # alias fold: condition over its own base lock
        checked += 1
        if reachable(dst, src):
            contradictions.append(
                {
                    "witnessed": f"{src} -> {dst}",
                    "manifest_orders": f"{dst} -> {src}",
                    "count": count,
                    "sites": f"{src_site} -> {dst_site}",
                }
            )
        elif (src, dst) not in manifest_pairs:
            new_edges.append({"edge": f"{src} -> {dst}", "count": count})
    return {
        "checked": checked,
        "contradictions": contradictions,
        "new_edges": new_edges,
        "witnessed_sites": len(sites_seen()),
        "unmapped_sites": sorted(unmapped),
    }


def write_report(path: str, result: Optional[dict] = None) -> dict:
    if result is None:
        result = cross_check()
    with open(path, "w", encoding="utf-8") as f:
        json.dump(result, f, indent=2, sort_keys=True)
    return result
