"""Runtime transfer guard + retrace witness for the device plane.

``BRPC_TORCH_TRANSFER_WITNESS=1`` arms this lane in a pytest run through
``-p incubator_brpc_tpu_torch.analysis.pytest_plugin``; ``chip_smoke.py``
arms it on the card.  Three mechanisms back it:

1. **Call-site guard.**  ``enable()`` wraps the host-pull spellings the
   static census counts as ``host-sync``: ``numpy.asarray``/``array``/
   ``ascontiguousarray``, ``torch.Tensor.item``/``tolist``/``numpy``/
   ``cpu``, ``torch.Tensor.to`` when its target is the CPU, and
   ``torch.cuda.synchronize``.  A call whose *call site* is package
   code, whose argument is a tensor (any tensor: on the CPU lane every
   tensor stands for a device value, as every ``jax.Array`` does in the
   JAX lane), made outside every ``allowed_transfer`` scope of its own
   thread, records a violation and raises
   :class:`TransferWitnessError`.  A ``.to(device)`` on a line the
   static census records as an explicit ``device-put`` is an upload to
   its path's device (the CPU, on the CPU lane), not a pull.
   Call-site scoping (not thread
   scoping) keeps test assertions free to pull results while every
   package path stays guarded; the witness's own plumbing (analysis/)
   is never guarded.  ``disable()`` puts every original back.

2. **Sync hook on the card.**  With CUDA available, ``enable()`` also
   sets ``torch.cuda.set_sync_debug_mode("warn")`` once for the process
   and routes torch's "synchronizing CUDA operation" warnings through a
   ``warnings.showwarning`` hook.  The mode is global to the process, so
   no scope ever lowers it; the hook runs on the thread that synced and
   reads that thread's allow depth, and it finds the package frame that
   made the call.  It catches what the wrappers cannot see
   (``bool(t)``, ``float(t)``, ``torch.equal``, ``nonzero``).  A
   blocking upload syncs too: a warning raised on a line the static
   census records as an explicit ``device-put`` is the sanctioned
   direction and passes.

3. **Retrace witness.**  ``FusedKernel`` reports each retrace via
   :func:`note_trace` with a shape *family*; a family retracing more
   times than its padding-bucket bound is a contradiction.

Justified transfers wrap the pull in ``allowed_transfer(key)``; armed,
the key must exist in the checked-in ``device_transfers.json`` (the
file the static transfer-manifest rule checks) and an unknown key
raises.  Disarmed, the scope only counts its uses per key
(:func:`transfer_counts`), so a test can show that a path moved no
payload through the host.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import warnings
from collections import Counter
from typing import Dict, List, Optional, Tuple

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ANALYSIS_DIR = os.path.dirname(os.path.abspath(__file__))

_NP_FUNCS = ("asarray", "array", "ascontiguousarray")
_TENSOR_PULLS = ("item", "tolist", "numpy", "cpu", "to")
_SYNC_WARNING = "called a synchronizing CUDA operation"


class TransferWitnessError(RuntimeError):
    """An unmanifested device→host transfer on a guarded call site."""


# reentrant for the lock witness's reason: a finalizer may run inside it
_state_lock = threading.RLock()
_enabled = False
_scope_roots: List[str] = []  # call-site roots under guard
_manifest_keys: set = set()
# (owner, attribute) -> (the original the wrapper replaced, whether
# the owner itself defined it: a method inherited from torch's C base
# is deleted from torch.Tensor again, not copied onto it)
_originals: Dict[Tuple[object, str], Tuple[object, bool]] = {}
_prev_sync_mode: Optional[int] = None
_prev_showwarning = None
_prev_filters: Optional[list] = None
# the census's explicit uploads: relpath -> [(first line, last line)]
_put_lines: Optional[Dict[str, List[Tuple[int, int]]]] = None

_violations: List[dict] = []
_scope_uses: Counter = Counter()
_sync_hook_calls = 0
# kernel label -> repr(family) -> {"count", "bound"}
_kernels: Dict[str, Dict[str, dict]] = {}

_tls = threading.local()


def enabled() -> bool:
    return _enabled


def reset() -> None:
    global _sync_hook_calls
    with _state_lock:
        _violations.clear()
        _scope_uses.clear()
        _kernels.clear()
        _sync_hook_calls = 0


def transfer_counts() -> Dict[str, int]:
    """key → number of scopes opened since the last ``reset()``."""
    with _state_lock:
        return dict(_scope_uses)


# ---------------------------------------------------------------------------
# the call-site guard
# ---------------------------------------------------------------------------


def _guarded_frame(f) -> Optional[str]:
    """"relpath:line" of the first frame from ``f`` outward that is not
    the witness's own plumbing, torch's Python layer or the warnings
    module — when it lives under a guarded root; else None."""
    torch_dir = _torch_dir()
    while f is not None:
        fn = f.f_code.co_filename
        if (
            fn.startswith(_ANALYSIS_DIR + os.sep)
            or (torch_dir and fn.startswith(torch_dir))
            or fn == warnings.__file__
        ):
            f = f.f_back
            continue
        for root in _scope_roots:
            if fn.startswith(root + os.sep) or fn == root:
                return f"{os.path.relpath(fn, root)}:{f.f_lineno}"
        return None
    return None


def _torch_dir() -> str:
    mod = sys.modules.get("torch")
    path = getattr(mod, "__file__", None) if mod is not None else None
    return os.path.dirname(path) + os.sep if path else ""


def _allowed() -> bool:
    return getattr(_tls, "allow_depth", 0) > 0


def _refuse(kind: str, site: str, what: str) -> None:
    v = {
        "kind": kind,
        "site": site,
        "what": what,
        "thread": threading.current_thread().name,
    }
    with _state_lock:
        _violations.append(v)
    raise TransferWitnessError(
        f"unmanifested device→host transfer ({what}) at {site}: wrap the "
        f"pull in allowed_transfer(<key>) and justify the key in "
        f"device_transfers.json, or keep the value device-resident"
    )


def _check_pull(what: str, is_pull: bool, upload_ok: bool = False) -> None:
    """``upload_ok``: a ``.to(device)`` on a line the census records as
    an explicit upload places the value on its path's device, which on
    the CPU lane is the CPU — not a pull."""
    if not _enabled or not is_pull or _allowed():
        return
    # the wrapper's own frame is plumbing: the walk starts past it
    site = _guarded_frame(sys._getframe(1))
    if site is None or (upload_ok and _is_census_put(site)):
        return
    _refuse("transfer", site, what)


def _is_tensor(a) -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(a, torch.Tensor)


def _to_cpu(args, kwargs) -> bool:
    """Whether ``Tensor.to(*args, **kwargs)`` targets the CPU."""
    torch = sys.modules["torch"]
    target = kwargs.get("device", args[0] if args else None)
    if isinstance(target, str):
        return target.split(":")[0] == "cpu"
    if isinstance(target, torch.device):
        return target.type == "cpu"
    return False


def _wrap_np(orig, name):
    def _witnessed(a, *args, **kwargs):
        _check_pull(f"np.{name}", _is_tensor(a))
        return orig(a, *args, **kwargs)

    _witnessed.__wrapped__ = orig
    return _witnessed


def _wrap_method(orig, name):
    if name == "to":
        def _witnessed(self, *args, **kwargs):
            _check_pull('.to("cpu")', _to_cpu(args, kwargs), upload_ok=True)
            return orig(self, *args, **kwargs)
    else:
        def _witnessed(self, *args, **kwargs):
            _check_pull(f".{name}()", True)
            return orig(self, *args, **kwargs)

    _witnessed.__wrapped__ = orig
    _witnessed.__name__ = name
    return _witnessed


def _wrap_synchronize(orig):
    def _witnessed(*args, **kwargs):
        _check_pull("torch.cuda.synchronize()", True)
        return orig(*args, **kwargs)

    _witnessed.__wrapped__ = orig
    return _witnessed


def _patch(owner, name, wrapper) -> None:
    orig = getattr(owner, name)
    _originals[(owner, name)] = (orig, name in vars(owner))
    setattr(owner, name, wrapper(orig))


# ---------------------------------------------------------------------------
# the sync hook (CUDA sync debug mode "warn")
# ---------------------------------------------------------------------------


def _census_put_lines() -> Dict[str, List[Tuple[int, int]]]:
    global _put_lines
    if _put_lines is None:
        from incubator_brpc_tpu_torch.analysis.devicegraph import (
            build_device_census,
        )

        lines: Dict[str, List[Tuple[int, int]]] = {}
        for s in build_device_census(_PKG_ROOT).by_kind("device-put"):
            lines.setdefault(s.module, []).append((s.line, s.end_line or s.line))
        _put_lines = lines
    return _put_lines


def _is_census_put(site: str) -> bool:
    rel, _, line = site.rpartition(":")
    n = int(line)
    return any(a <= n <= b for a, b in _census_put_lines().get(rel, ()))


def _showwarning(message, category, filename, lineno, file=None, line=None):
    global _sync_hook_calls
    if _enabled and _SYNC_WARNING in str(message):
        with _state_lock:
            _sync_hook_calls += 1
        if _allowed():
            return
        site = _guarded_frame(sys._getframe(1))
        if site is None or _is_census_put(site):
            return
        _refuse("sync", site, "a synchronizing CUDA operation")
    if _prev_showwarning is not None:
        _prev_showwarning(message, category, filename, lineno, file, line)


# ---------------------------------------------------------------------------
# allow scopes
# ---------------------------------------------------------------------------


class _AllowScope:
    __slots__ = ("key", "_armed")

    def __init__(self, key: str):
        self.key = key
        self._armed = False

    def __enter__(self):
        if _enabled and self.key not in _manifest_keys:
            v = {"kind": "unknown-scope-key", "key": self.key}
            with _state_lock:
                _violations.append(v)
            raise TransferWitnessError(
                f"allowed_transfer({self.key!r}): key is not in "
                f"device_transfers.json — add a manifest entry with a why"
            )
        with _state_lock:
            _scope_uses[self.key] += 1
        if _enabled:
            self._armed = True
            _tls.allow_depth = getattr(_tls, "allow_depth", 0) + 1
        return self

    def __exit__(self, *exc):
        if self._armed:
            self._armed = False
            _tls.allow_depth = getattr(_tls, "allow_depth", 1) - 1
        return False


def allowed_transfer(key: str) -> _AllowScope:
    """Justification scope for a manifested device→host transfer.

    Disarmed this only counts the use (``transfer_counts``); armed it
    validates `key` against the manifest, counts the use, and opens a
    thread-local allow window for the guard and the sync hook."""
    return _AllowScope(key)


# ---------------------------------------------------------------------------
# retrace witness
# ---------------------------------------------------------------------------


def note_trace(label: str, family, count: int, bound: int) -> None:
    """Called by FusedKernel on every retrace: ``count`` traces have now
    occurred for ``family`` on the kernel ``label``, whose padding policy
    bounds retraces to ``bound`` per family."""
    fam = repr(family)
    with _state_lock:
        rec = _kernels.setdefault(label, {}).setdefault(
            fam, {"count": 0, "bound": bound}
        )
        rec["count"] = max(rec["count"], count)
        rec["bound"] = bound


def retrace_contradictions() -> List[dict]:
    """Every family that retraced more often than its bound allows."""
    with _state_lock:
        return [
            {"kind": "retrace", "kernel": label, "family": fam,
             "count": rec["count"], "bound": rec["bound"]}
            for label, fams in _kernels.items()
            for fam, rec in fams.items()
            if rec["count"] > rec["bound"]
        ]


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------


def enable(extra_scopes=None, manifest_path: Optional[str] = None) -> None:
    """Arm the lane.  Must run before package hot paths execute.

    extra_scopes: additional call-site roots to guard (tests use a
    tmp dir to seed synthetic violations)."""
    global _enabled, _prev_sync_mode, _prev_showwarning, _prev_filters
    with _state_lock:
        if _enabled:
            for p in extra_scopes or ():
                p = os.path.abspath(p)
                if p not in _scope_roots:
                    _scope_roots.append(p)
            return
        from incubator_brpc_tpu_torch.analysis.devicegraph import (
            MANIFEST_PATH,
            load_device_manifest,
        )

        manifest = load_device_manifest(manifest_path or MANIFEST_PATH)
        _manifest_keys.clear()
        _manifest_keys.update(manifest.keys())
        _scope_roots.clear()
        _scope_roots.append(_PKG_ROOT)
        for p in extra_scopes or ():
            _scope_roots.append(os.path.abspath(p))

        import numpy as np
        import torch

        _originals.clear()
        for name in _NP_FUNCS:
            _patch(np, name, lambda orig, name=name: _wrap_np(orig, name))
        for name in _TENSOR_PULLS:
            _patch(torch.Tensor, name,
                   lambda orig, name=name: _wrap_method(orig, name))
        _patch(torch.cuda, "synchronize", _wrap_synchronize)
        _census_put_lines()

        if torch.cuda.is_available():
            # one process-wide mode, armed once: a scope never lowers it
            _prev_sync_mode = torch.cuda.get_sync_debug_mode()
            _prev_filters = list(warnings.filters)
            warnings.filterwarnings("always", message=_SYNC_WARNING)
            _prev_showwarning = warnings.showwarning
            warnings.showwarning = _showwarning
            torch.cuda.set_sync_debug_mode("warn")
        _enabled = True


def disable() -> None:
    global _enabled, _prev_sync_mode, _prev_showwarning, _prev_filters
    with _state_lock:
        if not _enabled:
            return
        for (owner, name), (orig, own) in _originals.items():
            if own:
                setattr(owner, name, orig)
            else:
                delattr(owner, name)
        _originals.clear()
        if _prev_sync_mode is not None:
            import torch

            torch.cuda.set_sync_debug_mode(_prev_sync_mode)
            warnings.showwarning = _prev_showwarning
            warnings.filters[:] = _prev_filters
            _prev_sync_mode = _prev_showwarning = _prev_filters = None
        _enabled = False


def cross_check() -> dict:
    """Session-end summary: recorded violations (including ones raised
    into `except` blocks that swallowed them), per-key scope uses, the
    sync hook's warnings and retrace contradictions."""
    retrace = retrace_contradictions()
    with _state_lock:
        return {
            "enabled": _enabled,
            "sync_hook": _prev_sync_mode is not None,
            "sync_warnings": _sync_hook_calls,
            "violations": list(_violations),
            "scope_uses": dict(_scope_uses),
            "kernels": {k: dict(v) for k, v in _kernels.items()},
            "retrace_contradictions": retrace,
        }


def write_report(path: str) -> dict:
    result = cross_check()
    with open(path, "w", encoding="utf-8") as f:
        json.dump(result, f, indent=2, default=repr)
    return result
