"""Per-task local storage (analog of bthread keys/TLS, bthread/key.cpp).

Each spawned Task carries its own key→value dict (keytable in the
reference); code running outside the runtime falls back to thread-local
storage. Used by rpcz to carry the parent span (reference span.h:75-78
bthread::tls_bls) and by servers for thread-local user data.
"""

from __future__ import annotations

import threading

from incubator_brpc_tpu_torch.runtime import scheduler

_thread_fallback = threading.local()


def _storage() -> dict:
    task = getattr(scheduler._tls, "current_task", None)
    if task is not None:
        if not hasattr(task, "locals"):
            task.locals = {}
        return task.locals
    d = getattr(_thread_fallback, "d", None)
    if d is None:
        d = _thread_fallback.d = {}
    return d


def get_local(key, default=None):
    return _storage().get(key, default)


def set_local(key, value):
    _storage()[key] = value


def del_local(key):
    _storage().pop(key, None)
