"""CallId — versioned correlation ids with lock/error/destroy semantics.

Analog of bthread_id (reference bthread/id.{h,cpp}, id.h:31-53; doc
docs/cn/bthread_id.md). This is the RPC correlation-id + cancellation +
retry-versioning mechanism: nearly every client-side correctness
property (stale responses of dead retries being dropped, cancellation,
sync Join) rests on it (SURVEY.md §7 "hard parts").

Id layout (fits the wire's int64, like the reference's 64-bit id):
    cid = (generation << 32) | (version << 20) | slot
- ``slot`` (20 bits): index into the slab pool.
- ``generation`` (31 bits): bumped on destroy; a recycled slot's old
  ids never resolve (ABA safety, reference version ranges).
- ``version`` (12 bits): the retry version within one RPC. Each retry
  mints a new version via ``bump_version``; a response carrying a
  superseded version fails ``lock`` and is dropped (reference: "drops
  stale versions = dead retries", baidu_rpc_protocol.cpp:571).
  version 0 is the *wildcard*: it locks/errors whatever version is
  current — used by the overall-deadline timer and join, which apply to
  the RPC as a whole, not to one attempt (reference arms its timer with
  the base id for the same reason).

Semantics (mirroring id.cpp):
- ``lock`` is a mutex: contenders block until unlocked.
- ``error`` runs the id's on_error handler *under the id lock*; if the
  id is currently locked, the error is queued and the handler runs at
  unlock time (reference PendingError list).
- ``unlock_and_destroy`` invalidates all versions and wakes joiners.
- ``join`` blocks until the id is destroyed, across retries
  (sync RPC waits here, channel.cpp:581).
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Tuple

INVALID_CALL_ID = 0

_SLOT_BITS = 20
_VER_BITS = 12
_SLOT_MASK = (1 << _SLOT_BITS) - 1
_VER_MASK = (1 << _VER_BITS) - 1
_GEN_MASK = (1 << 31) - 1

# on_error(data, cid, error_code, error_text) — must unlock or destroy cid.
OnError = Callable[[object, int, int, str], None]


def _pack(slot_idx: int, gen: int, ver: int) -> int:
    return ((gen & _GEN_MASK) << 32) | ((ver & _VER_MASK) << _SLOT_BITS) | slot_idx


def _unpack(cid: int) -> Tuple[int, int, int]:
    return (
        cid & _SLOT_MASK,
        (cid >> 32) & _GEN_MASK,
        (cid >> _SLOT_BITS) & _VER_MASK,
    )


def wildcard(cid: int) -> int:
    """Version-agnostic form of cid (matches whatever version is current)."""
    return cid & ~(_VER_MASK << _SLOT_BITS)


def wire_cid32(cid: int) -> int:
    """32-bit wire form for protocols whose correlation field is only
    32 bits (thrift seqid, nshead log_id). The low 32 bits of a cid are
    (version, slot) — REUSED verbatim when a slot is recycled, so a
    late response could match a newer RPC on the same slot. The slot
    generation is folded in through a multiplicative hash: a plain XOR
    collides easily for small gen/slot values (genA^genB == slotA^slotB
    happens constantly with concurrent in-flight RPCs), while the
    golden-ratio spread makes any gen difference look random across
    all 32 bits."""
    return (cid ^ ((cid >> 32) * 0x9E3779B1)) & 0xFFFFFFFF


class _IdSlot:
    __slots__ = ("gen", "cur_ver", "alive", "data", "on_error", "locked", "pending", "cond")

    def __init__(self):
        self.gen = 1
        self.cur_ver = 1
        self.alive = False
        self.data = None
        self.on_error: Optional[OnError] = None
        self.locked = False
        self.pending: List[Tuple[int, str]] = []
        self.cond = threading.Condition()


class CallIdPool:
    def __init__(self):
        self._slots: List[_IdSlot] = []
        self._free: List[int] = []
        self._lock = threading.Lock()

    # ---- lifecycle ---------------------------------------------------------
    def create(self, data=None, on_error: Optional[OnError] = None) -> int:
        with self._lock:
            if self._free:
                idx = self._free.pop()
                slot = self._slots[idx]
            else:
                idx = len(self._slots)
                if idx > _SLOT_MASK:
                    raise RuntimeError("CallId slot space exhausted")
                slot = _IdSlot()
                self._slots.append(slot)
        with slot.cond:
            slot.alive = True
            slot.cur_ver = 1
            slot.data = data
            slot.on_error = on_error
            slot.locked = False
            slot.pending.clear()
            return _pack(idx, slot.gen, 1)

    def _slot_of(self, cid: int) -> Optional[_IdSlot]:
        idx = cid & _SLOT_MASK
        if idx >= len(self._slots):
            return None
        return self._slots[idx]

    @staticmethod
    def _valid(slot: _IdSlot, cid: int) -> bool:
        """Valid for lock/error: alive, same generation, current (or
        wildcard) version."""
        _, gen, ver = _unpack(cid)
        return (
            slot.alive
            and slot.gen == gen
            and (ver == 0 or ver == slot.cur_ver)
        )

    @staticmethod
    def _same_rpc(slot: _IdSlot, cid: int) -> bool:
        """Valid for join: alive and same generation (any version)."""
        _, gen, _ = _unpack(cid)
        return slot.alive and slot.gen == gen

    #: sentinel returned by try_lock when the id exists but is locked
    BUSY = object()

    def try_lock(self, cid: int):
        """Non-blocking lock. Returns the data on success, None if this
        version is gone (stale-response drop), or CallIdPool.BUSY if the
        id is currently locked by someone else — callers that must not
        block (the event-dispatcher thread) re-dispatch on BUSY."""
        slot = self._slot_of(cid)
        if slot is None:
            return None
        with slot.cond:
            if not self._valid(slot, cid):
                return None
            if slot.locked:
                return CallIdPool.BUSY
            slot.locked = True
            return slot.data

    # ---- lock / unlock -----------------------------------------------------
    def lock(self, cid: int, timeout: Optional[float] = None):
        """Lock the id. Returns the data on success, None if this version
        of the id no longer exists — the stale-response drop."""
        slot = self._slot_of(cid)
        if slot is None:
            return None
        with slot.cond:
            while self._valid(slot, cid) and slot.locked:
                if not slot.cond.wait(timeout):
                    return None
            if not self._valid(slot, cid):
                return None
            slot.locked = True
            return slot.data

    def unlock(self, cid: int) -> bool:
        slot = self._slot_of(cid)
        if slot is None:
            return False
        run_error = None
        with slot.cond:
            if not slot.locked or not self._valid(slot, cid):
                return False
            if slot.pending:
                run_error = slot.pending.pop(0)  # stay locked; handler owns it
            else:
                slot.locked = False
                slot.cond.notify_all()
        if run_error is not None:
            code, text = run_error
            self._run_on_error(slot, _pack(cid & _SLOT_MASK, slot.gen, slot.cur_ver), code, text)
        return True

    def unlock_and_destroy(self, cid: int) -> bool:
        slot = self._slot_of(cid)
        if slot is None:
            return False
        idx = cid & _SLOT_MASK
        with slot.cond:
            if not self._same_rpc(slot, cid):
                return False
            slot.alive = False
            slot.gen = (slot.gen + 1) & _GEN_MASK or 1
            slot.locked = False
            slot.data = None
            slot.on_error = None
            slot.pending.clear()
            slot.cond.notify_all()
        with self._lock:
            self._free.append(idx)
        return True

    def bump_version(self, cid: int) -> int:
        """Mint the next retry version, invalidating previously-sent wire
        ids. Caller must hold the lock; returns the new current cid."""
        slot = self._slot_of(cid)
        assert slot is not None and slot.locked, "bump_version requires the lock"
        with slot.cond:
            slot.cur_ver += 1
            if slot.cur_ver > _VER_MASK:
                raise RuntimeError("too many retries for one CallId")
            return _pack(cid & _SLOT_MASK, slot.gen, slot.cur_ver)

    # ---- error & join ------------------------------------------------------
    def error(self, cid: int, error_code: int, error_text: str = "") -> bool:
        """Deliver an error to the id (reference bthread_id_error)."""
        slot = self._slot_of(cid)
        if slot is None:
            return False
        with slot.cond:
            if not self._valid(slot, cid):
                return False
            if slot.locked:
                slot.pending.append((error_code, error_text))
                return True
            slot.locked = True
            current = _pack(cid & _SLOT_MASK, slot.gen, slot.cur_ver)
        self._run_on_error(slot, current, error_code, error_text)
        return True

    def _run_on_error(self, slot: _IdSlot, cid: int, code: int, text: str):
        handler = slot.on_error
        data = slot.data
        if handler is None:
            # default: destroy so joiners wake (reference default handler)
            self.unlock_and_destroy(cid)
            return
        handler(data, cid, code, text)  # handler must unlock/destroy

    def join(self, cid: int, timeout: Optional[float] = None) -> bool:
        """Block until the id is destroyed (bthread_id_join), surviving
        retry version bumps."""
        slot = self._slot_of(cid)
        if slot is None:
            return True
        from incubator_brpc_tpu_torch.runtime import scheduler

        ctrl = scheduler.get_task_control() if scheduler.in_worker() else None
        with slot.cond:
            if not self._same_rpc(slot, cid):
                return True
            if ctrl:
                ctrl.on_task_block()
            try:
                return slot.cond.wait_for(lambda: not self._same_rpc(slot, cid), timeout)
            finally:
                if ctrl:
                    ctrl.on_task_unblock()


_default_pool = CallIdPool()


def default_pool() -> CallIdPool:
    return _default_pool
