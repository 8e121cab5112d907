"""ResourcePool / ObjectPool — slab pools addressable by versioned ids.

Analog of butil::ResourcePool (reference resource_pool.h:27) and
butil::ObjectPool (object_pool.h). Sockets, CallId slots, and stream
contexts live here; the versioned 64-bit id makes stale handles fail
address() instead of dereferencing recycled memory (ABA safety).

Id layout follows the reference's SocketId convention (socket.h:335):
``id = (version << 32) | slot``. A slot's version is bumped on every
return_resource, so an id minted before recycling no longer resolves.
"""

from __future__ import annotations

import threading
from typing import Callable, Generic, List, Optional, TypeVar

T = TypeVar("T")

INVALID_ID = (1 << 64) - 1


class _Slot:
    __slots__ = ("obj", "version")

    def __init__(self):
        self.obj = None
        self.version = 0


class ResourcePool(Generic[T]):
    def __init__(self, factory: Callable[[], T]):
        self._factory = factory
        self._slots: List[_Slot] = []
        self._free: List[int] = []
        self._lock = threading.Lock()

    def get_resource(self) -> tuple[int, T]:
        """Allocate (id, object). Object may be recycled; caller resets it."""
        with self._lock:
            if self._free:
                idx = self._free.pop()
                slot = self._slots[idx]
            else:
                idx = len(self._slots)
                slot = _Slot()
                slot.obj = self._factory()
                self._slots.append(slot)
            return (slot.version << 32) | idx, slot.obj

    def address(self, rid: int) -> Optional[T]:
        """Resolve id → object; None if the slot was recycled (version drift)."""
        idx = rid & 0xFFFFFFFF
        ver = rid >> 32
        slots = self._slots
        if idx >= len(slots):
            return None
        slot = slots[idx]
        if slot.version != ver:
            return None
        return slot.obj

    def return_resource(self, rid: int) -> bool:
        idx = rid & 0xFFFFFFFF
        ver = rid >> 32
        with self._lock:
            if idx >= len(self._slots):
                return False
            slot = self._slots[idx]
            if slot.version != ver:
                return False
            slot.version += 1
            self._free.append(idx)
            return True

    def size(self) -> int:
        return len(self._slots)

    def free_count(self) -> int:
        return len(self._free)


class ObjectPool(Generic[T]):
    """Pool of reusable objects without id addressing (butil::ObjectPool)."""

    def __init__(self, factory: Callable[[], T], max_free: int = 1024):
        self._factory = factory
        self._free: List[T] = []
        self._lock = threading.Lock()
        self._max_free = max_free

    def get_object(self) -> T:
        with self._lock:
            if self._free:
                return self._free.pop()
        return self._factory()

    def return_object(self, obj: T) -> None:
        with self._lock:
            if len(self._free) < self._max_free:
                self._free.append(obj)
