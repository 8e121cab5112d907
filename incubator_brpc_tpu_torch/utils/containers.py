"""Read-mostly containers (analog of butil/containers/).

- DoublyBufferedData: lock-free-for-readers read-mostly data, the
  structure every load balancer's hot SelectServer path reads
  (reference doubly_buffered_data.h:37-51). The CPython rebuild uses
  RCU-style snapshot swapping: readers grab an immutable snapshot
  reference (a single attribute load, atomic under the GIL); writers
  build the next snapshot off to the side and publish it with one store.
  Same reader guarantee (never blocked, never sees a torn value).
- FlatMap: open-addressing map in the reference (flat_map.h:109); dict
  is already an open-addressing hash map in CPython, so FlatMap is a
  thin API-compat shim.
- BoundedQueue: SPSC bounded ring (containers/bounded_queue.h).
"""

from __future__ import annotations

import threading
from typing import Callable, Generic, Optional, TypeVar

T = TypeVar("T")


class DoublyBufferedData(Generic[T]):
    def __init__(self, initial: T):
        self._snapshot: T = initial
        self._write_lock = threading.Lock()

    def read(self) -> T:
        """Hot path: single atomic attribute load, never blocks."""
        return self._snapshot

    def modify(self, fn: Callable[[T], T]) -> None:
        """Build next snapshot from the current one and publish atomically.

        `fn` receives the current snapshot and must return the new one
        (it may copy-and-mutate). Serialised across writers.
        """
        with self._write_lock:
            self._snapshot = fn(self._snapshot)

    def modify_inplace(self, copy: Callable[[T], T], mutate: Callable[[T], None]) -> None:
        with self._write_lock:
            nxt = copy(self._snapshot)
            mutate(nxt)
            self._snapshot = nxt


class FlatMap(dict):
    """API-compat shim over dict (reference butil::FlatMap, flat_map.h:109)."""

    def seek(self, key):
        return self.get(key)

    def insert(self, key, value):
        self[key] = value
        return value

    def erase(self, key) -> int:
        return 1 if self.pop(key, _MISSING) is not _MISSING else 0


_MISSING = object()


class BoundedQueue(Generic[T]):
    """Bounded ring buffer (SPSC in the reference; here lock-guarded)."""

    def __init__(self, capacity: int):
        self._buf: list = [None] * capacity
        self._cap = capacity
        self._head = 0
        self._count = 0
        self._lock = threading.Lock()

    def push(self, item: T) -> bool:
        with self._lock:
            if self._count == self._cap:
                return False
            self._buf[(self._head + self._count) % self._cap] = item
            self._count += 1
            return True

    def pop(self) -> Optional[T]:
        with self._lock:
            if not self._count:
                return None
            item = self._buf[self._head]
            self._buf[self._head] = None
            self._head = (self._head + 1) % self._cap
            self._count -= 1
            return item

    def __len__(self) -> int:
        return self._count

    def full(self) -> bool:
        return self._count == self._cap
