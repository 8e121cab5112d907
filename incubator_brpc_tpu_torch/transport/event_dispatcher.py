"""EventDispatcher — edge-triggered epoll loop feeding the runtime.

Analog of reference EventDispatcher (event_dispatcher.h:31-102,
event_dispatcher_epoll.cpp): a dedicated loop runs epoll_wait; IN
events hand the socket to the runtime via spawn_urgent (the reference's
bthread_start_urgent in Socket::StartInputEvent, socket.cpp:2083); OUT
events wake the socket's epollout butex so a parked KeepWrite task
resumes (socket.cpp WaitEpollOut).

The TPU twist lands in parallel/ici.py: the same Dispatcher
interface is implemented over device completion events instead of
epoll, preserving the one-read-task-per-socket invariant the reference
derives from edge-triggered semantics (SURVEY.md §7 hard parts).
"""

from __future__ import annotations

import os
import select
import threading
import time as _time
from typing import Dict, Optional

from incubator_brpc_tpu_torch.utils.flags import get_flag
from incubator_brpc_tpu_torch.utils.logging import log_error

_EPOLLIN = select.EPOLLIN
_EPOLLOUT = select.EPOLLOUT
_EPOLLET = select.EPOLLET
_EPOLLERR = select.EPOLLERR | select.EPOLLHUP

_tls = threading.local()

# chaos hook slot: set by chaos.injector while an armed plan targets
# the "dispatcher.dispatch" site (this module sits below the metrics
# stack, so the injector reaches down rather than being imported);
# disarmed cost is one `is None` check per IN event.
_chaos_hook = None


def set_chaos_hook(cb) -> None:
    global _chaos_hook
    _chaos_hook = cb


def in_dispatcher() -> bool:
    """True when called on an event-dispatcher thread — code that could
    block (id locks, connects) must re-dispatch to a worker instead."""
    return getattr(_tls, "in_dispatcher", False)


class EventDispatcher:
    def __init__(self, name: str = "tpubrpc-dispatcher"):
        self._epoll = select.epoll()
        self._handlers: Dict[int, object] = {}  # fd -> Socket-like consumer
        self._lock = threading.Lock()
        # self-pipe to interrupt epoll_wait for shutdown
        self._wake_r, self._wake_w = os.pipe()
        os.set_blocking(self._wake_r, False)
        self._epoll.register(self._wake_r, _EPOLLIN | _EPOLLET)
        self._stopped = False
        self._thread = threading.Thread(target=self._run, daemon=True, name=name)
        self._thread.start()

    # consumer must provide: _on_epoll_in(), _on_epoll_out(), _on_epoll_err()
    def add_consumer(self, fd: int, consumer) -> bool:
        """Analog of EventDispatcher::AddConsumer — register for ET IN."""
        with self._lock:
            self._handlers[fd] = consumer
        try:
            self._epoll.register(fd, _EPOLLIN | _EPOLLET)
            return True
        except OSError as e:
            log_error("epoll register fd=%d failed: %r", fd, e)
            with self._lock:
                self._handlers.pop(fd, None)
            return False

    def enable_epollout(self, fd: int) -> bool:
        """Add OUT interest (KeepWrite parked on EAGAIN);
        reference RegisterEvent with pollout."""
        try:
            self._epoll.modify(fd, _EPOLLIN | _EPOLLOUT | _EPOLLET)
            return True
        except OSError:
            return False

    def disable_epollout(self, fd: int) -> None:
        try:
            self._epoll.modify(fd, _EPOLLIN | _EPOLLET)
        except OSError:
            pass

    def remove_consumer(self, fd: int) -> None:
        try:
            self._epoll.unregister(fd)
        except OSError:
            pass
        with self._lock:
            self._handlers.pop(fd, None)

    def _run(self):
        _tls.in_dispatcher = True
        while not self._stopped:
            try:
                events = self._epoll.poll(1.0)
            except (OSError, ValueError):
                if self._stopped:
                    return
                continue
            for fd, ev in events:
                if fd == self._wake_r:
                    try:
                        os.read(self._wake_r, 4096)
                    except BlockingIOError:
                        pass
                    continue
                with self._lock:
                    consumer = self._handlers.get(fd)
                if consumer is None:
                    continue
                try:
                    if ev & _EPOLLERR:
                        consumer._on_epoll_err()
                        continue
                    if ev & _EPOLLOUT:
                        consumer._on_epoll_out()
                    if ev & _EPOLLIN:
                        hook = _chaos_hook  # snapshot: disarm() races
                        if hook is not None:
                            try:
                                hook()  # injected dispatch delay
                            except Exception:  # noqa: BLE001 — a chaos
                                pass  # bug must not eat an ET edge
                        self._stamp_receive(consumer)
                        consumer._on_epoll_in()
                except Exception as e:  # noqa: BLE001
                    log_error("dispatcher handler fd=%d raised: %r", fd, e)

    @staticmethod
    def _stamp_receive(consumer):
        """rpcz receive stamp: the earliest host-visible moment of this
        batch's bytes (span received_us; reference stamps in
        StartInputEvent). Slotted non-Socket consumers (fd waiters)
        simply don't carry it."""
        try:
            consumer.last_read_event_us = _time.time_ns() // 1000
        except AttributeError:
            pass

    def stop(self):
        self._stopped = True
        try:
            os.write(self._wake_w, b"x")
        except OSError:
            pass
        if threading.current_thread() is self._thread:
            return  # the loop itself cannot join/close safely
        self._thread.join(timeout=2)
        # Release the epoll fd and self-pipe (tests/teardown must not
        # leak 3 fds per loop) — but ONLY after a confirmed thread
        # exit: closing under a still-running loop would hand the fd
        # numbers to unrelated sockets the loop then reads.  Idempotent
        # via _fds_closed so a second stop() never double-closes.
        if self._thread.is_alive() or getattr(self, "_fds_closed", False):
            return
        self._fds_closed = True
        try:
            self._epoll.close()
        except OSError:
            pass
        for fd in (self._wake_r, self._wake_w):
            try:
                os.close(fd)
            except OSError:
                pass


_dispatchers: Optional[list] = None
_dispatcher_lock = threading.Lock()


def get_dispatcher(fd: int = 0) -> EventDispatcher:
    """The dispatcher owning ``fd`` (reference -event_dispatcher_num,
    event_dispatcher.cpp:30-45: an array of N epoll loops with fds
    assigned by hash).  The pool size comes from the
    ``event_dispatcher_num`` flag at first use; a given fd always maps
    to the same dispatcher (fd % N), so register/arm/remove stay
    consistent.  N defaults to 1 — on a single-core host extra loops
    only add context switches; multi-core deployments raise the flag
    before the first socket is created."""
    global _dispatchers
    if _dispatchers is None:
        with _dispatcher_lock:
            if _dispatchers is None:
                try:
                    n = max(1, int(get_flag("event_dispatcher_num", 1)))
                except (TypeError, ValueError):
                    n = 1
                _dispatchers = [
                    EventDispatcher(name=f"tpubrpc-dispatcher-{i}")
                    for i in range(n)
                ]
    ds = _dispatchers
    return ds[fd % len(ds)]
