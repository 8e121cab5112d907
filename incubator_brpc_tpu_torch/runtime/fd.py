"""fd_wait / task-aware connect — wait on raw fds without blocking
runtime workers.

Analog of reference bthread_fd_wait / bthread_connect (bthread/fd.cpp
EpollThread, :111-408): user code inside a task can park on a file
descriptor's readiness; the wait rides the shared EventDispatcher's
epoll loop (the reference runs a small dedicated epoll thread pool —
same shape, one loop here) and the task blocks on a Butex, so the
worker thread stays available to other tasks via the scheduler's
block/unblock accounting.
"""

from __future__ import annotations

import socket as _pysocket
from typing import Optional

from incubator_brpc_tpu_torch.runtime.butex import Butex
from incubator_brpc_tpu_torch.transport.event_dispatcher import get_dispatcher

EVENT_IN = "in"
EVENT_OUT = "out"


class _FdWaiter:
    """One-shot consumer: wakes the butex on the REQUESTED readiness
    (a writability waiter must not fire on incoming bytes), then
    detaches."""

    __slots__ = ("_butex", "result", "_want")

    def __init__(self, want: str):
        self._butex = Butex(0)
        self.result = 0  # 1 = ready, -1 = error/hup
        self._want = want

    def _fire(self, value: int):
        self.result = value
        self._butex.set_and_wake(1, all=True)

    def _on_epoll_in(self):
        if self._want == EVENT_IN:
            self._fire(1)

    def _on_epoll_out(self):
        if self._want == EVENT_OUT:
            self._fire(1)

    def _on_epoll_err(self):
        self._fire(-1)

    def wait(self, timeout: Optional[float]) -> int:
        # Butex.wait blocks while value == 0 and itself handles the
        # scheduler's block/unblock accounting
        if not self._butex.wait(0, timeout) and self._butex.value != 1:
            return 0
        return self.result


def fd_wait(fd: int, event: str = EVENT_IN, timeout: Optional[float] = None) -> int:
    """Park the calling task until `fd` is readable (EVENT_IN) or
    writable (EVENT_OUT). → 1 ready, 0 timeout, -1 error/hup.
    (bthread_fd_wait analog; the fd must not already be registered
    with the transport — this is for USER fds, not framework sockets.)
    """
    disp = get_dispatcher(fd)
    waiter = _FdWaiter(event)
    if not disp.add_consumer(fd, waiter):
        return -1
    if event == EVENT_OUT and not disp.enable_epollout(fd):
        disp.remove_consumer(fd)
        return -1  # fd not epollable for OUT: fail fast, not timeout
    try:
        return waiter.wait(timeout)
    finally:
        disp.remove_consumer(fd)


def task_connect(
    addr, timeout: Optional[float] = 3.0
) -> Optional[_pysocket.socket]:
    """Non-blocking connect that parks the task instead of the worker
    thread (bthread_connect analog). → connected socket or None."""
    host, port = addr[0], addr[1]
    try:
        family = _pysocket.getaddrinfo(
            host, port, _pysocket.AF_UNSPEC, _pysocket.SOCK_STREAM
        )[0][0]
    except OSError:
        return None
    s = _pysocket.socket(family, _pysocket.SOCK_STREAM)
    s.setblocking(False)
    try:
        rc = s.connect_ex(addr)
        if rc == 0:
            return s
        import errno as _errno

        if rc not in (_errno.EINPROGRESS, _errno.EWOULDBLOCK):
            s.close()
            return None
        if fd_wait(s.fileno(), EVENT_OUT, timeout) != 1:
            s.close()
            return None
        err = s.getsockopt(_pysocket.SOL_SOCKET, _pysocket.SO_ERROR)
        if err != 0:
            s.close()
            return None
        return s
    except OSError:
        s.close()
        return None
