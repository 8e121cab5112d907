"""SocketMap — process-global connection sharing + pooling.

Analog of reference SocketMap (socket_map.h:32-80) plus the pooled /
short connection acquisition of socket_inl.h (GetPooledSocket /
GetShortSocket, channel.h:84-89):

- "single" (default): one shared multiplexed connection per
  (EndPoint, channel signature); a non-empty ``connection_group``
  splits sharing (channel.h:130-134).
- "pooled": a free-list of connections per key; each RPC borrows one
  exclusively and returns it when done — the reference's fix for
  correlation-less protocols (HTTP), where responses match by FIFO
  order on the connection.
- "short": a fresh connection per RPC, closed on completion (callers
  use Socket.connect directly; nothing to share here).

Failed sockets are replaced on next acquisition; the old one is handed
to health checking by the caller.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, Optional, Tuple

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.transport.socket import Socket
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint


class SocketMap:
    def __init__(self):
        self._map: Dict[Tuple[EndPoint, str], int] = {}
        self._pools: Dict[Tuple[EndPoint, str], Deque[int]] = {}
        self._lock = threading.Lock()

    def get_or_create(
        self,
        remote: EndPoint,
        messenger,
        signature: str = "",
        user=None,
        connect_timeout_s: float = 3.0,
        ssl_params=None,
    ) -> Tuple[int, int]:
        """Returns (error_code, sid). Creates/replaces the shared socket
        when missing, failed, or draining."""
        key = (remote, signature)
        with self._lock:
            sid = self._map.get(key)
        if sid is not None:
            sock = Socket.address(sid)
            if sock is not None and not sock.failed and not sock.draining:
                return 0, sid
        # connect outside the map lock (reference creates then inserts)
        err, new_sid = Socket.connect(
            remote, messenger, timeout_s=connect_timeout_s, user=user,
            ssl_params=ssl_params,
        )
        if err:
            return err, 0
        with self._lock:
            cur = self._map.get(key)
            if cur is not None and cur != sid:
                cur_sock = Socket.address(cur)
                if cur_sock is not None and not cur_sock.failed and not cur_sock.draining:
                    # lost the race: keep theirs, drop ours
                    mine = Socket.address(new_sid)
                    if mine is not None:
                        mine.set_failed(0, "duplicate connection")
                        mine.recycle()
                    return 0, cur
            self._map[key] = new_sid
        return 0, new_sid

    # ---- pooled (GetPooledSocket, socket_inl.h) -----------------------------
    def get_pooled(
        self,
        remote: EndPoint,
        messenger,
        signature: str = "",
        user=None,
        connect_timeout_s: float = 3.0,
        ssl_params=None,
    ) -> Tuple[int, int]:
        """Borrow an idle pooled connection or create a fresh one. The
        caller owns the socket exclusively until return_pooled."""
        key = (remote, signature)
        while True:
            with self._lock:
                dq = self._pools.get(key)
                sid = dq.popleft() if dq else None
            if sid is None:
                break
            sock = Socket.address(sid)
            if sock is not None and not sock.failed and not sock.draining:
                return 0, sid
            # dead entry: recycle its slot, then try the next
            if sock is not None:
                if not sock.failed:
                    sock.set_failed(errors.ECLOSE, "pooled entry dead")
                sock.recycle()
        return Socket.connect(
            remote, messenger, timeout_s=connect_timeout_s, user=user,
            connection_type="pooled", ssl_params=ssl_params,
        )

    def return_pooled(self, remote: EndPoint, signature: str, sid: int) -> None:
        """Give a borrowed connection back. Only a CLEAN socket returns
        to the free list: one with a response still owed (written
        request that never answered — timeout, backup loser) would hand
        the NEXT borrower a stale response, the FIFO-misroute this
        connection type exists to prevent."""
        sock = Socket.address(sid)
        if sock is None:
            return
        dirty = (
            sock.failed
            or sock.draining
            or bool(sock.pipelined_info)
            or bool(sock.waiting_cids)
            or not sock.read_buf.empty()
        )
        if dirty:
            if not sock.failed:
                sock.set_failed(errors.ECLOSE, "pooled connection not clean")
            sock.recycle()
            return
        with self._lock:
            self._pools.setdefault((remote, signature), deque()).append(sid)

    def pooled_count(self, remote: EndPoint, signature: str = "") -> int:
        with self._lock:
            return len(self._pools.get((remote, signature), ()))

    def remove(self, remote: EndPoint, signature: str = ""):
        with self._lock:
            self._map.pop((remote, signature), None)
            pool = self._pools.pop((remote, signature), None)
        for sid in pool or ():
            sock = Socket.address(sid)
            if sock is not None:
                if not sock.failed:
                    sock.set_failed(errors.ECLOSE, "socket map entry removed")
                sock.recycle()

    def count(self) -> int:
        return len(self._map)


def acquire_socket(
    endpoint, messenger, signature, connection_type, connect_timeout_s,
    controller, ssl_params=None,
):
    """Connection acquisition by type (reference controller.cpp:1073-1111:
    single | GetPooledSocket | GetShortSocket). Pooled/short borrows are
    recorded on the controller (which releases them at finalize); if the
    RPC finalized while this attempt was connecting, the borrow is
    released right here instead of leaking."""
    smap = get_socket_map()
    if connection_type == "pooled":
        err, sid = smap.get_pooled(
            endpoint, messenger, signature=signature,
            connect_timeout_s=connect_timeout_s, ssl_params=ssl_params,
        )
        if err == 0:
            entry = ("pooled", sid, endpoint, signature)
            if not controller.try_record_owned(entry):
                release_owned_socket(entry)
                return errors.ECANCELED, 0
        return err, sid
    if connection_type == "short":
        err, sid = Socket.connect(
            endpoint, messenger, timeout_s=connect_timeout_s,
            connection_type="short", ssl_params=ssl_params,
        )
        if err == 0:
            entry = ("short", sid, endpoint, signature)
            if not controller.try_record_owned(entry):
                release_owned_socket(entry)
                return errors.ECANCELED, 0
        return err, sid
    return smap.get_or_create(
        endpoint, messenger, signature=signature,
        connect_timeout_s=connect_timeout_s, ssl_params=ssl_params,
    )


def release_owned_socket(entry) -> None:
    """Give back a pooled borrow / close a short connection."""
    kind, sid, remote, signature = entry
    if kind == "pooled":
        get_socket_map().return_pooled(remote, signature, sid)
        return
    sock = Socket.address(sid)
    if sock is not None:
        if not sock.failed:
            sock.set_failed(0, "short connection done")
        sock.recycle()


_global_map: Optional[SocketMap] = None
_global_lock = threading.Lock()


def get_socket_map() -> SocketMap:
    global _global_map
    if _global_map is None:
        with _global_lock:
            if _global_map is None:
                _global_map = SocketMap()
    return _global_map
