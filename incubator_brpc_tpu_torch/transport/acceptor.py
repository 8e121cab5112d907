"""Acceptor — accept loop on the listening socket.

Analog of reference Acceptor (acceptor.h:34-89, acceptor.cpp:84,130):
an InputMessenger subclass whose listening socket's edge-triggered IN
handler runs an accept loop creating connection Sockets owned by the
server's messenger; tracks the connection set for /connections and
closes them on server stop.
"""

from __future__ import annotations

import socket as _pysocket
import threading
import time
from typing import Dict, Set

from incubator_brpc_tpu_torch.transport.input_messenger import InputMessenger
from incubator_brpc_tpu_torch.transport.socket import Socket, SocketOptions
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint
from incubator_brpc_tpu_torch.utils.logging import log_error


class Acceptor(InputMessenger):
    def __init__(self, server):
        super().__init__(None)
        self._server = server
        self._listen_sid = 0
        self._connections: Set[int] = set()
        # accepted connections whose socket is being created: counted,
        # since the dispatcher may hand one's first request to its
        # handler before Socket.create returns
        self._registering = 0
        self._lock = threading.Lock()
        self._reaper_stop = threading.Event()
        self._reaper = None

    def start_accept(self, listen_fd: _pysocket.socket) -> int:
        self._listen_sid = Socket.create(
            SocketOptions(
                fd=listen_fd,
                on_edge_triggered_events=self._on_new_connections,
                server=self._server,
            )
        )
        idle = getattr(
            getattr(self._server, "options", None), "idle_timeout_sec", -1
        )
        if idle and idle > 0:
            self._reaper = threading.Thread(
                target=self._reap_idle, args=(float(idle),), daemon=True
            )
            self._reaper.start()
        return 0

    def _reap_idle(self, idle_s: float):
        """Close connections with no read/write activity for idle_s
        (reference idle-connection reaper, acceptor.cpp:130)."""
        tick = max(0.05, min(idle_s / 4.0, 1.0))
        while not self._reaper_stop.wait(tick):
            now = time.monotonic()
            with self._lock:
                conns = list(self._connections)
            for sid in conns:
                s = Socket.address(sid)
                if s is None or s.failed:
                    continue
                if now - s.last_active_s > idle_s:
                    s.set_failed(0, f"idle > {idle_s:.0f}s, closed by reaper")
            # recycle what we (or anything else) killed — without this,
            # reaped sockets sit in _connections/the pool until someone
            # happens to poll connection_count()
            self._gc()

    def _on_new_connections(self, listen_sock):
        """accept4 loop until EAGAIN (OnNewConnections, acceptor.cpp:84)."""
        ssl_ctx = getattr(self._server, "_ssl_server_ctx", None)
        while True:
            try:
                conn, addr = listen_sock.fd.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError as e:
                if not listen_sock.failed:
                    log_error("accept failed: %r", e)
                return
            try:
                conn.setsockopt(_pysocket.IPPROTO_TCP, _pysocket.TCP_NODELAY, 1)
            except OSError:
                pass
            remote = (
                EndPoint.tcp(addr[0], addr[1])
                if isinstance(addr, tuple)
                else EndPoint.uds(str(addr))
            )
            if ssl_ctx is not None:
                # handshake on its own task so a slow/hostile peer can't
                # stall the accept loop (reference runs the SSL state
                # machine non-blocking per socket; blocking-with-timeout
                # on a worker task is this transport's equivalent)
                from incubator_brpc_tpu_torch.runtime import scheduler

                scheduler.spawn(self._tls_accept, conn, remote, ssl_ctx)
                continue
            self._register_conn(conn, remote)

    def _tls_accept(self, conn, remote, ssl_ctx):
        from incubator_brpc_tpu_torch.transport.ssl_helper import wrap_server_side

        conn = wrap_server_side(conn, ssl_ctx, 3.0, remote, log_error)
        if conn is not None:
            self._register_conn(conn, remote)

    def _register_conn(self, conn, remote):
        with self._lock:
            self._registering += 1
        sid = None
        try:
            sid = Socket.create(
                SocketOptions(
                    fd=conn,
                    remote=remote,
                    messenger=self,
                    server=self._server,
                )
            )
        finally:
            with self._lock:
                self._registering -= 1
                if sid is not None:
                    self._connections.add(sid)

    def connection_count(self) -> int:
        self._gc()
        with self._lock:
            return len(self._connections) + self._registering

    def connections(self):
        self._gc()
        with self._lock:
            return [Socket.address(sid) for sid in self._connections]

    def _gc(self):
        with self._lock:
            dead = [
                sid
                for sid in self._connections
                if (s := Socket.address(sid)) is None or s.failed
            ]
            for sid in dead:
                s = Socket.address(sid)
                self._connections.discard(sid)
                if s is not None:
                    s.recycle()

    def stop_listening(self):
        """Phase one of graceful stop (Server::Stop closewait semantics):
        refuse NEW connections while existing ones keep serving, so
        in-flight requests can drain before stop_accept tears down."""
        listen = Socket.address(self._listen_sid)
        self._listen_sid = 0
        if listen is not None:
            listen.set_failed(0, "server stopping")
            listen.recycle()

    def stop_accept(self):
        self._reaper_stop.set()
        self.stop_listening()
        with self._lock:
            conns = list(self._connections)
            self._connections.clear()
        sockets = [s for sid in conns if (s := Socket.address(sid)) is not None]
        h2_socks = [s for s in sockets if s.h2_ctx is not None and not s.failed]
        if h2_socks:
            # graceful GOAWAY, then a short drain window so in-flight
            # handlers get their responses out — killing the fd right
            # after a GOAWAY that covers those sids would tell the peer
            # "possibly processed" and lose the answers
            from incubator_brpc_tpu_torch.protocols.h2 import send_goaway

            for s in h2_socks:
                try:
                    send_goaway(s)
                except Exception:  # noqa: BLE001
                    pass
            deadline = time.monotonic() + 1.0
            while time.monotonic() < deadline:
                # drained = no open streams AND their queued response
                # bytes flushed (streams pop when bytes enter _write_q;
                # set_failed clears that queue, so wait it out too)
                if all(
                    s.failed
                    or s.h2_ctx is None
                    or (not s.h2_ctx.streams and s._unwritten == 0)
                    for s in h2_socks
                ):
                    break
                time.sleep(0.02)
        for s in sockets:
            s.set_failed(0, "server stopping")
            s.recycle()
