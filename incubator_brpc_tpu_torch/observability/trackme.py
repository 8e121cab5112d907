"""trackme — version census / kill-switch pings.

Analog of reference trackme.{h,cpp} (trackme.cpp:36-39): when a
trackme server is configured (flag ``trackme_server``), the process
pings it in the background with its framework version; the response's
severity drives WARNING/FATAL logs (known-bug notices) and the server
may retune the ping interval. Disabled by default (opt-in phone-home,
same stance as the reference's -trackme_server flag).

Server side: TrackMeService answers the pings — register it on any
server to act as the census endpoint (the reference ships
tools/trackme_server; ours is a first-class service).
"""

from __future__ import annotations

import threading
from typing import Optional

from incubator_brpc_tpu_torch import __version__ as _version
from incubator_brpc_tpu_torch.protos.trackme_pb2 import (
    TrackMeRequest,
    TrackMeResponse,
    TrackMeFatal,
    TrackMeOK,
    TrackMeWarning,
)
from incubator_brpc_tpu_torch.server.service import Service, ServiceStub, rpc_method
from incubator_brpc_tpu_torch.utils.flags import define_flag, get_flag
from incubator_brpc_tpu_torch.utils.logging import log_error, log_info

define_flag(
    "trackme_server",
    "",
    "address of a TrackMeService census server; empty disables pings",
    validator=lambda v: True,
)

_DEFAULT_INTERVAL_S = 300
_rpc_version = 1  # bumped when wire-visible behavior changes


def rpc_version() -> int:
    return _rpc_version


class TrackMeService(Service):
    """The census endpoint (reference tools/trackme_server analog).
    Subclass and override ``check`` to flag known-bad versions."""

    # pinned: subclasses must keep answering at the canonical name the
    # pinger's stub addresses
    SERVICE_NAME = "TrackMeService"

    @rpc_method(TrackMeRequest, TrackMeResponse)
    def TrackMe(self, controller, request, response, done):
        sev, text, interval = self.check(request.rpc_version, request.server_addr)
        response.severity = sev
        if text:
            response.error_text = text
        if interval:
            response.new_interval = interval
        done()

    def check(self, version: int, server_addr: str):
        """→ (severity, error_text, new_interval_s). Default: all OK."""
        return TrackMeOK, "", 0


class _TrackMePinger:
    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._interval = _DEFAULT_INTERVAL_S
        self._lock = threading.Lock()
        self.last_response: Optional[TrackMeResponse] = None
        self.pings = 0

    def start_once(self):
        with self._lock:
            if self._thread is not None or not get_flag("trackme_server", ""):
                return
            # fresh Event per generation: the previous thread keeps ITS
            # (set) event, so a restart can never resurrect it
            self._stop = threading.Event()
            stop = self._stop
            self._thread = threading.Thread(
                target=self._run, args=(stop,), daemon=True,
                name="tpubrpc-trackme",
            )
            self._thread.start()

    def stop(self):
        with self._lock:
            self._stop.set()
            t, self._thread = self._thread, None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2)

    def ping_now(self, server_addr: str = "") -> Optional[TrackMeResponse]:
        """One synchronous ping (also the body of the background loop)."""
        target = get_flag("trackme_server", "")
        if not target:
            return None
        from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
        from incubator_brpc_tpu_torch.client.controller import Controller

        ch = Channel(ChannelOptions(timeout_ms=3000, max_retry=0))
        try:
            if ch.init(target) != 0:
                return None
            stub = ServiceStub(ch, TrackMeService)
            c = Controller()
            req = TrackMeRequest(rpc_version=_rpc_version)
            if server_addr:
                req.server_addr = server_addr
            resp = stub.TrackMe(c, req)
            if c.failed():
                return None
            self.pings += 1
            self.last_response = resp
            if resp.severity == TrackMeFatal:
                log_error("[TrackMe] FATAL notice: %s", resp.error_text)
            elif resp.severity == TrackMeWarning:
                log_error("[TrackMe] warning: %s", resp.error_text)
            if resp.new_interval > 0:
                self._interval = resp.new_interval
            return resp
        finally:
            ch.close()

    def _run(self, stop):
        log_info("trackme pinger started (version %s)", _version)
        while not stop.wait(1.0 if self.pings == 0 else self._interval):
            try:
                self.ping_now()
            except Exception as e:  # noqa: BLE001 — census must never hurt
                log_error("trackme ping failed: %r", e)


_pinger = _TrackMePinger()


def pinger() -> _TrackMePinger:
    return _pinger


def start_trackme():
    """Called on server start (reference triggers on first RPC)."""
    _pinger.start_once()
