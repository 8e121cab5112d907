"""Health checking — periodic reconnect probes for failed nodes.

Analog of reference HealthCheckTask (details/health_check.cpp:146): a
node whose connection failed is probed every
``health_check_interval_s``; when a probe connects, the node is revived
and rejoins load balancing (SocketUser::CheckHealth/AfterRevived,
socket.h:64-78).
"""

from __future__ import annotations

import socket as _pysocket
import threading
from typing import Callable, Optional

from incubator_brpc_tpu_torch.runtime.timer_thread import get_timer_thread
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint
from incubator_brpc_tpu_torch.utils.logging import log_info


class HealthCheckTask:
    def __init__(
        self,
        endpoint: EndPoint,
        on_revived: Callable[[], None],
        interval_s: float = 1.0,
        max_probes: int = 0,  # 0 = forever
    ):
        self.endpoint = endpoint
        self._on_revived = on_revived
        self._interval = interval_s
        self._max_probes = max_probes
        self._probes = 0
        self._stopped = False
        self._schedule()

    def _schedule(self):
        # the timer thread only *spawns* the probe; the blocking connect
        # runs on a runtime worker so armed RPC timers never stall
        get_timer_thread().schedule(self._spawn_probe, self._interval)

    def _spawn_probe(self):
        from incubator_brpc_tpu_torch.runtime import scheduler

        scheduler.spawn(self._probe)

    def _probe(self):
        if self._stopped:
            return
        self._probes += 1
        if self._check():
            log_info("health check: %s revived", self.endpoint)
            self._stopped = True
            try:
                self._on_revived()
            except Exception:
                pass
            return
        if self._max_probes and self._probes >= self._max_probes:
            self._stopped = True
            return
        self._schedule()

    def _check(self) -> bool:
        ep = self.endpoint
        if ep.scheme == "ici":
            from incubator_brpc_tpu_torch.parallel.ici import get_fabric

            return get_fabric().routable(ep.coords)
        try:
            s = _pysocket.create_connection(ep.sockaddr(), timeout=0.5)
            s.close()
            return True
        except OSError:
            return False

    def stop(self):
        self._stopped = True
