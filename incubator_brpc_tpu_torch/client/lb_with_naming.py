"""LoadBalancerWithNaming — glue NS → LB → sockets.

Analog of reference details/load_balancer_with_naming.{h,cpp}: watches
a NamingServiceThread, feeds add/remove into the LB, and resolves a
selected node to a shared Socket (SocketMap for TCP, fabric for ICI).
Per-node CircuitBreaker isolation, HealthCheckTask revival, and
ClusterRecoverPolicy anti-avalanche live here (reference spreads these
across socket/health_check/circuit_breaker; the composition point is
the same).

Port of the JAX package's ``client/lb_with_naming.py``: the one change
is the client ICI port, which lives on the owning channel's
``ChannelOptions.ici_device`` (``ici_device`` here) instead of being
acquired with no device.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.client.circuit_breaker import CircuitBreaker, ClusterRecoverPolicy
from incubator_brpc_tpu_torch.client.health_check import HealthCheckTask
from incubator_brpc_tpu_torch.client.load_balancer import (
    LoadBalancer,
    SelectIn,
    create_load_balancer,
)
from incubator_brpc_tpu_torch.client.naming_service import (
    NamingServiceThread,
    NamingServiceWatcher,
    ServerNode,
)
from incubator_brpc_tpu_torch.transport.socket import Socket
from incubator_brpc_tpu_torch.transport.socket_map import acquire_socket
from incubator_brpc_tpu_torch.utils.logging import log_error


class _NodeState:
    __slots__ = ("breaker", "health_task", "healthy")

    def __init__(self):
        self.breaker = CircuitBreaker()
        self.health_task: Optional[HealthCheckTask] = None
        self.healthy = True


class LoadBalancerWithNaming(NamingServiceWatcher):
    def __init__(self, ici_device=None):
        self._lb: Optional[LoadBalancer] = None
        self._ns_thread: Optional[NamingServiceThread] = None
        self._states: Dict[ServerNode, _NodeState] = {}
        self._lock = threading.Lock()
        self._recover = ClusterRecoverPolicy()
        self._ns_filter = None
        self._ici_port = None
        # torch device of the client ICI port (the owning channel's
        # ChannelOptions.ici_device; None: responses move by reference)
        self._ici_device = ici_device

    def init(self, url: str, lb_name: str, ns_filter=None) -> int:
        self._lb = create_load_balancer(lb_name)
        if self._lb is None:
            log_error("unknown load balancer %r", lb_name)
            return errors.EREQUEST
        self._ns_filter = ns_filter
        self._ns_thread = NamingServiceThread.get(url)
        if self._ns_thread is None:
            log_error("unknown naming service url %r", url)
            return errors.EREQUEST
        self._ns_thread.add_watcher(self)
        return 0

    # ---- NS watcher ---------------------------------------------------------
    def on_servers_changed(self, nodes):
        if self._ns_filter is not None:
            nodes = [n for n in nodes if self._ns_filter(n)]
        with self._lock:
            for n in nodes:
                if n not in self._states:
                    self._states[n] = _NodeState()
            for n in list(self._states):
                if n not in nodes:
                    st = self._states.pop(n)
                    if st.health_task:
                        st.health_task.stop()
        self._lb.reset_servers(list(nodes))

    # ---- selection (Controller::IssueRPC hot path) --------------------------
    def select_server(self, controller, messenger) -> Tuple[int, int, Optional[ServerNode]]:
        """Returns (err, sid, node). Skips isolated/excluded nodes, falls
        back through candidates, triggers health check on connect
        failure."""
        lb = self._lb
        all_nodes = lb.servers()
        if not all_nodes:
            return errors.ENOSERVICE, 0, None
        isolated = sum(
            1 for n in all_nodes if (st := self._states.get(n)) and st.breaker.is_isolated()
        )
        allow_isolated = self._recover.should_try_isolated(isolated, len(all_nodes))
        excluded = set(controller._excluded)
        request_code = getattr(controller, "request_code", 0) or controller.log_id
        channel = controller._channel
        signature = channel._signature() if channel is not None else ""
        conn_type = channel.options.connection_type if channel is not None else "single"
        connect_timeout_s = (
            channel.options.connect_timeout_ms / 1000.0 if channel is not None else 3.0
        )
        ssl_params = channel._ssl_params() if channel is not None else None
        for _attempt in range(len(all_nodes) + 1):
            node = lb.select_server(
                SelectIn(excluded=frozenset(excluded), request_code=request_code)
            )
            if node is None:
                break
            st = self._states.get(node)
            if (
                st is not None
                and st.breaker.is_isolated()
                and not allow_isolated
                and len(excluded) < len(all_nodes)
            ):
                excluded.add(node)
                continue
            err, sid = self._socket_for(
                node, messenger, signature, conn_type, connect_timeout_s,
                controller, ssl_params,
            )
            if err == errors.ECANCELED:
                # the RPC finalized while we were acquiring: not the
                # node's fault — no breaker mark, no further candidates
                return err, 0, None
            if err == 0:
                if hasattr(lb, "on_dispatch"):
                    lb.on_dispatch(node)
                    if not controller.try_record_dispatch(node) and hasattr(
                        lb, "on_undispatch"
                    ):
                        # RPC finalized while this backup attempt was
                        # selecting: feedback() already swept, so release
                        # the inflight count here or it leaks forever
                        lb.on_undispatch(node)
                return 0, sid, node
            self._on_connect_failed(node)
            excluded.add(node)
        return errors.EFAILEDSOCKET, 0, None

    def _socket_for(
        self,
        node: ServerNode,
        messenger,
        signature: str = "",
        conn_type: str = "single",
        connect_timeout_s: float = 3.0,
        controller=None,
        ssl_params=None,
    ) -> Tuple[int, int]:
        ep = node.endpoint
        if ep.is_ici():
            port = self._client_ici_port()
            if port is None:
                return errors.EFAILEDSOCKET, 0
            from incubator_brpc_tpu_torch.parallel.ici import get_fabric

            if not get_fabric().routable(ep.coords):
                return errors.EFAILEDSOCKET, 0
            sid = port.connect(ep.coords)
            return (0, sid) if sid is not None else (errors.EFAILEDSOCKET, 0)
        return acquire_socket(
            ep, messenger, signature, conn_type, connect_timeout_s, controller,
            ssl_params,
        )

    def _client_ici_port(self):
        if self._ici_port is None:
            with self._lock:
                if self._ici_port is None:
                    from incubator_brpc_tpu_torch.parallel.ici import acquire_client_port

                    self._ici_port = acquire_client_port(
                        device=self._ici_device
                    )
        return self._ici_port

    def close(self):
        """Detach from the NS thread, stop health probes, release the
        fabric port (no shutdown path = unbounded watcher/probe leak)."""
        if self._ns_thread is not None:
            self._ns_thread.remove_watcher(self)
            self._ns_thread = None
        with self._lock:
            states = list(self._states.values())
            self._states.clear()
        for st in states:
            if st.health_task:
                st.health_task.stop()
        if self._ici_port is not None:
            from incubator_brpc_tpu_torch.parallel.ici import get_fabric

            get_fabric().unregister(self._ici_port.coords)
            self._ici_port = None

    def _on_connect_failed(self, node: ServerNode):
        st = self._states.get(node)
        if st is None:
            return
        st.breaker.mark_failed_hard()
        if st.health_task is None or st.health_task._stopped:
            st.health_task = HealthCheckTask(
                node.endpoint, on_revived=lambda n=node: self._on_revived(n)
            )

    def _on_revived(self, node: ServerNode):
        st = self._states.get(node)
        if st is not None:
            st.breaker.reset()
            st.healthy = True

    # ---- per-RPC feedback (LB Feedback + breaker, OnComplete path) ----------
    def feedback(self, controller):
        lb = self._lb
        node = controller._selected_server
        # Every attempt (retry/backup) incremented inflight via
        # on_dispatch; lb.feedback below decrements exactly once for the
        # final node, so release every OTHER dispatch record here or the
        # leaked inflight permanently deflates those nodes' weights.
        # This sweep must run even with node None (e.g. the deadline
        # fired mid-select, before the attempt became _selected_server).
        dispatches = controller.take_dispatches()
        if dispatches and hasattr(lb, "on_undispatch"):
            final_released = False
            for d in dispatches:
                if node is not None and d == node and not final_released:
                    final_released = True  # lb.feedback covers this one
                    continue
                lb.on_undispatch(d)
        if node is None:
            return
        st = self._states.get(node)
        failed = controller.failed()
        if st is not None:
            # EOVERCROWDED is admission pressure, not node death: it
            # feeds the soft shed signal below (tier-aware LBs route
            # around and probe back), while the breaker stays armed for
            # real failures — tripping it on sheds would turn every
            # overload blip into an isolation the prober can't revive
            st.breaker.on_call(
                failed
                and controller.error_code
                not in (errors.ECANCELED, errors.EOVERCROWDED)
            )
            if failed and controller.error_code in (
                errors.EFAILEDSOCKET,
                errors.ECLOSE,
            ):
                self._on_connect_failed(node)
        if (
            failed
            and controller.error_code == errors.EOVERCROWDED
            and hasattr(lb, "on_shed")
        ):
            # admission shed (the retry-elsewhere code): tier-aware LBs
            # deprioritize the replica until successes decay the signal
            lb.on_shed(node)
        lb.feedback(node, controller.latency_us, failed)

    def servers(self):
        return self._lb.servers() if self._lb else []

    def describe(self) -> str:
        out = []
        for n in self.servers():
            st = self._states.get(n)
            iso = st.breaker.is_isolated() if st else False
            out.append(f"{n.endpoint}{' [isolated]' if iso else ''}")
        return "\n".join(out)
