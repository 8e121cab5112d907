"""Channel — the client entry point.

Port of the JAX package's ``client/channel.py`` (reference brpc::Channel,
channel.{h,cpp}): ``init`` takes a single server address — ``host:port``,
``unix:path`` or ``ici://slice/chip`` — or a naming URL and a load
balancer name (channel.h:160-183), and ``call_method`` drives the RPC
through the Controller (CallMethod, channel.cpp:407-584).
ChannelOptions mirrors channel.h:41-140 and keeps every field of the
JAX package's, with ``ici_device`` a ``torch.device``; a cluster
channel's client ICI port lives on it too.

Not carried over yet, each raising NotImplementedError when asked for:
the native C++ connection type and its submission ring (``call_many``,
ROADMAP.md queue 1 item 22).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, replace
from typing import Optional

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.global_init import global_init
from incubator_brpc_tpu_torch.metrics.latency_recorder import LatencyRecorder
from incubator_brpc_tpu_torch.protocols import find_protocol
from incubator_brpc_tpu_torch.protocols.compress import COMPRESS_TYPE_NONE
from incubator_brpc_tpu_torch.transport.input_messenger import InputMessenger
from incubator_brpc_tpu_torch.transport.socket_map import acquire_socket
from incubator_brpc_tpu_torch.unported import unported
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint, str2endpoint
from incubator_brpc_tpu_torch.utils.logging import log_error


@dataclass
class ChannelOptions:
    """Mirrors reference ChannelOptions (channel.h:41-140)."""

    connect_timeout_ms: int = 1000
    timeout_ms: int = 1000
    backup_request_ms: int = -1
    max_retry: int = 3
    protocol: str = "tpu_std"
    # "" = adaptive (http→pooled, else single); or single | pooled |
    # short ("native" is not ported yet)
    connection_type: str = ""
    connection_group: str = ""
    request_compress_type: int = COMPRESS_TYPE_NONE
    retry_policy: object = None
    ns_filter: object = None
    auth: object = None
    enable_circuit_breaker: bool = False
    # torch device owning this channel's ICI client port memory. None
    # (default): responses move by reference with no forced placement
    # hop. Set it and inbound device segments are placed onto (and,
    # same-device, transmitted through the copy+checksum kernels to)
    # that device — the full two-hop data plane.
    ici_device: object = None
    # TLS: a transport/ssl_helper.ChannelSSLOptions enables SSL on every
    # connection this channel opens (reference ChannelOptions.mutable_ssl_options,
    # channel.h; handshake in transport/socket.py Socket.connect)
    ssl_options: object = None


class Channel:
    def __init__(self, options: Optional[ChannelOptions] = None):
        # copy: init() resolves adaptive fields (connection_type) in
        # place, and mutating a caller-owned options object would leak
        # the resolution into other channels built from it
        self.options = replace(options) if options is not None else ChannelOptions()
        self.protocol = None
        self._endpoint: Optional[EndPoint] = None
        self._lb = None  # LoadBalancerWithNaming when cluster-init'ed
        self._messenger = InputMessenger()
        self._latency = None
        self._latency_lock = threading.Lock()
        self._init_done = False
        self._ici_client_port = None
        self._ssl_ctx = None  # built once from options.ssl_options

    # ---- init (channel.h:160-183) ------------------------------------------
    def init(self, naming_url: str, lb_name: Optional[str] = None) -> int:
        """init("ip:port") for a single server, or
        init("file://path" | "list://a:1,b:2" | "tpu://fabric", "rr") for
        a cluster behind a naming service + load balancer."""
        global_init()
        self.protocol = find_protocol(self.options.protocol)
        if self.protocol is None:
            log_error("unknown protocol %r", self.options.protocol)
            return errors.EREQUEST
        self._resolve_connection_type()
        # single-endpoint forms: host:port, unix:path, ici://slice/chip
        # (an ici:// URL names ONE chip; a cluster needs lb_name + a
        # naming service URL like file:// list:// tpu://)
        if lb_name is None and (
            "://" not in naming_url
            or naming_url.startswith("ici://")
            or naming_url.startswith("unix:")
        ):
            try:
                self._endpoint = str2endpoint(naming_url)
            except ValueError as e:
                log_error("bad address %r: %r", naming_url, e)
                return errors.EREQUEST
            self._init_done = True
            return 0
        # cluster path
        from incubator_brpc_tpu_torch.client.lb_with_naming import (
            LoadBalancerWithNaming,
        )

        lb = LoadBalancerWithNaming(ici_device=self.options.ici_device)
        rc = lb.init(naming_url, lb_name or "rr", self.options.ns_filter)
        if rc != 0:
            return rc
        self._lb = lb
        self._init_done = True
        return 0

    def init_single(self, endpoint: EndPoint) -> int:
        global_init()
        self.protocol = find_protocol(self.options.protocol)
        self._resolve_connection_type()
        self._endpoint = endpoint
        self._init_done = True
        return 0

    def _resolve_connection_type(self):
        """Adaptive connection type (reference adaptive_connection_type):
        correlation-less HTTP/1 defaults to pooled — FIFO matching is
        only safe with one outstanding request per connection."""
        ct = self.options.connection_type
        if ct == "native":
            unported("connection_type='native' (the C++ engine)", 22)
        if ct not in ("single", "pooled", "short", ""):
            log_error("unknown connection_type %r, using single", ct)
            self.options.connection_type = "single"
        elif not ct:
            self.options.connection_type = (
                "pooled" if self.options.protocol == "http" else "single"
            )

    # ---- the RPC entry (CallMethod, channel.cpp:407) -----------------------
    def call_method(self, method_spec, controller, request, response, done=None):
        """Drive one RPC: synchronous when ``done`` is None, else
        ``done()`` runs when the response (or failure) lands."""
        if not self._init_done:
            controller.set_failed(errors.EINTERNAL, "channel not initialized")
            if done:
                done()
            return
        controller._start_call(self, method_spec, request, response, done)
        if done is None:
            controller.join()

    def call_many(self, method_spec, requests, timeout_ms=None,
                  controllers=None):
        unported("call_many (the native submission ring)", 22)

    def submission_ring(self, depth: int = 128):
        unported("submission_ring (the native submission ring)", 22)

    # ---- socket selection (Controller::IssueRPC hooks) ---------------------
    def _select_socket(self, controller):
        """Returns (err, sid, server_node); single-server channels share
        the connection via SocketMap, ici:// ones the fabric port;
        cluster channels ask the LB."""
        if self._lb is not None:
            return self._lb.select_server(controller, self._messenger)
        if self._endpoint.is_ici():
            sid = self._ici_port().connect(self._endpoint.coords)
            if sid is None:
                return errors.EFAILEDSOCKET, 0, None
            return 0, sid, None
        err, sid = acquire_socket(
            self._endpoint,
            self._messenger,
            self._signature(),
            self.options.connection_type,
            self.options.connect_timeout_ms / 1000.0,
            controller,
            ssl_params=self._ssl_params(),
        )
        return err, sid, None

    def _ici_port(self):
        if self._ici_client_port is None:
            with self._latency_lock:  # double-checked: one port per channel
                if self._ici_client_port is None:
                    from incubator_brpc_tpu_torch.parallel.ici import (
                        acquire_client_port,
                    )

                    # default device=None: responses move by reference, no
                    # forced placement hop; options.ici_device opts into
                    # device-owned delivery (see ChannelOptions)
                    self._ici_client_port = acquire_client_port(
                        device=self.options.ici_device
                    )
        return self._ici_client_port

    def close(self):
        """Release channel resources: the client ICI port and the
        LB/naming watcher chain, if any."""
        port = self._ici_client_port
        if port is not None:
            from incubator_brpc_tpu_torch.parallel.ici import get_fabric

            self._ici_client_port = None
            get_fabric().unregister(port.coords)
        if self._lb is not None:
            lb, self._lb = self._lb, None
            self._init_done = False
            lb.close()

    def _signature(self) -> str:
        # the ssl marker keeps TLS and plaintext channels — and channels
        # with DIFFERENT TLS configs (verification, client certs) — from
        # sharing a connection (reference hashes the full
        # ChannelSSLOptions into the SocketMapKey's ChannelSignature)
        ssl_mark = ""
        if self.options.ssl_options is not None:
            import hashlib

            ssl_mark = (
                ":ssl:"
                + hashlib.md5(
                    repr(self.options.ssl_options).encode()
                ).hexdigest()[:10]
            )
        return f"{self.options.protocol}:{self.options.connection_group}{ssl_mark}"

    def _ssl_params(self):
        """(SSLContext, sni_hostname) or None; context built once."""
        opts = self.options.ssl_options
        if opts is None:
            return None
        if self._ssl_ctx is None:
            with self._latency_lock:
                if self._ssl_ctx is None:
                    from incubator_brpc_tpu_torch.transport.ssl_helper import (
                        make_client_context,
                    )

                    self._ssl_ctx = make_client_context(opts)
        return (self._ssl_ctx, opts.sni_name)

    def _on_rpc_end(self, controller):
        """Per-RPC bookkeeping: the latency recorder + LB feedback
        (reference Controller::Call::OnComplete); observations fold in
        at the 1 Hz sampler tick."""
        rec = self._latency or self._latency_recorder()
        if not controller.error_code:
            rec.update_batched(controller.latency_us)
        if self._lb is not None:
            self._lb.feedback(controller)

    def _latency_recorder(self) -> LatencyRecorder:
        if self._latency is None:
            with self._latency_lock:
                if self._latency is None:
                    self._latency = LatencyRecorder()
        return self._latency

    def latency_recorder(self) -> LatencyRecorder:
        return self._latency_recorder()
