"""Server — service hosting over the shared transport.

Port of the JAX package's ``server/server.py`` (reference brpc::Server,
server.{h,cpp}; StartInternal at server.cpp:734-1121): builds
per-method status/limiters, listens and starts the Acceptor, and
exposes the server on the ICI fabric (``start_ici``) over a torch
device.  One port speaks every registered protocol.

Micro-batching (``enable_batching``, ``batching/``), the builtin
observability pages (``builtin/``, on the same port or behind
``internal_port``), rpc_dump sampling and trackme are carried over.
Not carried over yet, raising NotImplementedError when asked for: the
native C++ engine (ROADMAP.md queue 1 item 22), with or without TLS.
"""

from __future__ import annotations

import socket as _pysocket
import threading
import time as _time
from dataclasses import dataclass
from typing import Dict, Optional

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.global_init import global_init
from incubator_brpc_tpu_torch.runtime.scheduler import get_task_control
from incubator_brpc_tpu_torch.server.method_status import MethodStatus, make_limiter
from incubator_brpc_tpu_torch.server.service import MethodSpec, Service
from incubator_brpc_tpu_torch.transport.acceptor import Acceptor
from incubator_brpc_tpu_torch.unported import unported
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint
from incubator_brpc_tpu_torch.utils.logging import log_error, log_info, log_warning


class _InternalPortView:
    """Server facade for the internal_port acceptor: serves ONLY the
    builtin observability pages, never user pb services (reference
    internal_port acceptor, server.cpp:1042-1080)."""

    def __init__(self, server: "Server"):
        self._server = server

    def __getattr__(self, name):
        return getattr(self._server, name)

    def builtin_allowed(self) -> bool:
        return True

    def find_method(self, service_name: str, method_name: str):
        return None  # pb services stay on the public port


@dataclass
class ServerOptions:
    """Mirrors reference ServerOptions (server.h)."""

    num_threads: int = 0  # 0 = runtime default
    max_concurrency: object = 0  # 0 | int | "auto" (server-level)
    method_max_concurrency: object = 0  # default per-method limiter spec
    idle_timeout_sec: int = -1
    auth: object = None
    has_builtin_services: bool = True
    internal_port: int = -1
    server_info_name: str = "tpubrpc"
    rpc_dump_dir: str = ""  # non-empty enables request sampling
    # a protocols.redis.RedisService instance makes this server speak
    # redis on the same port (reference ServerOptions.redis_service)
    redis_service: object = None
    # a protocols.memcache.MemcacheService makes this server answer the
    # memcached binary protocol on the same port (TPU extension — the
    # reference client is client-only)
    memcache_service: object = None
    # a protocols.thrift.ThriftService makes this server speak framed
    # thrift on the same port (reference ServerOptions.thrift_service)
    thrift_service: object = None
    # a protocols.mongo.MongoServiceAdaptor makes this server answer
    # mongo wire protocol (reference ServerOptions.mongo_service_adaptor)
    mongo_service_adaptor: object = None
    # a protocols.legacy.NsheadService answers raw nshead requests
    # (reference ServerOptions.nshead_service)
    nshead_service: object = None
    # a Service whose methods answer nova_pbrpc (nshead + pb body,
    # method index in head.reserved; reference nova server adaptor)
    nova_service: object = None
    # a protocols.rtmp.RtmpService gates/observes RTMP streams; media
    # relay publisher→players is built in (reference RtmpService)
    rtmp_service: object = None
    # Per-RPC reusable user data, pooled across requests (reference
    # ServerOptions.session_local_data_factory, server.cpp:811-851):
    # handlers call controller.session_local_data(); the object returns
    # to the pool when the response is sent.
    session_local_data_factory: object = None
    # Per worker thread user data (thread_local_data_factory):
    # controller.thread_local_data() creates once per thread.
    thread_local_data_factory: object = None
    # Run request parse + user handlers inline in the event-dispatcher
    # thread (two fewer scheduler handoffs per request). Only safe when
    # every handler is non-blocking — the latency-tuned threading model
    # (reference docs/cn/benchmark.md; inverse of -usercode_in_pthread).
    usercode_in_dispatcher: bool = False
    # Serve tpu_std over the C++ engine (native/engine.cpp): epoll +
    # framing + native-fastpath methods entirely off the GIL; other
    # methods fall back to the Python stack via the dispatch callback.
    # The reference is C++ end to end — this restores that property for
    # the hot loops (input_messenger.cpp:317-382, socket.cpp:1584-1790).
    # Requires auth=None (first-message verify stays on the Python
    # transport) and speaks only tpu_std framing on the port.
    native_engine: bool = False
    # TLS: a transport/ssl_helper.ServerSSLOptions serves every accepted
    # connection over SSL (reference ServerOptions.mutable_ssl_options;
    # handshake per-connection in transport/acceptor.py). native_engine
    # is not ported and raises with or without it.
    ssl_options: object = None
    # SIGTERM/SIGINT → stop(closewait_ms=graceful_quit_closewait_ms)
    # (reference -graceful_quit_on_sigterm, server.cpp signal hook).
    # Best-effort: signal handlers install only from the main thread.
    graceful_quit_on_sigterm: bool = False
    graceful_quit_closewait_ms: int = 5000
    # Adaptive micro-batching (docs/batching.md): True builds a Batcher
    # for every @batched_method whose policy is enabled, so concurrent
    # same-method requests coalesce into one fused handler execution.
    # False (default): every method takes the existing dispatch path —
    # the disabled-path cost is one empty-dict check per request.
    enable_batching: bool = False
    # Per-method policy overrides, full_name -> BatchPolicy | dict |
    # None (None/0 force-disables that method while enable_batching
    # covers the rest).
    batch_policies: object = None
    # Multi-tenant admission control (docs/overload.md): an
    # AdmissionPolicy (or its dict form) with priority tiers, tenant →
    # tier mappings and quotas.  None = the default inactive policy:
    # requests still route through server.admission (one decision
    # point for every shed path, with the unified code mapping) but
    # pay only the concurrency-gate check.
    admission_policy: object = None


class Server:
    def __init__(self, options: Optional[ServerOptions] = None):
        self.options = options or ServerOptions()
        self._services: Dict[str, Service] = {}
        self._methods: Dict[str, MethodSpec] = {}  # "Svc.Method" -> spec
        self._method_status: Dict[str, MethodStatus] = {}
        self._acceptor: Optional[Acceptor] = None
        self._listen_fd: Optional[_pysocket.socket] = None
        self._listen_ep: Optional[EndPoint] = None
        self._running = False
        self._lock = threading.Lock()
        self._rpc_dump_ctx = None
        self._ssl_server_ctx = None  # built at start from options.ssl_options
        self._session_local_pool = []  # reusable session-local objects
        self._session_local_lock = threading.Lock()
        self._thread_local_store = threading.local()
        self._ici_port = None
        self._batchers: Dict[str, object] = {}  # full_name -> Batcher
        self._builtin_handlers = {}
        self._internal_acceptor: Optional[Acceptor] = None
        self._internal_ep: Optional[EndPoint] = None
        from incubator_brpc_tpu_torch.server.admission import AdmissionController

        # every dispatch path sheds through this one decision point
        self.admission = AdmissionController(
            self, self.options.admission_policy
        )

    def builtin_allowed(self) -> bool:
        """When internal_port is set, builtin pages are denied on the
        public port (they move behind the firewall-able internal one)."""
        return self.options.internal_port is None or self.options.internal_port < 0

    def harvest_native_stats(self) -> None:
        """The builtin pages call this to fold the native engine's
        fast-path completions into MethodStatus first.  The port has no
        native engine (ROADMAP.md queue 1 item 22): nothing to fold."""

    # ---- registration (AddService, server.cpp:1230,1470) -------------------
    def add_service(self, service: Service) -> int:
        name = service.service_name()
        if name in self._services:
            log_error("service %s already added", name)
            return -1
        specs = service.method_specs()
        if not specs:
            log_error("service %s has no rpc methods", name)
            return -1
        self._services[name] = service
        for mname, spec in specs.items():
            bound = MethodSpec(
                spec.service_name,
                spec.method_name,
                spec.request_class,
                spec.response_class,
                fn=getattr(service, mname),
                batch_fn=(
                    spec.batch_fn.__get__(service)
                    if spec.batch_fn is not None
                    else None
                ),
                batch_policy=spec.batch_policy,
            )
            self._methods[bound.full_name] = bound
            self._method_status[bound.full_name] = MethodStatus(
                bound.full_name, make_limiter(self.options.method_max_concurrency)
            )
        return 0

    def remove_service(self, service: Service) -> int:
        name = service.service_name()
        if name not in self._services:
            return -1
        del self._services[name]
        for full in [f for f in self._methods if f.startswith(name + ".")]:
            del self._methods[full]
            self._method_status.pop(full, None)
        return 0

    def has_service(self, name: str) -> bool:
        return name in self._services

    def find_method(self, service_name: str, method_name: str) -> Optional[MethodSpec]:
        return self._methods.get(f"{service_name}.{method_name}")

    def method_status(self, full_name: str) -> Optional[MethodStatus]:
        return self._method_status.get(full_name)

    def run_user_method(self, method, ctrl, request, response, done):
        """Invoke the user callback with rpcz callback-entry stamping
        (callback-exit is stamped by the protocol's done wrapper just
        before the response is built). Returns the exception the method
        raised, or None — the caller decides how to answer it, so
        protocol-specific failure shapes stay in the protocols."""
        span = getattr(ctrl, "_span", None)
        if span is not None:
            span.callback_start_us = _time.time_ns() // 1000
        try:
            method.fn(ctrl, request, response, done)  # ← USER CODE
            return None
        except Exception as e:  # noqa: BLE001
            log_error("service method %s raised: %r", method.full_name, e)
            return e

    # ---- micro-batching (batching/, docs/batching.md) ----------------------
    def _init_batchers(self):
        """Build Batchers for every @batched_method with an enabled
        policy (ServerOptions.batch_policies overrides the decorator's
        default; None/0 there force-disables one method)."""
        if not self.options.enable_batching:
            return
        overrides = self.options.batch_policies or {}
        batchable = {n for n, s in self._methods.items()
                     if s.batch_fn is not None}
        for unknown in sorted(set(overrides) - batchable):
            # a typo'd key would otherwise silently leave the intended
            # method on its decorator default
            log_warning(
                "batch_policies[%r] matches no registered "
                "@batched_method (batchable: %s)",
                unknown, sorted(batchable),
            )
        for full_name, spec in self._methods.items():
            if spec.batch_fn is None:
                continue
            if full_name in self._batchers:
                # already live (start_ici alongside start, or a restart):
                # rebuilding would stop+drain a serving batcher and zero
                # its counters for nothing
                continue
            policy = overrides.get(full_name, spec.batch_policy)
            if policy in (None, 0):
                continue  # explicit per-method off
            self.enable_method_batching(full_name, policy)

    def enable_method_batching(self, full_name: str, policy=None):
        """(Re)build the Batcher for one @batched_method; returns it,
        or None when the method is unknown/unbatchable or the policy is
        off (max_batch_size <= 1).  Runtime-callable: the /batching
        builtin tunes live policies through here."""
        from incubator_brpc_tpu_torch.batching.batcher import Batcher
        from incubator_brpc_tpu_torch.batching.policy import BatchPolicy

        spec = self._methods.get(full_name)
        if spec is None or spec.batch_fn is None:
            return None
        # validate the replacement policy FIRST: a bad one must fail
        # cleanly, not tear down the live batcher on its way to raising
        # (which would leave the method silently unbatched).  The
        # Batcher itself is built only after the old one stops — its
        # exposed metric variables share the per-method names the old
        # stop() hides.
        if policy is not None and not isinstance(policy, (BatchPolicy, dict)):
            # an explicit falsy value (0, False) = force-off, same
            # convention as ServerOptions.batch_policies; only None
            # means "use the decorator default".  Truthy garbage (a
            # bare int batch size, a string) must raise, not silently
            # tear the live batcher down as "off".
            if policy:
                raise TypeError(
                    f"policy must be a BatchPolicy, a policy dict, None "
                    f"(decorator default) or falsy (force-off); got "
                    f"{policy!r}"
                )
            policy = False
        else:
            if isinstance(policy, dict):
                policy = BatchPolicy.from_dict(policy)
            policy = policy or spec.batch_policy or BatchPolicy()
            # private copy: the Batcher's policy is runtime-tunable
            # (POST /batching) and must never write through to a
            # decorator-level object shared across methods and future
            # servers
            policy = BatchPolicy.from_dict(policy.to_dict())
        old = self._batchers.pop(full_name, None)
        if old is not None:
            old.stop()
        if policy is False or not policy.enabled:
            return None  # the off config: existing dispatch path
        batcher = Batcher(
            full_name,
            spec.batch_fn,
            policy,
            inline=self.options.usercode_in_dispatcher,
        )
        self._batchers[full_name] = batcher
        return batcher

    # ---- admission control (server/admission.py, docs/overload.md) ---------
    def set_admission_policy(self, policy) -> None:
        """Swap the admission policy live (the /admission builtin and
        the overhead bench toggle through here).  None = the inactive
        default.  In-flight tickets release against the controller
        that issued them, so a mid-flight swap never corrupts the
        inflight gauges."""
        from incubator_brpc_tpu_torch.server.admission import AdmissionController

        old, self.admission = self.admission, AdmissionController(self, policy)
        # stop the replaced controller's queue-depth contribution: both
        # resolve the same batchers, and two live controllers would
        # double-count every queued row on /metrics
        old.retire()

    def disable_method_batching(self, full_name: str) -> None:
        old = self._batchers.pop(full_name, None)
        if old is not None:
            old.stop()

    def batcher(self, full_name: str):
        return self._batchers.get(full_name)

    def submit_batched(self, method, ctrl, request, response, done) -> bool:
        """Hand one parsed request to the method's Batcher.  False =
        not batched (no batcher, or it stopped) — the caller runs the
        existing dispatch path.  (The JAX package also defers rows of a
        native read burst into one submit_many; the native engine is
        ROADMAP.md queue 1 item 22.)"""
        batcher = self._batchers.get(method.full_name)
        if batcher is None:
            return False
        return batcher.submit(ctrl, request, response, done)

    def services(self) -> Dict[str, Service]:
        return dict(self._services)

    def methods(self) -> Dict[str, MethodSpec]:
        return dict(self._methods)

    # ---- lifecycle (Start → StartInternal, server.cpp:734-1121) ------------
    def start(self, addr=8000) -> int:
        global_init()
        if self._running:
            return -1
        if isinstance(addr, int):
            ep = EndPoint.tcp("0.0.0.0", addr)
        elif isinstance(addr, EndPoint):
            ep = addr
        else:
            from incubator_brpc_tpu_torch.utils.endpoint import str2endpoint

            ep = str2endpoint(str(addr))
        # warm the runtime (bthread_setconcurrency, server.cpp:953-961)
        if self.options.num_threads:
            get_task_control()
        if self.options.native_engine:
            unported("the native C++ engine (native_engine)", 22)
        if self.options.has_builtin_services:
            self._add_builtin_services()
        if self.options.rpc_dump_dir:
            from incubator_brpc_tpu_torch.observability.rpc_dump import RpcDumpContext

            self._rpc_dump_ctx = RpcDumpContext(self.options.rpc_dump_dir)
        for status in self._method_status.values():
            status.expose()
        self._init_batchers()
        self._ssl_server_ctx = None
        if self.options.ssl_options is not None:
            from incubator_brpc_tpu_torch.transport.ssl_helper import (
                make_server_context,
            )

            try:
                self._ssl_server_ctx = make_server_context(
                    self.options.ssl_options
                )
            except (OSError, ValueError) as e:
                log_error("server SSL context failed: %r", e)
                return -1
        try:
            if ep.scheme == "uds":
                fd = _pysocket.socket(_pysocket.AF_UNIX, _pysocket.SOCK_STREAM)
                fd.bind(ep.host)
            else:
                fd = _pysocket.socket(_pysocket.AF_INET, _pysocket.SOCK_STREAM)
                fd.setsockopt(_pysocket.SOL_SOCKET, _pysocket.SO_REUSEADDR, 1)
                fd.bind((ep.host, ep.port))
            fd.listen(1024)
            fd.setblocking(False)
        except OSError as e:
            log_error("listen on %s failed: %r", ep, e)
            return -1
        if ep.scheme == "tcp" and ep.port == 0:
            ep = EndPoint.tcp(ep.host, fd.getsockname()[1])
        self._listen_fd = fd
        self._listen_ep = ep
        self._running = True
        self._acceptor = Acceptor(self)
        self._acceptor.start_accept(fd)
        if self.options.internal_port is not None and self.options.internal_port >= 0:
            # UDS main listener: the internal port is TCP, serve loopback
            host = ep.host if ep.scheme == "tcp" else "127.0.0.1"
            rc = self._start_internal_port(host)
            if rc != 0:
                self.stop()
                return rc
        log_info("Server started on %s", ep)
        # trackme census pings (opt-in via -trackme_server flag;
        # reference triggers on first RPC, trackme.cpp:36-39)
        from incubator_brpc_tpu_torch.observability.trackme import start_trackme

        start_trackme()
        # SIGUSR1 → stack dump to stderr (tools/task_stacks CLI target;
        # best-effort: only works from the main thread)
        from incubator_brpc_tpu_torch.tools.task_stacks import install_sigusr1_handler

        install_sigusr1_handler()
        self._maybe_install_graceful_quit()
        return 0

    def _start_internal_port(self, host: str) -> int:
        """Second acceptor for builtin services only (server.cpp:1042)."""
        try:
            fd = _pysocket.socket(_pysocket.AF_INET, _pysocket.SOCK_STREAM)
            fd.setsockopt(_pysocket.SOL_SOCKET, _pysocket.SO_REUSEADDR, 1)
            fd.bind((host, self.options.internal_port))
            fd.listen(128)
            fd.setblocking(False)
        except OSError as e:
            log_error("listen on internal_port %s failed: %r",
                      self.options.internal_port, e)
            return -1
        self._internal_ep = EndPoint.tcp(host, fd.getsockname()[1])
        self._internal_acceptor = Acceptor(_InternalPortView(self))
        self._internal_acceptor.start_accept(fd)
        log_info("builtin services on internal port %s", self._internal_ep)
        return 0

    def _add_builtin_services(self):
        # no ImportError guard: a broken builtin/ must fail the start
        from incubator_brpc_tpu_torch.builtin import register_builtin_services

        register_builtin_services(self)

    def add_builtin_handler(self, path: str, fn):
        self._builtin_handlers[path.rstrip("/") or "/"] = fn

    def find_builtin_handler(self, path: str):
        h = self._builtin_handlers.get(path)
        if h is not None:
            return h
        # prefix match for parameterized pages (/pprof/...)
        for p, fn in self._builtin_handlers.items():
            if p != "/" and path.startswith(p + "/"):
                return fn
        return None

    def _maybe_install_graceful_quit(self):
        """SIGTERM/SIGINT → graceful stop (reference
        -graceful_quit_on_sigterm).  Chains any previous handler so the
        process's own shutdown logic still runs after the drain."""
        if not self.options.graceful_quit_on_sigterm:
            return
        import signal

        prev_handlers = {}

        def handler(signum, frame):
            self.stop(closewait_ms=self.options.graceful_quit_closewait_ms)
            prev = prev_handlers.get(signum)
            if callable(prev):
                prev(signum, frame)

        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev = signal.signal(sig, handler)
                prev_handlers[sig] = (
                    prev if prev not in (signal.SIG_DFL, signal.SIG_IGN) else None
                )
        except ValueError:
            # not the main thread: the reference's hook has the same
            # constraint; callers stop() explicitly instead
            pass

    def start_ici(self, slice_id: int = 0, chip_id: int = 0, device=None) -> int:
        """Expose this server on the ICI fabric at ici://slice/chip —
        the analog of listening on a port (reference:
        ServerOptions.use_rdma + rdma init, server.cpp:772-782).  The
        port's device defaults to ``cuda:(chip_id % device_count)``;
        pass ``device`` (e.g. ``torch.device("cpu")``) to choose.  With
        no card and no device the call raises.  Can serve ICI alongside
        (or instead of) TCP."""
        global_init()
        from incubator_brpc_tpu_torch.parallel.ici import get_fabric
        from incubator_brpc_tpu_torch.parallel.mesh import device_for_chip

        self._init_batchers()
        device = device_for_chip(chip_id, device)
        try:
            self._ici_port = get_fabric().register(
                (slice_id, chip_id), server=self, device=device
            )
        except ValueError as e:
            log_error("start_ici failed: %r", e)
            return -1
        self._running = True
        if self._listen_ep is None:
            self._listen_ep = EndPoint.ici(slice_id, chip_id)
        for status in self._method_status.values():
            status.expose()
        log_info("Server exposed on ici://slice%d/chip%d", slice_id, chip_id)
        return 0

    def stop(self, closewait_ms: int = 0) -> int:
        """Stop serving.  ``closewait_ms`` > 0 gives in-flight requests
        that long to finish before connections close (reference
        Server::Stop(closewait_ms), server.cpp: stop listening first,
        drain, then tear down): the listener refuses new connections
        immediately while existing ones flush their responses."""
        with self._lock:
            if not self._running:
                return 0
            self._running = False
        # stop batchers first: each flushes its queued rows so admitted
        # requests finish inside the closewait drain below; late
        # arrivals fall back to direct dispatch (and then ELOGOFF)
        for batcher in list(self._batchers.values()):
            batcher.stop()
        self._batchers.clear()
        if self._ici_port is not None:
            from incubator_brpc_tpu_torch.parallel.ici import get_fabric

            get_fabric().unregister(self._ici_port.coords)
            self._ici_port = None
        if closewait_ms > 0:
            # refuse NEW connections on every listener right away (the
            # docstring's contract), then drain
            if self._acceptor is not None:
                self._acceptor.stop_listening()
            if self._internal_acceptor is not None:
                self._internal_acceptor.stop_listening()
            deadline = _time.monotonic() + closewait_ms / 1000.0
            clean_streak = 0
            while _time.monotonic() < deadline:
                if self._drained():
                    # require the quiet state to HOLD: a request parsed
                    # but not yet counted in concurrency shows as a
                    # momentary zero on a single sample
                    clean_streak += 1
                    if clean_streak >= 3:
                        break
                else:
                    clean_streak = 0
                _time.sleep(0.01)
        if self._acceptor is not None:
            self._acceptor.stop_accept()
            self._acceptor = None
        if self._internal_acceptor is not None:
            self._internal_acceptor.stop_accept()
            self._internal_acceptor = None
        self._listen_fd = None
        return 0

    def _drained(self) -> bool:
        """No handler running, no queued response bytes, no unparsed
        request bytes on any live connection."""
        if any(st.concurrency > 0 for st in self._method_status.values()):
            return False
        acceptor = self._acceptor
        if acceptor is not None:
            for sock in acceptor.connections():
                if sock is None or sock.failed:
                    continue
                if sock._unwritten > 0 or not sock.read_buf.empty():
                    return False
        return True

    def join(self, timeout_s: Optional[float] = None) -> int:
        """Block until the server is STOPPED and every in-flight handler
        finished (reference Server::Join: returns only after Stop).
        Returns 0 when stopped+drained, -1 on timeout."""
        deadline = (
            _time.monotonic() + timeout_s if timeout_s is not None else None
        )
        while self._running or any(
            st.concurrency > 0 for st in self._method_status.values()
        ):
            if deadline is not None and _time.monotonic() > deadline:
                return -1
            _time.sleep(0.01)
        return 0

    def is_running(self) -> bool:
        return self._running

    @property
    def listen_endpoint(self) -> Optional[EndPoint]:
        return self._listen_ep

    @property
    def port(self) -> int:
        return self._listen_ep.port if self._listen_ep else 0

    @property
    def internal_port(self) -> int:
        return self._internal_ep.port if self._internal_ep else -1

    def connection_count(self) -> int:
        return self._acceptor.connection_count() if self._acceptor else 0

    # ---- session/thread-local data pools (server.cpp:811-851) --------------
    def acquire_session_local(self):
        """Pop a pooled object (or build one via the factory)."""
        factory = self.options.session_local_data_factory
        if factory is None:
            return None
        with self._session_local_lock:
            if self._session_local_pool:
                return self._session_local_pool.pop()
        return factory()

    def return_session_local(self, data):
        if data is None:
            return
        with self._session_local_lock:
            if len(self._session_local_pool) < 1024:
                self._session_local_pool.append(data)

    def thread_local_data(self):
        """Per worker-thread user data (thread_local_data_factory)."""
        factory = self.options.thread_local_data_factory
        if factory is None:
            return None
        store = self._thread_local_store
        data = getattr(store, "data", None)
        if data is None:
            data = store.data = factory()
        return data
