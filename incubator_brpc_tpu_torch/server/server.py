"""Server — service hosting over the shared transport.

Port of the JAX package's ``server/server.py`` (reference brpc::Server,
server.{h,cpp}; StartInternal at server.cpp:734-1121): builds
per-method status/limiters, listens and starts the Acceptor, and
exposes the server on the ICI fabric (``start_ici``) over a torch
device.  One port speaks every registered protocol.

Micro-batching (``enable_batching``, ``batching/``), the builtin
observability pages (``builtin/``, on the same port or behind
``internal_port``), rpc_dump sampling and trackme are carried over.
``native_engine=True`` serves tpu_std (and sniffed HTTP and redis)
over the C++ engine (``native/``): the engine cuts every fallback frame
of one read burst into one dispatch, whose batched rows reach each
Batcher as one ``submit_many`` and whose replies leave as one
``ns_send_burst`` per connection.  Where the JAX package serves on its
Python transport when the engine cannot be built, the port raises
``native.NativeEngineError``; the semantic fallbacks (TLS, first-message
auth, a non-TCP endpoint) stay as they are there, logged.
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
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint
from incubator_brpc_tpu_torch.utils.logging import log_error, log_info, log_warning


# ---- server response ring (docs/fastpath.md "server ring") ----
# Per-thread staging of native-connection response frames: while a
# harvested window is being answered (a native read-burst loop, or a
# micro-batcher scatter fan-out), _NativeConnSocket.write stages frames
# here instead of crossing into C per call, and resp_ring_flush ships
# each connection's frames as ONE ns_send_burst (one writev burst per
# harvested window — the server half of nc_mux_submit_many).  tpu_std
# frames carry correlation ids, so batching replies is order-safe; the
# HTTP/RESP paths never reach this collector.
_resp_ring_tls = threading.local()


def resp_ring_begin():
    """Open a response-ring staging scope on this thread.  Returns a
    truthy token when THIS call opened the scope (the caller must pass
    it to resp_ring_flush), falsy when an enclosing scope is already
    staging (the outer scope flushes — nesting is safe)."""
    if getattr(_resp_ring_tls, "frames", None) is not None:
        return False
    _resp_ring_tls.frames = []
    return True


def resp_ring_flush(token) -> None:
    """Close a staging scope: group the staged frames by connection and
    flush each group through ONE engine send_burst.  Staged writes
    already returned 0 to their callers (buffered-write semantics, same
    contract as the engine's internal outq); a failed burst marks every
    staged socket failed so subsequent writes surface the error."""
    if not token:
        return
    frames = _resp_ring_tls.frames
    _resp_ring_tls.frames = None
    if not frames:
        return
    # the ring.submit chaos site covers BOTH ring halves: here it hits
    # the server response ring's flush (drop = the whole window's
    # replies never reach the engine — clients recover via their
    # timeout/retry budget; delay_us = a slow flush).  Short/partial
    # writev mid-burst is the native srv_write fault inside
    # conn_write_parts, which ns_send_burst inherits.
    from incubator_brpc_tpu_torch.chaos import injector as _chaos

    if _chaos.armed:
        spec = _chaos.check("ring.submit", direction="flush")
        if spec is not None:
            if spec.action == "delay_us":
                _chaos.sleep_us(spec.arg)
            elif spec.action == "drop":
                for sock, _ in frames:
                    sock.failed = True
                return
    groups: Dict[tuple, list] = {}
    order = []
    for sock, data in frames:
        key = (id(sock.server), sock._conn_id)
        group = groups.get(key)
        if group is None:
            group = (sock.server, sock._conn_id, [], [])
            groups[key] = group
            order.append(group)
        group[2].append(data)
        group[3].append(sock)
    for server, conn_id, datas, socks in order:
        rc = server._engine_op(
            lambda eng, c=conn_id, d=datas: eng.send_burst(c, d)
        )
        if rc is None or rc != 0:
            for sock in socks:
                sock.failed = True
    try:
        from incubator_brpc_tpu_torch.metrics import ring_metrics

        ring_metrics.rpc_ring_flush_bursts << len(order)
    except Exception:  # noqa: BLE001 — metrics never fail a flush
        pass


class _NativeConnSocket:
    """Socket facade over one native-engine connection: gives the
    Python fallback path (tpu_std.process_request/send_response) the
    surface it needs while IO stays in the C++ engine."""

    is_server_side = True

    def __init__(self, server: "Server", conn_id: int):
        self.server = server
        self._conn_id = conn_id
        self.remote = None
        self.failed = False

    def write(self, buf, ignore_eovercrowded=False, span=None) -> int:
        data = buf.to_bytes()
        frames = getattr(_resp_ring_tls, "frames", None)
        if frames is not None:
            # response ring open on this thread: stage instead of
            # crossing into C — resp_ring_flush ships the window as one
            # writev burst.  0 here means "handed to the ring", the
            # same buffered contract as the engine's outq below.
            frames.append((self, data))
            if span is not None:
                span.write_done(0)
            return 0
        rc = self.server._engine_op(
            lambda eng: eng.send(self._conn_id, data)
        )
        if rc is None or rc != 0:
            self.failed = True
            if span is not None:
                span.write_done(errors.EFAILEDSOCKET)
            return errors.EFAILEDSOCKET
        if span is not None:
            span.write_done(0)  # handed to the engine's writer
        return 0

    def set_failed(self, code=0, reason=""):
        self.failed = True
        self.server._engine_op(lambda eng: eng.close_conn(self._conn_id))

    def close_after_flush(self, code=0, reason=""):
        """An HTTP reply with ``Connection: close``: the engine has no
        close-after-flush for Python replies (``close_conn`` shuts the
        socket at once and would cut a queued reply), so the connection
        stays to the client, which asked to close it; the engine reaps it
        at EOF.  (The JAX package's facade lacks the method, and its
        fallback raises AttributeError after the reply.)"""


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
    # handshake per-connection in transport/acceptor.py). Incompatible
    # with native_engine (the C++ engine is plaintext) — ssl wins and
    # the server falls back to the Python transport.
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
        # per-thread burst collector: while a multi-frame native read
        # burst (a client submission-ring window) is being processed,
        # batched-method rows defer here and land in each Batcher as
        # ONE submit_many accumulation (see _process_native_frame)
        self._burst_tls = threading.local()
        self._native_engine = None
        self._native_fast_methods = []
        self._harvest_lock = threading.Lock()
        # engine-lifetime readers/writer state: _engine_op holds a ref
        # while calling into C; stop() drains refs before destroy()
        self._engine_cv = threading.Condition(self._harvest_lock)
        self._engine_refs = 0
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
        existing dispatch path.  Inside a native read-burst window the
        row defers to the per-thread collector instead, so the whole
        window reaches the Batcher as one submit_many accumulation."""
        batcher = self._batchers.get(method.full_name)
        if batcher is None:
            return False
        rows = getattr(self._burst_tls, "rows", None)
        if rows is not None:
            rows.append((batcher, method, ctrl, request, response, done))
            return True
        return batcher.submit(ctrl, request, response, done)

    def _burst_begin(self) -> None:
        self._burst_tls.rows = []

    def _burst_end(self) -> None:
        """Flush the burst collector: group deferred rows by Batcher and
        hand each group over in ONE submit_many (one lock, one flush
        decision).  A batcher that stopped mid-burst degrades to the
        direct dispatch path per row — the same fallback submit's False
        return would have triggered inline."""
        rows = self._burst_tls.rows
        self._burst_tls.rows = None
        if not rows:
            return
        groups = {}
        for batcher, method, ctrl, request, response, done in rows:
            groups.setdefault(id(batcher), (batcher, []))[1].append(
                (method, ctrl, request, response, done)
            )
        for batcher, group in groups.values():
            if batcher.submit_many(
                [(c, req, res, d) for _, c, req, res, d in group]
            ):
                continue
            from incubator_brpc_tpu_torch.observability.span import (
                swap_current_span,
            )

            for method, ctrl, request, response, done in group:
                prev = (
                    swap_current_span(ctrl._span)
                    if ctrl._span is not None
                    else None
                )
                try:
                    exc = self.run_user_method(
                        method, ctrl, request, response, done
                    )
                    if exc is not None:
                        ctrl.set_failed(
                            errors.EINTERNAL, f"method raised: {exc}"
                        )
                        done()
                finally:
                    if ctrl._span is not None:
                        swap_current_span(prev)

    def _engine_op(self, fn):
        """Run fn(engine), or return None if the engine is gone.

        Reader/writer discipline instead of a global mutex on the send
        hot path (the engine is internally thread-safe): ops take a
        refcount under the lifetime lock and run CONCURRENTLY outside
        it; stop() swaps the field to None under the lock and waits for
        the refcount to drain before destroy().  An op that entered
        before the swap finishes on a live engine; one after sees None:
        no use-after-free, and no serialized responses."""
        cv = self._engine_cv
        with cv:
            eng = self._native_engine
            if eng is None:
                return None
            self._engine_refs += 1
        try:
            return fn(eng)
        finally:
            with cv:
                self._engine_refs -= 1
                if self._engine_refs == 0:
                    cv.notify_all()

    def harvest_native_stats(self) -> None:
        """Fold native fast-path completions into MethodStatus.

        The C++ engine answers fast-path frames without touching Python,
        so their counts/latencies accumulate in per-method atomics
        (engine.cpp NativeMethod).  This pulls the deltas into the same
        MethodStatus the Python transport feeds — /status, /vars and the
        auto limiter then see ALL traffic.  Called lazily by the /status
        builtin and at stop(); cheap enough for every render (a couple
        of atomic loads per method)."""
        # single-flight: concurrent /status renders would diff the same
        # snapshot and double-count deltas.  The engine read must ALSO
        # happen under the lock: stop() swaps the field to None and
        # destroys the engine under this same lock, so a render racing
        # stop() either sees None or finishes before the free.
        with self._harvest_lock:
            eng = self._native_engine
            if eng is None:
                return
            for entry in self._native_fast_methods:
                name, mname, last = entry
                cur = eng.method_stats(name, mname)
                if cur is None:
                    continue
                dn = cur["count"] - last["count"]
                status = self._method_status.get(f"{name}.{mname}")
                if status is not None and dn > 0:
                    avg_us = (
                        cur["latency_ns_sum"] - last["latency_ns_sum"]
                    ) / (dn * 1000.0)
                    status.latency_rec.update_bulk(avg_us, dn)
                    if status.limiter is not None:
                        status.limiter.on_response_bulk(int(avg_us), dn)
                derr = (cur["errors"] - last["errors"]) + (
                    cur["rejected"] - last["rejected"]
                )
                if status is not None and derr > 0:
                    status.errors << derr
                if status is not None and status.limiter is not None:
                    # re-push the (possibly moving) limit into the C++ gate
                    eng.set_method_max_concurrency(
                        name, mname, status.limiter.max_concurrency()
                    )
                entry[2] = cur

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
        if self.options.native_engine and self._ssl_server_ctx is None:
            rc = self._start_native(ep)
            if rc <= 0:
                return rc
            # rc > 0: a semantic fallback (not TCP/UDS, auth) → Python
        elif self.options.native_engine:
            log_error("native_engine is plaintext-only; ssl_options set → "
                      "serving on the Python transport")
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

    def _start_native(self, ep: EndPoint) -> int:
        """Bring the C++ engine up on `ep`. Returns 0 = serving natively,
        <0 = hard error, >0 = a semantic fallback to the Python transport
        (an endpoint that is not TCP/UDS, first-message auth).  Raises
        native.NativeEngineError when the engine cannot be built."""
        if ep.scheme not in ("tcp", "uds"):
            log_error("native_engine serves TCP/UDS only; falling back")
            return 1
        if self.options.auth is not None:
            log_error("native_engine does not do first-message auth; "
                      "falling back to the Python transport")
            return 1
        from incubator_brpc_tpu_torch import native

        # no engine, no native server: NativeEngineError carries the
        # compiler's message (the JAX package serves on Python instead)
        native.require()
        import os as _os

        # default scales with the machine: extra epoll workers on a
        # single shared core only add context switches
        nworkers = self.options.num_threads or min(4, _os.cpu_count() or 4)
        eng = native.NativeServerEngine(nworkers=nworkers)
        eng.set_dispatch(self._native_fallback_frame)
        # one port speaks every protocol (the InputMessenger inversion):
        # the engine sniffs http/redis per connection, answers native
        # fast paths in C, and hands everything else to the Python
        # stack above (builtin pages, restful routing, RedisService)
        eng.enable_protocols(
            http=True, redis=self.options.redis_service is not None
        )
        if self.options.redis_service is not None and getattr(
            self.options.redis_service, "native_kv", False
        ):
            eng.redis_enable_native_kv()
        self._native_fast_methods = []  # (service, method, harvested snapshot)
        for name, svc in self._services.items():
            for path in getattr(svc, "native_http_fastpaths", list)():
                # raw-body echo endpoints answered entirely in C (the
                # reference http_server example's trivial handler shape)
                eng.register_native_http_echo(path)
            for mname, fast in getattr(svc, "native_fastpaths", dict)().items():
                kind, attach = fast
                if kind == "echo":
                    eng.register_native_echo(name, mname, attach)
                elif kind == "method":
                    eng.register_native_method(name, mname, attach)
                else:
                    continue
                self._native_fast_methods.append(
                    [name, mname, {"count": 0, "latency_ns_sum": 0,
                                   "rejected": 0, "errors": 0}]
                )
                # mirror the method's concurrency limit into the C++
                # gate (fast-path rejections return EOVERCROWDED like
                # the Python admission path; the auto limiter's moving
                # limit is re-pushed on every stats harvest)
                status = self._method_status.get(f"{name}.{mname}")
                if status is not None and status.limiter is not None:
                    eng.set_method_max_concurrency(
                        name, mname, status.limiter.max_concurrency()
                    )
        try:
            port = eng.listen(0 if ep.scheme == "uds" else ep.port, ep.host)
        except OSError as e:
            log_error("native listen on %s failed: %r", ep, e)
            eng.destroy()
            return -1
        self._native_engine = eng
        self._listen_ep = ep if ep.scheme == "uds" else EndPoint.tcp(ep.host, port)
        self._running = True
        if self.options.internal_port is not None and self.options.internal_port >= 0:
            # the internal port is always TCP; a UDS main listener
            # serves builtins on loopback (matches the non-native path)
            rc = self._start_internal_port(
                ep.host if ep.scheme == "tcp" else "127.0.0.1"
            )
            if rc != 0:
                self.stop()
                return rc
        log_info("Server started on %s (native engine, %d workers)",
                 self._listen_ep, nworkers)
        self._maybe_install_graceful_quit()
        return 0

    def _native_fallback_frame(self, conn_id: int, proto: int, frame: bytes):
        """Frames the C++ fast path didn't answer: full Python-stack
        semantics. Runs on an engine worker thread — hand off to the
        scheduler so slow handlers never stall the event loop.  proto
        says which wire protocol the engine sniffed on the connection
        (tpu_std / http / redis).

        With usercode_in_dispatcher the handler runs INLINE on the
        engine worker, inside the dispatch callback (same trade as the
        Python transport's flag: no handoff latency, but a slow handler
        stalls that worker's event loop).  Inline mode also makes the
        fallback reply synchronous with the engine's cut — the reply
        leaves before the dispatch returns — which is what the
        reply-ordering tests rely on to be deterministic."""
        from incubator_brpc_tpu_torch import native
        from incubator_brpc_tpu_torch.runtime import scheduler

        if proto == native.PROTO_HTTP:
            fn = self._process_native_http
        elif proto == native.PROTO_REDIS:
            fn = self._process_native_redis
        else:
            fn = self._process_native_frame
        if self.options.usercode_in_dispatcher:
            try:
                fn(conn_id, frame)
            except Exception as e:  # noqa: BLE001 — never unwind into C
                log_error("inline native fallback raised: %r", e)
            return
        scheduler.spawn(fn, conn_id, frame)

    def _process_native_http(self, conn_id: int, frame: bytes):
        """One complete HTTP request the engine's framer cut but no
        native handler answered: run it through the full Python http
        stack (restful routing, builtins, pb services) and write the
        response back through the engine."""
        from incubator_brpc_tpu_torch.protocols import ParseError
        from incubator_brpc_tpu_torch.protocols import http as http_mod
        from incubator_brpc_tpu_torch.utils.iobuf import IOBuf

        if self._native_engine is None:
            return
        sock = _NativeConnSocket(self, conn_id)
        buf = IOBuf(frame)
        try:
            res = http_mod.parse(buf, sock, False)
        except Exception:  # noqa: BLE001
            res = None
        if res is None or res.error != ParseError.OK or res.message is None:
            self._engine_op(lambda eng: eng.close_conn(conn_id))
            self._engine_op(lambda eng: eng.py_done(conn_id))
            return
        try:
            http_mod.process_request(res.message, sock)
        except Exception as e:  # noqa: BLE001
            log_error("native http fallback handler raised: %r", e)
        finally:
            # resume the paused connection (replies stay in order: the
            # engine cut nothing since dispatching this frame)
            self._engine_op(lambda eng: eng.py_done(conn_id))

    def _process_native_redis(self, conn_id: int, frame: bytes):
        """One complete RESP command the engine's native KV didn't
        recognize: hand it to the Python RedisService."""
        from incubator_brpc_tpu_torch.protocols import ParseError
        from incubator_brpc_tpu_torch.protocols import redis as redis_mod
        from incubator_brpc_tpu_torch.utils.iobuf import IOBuf

        if self._native_engine is None:
            return
        sock = _NativeConnSocket(self, conn_id)
        buf = IOBuf(frame)
        try:
            res = redis_mod.parse(buf, sock, False)
        except Exception:  # noqa: BLE001
            res = None
        if res is None or res.error != ParseError.OK or res.message is None:
            self._engine_op(lambda eng: eng.close_conn(conn_id))
            self._engine_op(lambda eng: eng.py_done(conn_id))
            return
        try:
            redis_mod.process_request(res.message, sock)
        except Exception as e:  # noqa: BLE001
            log_error("native redis fallback handler raised: %r", e)
        finally:
            self._engine_op(lambda eng: eng.py_done(conn_id))

    def _process_native_frame(self, conn_id: int, frame: bytes):
        import struct as _struct

        from incubator_brpc_tpu_torch.protocols import tpu_std
        from incubator_brpc_tpu_torch.protos import rpc_meta_pb2 as _pb
        from incubator_brpc_tpu_torch.utils.iobuf import IOBuf

        if self._native_engine is None:  # racing stop(): engine is gone
            return

        def _kill():  # garbage framing kills the conn, same as
            # ParseResult.bad() on the Python transport; routed through
            # _engine_op so a racing stop() can't hand us a freed engine
            self._engine_op(lambda eng: eng.close_conn(conn_id))

        # The engine coalesces every Python-fallback tpu_std frame it
        # cut from ONE read burst into a single dispatch (engine.cpp
        # cut_frames), so `frame` may hold N concatenated TRPC frames —
        # a client submission-ring window arrives here whole, as one
        # scheduler task.  Validate the framing of the whole burst
        # first (any garbage kills the conn, exactly like the
        # single-frame path did), then process in arrival order.
        bounds = []
        off = 0
        total = len(frame)
        while off < total:
            if total - off < 12 or frame[off : off + 4] != b"TRPC":
                _kill()
                return
            meta_size, body_size = _struct.unpack_from(">II", frame, off + 4)
            end = off + 12 + meta_size + body_size
            if end > total:
                _kill()
                return
            bounds.append((off, meta_size, end))
            off = end
        if not bounds:
            _kill()
            return
        burst = len(bounds) > 1
        # server response ring: replies to a multi-frame window stage on
        # this thread and flush as one writev burst after the window is
        # fully dispatched (including inline-executed batch fan-outs)
        ring_token = resp_ring_begin() if burst else False
        if burst:
            # batched-method rows in this burst defer into the
            # collector and reach each Batcher as ONE accumulation
            self._burst_begin()
        try:
            sock = _NativeConnSocket(self, conn_id)
            for off, meta_size, end in bounds:
                meta = _pb.RpcMeta()
                try:
                    meta.ParseFromString(frame[off + 12 : off + 12 + meta_size])
                except Exception:  # noqa: BLE001
                    _kill()
                    return
                body_size = end - off - 12 - meta_size
                if meta.attachment_size < 0 or meta.attachment_size > body_size:
                    _kill()
                    return
                payload = IOBuf(frame[off + 12 + meta_size : end])
                msg = tpu_std.TpuStdMessage(meta, payload)
                # rpcz stamps for the native fallback: the engine cut the
                # frame off-GIL, so received≈parse_done≈enqueued at entry
                now_us = _time.time_ns() // 1000
                msg.received_us = msg.parse_done_us = msg.enqueued_us = now_us
                tpu_std.process_request(msg, sock)
        finally:
            if burst:
                try:
                    self._burst_end()
                finally:
                    # flush AFTER _burst_end: inline-executed batch
                    # handlers' responses also ride this window's burst
                    resp_ring_flush(ring_token)

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
        if self._native_engine is not None:
            self.harvest_native_stats()  # final fold before teardown
            # swap under the lifetime lock, then wait for in-flight
            # _engine_op refs to drain before freeing the C++ object.
            # New ops see None; old ops finish on the live engine.
            with self._engine_cv:
                eng, self._native_engine = self._native_engine, None
                drained = self._engine_cv.wait_for(
                    lambda: self._engine_refs == 0, timeout=5.0
                )
            if drained:
                eng.destroy()
            else:
                # a ref-holder is wedged inside the C engine: freeing it
                # now would be the exact use-after-free this guards
                # against.  Stop the engine's threads but leak the
                # object — bounded, and strictly safer.
                log_error(
                    "native engine refs not drained after 5s; stopping "
                    "without destroy (leaking engine object)"
                )
                eng.stop()
            # remove the UDS socket file we bound, or a later
            # Python-transport restart on the path hits EADDRINUSE
            if self._listen_ep is not None and self._listen_ep.scheme == "uds":
                import os as _os

                try:
                    _os.unlink(self._listen_ep.host)
                except OSError:
                    pass
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
