"""Builtin HTTP services — the observability surface.

Analog of reference src/brpc/builtin/ (13.2k LoC): served on the same
port as RPC traffic (the InputMessenger inversion lets HTTP coexist
with tpu_std), or restricted via internal_port. Implemented pages:

  /            index: links to everything (index_service)
  /status      server overview: methods, qps, latency pXX, concurrency
  /vars[?f]    metrics dump with wildcard filter; ?console=1 (or a
               browser Accept header) renders the HTML dashboard with
               SVG sparklines from the 1 Hz sampler rings
  /metrics     Prometheus text exposition (prometheus_metrics_service)
  /flags       runtime flag listing + ?setvalue editing (flags_service)
  /connections live socket table (connections_service)
  /rpcz        tracing spans; ?trace= merges the sqlite backend
  /health      liveness probe (health_service)
  /version     framework version
  /list        registered services/methods (list_service)
  /threads     runtime worker/blocked counts
  /bthreads    full stack dump of every thread/task (gdb-plugin analog)
  /ids         CallId pool stats (ids_service analog)
  /sockets     Socket pool stats
  /pprof/profile, /hotspots/cpu   cProfile capture (?seconds=N)
  /hotspots/contention            lock-wait profile (Collector-sampled)
  /hotspots/heap, /hotspots/growth  tracemalloc profiles
  /vlog        toggle verbose logging

Handlers are plain callables (server, http_msg) -> (status, body,
content_type), registered per path at server start.
"""

from __future__ import annotations

import io
import json
import threading
import time

from incubator_brpc_tpu_torch import __version__ as _version
from incubator_brpc_tpu_torch.metrics.variable import dump_exposed, list_exposed, _registry
from incubator_brpc_tpu_torch.utils.flags import list_flags, set_flag

_START_TIME = time.time()


def register_builtin_services(server):
    for path, fn in {
        "/": index_page,
        "/index": index_page,
        "/status": status_page,
        "/vars": vars_page,
        "/metrics": metrics_page,
        "/flags": flags_page,
        "/connections": connections_page,
        "/rpcz": rpcz_page,
        "/rpcz/export": rpcz_export_page,
        "/cluster/export": cluster_export_page,
        "/cluster/metrics": cluster_metrics_page,
        "/cluster/latency_breakdown": cluster_latency_breakdown_page,
        "/cluster/stragglers": cluster_stragglers_page,
        "/rpc_dump": rpc_dump_page,
        "/latency_breakdown": latency_breakdown_page,
        "/health": health_page,
        "/version": version_page,
        "/list": list_page,
        "/threads": threads_page,
        "/bthreads": bthreads_page,
        "/ids": ids_page,
        "/sockets": sockets_page,
        "/pprof/profile": pprof_profile,
        "/pprof/heap": pprof_heap,
        "/pprof/growth": pprof_growth,
        "/pprof/symbol": pprof_symbol,
        "/pprof/cmdline": pprof_cmdline,
        "/hotspots/cpu": pprof_profile,
        "/hotspots/contention": contention_page,
        "/hotspots/heap": heap_page,
        "/hotspots/growth": growth_page,
        "/hotspots/hbm": hbm_page,
        "/hotspots/device": device_page,
        "/hotspots/runtime": runtime_page,
        "/protobufs": protobufs_page,
        "/dir": dir_page,
        "/vlog": vlog_page,
        "/chaos": chaos_page,
        "/batching": batching_page,
        "/admission": admission_page,
        "/cache": cache_page,
        "/resharding": resharding_page,
        "/replication": replication_page,
        "/serving": serving_page,
    }.items():
        server.add_builtin_handler(path, fn)


def index_page(server, msg):
    pages = [
        "status", "vars", "vars?console=1", "metrics", "flags",
        "connections", "rpcz", "rpcz/export?trace=", "latency_breakdown",
        "cluster/export", "cluster/metrics", "cluster/latency_breakdown",
        "cluster/stragglers", "rpc_dump", "health",
        "version", "list", "threads",
        "bthreads", "ids", "sockets", "hotspots/cpu",
        "hotspots/contention", "hotspots/heap", "hotspots/growth",
        "hotspots/hbm", "hotspots/device", "hotspots/runtime",
        "pprof/heap", "pprof/growth", "pprof/symbol", "pprof/cmdline",
        "protobufs", "dir", "vlog", "chaos", "batching", "admission",
        "cache", "resharding", "replication", "serving",
    ]
    links = "\n".join(f'<a href="/{p}">/{p}</a><br>' for p in pages)
    return 200, f"<html><body><h1>{server.options.server_info_name}</h1>{links}</body></html>", "text/html"


def status_page(server, msg):
    # pull native fast-path completions into MethodStatus first, so the
    # page reflects traffic the C++ engine answered off-GIL
    server.harvest_native_stats()
    out = [f"server: {server.options.server_info_name}"]
    out.append(f"version: {_version}")
    out.append(f"uptime_s: {time.time() - _START_TIME:.0f}")
    out.append(f"listen: {server.listen_endpoint}")
    out.append(f"connections: {server.connection_count()}")
    out.append("")
    for full_name, status in sorted(server._method_status.items()):
        rec = status.latency_rec
        out.append(
            f"{full_name}:\n"
            f"  count={rec.count()} qps={rec.qps():.1f} concurrency={status.concurrency}\n"
            f"  latency_us avg={rec.latency():.0f} p50={rec.latency_percentile(0.5):.0f} "
            f"p90={rec.latency_percentile(0.9):.0f} p99={rec.latency_percentile(0.99):.0f} "
            f"p999={rec.latency_percentile(0.999):.0f} max={rec.max_latency():.0f}"
            + (
                " (percentiles approximate: native fast-path folds at mean)"
                if rec.bulk_folded
                else ""
            )
            + "\n"
            f"  errors={status.errors.get_value()}"
            + (
                # the (possibly moving) limiter state: current
                # max_concurrency for the auto limiter was computed but
                # never surfaced per-render before the /batching round
                f" limiter={type(status.limiter).__name__}"
                f" max_concurrency={status.limiter.max_concurrency()}"
                if status.limiter
                else ""
            )
            + _admission_status_line(server, full_name)
            + _batch_status_line(server, full_name)
        )
    out.extend(_streams_section())
    out.extend(_replication_section())
    out.extend(_serving_section())
    out.extend(_ring_section(server))
    return 200, "\n".join(out), "text/plain"


def _admission_status_line(server, full_name: str) -> str:
    """One /status line per method when a tiered admission policy is
    active: the tier tenant-less traffic resolves to, its capacity
    share and quota (server/admission.py, docs/overload.md)."""
    adm = getattr(server, "admission", None)
    if adm is None or not adm.policy.active:
        return ""
    policy = adm.policy
    tier = policy.tier_of("", full_name)
    spec = policy.tiers.get(tier)
    return (
        f"\n  admission: tier={tier} share={policy.share(tier):.2f} "
        f"quota={spec.quota if spec else 0} "
        f"inflight={adm.tier_inflight(tier)}"
    )


def _streams_section():
    """Live streaming-RPC streams grouped per negotiating method
    (streaming/observe.py registry) — empty when the process never
    established a stream, so /status costs nothing extra then."""
    import sys

    observe = sys.modules.get("incubator_brpc_tpu_torch.streaming.observe")
    if observe is None:
        return []
    by_method = observe.streams_by_method()
    if not by_method:
        return []
    lines = ["", "streams:"]
    for method, rows in sorted(by_method.items()):
        lines.append(f"  {method}: {len(rows)} live")
        for r in rows[:16]:  # bound the page, not the registry
            lines.append(
                f"    id={r['id']} peer={r['peer']} "
                f"frames_out={r['frames_sent']} frames_in={r['frames_received']} "
                f"unconsumed={r['unconsumed']} consumed={r['consumed_bytes']} "
                f"writer_blocked={r['writer_blocked_us']}us"
            )
        if len(rows) > 16:
            lines.append(f"    ... {len(rows) - 16} more")
    return lines


def _replication_section():
    """Per-replica-group /status lines (replication/group.py registry)
    — empty when the process registered no groups, so /status costs
    nothing extra then (same discipline as _streams_section)."""
    import sys

    grp = sys.modules.get("incubator_brpc_tpu_torch.replication.group")
    if grp is None:
        return []
    groups = grp.groups_snapshot()
    if not groups:
        return []
    lines = ["", "replication:"]
    for name, d in sorted(groups.items()):
        healthy = sum(
            1 for r in d["replicas"] if r["alive"] and not r["repairing"]
        )
        c = d["counters"]
        lines.append(
            f"  {name}: leader={d['leader']} epoch={d['epoch']} "
            f"lease_remaining={d['lease_remaining_s']:.3f}s "
            f"quorum={d['quorum']} serving={healthy}/{len(d['replicas'])} "
            f"writes={c['quorum_writes']} fenced={c['fenced_writes']} "
            f"quorum_failures={c['quorum_failures']} "
            f"leader_changes={c['leader_changes']} "
            f"repair_keys={c['repair_keys']} hedged={c['hedged_reads']}"
        )
    return lines


def _serving_section():
    """Per-session /status lines (serving/session.py registry) —
    empty when the process served no disaggregated sessions, so
    /status costs nothing extra then (same discipline as
    _streams_section)."""
    import sys

    sess = sys.modules.get("incubator_brpc_tpu_torch.serving.session")
    if sess is None:
        return []
    sessions = sess.sessions_snapshot()
    if not sessions:
        return []
    lines = ["", "serving:"]
    for sid, d in sorted(sessions.items())[:32]:  # bound the page
        lines.append(
            f"  {sid}: state={d['state']} replica={d['replica']} "
            f"epoch={d['epoch']} kv_epoch={d['kv_epoch']} "
            f"kv_bytes={d['kv_bytes']} "
            f"tokens={d['tokens']}/{d['max_tokens']} "
            f"prefills={d['prefill_executions']} "
            f"migrations={d['migrations']}"
        )
    if len(sessions) > 32:
        lines.append(f"  ... {len(sessions) - 32} more")
    return lines


def _ring_section(server):
    """One ``ring:`` /status line when ring traffic exists: the server
    engine's response-ring step log (ns_ring_stats) plus the process's
    client-side ring counters (metrics/ring_metrics.py) — empty when
    neither lane ever fired, so /status costs nothing extra then (same
    discipline as _streams_section)."""
    import sys

    srv = {"windows": 0, "responses": 0, "flush_bursts": 0}
    eng_stats = server._engine_op(
        lambda eng: eng.ring_stats() if hasattr(eng, "ring_stats") else None
    ) if hasattr(server, "_engine_op") else None
    if eng_stats:
        srv = eng_stats
    rm = sys.modules.get("incubator_brpc_tpu_torch.metrics.ring_metrics")
    cli = rm.snapshot() if rm is not None else {
        "crossings": 0, "windows": 0, "flush_bursts": 0,
    }
    if not any(srv.values()) and not any(cli.values()):
        return []
    return [
        "",
        "ring:",
        (
            f"  server windows={srv['windows']} "
            f"responses={srv['responses']} "
            f"flush_bursts={srv['flush_bursts']}"
        ),
        (
            f"  client crossings={cli['crossings']} "
            f"windows={cli['windows']}"
        ),
    ]


def _batch_status_line(server, full_name: str) -> str:
    """One /status line for a batched method: live queue depth + the
    coalescing shape (batching/batcher.py counters)."""
    batcher = server._batchers.get(full_name)
    if batcher is None:
        return ""
    return (
        f"\n  batching: queue_depth={batcher.pending()} "
        f"batches={batcher.batches} rows={batcher.rows} "
        f"shed={batcher.shed.get_value()} "
        f"occupancy={batcher.occupancy():.2f} "
        f"max_wait_us={batcher.policy.max_wait_us}"
    )


def vars_page(server, msg):
    wildcard = msg.query.get("filter", msg.query.get("f", "*"))
    # tri-state: console=1 forces HTML, console=0 forces plain text,
    # absent sniffs the Accept header (browsers get the dashboard)
    console = msg.query.get("console")
    want_html = (
        console not in ("0", "false")
        if console is not None
        else "text/html" in (msg.header("accept", "") or "")
    )
    if want_html:
        return vars_html(wildcard)
    pairs = dump_exposed(wildcard)
    return 200, "\n".join(f"{k} : {v}" for k, v in pairs), "text/plain"


def _sparkline_svg(values, w=120, h=22) -> str:
    """Inline SVG sparkline (the reference embeds flot JS for its
    dashboard plots; an SVG needs no scripts)."""
    if len(values) < 2:
        return ""
    lo, hi = min(values), max(values)
    span = (hi - lo) or 1.0
    step = w / (len(values) - 1)
    pts = " ".join(
        f"{i * step:.1f},{h - 2 - (v - lo) / span * (h - 4):.1f}"
        for i, v in enumerate(values)
    )
    return (
        f'<svg width="{w}" height="{h}"><polyline points="{pts}" '
        'fill="none" stroke="#4a90d9" stroke-width="1.5"/></svg>'
    )


def vars_html(wildcard: str):
    """HTML dashboard: value table with 1 Hz-series sparklines for
    windowed variables (Window/PerSecond sampler rings)."""
    import html as _html

    rows = []
    for name, desc in dump_exposed(wildcard):
        var = _registry.get(name)
        spark = ""
        sampler = getattr(var, "_sampler", None)
        if sampler is not None:
            from incubator_brpc_tpu_torch.metrics.window import PerSecond

            with sampler.lock:
                series = [v for _, v in sampler.samples]
            if series and all(isinstance(v, (int, float)) for v in series):
                if isinstance(var, PerSecond) and len(series) > 1:
                    # show the per-second rate series, not cumulative
                    series = [
                        b - a for a, b in zip(series, series[1:])
                    ]
                spark = _sparkline_svg(series)
        rows.append(
            f"<tr><td><code>{_html.escape(name)}</code></td>"
            f"<td>{_html.escape(str(desc))}</td><td>{spark}</td></tr>"
        )
    body = (
        "<html><head><style>"
        "body{font-family:monospace;margin:16px}"
        "table{border-collapse:collapse}"
        "td{border-bottom:1px solid #ddd;padding:3px 12px 3px 0;"
        "vertical-align:middle}"
        "</style></head><body>"
        f"<h2>/vars ({_html.escape(wildcard)})</h2>"
        '<p><a href="/">index</a> · plain text: <a href="/vars?console=0">/vars?console=0</a></p>'
        "<table><tr><th>variable</th><th>value</th><th>last&nbsp;~10s</th></tr>"
        + "".join(rows)
        + "</table></body></html>"
    )
    return 200, body, "text/html"


def metrics_page(server, msg):
    """Prometheus text exposition (prometheus_metrics_service.h:26)."""
    from incubator_brpc_tpu_torch.metrics.multi_dimension import MultiDimension

    lines = []
    for name in list_exposed():
        var = _registry.get(name)
        if var is None:
            continue
        if isinstance(var, MultiDimension):
            for key, sub in var.items():
                labels = ",".join(
                    f'{k}="{v}"' for k, v in zip(var.labels, key)
                )
                val = _num(sub.get_value())
                if val is not None:
                    lines.append(f"{name}{{{labels}}} {val}")
            continue
        val = _num(var.get_value())
        if val is not None:
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {val}")
    return 200, "\n".join(lines) + "\n", "text/plain; version=0.0.4"


def _num(v):
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, (int, float)):
        return v
    return None


def flags_page(server, msg):
    setv = msg.query.get("setvalue")
    name = msg.query.get("flag")
    if setv is not None and name:
        ok = set_flag(name, setv)
        if not ok:
            return 403, f"flag {name} is not reloadable or value invalid", "text/plain"
        return 200, f"{name} set to {setv}", "text/plain"
    out = []
    for fname, f in sorted(list_flags().items()):
        mark = " (R)" if f.reloadable else ""
        out.append(f"{fname}={f.value}{mark}  default={f.default}  {f.help}")
    out.append("")
    out.append("set with /flags?flag=NAME&setvalue=VALUE (reloadable flags only)")
    return 200, "\n".join(out), "text/plain"


def connections_page(server, msg):
    from incubator_brpc_tpu_torch.transport import socket as sm

    out = [
        f"total_connections: {sm.g_connections.get_value()}",
        f"in_bytes: {sm.g_in_bytes.get_value()}  out_bytes: {sm.g_out_bytes.get_value()}",
        f"in_messages: {sm.g_in_messages.get_value()}  out_messages: {sm.g_out_messages.get_value()}",
        "",
    ]
    if server._acceptor is not None:
        for sock in server._acceptor.connections():
            if sock is None:
                continue
            out.append(
                f"sid={sock.sid:x} remote={sock.remote} failed={sock.failed} "
                f"unwritten={sock._unwritten}"
            )
    return 200, "\n".join(out), "text/plain"


def rpcz_page(server, msg):
    from incubator_brpc_tpu_torch.observability import trace as trace_mod
    from incubator_brpc_tpu_torch.observability.span import parse_trace_id, span_db

    trace = msg.query.get("trace")
    if trace:
        try:
            tid = parse_trace_id(trace)
        except ValueError:
            return 400, f"bad trace id {trace!r} (hex expected)", "text/plain"
        if msg.query.get("stitch") not in (None, "", "0", "false"):
            # cluster view: follow the peer endpoints on this trace's
            # client sub-spans, pull their spans over /rpcz/export, and
            # render one tree with per-leg wire+queue residuals
            from incubator_brpc_tpu_torch.observability import cluster

            stitched = cluster.render_stitched(tid)
            if stitched is None:
                return 200, f"no spans for trace {trace}", "text/plain"
            return 200, stitched, "text/plain"
        lines = []
        # hierarchical timeline: client span → collective legs → server
        # span, indented, each line carrying its phase deltas
        tree = trace_mod.render(tid)
        if tree:
            lines.append(tree)
        # sqlite backend covers ring-evicted spans and prior runs
        persisted = span_db().persisted_by_trace(tid)
        in_ring = {s.describe() for s in span_db().by_trace(tid)}
        lines += [
            f"[persisted] {d}" for d in persisted if d not in in_ring
        ]
        if not lines:
            return 200, f"no spans for trace {trace}", "text/plain"
        return 200, "\n".join(lines), "text/plain"
    spans = span_db().recent(int(msg.query.get("n", "50")))
    if not spans:
        return 200, "no spans collected (set rpcz_enabled=true and make calls)", "text/plain"
    return 200, "\n".join(s.describe() for s in reversed(spans)), "text/plain"


def latency_breakdown_page(server, msg):
    """Per-method per-phase latency percentiles (parse/queue/callback/
    write/send, from rpcz span stamps) + the _runtime queue-wait rows.
    The same numbers export to Prometheus as rpc_phase_latency_us."""
    from incubator_brpc_tpu_torch.observability import latency_breakdown

    return 200, latency_breakdown.render(), "text/plain"


def rpcz_export_page(server, msg):
    """This process's SpanDB spans for one trace, as JSON — the wire
    format the cluster stitcher consumes (observability/cluster.py).
    Ids travel in the canonical hex form so they copy-paste between
    /rpcz pages, x-trace-id headers and this endpoint."""
    from incubator_brpc_tpu_torch.observability import cluster
    from incubator_brpc_tpu_torch.observability.span import parse_trace_id

    trace = msg.query.get("trace")
    if not trace:
        return 400, "missing trace=<hex id>", "text/plain"
    try:
        tid = parse_trace_id(trace)
    except ValueError:
        return 400, f"bad trace id {trace!r} (hex expected)", "text/plain"
    payload = cluster.export_trace(
        tid, endpoint=str(server.listen_endpoint or "")
    )
    return 200, json.dumps(payload), "application/json"


def _cluster_export_payload(server) -> dict:
    """This replica's mergeable aggregation STATE (counts + histogram
    buckets, never computed percentiles): per-method server latency and
    every exposed MultiDimension family."""
    from incubator_brpc_tpu_torch.metrics.multi_dimension import MultiDimension
    from incubator_brpc_tpu_torch.observability import cluster  # noqa: F401 — registers fan-out metrics

    server.harvest_native_stats()
    methods = {}
    for full_name, status in server._method_status.items():
        snap = status.latency_rec.mergeable_snapshot()
        errors = int(status.errors.get_value())
        if not snap["count"] and not snap["latency_num"] and not errors:
            continue
        methods[full_name] = {"latency": snap, "errors": errors}
    dims = {}
    for name in list_exposed():
        var = _registry.get(name)
        if isinstance(var, MultiDimension):
            snap = var.mergeable_snapshot()
            if snap["stats"]:
                dims[name] = snap
    return {
        "endpoint": str(server.listen_endpoint or ""),
        "methods": methods,
        "dims": dims,
    }


def cluster_export_page(server, msg):
    """The scrape surface /cluster/metrics on any replica pulls from
    the whole pod and merges exactly (_cluster_export_payload)."""
    return 200, json.dumps(_cluster_export_payload(server)), "application/json"


def _is_self_endpoint(server, ep: str) -> bool:
    """Does `ep` name THIS server?  The scrape must answer itself
    in-process: a synchronous HTTP fetch back to our own port from
    inside a builtin handler would hold the runtime worker the inner
    request needs — a self-deadlock on single-worker runtimes."""
    host, sep, port = ep.rpartition(":")
    if not sep or not port.isdigit() or int(port) != server.port:
        return False
    lep = server.listen_endpoint
    lhost = str(getattr(lep, "host", "") or "")
    return host in ("127.0.0.1", "localhost", "0.0.0.0", lhost)


def _cluster_scrape(server, msg):
    """Shared replica-resolution + scrape for the /cluster pages.
    Returns ((payloads, errors), None) or (None, error_response)."""
    from incubator_brpc_tpu_torch.observability import cluster

    spec = msg.query.get("replicas", "")
    if not spec:
        return None, (
            400,
            "missing replicas=host:port,... or replicas=<naming url>",
            "text/plain",
        )
    try:
        replicas = cluster.resolve_replicas(spec)
    except Exception as e:  # noqa: BLE001
        return None, (400, f"bad replicas spec: {e}", "text/plain")
    if not replicas:
        return None, (400, f"no replicas resolved from {spec!r}", "text/plain")
    try:
        timeout = float(msg.query.get("timeout_s", "3"))
    except ValueError:
        return None, (400, "bad timeout_s", "text/plain")
    payloads, errors = [], []
    for ep in replicas:
        if _is_self_endpoint(server, ep):
            payloads.append(_cluster_export_payload(server))
            cluster.cluster_scrapes_total << 1
        else:
            p, e = cluster.scrape_exports([ep], timeout=timeout)
            payloads.extend(p)
            errors.extend(e)
    return (payloads, errors), None


def cluster_metrics_page(server, msg):
    """Pod-merged Prometheus-style exposition.  ?replicas= names the
    pod (explicit endpoints or a naming url); each replica's
    /cluster/export state merges elementwise, so latency percentiles
    here are exactly those of the pooled samples — not an average of
    per-replica percentiles."""
    from incubator_brpc_tpu_torch.observability import cluster

    scraped, err = _cluster_scrape(server, msg)
    if err is not None:
        return err
    payloads, errors = scraped
    merged = cluster.merge_exports(payloads)
    return 200, cluster.render_merged_metrics(merged, errors), "text/plain"


def cluster_latency_breakdown_page(server, msg):
    """/latency_breakdown over the whole pod: per-replica recorder
    state merged exactly, rendered with the same table the local page
    uses."""
    from incubator_brpc_tpu_torch.observability import cluster, latency_breakdown

    scraped, err = _cluster_scrape(server, msg)
    if err is not None:
        return err
    payloads, errors = scraped
    merged = cluster.merge_exports(payloads)
    table = cluster.merged_breakdown(merged)
    head = [
        f"merged over {len(merged['replicas'])} replicas: "
        + ",".join(merged["replicas"])
    ]
    head += [f"[unreachable] {e}" for e in errors]
    body = (
        latency_breakdown.render_table(table)
        if table
        else "no phase data on any replica (rpcz_enabled must be true)"
    )
    return 200, "\n".join(head) + "\n\n" + body, "text/plain"


def cluster_stragglers_page(server, msg):
    """Shard/replica straggler attribution over the sliding fan-out
    window: peers ranked by drag on fan-out tail latency, split into
    server time vs wire+queue residual (?window_s= overrides)."""
    from incubator_brpc_tpu_torch.observability import cluster

    window = msg.query.get("window_s")
    try:
        window_f = float(window) if window else None
    except ValueError:
        return 400, f"bad window_s {window!r}", "text/plain"
    report = cluster.fanout_tracker().report(window_f)
    return 200, json.dumps(report, indent=1), "application/json"


def rpc_dump_page(server, msg):
    """Request-capture control + visibility (observability/rpc_dump.py).

    GET  → JSON: enabled flag, dir, ratio, sampled count, dump files.
    POST → enable capture at runtime: /rpc_dump?dir=PATH&ratio=0.01
           (or the same keys as a JSON body); dir="" / disable=1 turns
           it off.  Same gate ServerOptions.rpc_dump_dir arms at start.
    """
    from incubator_brpc_tpu_torch.observability.rpc_dump import (
        RpcDumpContext,
        list_dump_files,
    )

    if msg.method == "POST":
        params = {k: v for k, v in msg.query.items()}
        body = msg.body.to_bytes() if len(msg.body) else b""
        if body:
            try:
                parsed = json.loads(body.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                parsed = None
            if not isinstance(parsed, dict):
                return 400, "POST body must be a JSON object", "text/plain"
            params.update(parsed)
        if params.get("disable") not in (None, "", "0", "false", False):
            server._rpc_dump_ctx = None
            return 200, json.dumps({"enabled": False}), "application/json"
        dump_dir = params.get("dir")
        if not dump_dir:
            return 400, "missing dir=PATH (or disable=1)", "text/plain"
        try:
            ratio = float(params.get("ratio", 0.01))
            if not (0 < ratio <= 1):
                raise ValueError
        except (TypeError, ValueError):
            return 400, f"bad ratio {params.get('ratio')!r} (0<ratio<=1)", "text/plain"
        try:
            server._rpc_dump_ctx = RpcDumpContext(
                str(dump_dir), sample_ratio=ratio
            )
        except OSError as e:
            return 400, f"cannot open dump dir: {e}", "text/plain"
        return (
            200,
            json.dumps({"enabled": True, "dir": str(dump_dir), "ratio": ratio}),
            "application/json",
        )
    ctx = getattr(server, "_rpc_dump_ctx", None)
    if ctx is None:
        return 200, json.dumps({"enabled": False}), "application/json"
    return (
        200,
        json.dumps(
            {
                "enabled": True,
                "dir": ctx.dump_dir,
                "ratio": ctx.sample_ratio,
                "sampled": ctx.sampled,
                "files": list_dump_files(ctx.dump_dir),
            }
        ),
        "application/json",
    )


def health_page(server, msg):
    return (200, "OK", "text/plain") if server.is_running() else (503, "stopping", "text/plain")


def version_page(server, msg):
    return 200, f"incubator-brpc_tpu/{_version}", "text/plain"


def list_page(server, msg):
    out = []
    for name, svc in sorted(server.services().items()):
        out.append(name)
        for mname, spec in sorted(svc.method_specs().items()):
            out.append(
                f"  {mname}({spec.request_class.__name__}) -> {spec.response_class.__name__}"
            )
    return 200, "\n".join(out), "text/plain"


def threads_page(server, msg):
    import threading

    from incubator_brpc_tpu_torch.runtime.scheduler import _default_control

    out = [f"python_threads: {threading.active_count()}"]
    if _default_control is not None:
        out.append(f"runtime_workers: {_default_control.worker_count()}")
        out.append(f"runtime_blocked: {_default_control.blocked_count()}")
    for t in threading.enumerate():
        out.append(f"  {t.name} daemon={t.daemon}")
    return 200, "\n".join(out), "text/plain"


def bthreads_page(server, msg):
    """Full stack dump of every runtime thread/task (the reference's
    /bthreads debug page + gdb_bthread_stack plugin, without gdb)."""
    from incubator_brpc_tpu_torch.tools.task_stacks import dump_stacks

    return 200, dump_stacks(), "text/plain"


def ids_page(server, msg):
    from incubator_brpc_tpu_torch.runtime.call_id import default_pool

    pool = default_pool()
    return (
        200,
        f"call_id_slots: {len(pool._slots)}\nfree: {len(pool._free)}\n"
        f"live: {len(pool._slots) - len(pool._free)}",
        "text/plain",
    )


def sockets_page(server, msg):
    from incubator_brpc_tpu_torch.transport.socket import Socket

    pool = Socket._pool
    return (
        200,
        f"socket_slots: {pool.size()}\nfree: {pool.free_count()}\n"
        f"live: {pool.size() - pool.free_count()}",
        "text/plain",
    )


def pprof_profile(server, msg):
    """CPU profile capture — the /hotspots/cpu analog (gperftools in the
    reference, builtin/hotspots_service.cpp; cProfile+pstats here).
    ?view=flame samples sys._current_frames() instead and renders an
    SVG flamegraph (the reference bundles pprof+flot JS for the same
    visualization, hotspots_service.cpp:733-796)."""
    seconds = min(float(msg.query.get("seconds", "1")), 10.0)
    if msg.query.get("view") == "flame":
        from incubator_brpc_tpu_torch.builtin.flamegraph import (
            render_flamegraph,
            sample_stacks,
        )

        stacks = sample_stacks(seconds)
        svg = render_flamegraph(
            {k: float(v) for k, v in stacks.items()},
            title=f"cpu wall-clock samples over {seconds:g}s",
        )
        return 200, svg, "image/svg+xml"
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    time.sleep(seconds)
    prof.disable()
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("cumulative").print_stats(40)
    return 200, buf.getvalue(), "text/plain"


def contention_page(server, msg):
    """Contention profile (reference /hotspots/contention: bthread
    mutex wait samples through the bvar Collector, mutex.cpp:106-180).
    ?reset=1 clears the aggregate."""
    from incubator_brpc_tpu_torch.observability.contention import profiler

    if msg.query.get("reset"):
        profiler().reset()
        return 200, "contention profile reset", "text/plain"
    if msg.query.get("view") == "flame":
        from incubator_brpc_tpu_torch.builtin.flamegraph import render_flamegraph

        stacks = {
            stack: ns / 1000.0
            for stack, (count, ns) in profiler().snapshot().items()
        }
        return (
            200,
            render_flamegraph(stacks, title="lock contention", unit="us"),
            "image/svg+xml",
        )
    return 200, profiler().render(int(msg.query.get("top", "40"))), "text/plain"


_tracemalloc_baseline = [None]


def heap_page(server, msg):
    """Heap profile via tracemalloc (reference /hotspots/heap uses
    tcmalloc MallocExtension; tracemalloc is the managed-runtime
    equivalent). First call starts tracing; later calls report the
    top allocation sites."""
    import tracemalloc

    if not tracemalloc.is_tracing():
        tracemalloc.start(12)
        _tracemalloc_baseline[0] = None
        return 200, "tracemalloc started; re-fetch for the profile", "text/plain"
    snap = tracemalloc.take_snapshot()
    top = snap.statistics("lineno")[: int(msg.query.get("top", "40"))]
    cur, peak = tracemalloc.get_traced_memory()
    out = [f"--- heap  current={cur} peak={peak}", ""]
    out += [str(s) for s in top]
    return 200, "\n".join(out), "text/plain"


def growth_page(server, msg):
    """Heap growth since the previous /hotspots/growth call (reference
    /hotspots/growth: tcmalloc growth stacks)."""
    import tracemalloc

    if not tracemalloc.is_tracing():
        tracemalloc.start(12)
        _tracemalloc_baseline[0] = tracemalloc.take_snapshot()
        return 200, "tracemalloc started; re-fetch for growth", "text/plain"
    snap = tracemalloc.take_snapshot()
    base = _tracemalloc_baseline[0]
    _tracemalloc_baseline[0] = snap
    if base is None:
        return 200, "baseline captured; re-fetch for growth", "text/plain"
    diff = snap.compare_to(base, "lineno")[: int(msg.query.get("top", "40"))]
    out = ["--- growth since last fetch", ""]
    out += [str(s) for s in diff]
    return 200, "\n".join(out), "text/plain"


def hbm_page(server, msg):
    """HBM heap profile (observability/profiling.py): per-tag adopted
    device bytes, cross-checked against the device's own census with
    an explicit ``<dark>`` bucket.  ``?growth=1`` diffs against the
    previous growth fetch; ``?rebase=1`` snaps the census baseline so
    everything currently resident counts as explained."""
    from incubator_brpc_tpu_torch.observability import profiling

    if msg.query.get("rebase") not in (None, "", "0", "false"):
        cen = profiling.rebase_census()
        return (
            200,
            f"census baseline rebased to {cen['bytes']} bytes "
            f"(source={cen['source']})",
            "text/plain",
        )
    top = int(msg.query.get("top", "40"))
    if msg.query.get("growth") not in (None, "", "0", "false"):
        return 200, profiling.render_hbm_growth(top), "text/plain"
    return 200, profiling.render_hbm(top=top), "text/plain"


def device_page(server, msg):
    """Device-time attribution (observability/profiling.py).  Without
    arguments: the always-on per-kernel-family counter table.
    ``?seconds=N`` arms an on-demand ``torch.profiler`` window (the
    deep capture; chaos site ``profile.capture``) and summarizes the
    families that executed inside it."""
    from incubator_brpc_tpu_torch.observability import profiling

    seconds = msg.query.get("seconds")
    if seconds is None:
        return 200, profiling.render_device(), "text/plain"
    try:
        seconds_f = float(seconds)
    except ValueError:
        return 400, f"bad seconds {seconds!r}", "text/plain"
    try:
        result = profiling.device_capture(seconds_f)
    except profiling.CaptureError as e:
        # failed capture → error page; serving continues and the
        # finally-disarmed trace session never leaks (regression-tested)
        return 500, f"device capture failed: {e}", "text/plain"
    return 200, profiling.render_capture(result), "text/plain"


def runtime_page(server, msg):
    """Runtime occupancy (observability/profiling.py): worker/blocked/
    parked counts, steal and park totals, per-worker run-queue depth
    and the task queue-wait aggregate — the M:N scheduler's utilization
    evidence."""
    from incubator_brpc_tpu_torch.observability import profiling

    return 200, profiling.render_runtime(), "text/plain"


# ---------------------------------------------------------------------------
# pprof protocol endpoints (reference builtin/pprof_service.h:38-58):
# machine-readable profiles an external `pprof` / `go tool pprof` can
# fetch.  Python allocation sites have no machine addresses, so each
# distinct file:line:function gets a stable SYNTHETIC address which
# /pprof/symbol resolves back — the exact contract pprof's two-step
# fetch+symbolize protocol defines.
# ---------------------------------------------------------------------------

_pprof_sym_lock = threading.Lock()
_pprof_sym_by_name: dict = {}
_pprof_name_by_addr: dict = {}
_PPROF_ADDR_BASE = 0x10000000000  # clear of real mappings


def _pprof_addr_of(name: str) -> int:
    with _pprof_sym_lock:
        addr = _pprof_sym_by_name.get(name)
        if addr is None:
            addr = _PPROF_ADDR_BASE + 16 * (len(_pprof_sym_by_name) + 1)
            _pprof_sym_by_name[name] = addr
            _pprof_name_by_addr[addr] = name
        return addr


def _pprof_heap_text(stats) -> str:
    """Legacy gperftools heap-profile text format over tracemalloc
    traceback statistics (what `pprof http://host/pprof/heap` parses)."""
    total_objs = sum(s.count for s in stats)
    total_bytes = sum(s.size for s in stats)
    lines = [
        f"heap profile: {total_objs}: {total_bytes} "
        f"[{total_objs}: {total_bytes}] @ heap_v2/1"
    ]
    for s in stats:
        addrs = []
        for frame in s.traceback:
            sym = f"{frame.filename.rsplit('/', 1)[-1]}:{frame.lineno}"
            addrs.append(f"{_pprof_addr_of(sym):#x}")
        if not addrs:
            addrs.append(f"{_pprof_addr_of('unknown'):#x}")
        lines.append(
            f"{s.count}: {s.size} [{s.count}: {s.size}] @ "
            + " ".join(addrs)
        )
    lines.append("")
    lines.append("MAPPED_LIBRARIES:")
    return "\n".join(lines)


def pprof_heap(server, msg):
    import tracemalloc

    if not tracemalloc.is_tracing():
        tracemalloc.start(12)
        return (
            200,
            "tracemalloc started; re-fetch for the profile",
            "text/plain",
        )
    snap = tracemalloc.take_snapshot()
    stats = snap.statistics("traceback")[: int(msg.query.get("top", "200"))]
    return 200, _pprof_heap_text(stats), "text/plain"


_pprof_growth_baseline = [None]  # separate from /hotspots/growth's slot:
# each endpoint diffs against ITS OWN previous fetch


def pprof_growth(server, msg):
    import tracemalloc

    if not tracemalloc.is_tracing():
        tracemalloc.start(12)
        _pprof_growth_baseline[0] = tracemalloc.take_snapshot()
        return 200, "tracemalloc started; re-fetch for growth", "text/plain"
    snap = tracemalloc.take_snapshot()
    base = _pprof_growth_baseline[0]
    _pprof_growth_baseline[0] = snap
    if base is None:
        return 200, "baseline captured; re-fetch for growth", "text/plain"
    diff = snap.compare_to(base, "traceback")
    grown = [d for d in diff if d.size_diff > 0][
        : int(msg.query.get("top", "200"))
    ]

    class _Stat:  # adapt StatisticDiff to the heap-text shape
        __slots__ = ("count", "size", "traceback")

        def __init__(self, d):
            self.count = max(1, d.count_diff)
            self.size = d.size_diff
            self.traceback = d.traceback

    return 200, _pprof_heap_text([_Stat(d) for d in grown]), "text/plain"


def pprof_symbol(server, msg):
    """GET → whether symbolization is available; POST with a +-joined
    hex address list → one "0xaddr\\tname" line per address (the pprof
    symbolization handshake, pprof_service.h GetSymbol)."""
    if msg.method != "POST" or not len(msg.body):
        with _pprof_sym_lock:
            n = max(1, len(_pprof_sym_by_name))
        return 200, f"num_symbols: {n}\n", "text/plain"
    out = []
    body = msg.body.to_bytes().decode("latin1")
    for tok in body.replace("\n", "+").split("+"):
        tok = tok.strip()
        if not tok:
            continue
        try:
            addr = int(tok, 16)
        except ValueError:
            continue
        with _pprof_sym_lock:
            name = _pprof_name_by_addr.get(addr, "unknown")
        out.append(f"{tok}\t{name}")
    return 200, "\n".join(out) + "\n", "text/plain"


def pprof_cmdline(server, msg):
    """Process command line (pprof uses it to label the binary)."""
    try:
        with open("/proc/self/cmdline", "rb") as f:
            raw = f.read()
        return 200, raw.replace(b"\0", b"\n").decode(
            "utf-8", "replace"
        ), "text/plain"
    except OSError:
        import sys as _sys

        return 200, "\n".join(_sys.argv), "text/plain"


def _proto_label(f):
    from google.protobuf.descriptor import FieldDescriptor as FD

    if f.is_repeated:
        return "map" if (
            f.type == FD.TYPE_MESSAGE and f.message_type.GetOptions().map_entry
        ) else "repeated"
    return "optional" if f.has_presence else ""


def _proto_type_name(f):
    from google.protobuf.descriptor import FieldDescriptor as FD

    names = {
        FD.TYPE_DOUBLE: "double", FD.TYPE_FLOAT: "float",
        FD.TYPE_INT64: "int64", FD.TYPE_UINT64: "uint64",
        FD.TYPE_INT32: "int32", FD.TYPE_FIXED64: "fixed64",
        FD.TYPE_FIXED32: "fixed32", FD.TYPE_BOOL: "bool",
        FD.TYPE_STRING: "string", FD.TYPE_BYTES: "bytes",
        FD.TYPE_UINT32: "uint32", FD.TYPE_SFIXED32: "sfixed32",
        FD.TYPE_SFIXED64: "sfixed64", FD.TYPE_SINT32: "sint32",
        FD.TYPE_SINT64: "sint64",
    }
    if f.type == FD.TYPE_MESSAGE:
        if f.message_type.GetOptions().map_entry:
            kf = f.message_type.fields_by_name["key"]
            vf = f.message_type.fields_by_name["value"]
            return f"<{_proto_type_name(kf)}, {_proto_type_name(vf)}>"
        return f.message_type.full_name
    if f.type == FD.TYPE_ENUM:
        return f.enum_type.full_name
    return names.get(f.type, f"type{f.type}")


def _describe_descriptor(d) -> str:
    """Render one message descriptor as proto-style text (the reference
    /protobufs shows DebugString of the descriptor,
    builtin/protobufs_service.cpp)."""
    lines = [f"message {d.full_name} {{"]
    for f in d.fields:
        label = _proto_label(f)
        ty = _proto_type_name(f)
        decl = (
            f"  map{ty} {f.name} = {f.number};"
            if label == "map"
            else f"  {label + ' ' if label else ''}{ty} {f.name} = {f.number};"
        )
        lines.append(decl)
    for e in d.enum_types:
        lines.append(f"  enum {e.name} {{")
        for v in e.values:
            lines.append(f"    {v.name} = {v.number};")
        lines.append("  }")
    lines.append("}")
    return "\n".join(lines)


def protobufs_page(server, msg):
    """Message schemas of every registered method (reference
    /protobufs, builtin/protobufs_service.cpp: lists message types,
    ?name shows one DebugString).  Nested field message/enum types are
    indexed transitively, so every full name the schema output mentions
    resolves."""
    from google.protobuf.descriptor import FieldDescriptor as FD

    descriptors = {}
    enums = {}

    def visit(d):
        if d.full_name in descriptors:
            return
        descriptors[d.full_name] = d
        for f in d.fields:
            if f.type == FD.TYPE_MESSAGE:
                if f.message_type.GetOptions().map_entry:
                    # the synthetic entry type stays hidden, but its
                    # VALUE type is printed in schemas — index it
                    vf = f.message_type.fields_by_name["value"]
                    if vf.type == FD.TYPE_MESSAGE:
                        visit(vf.message_type)
                    elif vf.type == FD.TYPE_ENUM:
                        enums[vf.enum_type.full_name] = vf.enum_type
                else:
                    visit(f.message_type)
            elif f.type == FD.TYPE_ENUM:
                enums[f.enum_type.full_name] = f.enum_type

    for full, spec in sorted(server.methods().items()):
        for cls in (spec.request_class, spec.response_class):
            if cls is not None and hasattr(cls, "DESCRIPTOR"):
                visit(cls.DESCRIPTOR)
    want = msg.query.get("name", msg.query.get("msg"))
    if want:
        d = descriptors.get(want)
        if d is not None:
            return 200, _describe_descriptor(d), "text/plain"
        e = enums.get(want)
        if e is not None:
            lines = [f"enum {e.full_name} {{"]
            lines += [f"  {v.name} = {v.number};" for v in e.values]
            lines.append("}")
            return 200, "\n".join(lines), "text/plain"
        return 404, f"unknown message {want!r}", "text/plain"
    out = ["registered protobuf messages (?name=Full.Name for schema):", ""]
    out += list(descriptors)
    out += list(enums)
    return 200, "\n".join(out), "text/plain"


def dir_page(server, msg):
    """Filesystem browser (reference /dir, builtin/dir_service.cpp).
    Gated behind the ``enable_dir_service`` flag exactly like the
    reference's -enable_dir_service (default OFF): arbitrary
    filesystem reads must be an explicit operator decision, toggleable
    at runtime via /flags?setvalue."""
    import os
    import stat as _stat

    from incubator_brpc_tpu_torch.utils.flags import get_flag

    if not get_flag("enable_dir_service", False):
        return (
            403,
            "/dir is disabled; enable with the enable_dir_service flag "
            "(reference -enable_dir_service, likewise default off)",
            "text/plain",
        )
    path = msg.query.get("path", ".") or "/"
    try:
        st = os.stat(path)
        if _stat.S_ISDIR(st.st_mode):
            rows = []
            for name in sorted(os.listdir(path)):
                full = os.path.join(path, name)
                try:
                    s = os.stat(full)
                    kind = "d" if _stat.S_ISDIR(s.st_mode) else "-"
                    rows.append(f"{kind} {s.st_size:>12} {name}")
                except OSError:
                    rows.append(f"? {'?':>12} {name}")
            return (
                200,
                f"--- {os.path.abspath(path)} ---\n" + "\n".join(rows),
                "text/plain",
            )
        size = st.st_size
        if size > (8 << 20):
            return 403, f"{path}: {size} bytes (over the 8MB cap)", "text/plain"
        with open(path, "rb") as f:
            body = f.read()
        return 200, body, "application/octet-stream"
    except OSError as e:
        return 404, f"{path}: {e}", "text/plain"


def chaos_page(server, msg):
    """Fault-injection control + visibility (chaos/injector.py).

    GET             → JSON: armed flag, active plan, per-site hit
                      counts (native engine sites harvested into
                      chaos_injected_total as a side effect — the
                      /metrics family and this page agree)
    GET ?disarm=1   → disarm the active plan
    POST <plan json>→ arm the posted FaultPlan (replaces any armed one)
    """
    from incubator_brpc_tpu_torch.chaos import injector
    from incubator_brpc_tpu_torch.chaos.plan import FaultPlan

    if msg.method == "POST":
        # POST wins over a stray ?disarm= in the URL: silently
        # discarding a posted plan would leave the caller believing
        # chaos is armed while nothing injects
        body = msg.body.to_bytes() if len(msg.body) else b""
        if not body:
            return 400, "POST expects a FaultPlan JSON body", "text/plain"
        try:
            plan = FaultPlan.from_json(body.decode("utf-8"))
            injector.arm(plan)
        except Exception as e:  # noqa: BLE001
            return 400, f"bad fault plan: {e}", "text/plain"
        return (
            200,
            json.dumps({"armed": True, "plan": plan.to_dict()}),
            "application/json",
        )
    if msg.query.get("disarm") not in (None, "", "0", "false"):
        injector.disarm()
        return 200, json.dumps({"armed": False}), "application/json"
    return 200, json.dumps(injector.describe(), indent=1), "application/json"


def batching_page(server, msg):
    """Micro-batching control + visibility (batching/, docs/batching.md).

    GET  → JSON per batched method: policy, live occupancy / queue
           depth, batches/rows/shed counters, service-time EMA.
    POST → tune one method's max_wait_us at runtime:
           /batching?method=Svc.Method&max_wait_us=N (or the same keys
           as a JSON body).  The latency/throughput dial, reloadable
           like /flags.
    """
    batchers = server._batchers
    if msg.method == "POST":
        params = {k: v for k, v in msg.query.items()}
        body = msg.body.to_bytes() if len(msg.body) else b""
        if body:
            try:
                parsed = json.loads(body.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                parsed = None
            if not isinstance(parsed, dict):
                return 400, "POST body must be a JSON object", "text/plain"
            params.update(parsed)
        name = params.get("method")
        if not name:
            return 400, "missing method=Svc.Method", "text/plain"
        batcher = batchers.get(name)
        if batcher is None:
            return (
                404,
                f"no live batcher for {name!r} (batched methods: "
                f"{sorted(batchers)})",
                "text/plain",
            )
        wait = params.get("max_wait_us")
        if wait is None:
            return 400, "missing max_wait_us=N", "text/plain"
        try:
            wait = int(wait)
            if wait < 0:
                raise ValueError
        except (TypeError, ValueError):
            return 400, f"bad max_wait_us {wait!r}", "text/plain"
        batcher.set_max_wait_us(wait)
        return (
            200,
            json.dumps({"method": name, "max_wait_us": wait}),
            "application/json",
        )
    out = {
        "enabled": bool(batchers),
        "methods": {
            name: batcher.describe()
            for name, batcher in sorted(batchers.items())
        },
    }
    return 200, json.dumps(out, indent=1), "application/json"


def admission_page(server, msg):
    """Multi-tenant admission control + visibility (server/admission.py,
    docs/overload.md).

    GET  → JSON: tiers (priority/weight/share/quota/inflight/queue
           depth), tenant mappings + quotas + inflight, per-method
           tier overrides, cumulative shed counts, the code mapping.
    POST → live-tune, JSON body (or query params):
             {"tier": "bulk", "weight": 4, "quota": 0}
             {"tenant": "batch-ingest", "set_tier": "bulk", "quota": 8}
             {"method": "PsService.Put", "set_tier": "bulk"}
           Weights re-derive every tier's capacity share immediately —
           the shed dial, reloadable like /flags and /batching.
    """
    adm = server.admission
    if msg.method == "POST":
        params = {k: v for k, v in msg.query.items()}
        body = msg.body.to_bytes() if len(msg.body) else b""
        if body:
            try:
                parsed = json.loads(body.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                parsed = None
            if not isinstance(parsed, dict):
                return 400, "POST body must be a JSON object", "text/plain"
            params.update(parsed)
        try:
            if "tier" in params:
                adm.policy.set_tier(
                    str(params["tier"]),
                    weight=(
                        float(params["weight"])
                        if "weight" in params else None
                    ),
                    quota=(
                        int(params["quota"]) if "quota" in params else None
                    ),
                    priority=(
                        int(params["priority"])
                        if "priority" in params else None
                    ),
                )
            elif "tenant" in params:
                adm.policy.set_tenant(
                    str(params["tenant"]),
                    tier=params.get("set_tier"),
                    quota=(
                        int(params["quota"]) if "quota" in params else None
                    ),
                )
            elif "method" in params:
                if "set_tier" not in params:
                    return 400, "method tuning needs set_tier=", "text/plain"
                adm.policy.set_method_tier(
                    str(params["method"]), str(params["set_tier"])
                )
            else:
                return (
                    400,
                    "POST tunes one of tier= / tenant= / method= "
                    "(see docs/overload.md)",
                    "text/plain",
                )
        except (TypeError, ValueError) as e:
            return 400, f"bad admission tuning: {e}", "text/plain"
        return 200, json.dumps(adm.describe(), indent=1), "application/json"
    return 200, json.dumps(adm.describe(), indent=1), "application/json"


def cache_page(server, msg):
    """HBM cache tier visibility (cache/store.py, docs/cache.md):
    store occupancy vs budget, hit/miss/eviction counters, and which
    protocol fronts (redis/memcache) share it.  Finds the store behind
    whichever service option carries one."""
    stores = {}
    opts = server.options
    for front in ("redis_service", "memcache_service"):
        svc = getattr(opts, front, None)
        store = getattr(svc, "store", None)
        if store is not None and hasattr(store, "stats"):
            stores.setdefault(id(store), {"store": store, "fronts": []})[
                "fronts"
            ].append(front.replace("_service", ""))
    if not stores:
        return (
            200,
            json.dumps({"enabled": False, "reason": "no cache-tier service"}),
            "application/json",
        )
    out = []
    for ent in stores.values():
        d = ent["store"].stats()
        d["fronts"] = ent["fronts"]
        out.append(d)
    return 200, json.dumps({"enabled": True, "stores": out}, indent=1), "application/json"


def resharding_page(server, msg):
    """Live scheme-migration visibility (resharding/migration.py,
    docs/resharding.md): every registered migration's per-replica
    state — phase, routing epoch, scheme pair, and the step-log
    counters (keys moved/copied/drained, checksum failures, survivor
    completions, rollbacks) the zero-downtime proof reads.
    ``?name=<migration>`` filters to one migration."""
    from incubator_brpc_tpu_torch.resharding.migration import states_snapshot

    states = states_snapshot()
    name = msg.query.get("name")
    if name is not None:
        st = states.get(name)
        if st is None:
            return (
                404,
                json.dumps({"error": f"no migration named {name!r}"}),
                "application/json",
            )
        return 200, json.dumps(st, indent=1), "application/json"
    return (
        200,
        json.dumps({"migrations": states}, indent=1),
        "application/json",
    )


def serving_page(server, msg):
    """Disaggregated-serving visibility (serving/, docs/serving.md):
    every registered session's state machine position, ownership
    epoch, KV residency (kv_epoch/n_layers/kv_bytes), token progress,
    the per-session migration log (the exactly-once audit trail) and
    the ``rpc_serving_*`` counters.  ``?session=<id>`` filters to one
    session."""
    import sys

    sess_mod = sys.modules.get("incubator_brpc_tpu_torch.serving.session")
    sessions = sess_mod.sessions_snapshot() if sess_mod is not None else {}
    sid = msg.query.get("session")
    if sid is not None:
        d = sessions.get(sid)
        if d is None:
            return (
                404,
                json.dumps({"error": f"no session named {sid!r}"}),
                "application/json",
            )
        return 200, json.dumps(d, indent=1), "application/json"
    metrics_mod = sys.modules.get("incubator_brpc_tpu_torch.serving.metrics")
    return (
        200,
        json.dumps(
            {
                "enabled": bool(sessions),
                "sessions": sessions,
                "counters": (
                    metrics_mod.snapshot() if metrics_mod is not None else {}
                ),
            },
            indent=1,
        ),
        "application/json",
    )


def replication_page(server, msg):
    """Replicated HA tier visibility (replication/, docs/replication.md):
    every registered replica group's leader, lease epoch, remaining
    lease time, per-replica health (alive/repairing/applied_seq/
    epoch_floor) and the step-log counters (quorum writes/failures,
    fenced writes, leader changes, repair keys, hedged reads) the
    zero-acked-write-loss proof reads.  ``?name=<group>`` filters to
    one group."""
    from incubator_brpc_tpu_torch.replication.group import groups_snapshot

    groups = groups_snapshot()
    name = msg.query.get("name")
    if name is not None:
        g = groups.get(name)
        if g is None:
            return (
                404,
                json.dumps({"error": f"no replica group named {name!r}"}),
                "application/json",
            )
        return 200, json.dumps(g, indent=1), "application/json"
    return (
        200,
        json.dumps({"groups": groups}, indent=1),
        "application/json",
    )


def vlog_page(server, msg):
    import logging as _pylog

    from incubator_brpc_tpu_torch.utils.logging import set_min_log_level

    level = msg.query.get("v")
    if level is not None:
        set_min_log_level(_pylog.DEBUG if level not in ("0", "off") else _pylog.WARNING)
        return 200, f"verbose={level}", "text/plain"
    return 200, "toggle with /vlog?v=1 or /vlog?v=0", "text/plain"
