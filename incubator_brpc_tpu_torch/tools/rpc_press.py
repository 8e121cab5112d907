"""rpc_press — protocol-generic load generator.

Analog of reference tools/rpc_press (rpc_press.cpp:98): drives a
service from a JSON request at a target qps with live qps/latency
reporting from the channel's LatencyRecorder (the reference's
InfoThread).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import threading
import time


def resolve_message(spec: str):
    """"module:ClassName" → message class."""
    mod, _, cls = spec.partition(":")
    return getattr(importlib.import_module(mod), cls)


def load_chaos_plan(spec: str):
    """``--chaos-plan`` value → FaultPlan.  Accepts inline JSON or
    ``@path/to/plan.json`` (see docs/chaos.md for the schema)."""
    from incubator_brpc_tpu_torch.chaos.plan import FaultPlan

    if spec.startswith("@"):
        with open(spec[1:], "r", encoding="utf-8") as f:
            spec = f.read()
    return FaultPlan.from_json(spec)


def _arm_chaos(chaos_plan: str, report):
    """Load + arm a ``--chaos-plan`` value.  Returns the armed plan,
    or None after reporting the error (callers bail out)."""
    from incubator_brpc_tpu_torch.chaos import injector as chaos_injector

    try:
        plan = load_chaos_plan(chaos_plan)
        chaos_injector.arm(plan)
    except (OSError, TypeError, ValueError, KeyError, RuntimeError) as e:
        report(f"bad chaos plan: {e}")
        return None
    report(f"chaos plan armed: sites={plan.sites()} seed={plan.seed}")
    return plan


def _finish_chaos():
    """Collect the armed plan's per-site hits and disarm."""
    from incubator_brpc_tpu_torch.chaos import injector as chaos_injector

    hits = chaos_injector.site_hits()
    chaos_injector.disarm()
    return hits


def press(
    server: str,
    service: str,
    method: str,
    request_json: str = "{}",
    qps: int = 100,
    duration_s: float = 5.0,
    threads: int = 4,
    request_cls=None,
    response_cls=None,
    lb: str = None,
    report=print,
    chaos_plan: str = None,
):
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.serialization.json2pb import json_to_proto
    from incubator_brpc_tpu_torch.server.service import MethodSpec

    if request_cls is None or response_cls is None:
        from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest, EchoResponse

        request_cls = request_cls or EchoRequest
        response_cls = response_cls or EchoResponse
    spec = MethodSpec(service, method, request_cls, response_cls)
    ch = Channel(ChannelOptions(timeout_ms=5000))
    rc = ch.init(server, lb)
    if rc != 0:
        report(f"channel init failed: {rc}")
        return None
    request = request_cls()
    ok, err = json_to_proto(request_json, request)
    if not ok:
        report(f"bad request json: {err}")
        return None

    plan = None
    if chaos_plan:
        plan = _arm_chaos(chaos_plan, report)
        if plan is None:
            return None

    stop = time.monotonic() + duration_s
    sent = [0]
    errors_n = [0]
    lock = threading.Lock()
    interval = threads / max(qps, 1)

    def worker():
        nxt = time.monotonic()
        while time.monotonic() < stop:
            nxt += interval
            c = Controller()
            resp = response_cls()
            ch.call_method(spec, c, request, resp, None)
            with lock:
                sent[0] += 1
                if c.failed():
                    errors_n[0] += 1
            delay = nxt - time.monotonic()
            if delay > 0:
                time.sleep(delay)

    ts = [threading.Thread(target=worker, daemon=True) for _ in range(threads)]
    t0 = time.monotonic()
    try:
        for t in ts:
            t.start()

        # live report (InfoThread analog)
        while time.monotonic() < stop:
            left = stop - time.monotonic()
            # `left` may have gone <= 0 since the loop check (more
            # likely under an armed chaos plan): sleep() would raise
            time.sleep(min(1.0, left) if left > 0 else 0.05)
            rec = ch.latency_recorder()
            report(
                f"sent={sent[0]} errors={errors_n[0]} qps={rec.qps():.0f} "
                f"avg={rec.latency():.0f}us p99={rec.latency_percentile(0.99):.0f}us"
            )
        for t in ts:
            t.join(5)
    finally:
        chaos_hits = _finish_chaos() if plan is not None else None
    wall = time.monotonic() - t0
    rec = ch.latency_recorder()
    result = {
        "sent": sent[0],
        "errors": errors_n[0],
        "wall_s": round(wall, 2),
        "achieved_qps": round(sent[0] / wall, 1),
        "avg_us": round(rec.latency()),
        "p99_us": round(rec.latency_percentile(0.99)),
    }
    if chaos_hits is not None:
        result["chaos_hits"] = chaos_hits
    report(json.dumps(result))
    return result


def press_native(
    server: str,
    service: str = "EchoService",
    method: str = "Echo",
    payload_len: int = 4096,
    concurrency: int = 8,
    duration_s: float = 5.0,
    depth: int = 1,
    conns: int = 1,
    report=print,
    chaos_plan: str = None,
):
    """Max-throughput mode on the C++ engine (nc_bench_echo): both ends
    native, zero Python per RPC — the reference's rpc_press is likewise
    a native tool. No qps pacing: measures capacity.

    ``chaos_plan`` arms a FaultPlan in THIS process for the run: its
    ``native.*`` sites hit a co-located engine server; a remote server
    is armed via its ``/chaos`` builtin instead."""
    from incubator_brpc_tpu_torch import native

    if not native.available():
        report(f"native engine unavailable: {native.unavailable_reason()}")
        return None
    plan = None
    if chaos_plan:
        plan = _arm_chaos(chaos_plan, report)
        if plan is None:
            return None
    host, _, port = server.partition(":")
    try:
        result = native.bench_echo(
            host, int(port), payload_len, concurrency,
            int(duration_s * 1000), depth, conns, service, method,
        )
    finally:
        chaos_hits = _finish_chaos() if plan is not None else None
    if chaos_hits is not None:
        result["chaos_hits"] = chaos_hits
    report(json.dumps(result))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description="rpc_press load generator")
    ap.add_argument("--server", required=True, help="ip:port | ici://... | naming url")
    ap.add_argument("--service", default="EchoService")
    ap.add_argument("--method", default="Echo")
    ap.add_argument("--request", default='{"message": "press"}', help="request JSON")
    ap.add_argument("--qps", type=int, default=100)
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--lb", default=None)
    ap.add_argument("--proto", default=None, help="module:RequestClass,module:ResponseClass")
    ap.add_argument(
        "--native", action="store_true",
        help="max-throughput mode on the C++ engine (no qps pacing)",
    )
    ap.add_argument("--payload", type=int, default=4096,
                    help="--native mode: echo message size in bytes")
    ap.add_argument("--depth", type=int, default=1,
                    help="--native mode: pipelined in-flight RPCs per worker")
    ap.add_argument(
        "--chaos-plan", default=None, metavar="JSON|@FILE",
        help="run the load under a chaos FaultPlan (inline JSON or "
        "@file; armed for the run, disarmed after — docs/chaos.md)",
    )
    args = ap.parse_args(argv)
    if args.native:
        press_native(
            args.server, args.service, args.method, args.payload,
            args.threads, args.duration, args.depth,
            chaos_plan=args.chaos_plan,
        )
        return
    req_cls = res_cls = None
    if args.proto:
        a, _, b = args.proto.partition(",")
        req_cls, res_cls = resolve_message(a), resolve_message(b)
    press(
        args.server, args.service, args.method, args.request,
        args.qps, args.duration, args.threads, req_cls, res_cls, args.lb,
        chaos_plan=args.chaos_plan,
    )


if __name__ == "__main__":
    main()
