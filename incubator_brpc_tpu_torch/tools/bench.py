#!/usr/bin/env python
"""Benchmark program of the PyTorch/CUDA port — prints ONE JSON line.

    python -m incubator_brpc_tpu_torch.tools.bench

The port's counterpart of the JAX package's ``bench.py`` (at the
repository root): every ``bench_*`` function there has one here with
the same name, the same parameters and defaults and the same returned
keys, so a figure of one means what the same key of the other means.
Measures the BASELINE.json configs that map to this round's stack:
  1. 4KB echo latency p50/p99 + multi-threaded qps over loopback TCP
     (reference example/echo_c++ / multi_threaded_echo_c++), on the
     port's native engine.
  2. The ICI data plane on a 64MB tensor payload (reference
     example/rdma_performance 64MB transfer):
       - HEADLINE: a fully measured end-to-end 64MB echo with zero_copy
         OFF — both hops run the copy+checksum transmit kernel inside
         the timed, data-dependence-chained region (see bench_ici_rpc;
         the JAX bench's definition, unchanged);
       - transmit-op bandwidth (extras, diagnostic): the copy+checksum
         kernel alone, same marginal-cost method.

Headline vs the reference's best single-machine throughput of 2.3 GB/s
(upstream bRPC's docs/cn/benchmark.md:104, BASELINE.md:16): a figure of
that project's own hardware, not of any accelerator.

Keys that name a TPU mechanism keep their names, and measure the
port's hand-written CUDA kernels (incubator_brpc_tpu_torch/ops/csrc/
transfer.cu):
  - ``pallas_transmit_64mb_gbps`` / ``_us``: K1 (``copy_csum_blocks``,
    the port of the JAX package's whole-frame Pallas copy+checksum) on
    a 64 MB float32 (8192, 2048) frame;
  - ``ici_pipeline_curve``: ``off`` and ``fused`` run one K1 launch a
    hop, ``pipelined`` one K1 a chunk with the lane accumulator carried
    into StagingRing slots, and ``pallas`` one K2 launch a frame
    (``copy_csum_staged``, the port of the DMA kernel); a ``pallas``
    row's ``pallas_dispatches`` / ``pallas_fallbacks`` read the fabric's
    ``ici_pallas_frames`` / ``ici_pallas_fallbacks`` counters
    (``rpc_ici_pallas_*`` on /metrics): frames that took one K2 launch,
    and frames of that mode that could not.

Device: every function that touches a device takes ``device=None``,
which means the card (``parallel/mesh.py``'s ``device_for_chip``: chip
``j`` on ``cuda:(j % count)``); without a card such a function raises.
Pass ``torch.device("cpu")`` to run it on the kernels' plain versions
(the CPU tests do).  Nothing falls back: an error raises and ``main()``
exits non-zero, where the JAX bench turns eleven benches' exceptions
into ``-1`` or an ``*_error`` key to keep printing its line.  Where the
JAX bench writes ``-1`` for a figure with nothing to measure (no sample
— the no-tail control's slow requests —, no positive marginal time),
this one writes ``null``, so no figure of the line is negative but the
overhead percentages, which are signed (the ON segments may run
faster than the OFF ones).  ``bench_sharded_ps``
runs on the port's single-controller mesh (virtual chips on one card,
chip ``j`` on ``cuda:(j % count)``), never in a child on virtual CPU
devices: the JAX bench's ``--sharded-ps-child`` re-execution has no
counterpart.  The native engine builds at first use; without it the
benches that need it raise ``NativeEngineError`` (no Python transport
stands in).

Completion: the JAX bench chains its transmits inside one jitted
program and forces them with a scalar fetch.  Here each transmit is a
kernel launch issued from Python on the previous output.  The transmit
op (``pallas_transmit_64mb_us``) reads the card's time all the same: on
the card its chains are queued behind a sleep kernel and timed by CUDA
events between the sleep's end and the chain's end
(``tools/_device_time.py``), so the host's issue time per transmit,
which can exceed K1's (PERF.md §6), stays out of the figure, as it stays
out of the JAX bench's one program; on the CPU a chain is timed on the
host clock up to the fold's fetch.  Every other chain (the chunk sweep,
the headline echo, the DCN echo) is issued from Python in both benches,
and the same scalar fetch (a ``float()`` of elements of the last output)
forces it, so a timed region ends only when the card has finished it and
includes the host's issue time.  ``chip_smoke.py``'s ``[bench]`` phase
prints the transmit op's figure beside the host's issue time per
transmit and K1's own frame time.  ``main()``'s line adds one key to the JAX bench's: ``card``,
the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` prints them.
"""

import json
import threading
import time

import torch

from incubator_brpc_tpu_torch.parallel.mesh import device_for_chip


def bench_tcp_echo(payload=4096, calls=4000, threads=8):
    """4KB echo over loopback TCP, like the reference's benchmark setup
    (docs/cn/benchmark.md: C++ client + C++ server, one machine):

    - headline echo numbers come from the NATIVE press (tools/rpc_press
      native engine, engine.cpp nc_bench_echo) against the native-engine
      server — both sides of the wire are this framework's C++ engine,
      zero Python in the loop, matching the reference's methodology.
    - echo_size_curve mirrors the reference's qps-vs-request-size plot
      (docs/images/qps_vs_reqsize.png); the 128B point is the one to
      hold against the baseline's small-payload 1M-5M qps range.
    - echo_4kb_pyapi_* measures the same RPC through the Python user
      API (stub → Channel connection_type=native → C mux reactor), as
      a config curve over sync thread counts and async pipeline depths.
      Sync points come in two flavors:
        * sync_bytes — the pooled zero-Python-per-call fast path
          (docs/fastpath.md): request packed to bytes ONCE, pooled
          Controller (acquire/release), RAW_RESPONSE (reply bytes on
          controller.response_bytes, no per-call pb parse).  This is
          the leanest supported user API, not a bench-only backdoor.
        * sync_pb — per-call pb response parse with a pooled response
          object (reported as echo_4kb_pyapi_sync_pb_qps).
      The sync headline (echo_4kb_pyapi_sync_qps) is the best sync
      point whose p50 stays ≤ 100us — an SLO-constrained best, so a
      high-thread-count config can't buy qps with queueing latency.

    Needs the native engine (built at first use): without it this
    raises NativeEngineError, where the JAX bench measures the Python
    transport instead.
    """
    from incubator_brpc_tpu_torch import native
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    native.require()
    srv = Server(ServerOptions(native_engine=True))
    srv.add_service(EchoService(attach_echo=False))
    assert srv.start(0) == 0
    out = {}
    # qps-vs-configuration curve: (client threads, pipeline depth,
    # connections per client).  depth=1 is the classic sync
    # thread-per-request shape; depth>1 is the async/mux shape that
    # amortizes per-RPC syscalls (reference clients pipeline the
    # same way on pooled/single connections).  All points are
    # native-engine measurements — see echo_4kb_pyapi_* below for
    # what a Python caller observes.
    curve = []
    for conc, depth, conns in [
        (threads, 1, 1), (1, 16, 1), (1, 32, 1), (1, 64, 2),
    ]:
        r = native.bench_echo(
            "127.0.0.1", srv.port, payload, concurrency=conc,
            duration_ms=1500, depth=depth, conns=conns,
        )
        curve.append(
            {
                "threads": conc, "depth": depth, "conns": conns,
                "qps": r["qps"], "p50_us": r["p50_us"],
                "p99_us": r["p99_us"], "failed": r["failed"],
            }
        )
    # failing configs never become the headline, whatever their qps
    best = max(curve, key=lambda p: (p["failed"] == 0, p["qps"]))
    # headline = a fresh 3s run at the best curve point
    r = native.bench_echo(
        "127.0.0.1", srv.port, payload, concurrency=best["threads"],
        duration_ms=3000, depth=best["depth"], conns=best["conns"],
    )
    out.update(
        {
            "echo_4kb_qps": r["qps"],
            "echo_4kb_p50_us": r["p50_us"],
            "echo_4kb_p99_us": r["p99_us"],
            "echo_4kb_ok": r["ok"],
            "echo_4kb_failed": r["failed"],
            "echo_4kb_config": {
                "threads": best["threads"], "depth": best["depth"],
                "conns": best["conns"],
            },
            "echo_4kb_curve": curve,
        }
    )
    # qps/GB/s vs payload size, best config per size (the
    # reference's benchmark.md charts this axis; its peak is
    # 2.3 GB/s on large payloads — writev scatter-gather on both
    # sides keeps big echoed bodies zero-copy in user space, so
    # GB/s RISES with size to a peak then saturates; past the host
    # cache's capacity the kernel-crossing copies per byte fall out
    # of it and the curve declines toward the loopback-TCP copy
    # floor).  The 64KB point guards the engine's large-read path
    # (ByteBuf tail reads, buffer steal, mallopt) against a crater.
    size_curve = []
    for psize in (128, 1024, 4096, 16384, 65536, 262144, 1048576):
        per_size_best = None
        cfgs = (
            [(2, 1, 1), (threads, 1, 1), (1, 16, 1), (16, 1, 1)]
            if psize >= 16384
            else [(best["threads"], best["depth"], best["conns"])]
        )
        for conc, depth, conns in cfgs:
            rs = native.bench_echo(
                "127.0.0.1", srv.port, psize, concurrency=conc,
                duration_ms=1200, depth=depth, conns=conns,
            )
            gbps = rs["qps"] * psize / 1e9
            if rs["failed"] == 0 and (
                per_size_best is None or gbps > per_size_best["gbps"]
            ):
                per_size_best = {
                    "payload": psize, "qps": rs["qps"],
                    "gbps": round(gbps, 2), "p50_us": rs["p50_us"],
                    "failed": rs["failed"],
                    "config": {
                        "threads": conc, "depth": depth, "conns": conns,
                    },
                }
        if per_size_best is not None:
            size_curve.append(per_size_best)
    out["echo_size_curve"] = size_curve
    out["echo_peak_gbps"] = max(
        (p["gbps"] for p in size_curve), default=0.0
    )
    # same-machine UDS variant (the reference supports UDS endpoints
    # first-class; loopback TCP stays the headline for parity)
    import os as _os
    import tempfile as _tmp

    uds_path = _os.path.join(_tmp.gettempdir(), f"tpubrpc_bench_{_os.getpid()}.sock")
    uds_srv = Server(ServerOptions(native_engine=True))
    uds_srv.add_service(EchoService(attach_echo=False))
    from incubator_brpc_tpu_torch.utils.endpoint import EndPoint as _EP

    assert uds_srv.start(_EP.uds(uds_path)) == 0, "UDS echo server did not start"
    try:
        ru = native.bench_echo(
            uds_path, 0, payload, concurrency=best["threads"],
            duration_ms=2000, depth=best["depth"], conns=best["conns"],
        )
    finally:
        uds_srv.stop()
        try:
            _os.unlink(uds_path)
        except OSError:
            pass
    out["echo_4kb_uds_qps"] = ru["qps"]
    out["echo_4kb_uds_p50_us"] = ru["p50_us"]

    ch = Channel(ChannelOptions(timeout_ms=10000, connection_type="native"))
    ch.init(f"127.0.0.1:{srv.port}")
    stub = echo_stub(ch)
    msg = "x" * payload
    # the pooled fast-path ingredients (docs/fastpath.md): request
    # packed ONCE, controllers from the freelist, replies as raw bytes
    from incubator_brpc_tpu_torch.client.controller import (
        acquire_controller,
        release_controller,
    )
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoResponse
    from incubator_brpc_tpu_torch.server.service import RAW_RESPONSE

    packed_req = EchoRequest(message=msg).SerializeToString()

    # warmup
    c = Controller()
    stub.Echo(c, EchoRequest(message=msg))

    def pyapi_sync(nthreads: int, total: int, parse_pb: bool = False):
        """Sync stubs from N threads over the pooled fast path: each
        call parks in C on the mux reactor with the GIL released
        (nc_mux_call).  parse_pb=True keeps a per-call pb response
        parse (into a pooled response object); the default bytes mode
        delivers the reply on controller.response_bytes."""
        lat = []
        lat_lock = threading.Lock()
        per_thread = total // nthreads

        def worker():
            local = []
            resp = EchoResponse() if parse_pb else RAW_RESPONSE
            call = stub.Echo  # bind once, call per RPC
            for _ in range(per_thread):
                c = acquire_controller()
                call(c, packed_req, response=resp)
                if not c.error_code:
                    local.append(c.latency_us)
                release_controller(c)
            with lat_lock:
                lat.extend(local)

        t0 = time.monotonic()
        ts = [threading.Thread(target=worker) for _ in range(nthreads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        wall = time.monotonic() - t0
        lat.sort()
        return lat, wall

    def pyapi_async(depth: int, total: int):
        """Self-clocking async pipeline through the public done-callback
        API: each completion submits the next request from the harvester
        thread (the reference's async CallMethod usage pattern)."""
        lat = []
        append = lat.append
        fin = threading.Event()
        # guarded counters: during the priming loop the main thread and
        # the harvester thread both run submit_one concurrently, and an
        # unlocked read-modify-write could over-submit past `total`
        # (stray completions would then race the final lat.sort())
        state_lock = threading.Lock()
        state = {"submitted": 0, "done": 0}

        def submit_one():
            with state_lock:
                if state["submitted"] >= total:
                    return
                state["submitted"] += 1
            c = acquire_controller()

            def d(c=c):
                if not c.error_code:
                    append(c.latency_us)
                # done is the last touch: safe to pool the controller
                release_controller(c)
                with state_lock:
                    state["done"] += 1
                    finished = state["done"] >= total
                if finished:
                    fin.set()
                else:
                    submit_one()

            stub.Echo(c, packed_req, done=d)

        t0 = time.monotonic()
        for _ in range(depth):
            submit_one()
        fin.wait(120)
        wall = time.monotonic() - t0
        lat.sort()
        return lat, wall

    # configuration curve over the public user API: classic sync
    # thread-per-request shapes (bytes + pb flavors, see docstring) and
    # async pipelined shapes.  Headline = best non-failing config, like
    # the native echo_4kb_config curve.
    def run_py(kind, par, total):
        if kind == "async":
            return pyapi_async(par, total)
        return pyapi_sync(par, total, parse_pb=(kind == "sync_pb"))

    # pinned warmup phase: the curve's first points otherwise pay
    # reactor spin-up, controller-pool fill, thread creation and
    # allocator warmup inside their measured window.  Warm both call
    # shapes first, then measure each point as the BEST of 3 windows
    # (the scheduler can steal any one window on a shared host; it can
    # rarely steal three in a row), so the curve reflects capability,
    # not boot order.  Curve windows floor at 4000 calls: a short
    # window aliases one multi-ms scheduler steal into its rate.
    pyapi_sync(8, 1500)
    pyapi_async(8, 1000)
    win_calls = max(4000, calls)
    pycurve = []
    for kind, par in [
        ("sync_bytes", 8), ("sync_bytes", 10), ("sync_bytes", 16),
        ("sync_pb", 8), ("async", 8), ("async", 12),
    ]:
        windows = []
        for _ in range(3):
            lat, wall = run_py(kind, par, win_calls)
            n = len(lat)
            windows.append(
                {
                    "mode": kind,
                    "parallelism": par,
                    "qps": round(n / wall, 1) if wall else 0.0,
                    "p50_us": lat[n // 2] if n else None,
                    "p99_us": lat[min(n - 1, n * 99 // 100)] if n else None,
                    "ok": n,
                }
            )
        best_w = max(windows, key=lambda w: (w["ok"] >= win_calls, w["qps"]))
        best_w["window_qps"] = [w["qps"] for w in windows]
        pycurve.append(best_w)
    best_py = max(pycurve, key=lambda p: (p["ok"] >= win_calls, p["qps"]))
    # fresh, longer run at the best config for the headline number
    lat, wall = run_py(best_py["mode"], best_py["parallelism"], calls * 3)
    n = len(lat)
    # sync headline: SLO-constrained best (p50 <= 100us) among sync
    # points, re-measured fresh and longer so a lucky 40ms curve sample
    # can't become the record; falls back to the best sync point when
    # nothing meets the SLO.  Identical runs swing between each other,
    # so the top TWO eligible configs each get a fresh longer run and
    # the best (p50-eligible first) wins — all runs are reported,
    # nothing is hidden.
    sync_pts = [p for p in pycurve if p["mode"].startswith("sync")]
    slo_pts = [p for p in sync_pts if p["p50_us"] is not None and p["p50_us"] <= 100]
    ranked = sorted(slo_pts or sync_pts, key=lambda p: -p["qps"])
    sync_runs = []
    for cfg in ranked[:2]:
        for _ in range(2):
            rlat, rwall = run_py(cfg["mode"], cfg["parallelism"], calls * 6)
            rn = len(rlat)
            sync_runs.append(
                {
                    "mode": cfg["mode"],
                    "parallelism": cfg["parallelism"],
                    "qps": round(rn / rwall, 1) if rwall else 0.0,
                    "p50_us": rlat[rn // 2] if rn else None,
                    "ok": rn,
                }
            )
    eligible = [r for r in sync_runs if r["p50_us"] is not None and r["p50_us"] <= 100]
    sync_best = max(eligible or sync_runs, key=lambda r: r["qps"])
    pb_pt = max(
        (p for p in pycurve if p["mode"] == "sync_pb"),
        key=lambda p: p["qps"],
    )

    # ---- submission/completion ring curve (docs/fastpath.md, ring
    # section): a window of W same-method calls crosses the Python↔C
    # boundary ONCE (mux_submit_many), completions harvest in bursts
    # (mux_harvest), so qps should rise with W while boundary
    # crossings/call fall toward 2/W.  Same measurement discipline as
    # the pycurve: every point floors at 4000 calls and takes the best
    # of 3 windows.  The step-log counters ride along per point so the
    # "vectorized" claim is STRUCTURAL (few crossings, zero fallback),
    # not just a qps number that could equally describe a lucky
    # scheduler minute.  nthreads=1 is deliberate: the ring is
    # throughput-shaped (windows hide RTT the way sync's 8 threads do),
    # so extra Python threads only add GIL contention and
    # leader/follower handoffs.
    def pyapi_ring(window: int, total: int, req_bytes: bytes,
                   nthreads: int = 1):
        spec = stub.method_spec("Echo")
        per_thread = max(window, total // nthreads)
        nwin = max(1, per_thread // window)
        agg = {"ok": 0, "calls": 0}
        csum = {}
        agg_lock = threading.Lock()

        def worker():
            # depth == window: submit_all() auto-flushes exactly at W,
            # so every crossing carries a full window
            ring = ch.submission_ring(depth=window)
            reqs = [req_bytes] * window
            ok = 0
            for _ in range(nwin):
                ring.submit_all(spec, reqs)
                for _slot, res in ring.drain():
                    if type(res) is bytes:
                        ok += 1
            with agg_lock:
                agg["ok"] += ok
                agg["calls"] += nwin * window
                for k, v in ring.counters().items():
                    csum[k] = csum.get(k, 0) + v

        t0 = time.monotonic()
        ts = [threading.Thread(target=worker) for _ in range(nthreads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        wall = time.monotonic() - t0
        return agg["ok"], agg["calls"], wall, csum

    # server-ring flavor: every curve point also snapshots the server
    # engine's reply step log (ns_ring_stats) so the point carries the
    # SERVER-side proof — replies left as one writev burst per
    # harvested window (responses_per_window ≈ the read-burst size,
    # windows ≪ responses), never per-call sends
    def srv_ring_stats():
        return dict(srv._engine_op(lambda eng: eng.ring_stats()))

    ring_payloads = [(f"{payload // 1024}kb", packed_req)]
    if payload != 65536:  # the large-payload flavor
        ring_payloads.append(
            ("64kb", EchoRequest(message="y" * 65536).SerializeToString())
        )
    pyapi_ring(32, 1500, packed_req)  # warm the ring lane
    ring_curve = []
    for ptag, req_b in ring_payloads:
        for window in (1, 8, 32, 128):
            windows3 = []
            for _ in range(3):
                sb = srv_ring_stats()
                ok, rcalls, wall, cts = pyapi_ring(window, win_calls, req_b)
                sa = srv_ring_stats()
                point = {
                    "payload": ptag,
                    "window": window,
                    "qps": round(ok / wall, 1) if wall else 0.0,
                    "ok": ok,
                    "calls": rcalls,
                    "counters": cts,
                }
                sw = {k: sa[k] - sb[k] for k in sb}
                sw["responses_per_window"] = round(
                    sw["responses"] / max(1, sw["windows"]), 2
                )
                point["server_ring"] = sw
                windows3.append(point)
            best_w = max(windows3, key=lambda w: (w["ok"], w["qps"]))
            best_w["window_qps"] = [w["qps"] for w in windows3]
            c = best_w["counters"]
            best_w["crossings_per_call"] = round(
                c["boundary_crossings"]
                / max(1, c["submissions"] + c["fallback_calls"]),
                4,
            )
            ring_curve.append(best_w)
    ring_hl = [p for p in ring_curve if p["payload"] == ring_payloads[0][0]]
    ring_clean = [p for p in ring_hl if p["ok"] >= p["calls"]]
    ring_best = max(ring_clean or ring_hl, key=lambda p: p["qps"])
    srv.stop()
    ch.close()
    out.update(
        {
            "echo_4kb_pyapi_p50_us": lat[n // 2] if n else None,
            "echo_4kb_pyapi_p99_us": lat[min(n - 1, n * 99 // 100)] if n else None,
            "echo_4kb_pyapi_qps": round(n / wall, 1),
            "echo_4kb_pyapi_ok": n,
            "echo_4kb_pyapi_config": {
                "mode": best_py["mode"],
                "parallelism": best_py["parallelism"],
            },
            "echo_4kb_pyapi_curve": pycurve,
            # sync-stub headline (bytes-mode pooled fast path,
            # p50-SLO-constrained config choice, best of the fresh
            # re-runs listed in echo_4kb_pyapi_sync_runs)
            "echo_4kb_pyapi_sync_qps": sync_best["qps"],
            "echo_4kb_pyapi_sync_p50_us": sync_best["p50_us"],
            "echo_4kb_pyapi_sync_config": {
                "mode": sync_best["mode"],
                "parallelism": sync_best["parallelism"],
            },
            "echo_4kb_pyapi_sync_runs": sync_runs,
            # per-call pb-parse flavor
            "echo_4kb_pyapi_sync_pb_qps": pb_pt["qps"],
            "echo_4kb_pyapi_sync_pb_p50_us": pb_pt["p50_us"],
            # vectorized call_many lane: window × payload curve with
            # per-point step-log counters (structural proof the window
            # crossed once and harvested in bursts)
            "pyapi_ring_curve": ring_curve,
            "echo_4kb_pyapi_ring_qps": ring_best["qps"],
            "echo_4kb_pyapi_ring_window": ring_best["window"],
            "echo_4kb_pyapi_ring_counters": ring_best["counters"],
            # server-side flush contract at the headline point: one
            # writev burst per harvested window (ns_ring_stats delta)
            "echo_4kb_pyapi_ring_server_ring": ring_best.get("server_ring"),
            "echo_4kb_pyapi_ring_vs_sync": round(
                ring_best["qps"] / sync_best["qps"], 2
            ) if sync_best["qps"] else 0.0,
        }
    )
    if out["echo_4kb_qps"]:
        # the headline gap: batched Python API vs the raw native engine
        # (target: within ~2x)
        out["echo_4kb_pyapi_ring_vs_native"] = round(
            ring_best["qps"] / out["echo_4kb_qps"], 3
        )
    return out


# transmits a queued window of bench_transmit_op's chain holds on the card
# (two launches each: K1, which folds the checksum in its tail, and the
# scalar add; an H100's stream took 340 of three launches behind a sleep
# before the host waited); a longer chain is timed in consecutive windows,
# its device times added
QUEUED_TRANSMITS = 200


def transmit_chain(y, s, iters):
    """``iters`` transmits, each copying the previous one's output, their
    checksums added to the device scalar ``s``: (last output, sum)."""
    from incubator_brpc_tpu_torch.ops.transfer import device_copy_with_checksum

    for _ in range(iters):
        y, csum = device_copy_with_checksum(y)
        s = s + csum
    return y, s


def transmit_fold(y, s):
    """The scalar fetched at a chain's end: it depends on every transmit."""
    return y[0, 0] + y[-1, -1] + 0.0 * s


def bench_transmit_op(mb=64, hi=200, lo=8, reps=3, device=None):
    """Marginal-cost bandwidth of the fabric's transmit op (K1,
    ``copy_csum_blocks``).

    Chains `hi` (resp. `lo`) data-dependent transmissions of a 64MB
    payload — each launch copies the previous launch's output — with
    the checksums summed on the card and a scalar folded from the final
    output, and divides the time difference by (hi - lo) transmissions.
    Counts 2x payload per pass (HBM read + write), the same accounting
    as reference rdma_perf.  On the card a chain's time is the card's:
    its launches are queued behind a sleep and timed by CUDA events
    (``tools/_device_time.py``), in windows of at most QUEUED_TRANSMITS
    transmits carrying the output and the sum from one to the next, the
    fold in the last, so the figure is the card's time per transmit, as
    the JAX bench's one jitted program gives it.  On the CPU (the plain
    versions) a chain runs as it is issued, and the host clock times it
    up to the fold's fetch: a CPU has no queue to fill."""
    from incubator_brpc_tpu_torch.analysis.device_witness import allowed_transfer
    from incubator_brpc_tpu_torch.tools._device_time import SLEEP_CYCLES, queued_ms

    dev = device_for_chip(0, device)
    rows = (mb << 20) // (2048 * 4)
    cycles = SLEEP_CYCLES

    def chain(a, iters):
        """Seconds the chain of `iters` transmits from `a` took."""
        nonlocal cycles
        s = torch.zeros((), dtype=torch.float32, device=dev)
        if dev.type != "cuda":
            t0 = time.perf_counter()
            fold = transmit_fold(*transmit_chain(a, s, iters))
            with allowed_transfer("bench.device-time"):
                float(fold)
            return time.perf_counter() - t0
        y, ms, fold = a, 0.0, None
        for done in range(0, iters, QUEUED_TRANSMITS):
            n = min(QUEUED_TRANSMITS, iters - done)
            last = done + n == iters

            def window(y=y, s=s, n=n, last=last):
                y, s = transmit_chain(y, s, n)
                return y, s, transmit_fold(y, s) if last else None

            part, (y, s, fold), cycles = queued_ms(window, cycles)
            ms += part
        with allowed_transfer("bench.device-time"):
            float(fold)
        return ms / 1e3

    base = torch.linspace(
        0.0, 1.0, rows * 2048, dtype=torch.float32, device=dev
    ).reshape(rows, 2048)
    xs = [base + i for i in range(2 * reps + 2)]
    chain(xs[0], hi)  # warm: loads the kernel, fills the allocator's pool
    chain(xs[1], lo)
    best_per = None
    k = 2
    for _ in range(reps):
        t_hi = chain(xs[k], hi)
        t_lo = chain(xs[k + 1], lo)
        k += 2
        per = (t_hi - t_lo) / (hi - lo)
        if per > 0 and (best_per is None or per < best_per):
            best_per = per
    if not best_per:
        return {"pallas_transmit_64mb_gbps": None}
    return {
        "pallas_transmit_64mb_gbps": round(2 * mb / 1024 / best_per, 1),
        "pallas_transmit_64mb_us": round(best_per * 1e6, 1),
    }


def bench_ici_pipeline_curve(mb=64, hi=10, lo=2, reps=3, device=None):
    """Chunk-size/mode sweep of the fabric's large-frame transmit
    path (docs/ici_pipeline.md): the SAME chained marginal-cost method
    as bench_transmit_op, but driven through IciFabric's chunk policy
    so the sweep measures exactly what a 64MB frame pays per hop under
    each config:

      - off        — whole-frame transmit: one K1 launch;
      - fused      — the frame's chunk plan run by one K1 launch;
      - pipelined  — one K1 launch per chunk, the lane accumulator
                     carried from chunk to chunk, outputs in
                     StagingRing slots;
      - pallas     — ONE staged kernel launch per frame (K2,
                     ``copy_csum_staged``: persistent CTAs keep the next
                     tiles' bulk loads in flight while a tile is summed
                     and stored back).

    The best config is APPLIED to the fabric before bench_ici_rpc runs,
    the same way echo_4kb picks its best curve point for the headline —
    the headline's definition (median marginal per echo, zero_copy off)
    is unchanged; only the chunk policy, an operator knob, is tuned."""
    return _bench_ici_pipeline_curve_impl(mb, hi, lo, reps, device)


def _bench_ici_pipeline_curve_impl(mb, hi, lo, reps, device=None):
    from incubator_brpc_tpu_torch.parallel.ici import (
        StagingRing,
        get_fabric,
        ici_pallas_fallbacks,
        ici_pallas_frames,
    )

    fabric = get_fabric()
    rows = (mb << 20) // (2048 * 4)
    x0 = torch.linspace(
        0.0, 1.0, rows * 2048, dtype=torch.float32,
        device=device_for_chip(0, device),
    ).reshape(rows, 2048)

    class _PortShim:
        """Staging-ring host for the sweep (no live port needed)."""

        coords = (0, 0)
        device = None

        def __init__(self):
            self.staging = StagingRing()

    shim = _PortShim()

    def transmit(arr):
        out, _ = fabric._transmit_segment(arr, shim, None)
        # pallas mode writes into ring slots; the consumed input is
        # this hop's recyclable buffer — releasing it keeps frame 2+
        # allocation-free (the StagingRing contract)
        if fabric.chunk_mode == "pallas" and arr is not x0:
            shim.staging.release(arr)
        return out

    def chain(n):
        t0 = time.perf_counter()
        y = x0
        for _ in range(n):
            y = transmit(y)
        float(y[0, 0] + y[-1, -1])  # forces every chunk of every pass
        return time.perf_counter() - t0

    configs = [
        ("off", 0),
        ("fused", 4 << 20), ("fused", 8 << 20), ("fused", 16 << 20),
        ("pipelined", 4 << 20), ("pipelined", 8 << 20),
        ("pipelined", 16 << 20),
        ("pallas", 4 << 20), ("pallas", 8 << 20), ("pallas", 16 << 20),
    ]
    saved = (fabric.chunk_mode, fabric.chunk_bytes)
    curve = []
    try:
        for mode, cb in configs:
            fabric.chunk_mode = mode
            if cb:
                fabric.chunk_bytes = cb
            f0 = int(ici_pallas_frames.get_value())
            fb0 = int(ici_pallas_fallbacks.get_value())
            transmits = 2
            chain(2)  # warm this config: kernels loaded, ring slots seeded
            per = []
            for _ in range(reps):
                d = (chain(hi) - chain(lo)) / (hi - lo)
                transmits += hi + lo
                if d > 0:
                    per.append(d)
            per.sort()
            med = per[len(per) // 2] if per else None
            entry = {
                "mode": mode,
                "chunk_mb": cb >> 20,
                "gbps": round(2 * mb / 1024 / med, 1) if med else None,
                "per_pass_us": round(med * 1e6, 1) if med else None,
            }
            if mode == "pallas":
                # proof-by-step-log: on the hit path every frame is ONE
                # K2 launch (dispatches == transmits and zero
                # fallbacks); a silent fallback to the per-chunk
                # pipeline shows up here, not as a quiet slowdown
                entry["pallas_dispatches"] = (
                    int(ici_pallas_frames.get_value()) - f0
                )
                entry["pallas_fallbacks"] = (
                    int(ici_pallas_fallbacks.get_value()) - fb0
                )
                entry["pallas_transmits"] = transmits
            curve.append(entry)
    finally:
        fabric.chunk_mode, fabric.chunk_bytes = saved
    best = max(curve, key=lambda p: p["gbps"] or 0.0)
    if best["gbps"]:
        # tune the fabric for the headline run (and record the choice)
        fabric.chunk_mode = best["mode"]
        if best["chunk_mb"]:
            fabric.chunk_bytes = best["chunk_mb"] << 20
    return {"ici_pipeline_curve": curve, "ici_pipeline_best": best}


def bench_ici_rpc(mb=64, hi=48, lo=8, reps=9, device=None):
    """Measured END-TO-END 64MB device-payload echo over the ICI
    transport — THE headline. zero_copy stays OFF (the fabric default),
    so both hops of every echo (request: client→server port, response:
    server→client port) run the payload through the copy+checksum
    transmit kernel of the fabric's chunk mode (K1, or K2 in pallas
    mode) INSIDE the timed region.

    Two honesty mechanisms (launches return before the card has run
    them, and a host-visible fetch has a fixed cost of its own):
      - chaining: echo i+1's request attachment IS echo i's response
        device tensor, and the timed region ends with a scalar fetch
        folded from the final response — so that fetch data-depends on
        EVERY hop's kernel in the chain; nothing can be skipped.
      - marginal cost: a long chain (hi echoes) is differenced against a
        short one (lo), cancelling the fixed fetch cost; the quotient is
        the real per-echo time (framing + both device hops).

    Headline = 2*64MB (request + response payload per echo) divided by
    the MEDIAN over reps of the marginal per-echo time — the JAX bench's
    definition, unchanged."""
    return _bench_ici_rpc_impl(mb, hi, lo, reps, device)


def _bench_ici_rpc_impl(mb, hi, lo, reps, device=None):
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
    from incubator_brpc_tpu_torch.parallel.ici import get_fabric
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    dev = device_for_chip(0, device)
    # usercode_in_dispatcher: the echo handler runs inline on the
    # fabric delivery path (IciPort.inline_dispatch), saving two task
    # handoffs per RPC — the same threading-model tuning the TCP/native
    # benches already apply (reference docs/cn/benchmark.md); the echo
    # handler never blocks, which is the documented contract for it
    srv = Server(ServerOptions(usercode_in_dispatcher=True))
    srv.add_service(EchoService())
    # server port and client port both own this device's HBM, so BOTH
    # hops place+transmit (multi-device hosts would otherwise measure a
    # device_put hop instead)
    assert srv.start_ici(0, 63, device=dev) == 0
    assert get_fabric().zero_copy is False, "honest mode is the default"
    lat = []

    try:
        ch = Channel(ChannelOptions(timeout_ms=30000, ici_device=dev))
        ch.init("ici://slice0/chip63")
        stub = echo_stub(ch)

        rows = (mb << 20) // (2048 * 4)
        x0 = torch.ones((rows, 2048), dtype=torch.float32, device=dev)

        def chain(n):
            """n chained echoes + forced completion; returns wall secs."""
            cur = x0
            t0 = time.perf_counter()
            for _ in range(n):
                c = Controller()
                c.timeout_ms = 30000
                c.request_attachment.append_device(cur)
                stub.Echo(c, EchoRequest(message="bulk"))
                if c.failed():
                    raise RuntimeError(f"ici echo failed: {c.error_text()}")
                assert len(c.response_attachment) == mb << 20
                arrs = c.response_attachment.device_arrays()
                # payload must still be device-resident (no host detour)
                assert len(arrs) == 1
                cur = arrs[0]
                lat.append(c.latency_us)
            float(cur[0, 0] + cur[-1, -1])  # forces the whole chain
            return time.perf_counter() - t0

        chain(2)  # warmup: loads both hops' kernel, seeds the allocator
        per = []
        for _ in range(reps):
            t_hi = chain(hi)
            t_lo = chain(lo)
            d = (t_hi - t_lo) / (hi - lo)
            if d > 0:
                per.append(d)
    finally:
        srv.stop()

    per.sort()
    lat.sort()
    out = {
        "ici_echo_e2e_us_per_echo_all": [round(p * 1e6, 1) for p in per],
        "ici_rpc_dispatch_p50_us": lat[len(lat) // 2] if lat else None,
        "ici_rpc_ok": len(lat),
    }
    if per:
        med = per[len(per) // 2]
        out["ici_echo_e2e_us_per_echo_median"] = round(med * 1e6, 1)
        out["ici_echo_e2e_us_per_echo_min"] = round(per[0] * 1e6, 1)
        out["ici_echo_e2e_us_per_echo_max"] = round(per[-1] * 1e6, 1)
        out["ici_64mb_echo_gbps"] = round((2 * mb / 1024) / med, 1)
        # "best" is diagnostic only, and a host stall during a lo
        # chain can fabricate a tiny positive difference; the JAX
        # bench's 200us floor for two hops is kept, so both benches
        # report "best" under the same rule (two K1 hops of 64 MB take
        # about 0.1 ms of the card's time; an echo takes more)
        if per[0] * 1e6 >= 200:
            out["ici_64mb_echo_gbps_best"] = round((2 * mb / 1024) / per[0], 1)
    return out


def bench_dcn_bulk(mb=64, reps=7, device=None):
    """Cross-process bulk bandwidth over the DCN bridge: a REAL second
    process hosts an ici:// echo server behind listen_dcn; this process
    echoes a 64MB attachment through it (reference analog:
    rdma_performance's cross-machine transfer).  Counts request+response
    payload (2 x mb) per echo; reports the median.  The attachment is
    host bytes, so neither process runs a kernel on it; the child's
    ici:// port lives on ``device`` (the card of chip 5 when None).

    Same-host bridges auto-upgrade to UDS after the TCP handshake; what
    separates the figure from the wire's floor is per-frame work:
    receive-side buffer assembly, scheduler handoffs, and tpu_std
    framing."""
    import os
    import pathlib
    import subprocess
    import sys

    script = (
        "import json,sys,torch;"
        "from incubator_brpc_tpu_torch.parallel.dcn import listen_dcn;"
        "from incubator_brpc_tpu_torch.models.echo import EchoService;"
        "from incubator_brpc_tpu_torch.server.server import Server;"
        "dev=None if sys.argv[1]=='' else torch.device(sys.argv[1]);"
        "srv=Server();srv.add_service(EchoService());"
        "assert srv.start_ici(0, 5, device=dev)==0;"
        "print(json.dumps({'p': listen_dcn(0, host='127.0.0.1')}),flush=True);"
        "sys.stdin.read()"
    )
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import echo_stub
    from incubator_brpc_tpu_torch.parallel.dcn import connect_dcn
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest

    client_dev = device_for_chip(0, device)  # raises here without a card
    env = dict(os.environ)
    root = str(pathlib.Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = (
        root + os.pathsep + env["PYTHONPATH"]
        if env.get("PYTHONPATH")
        else root
    )
    proc = subprocess.Popen(
        [sys.executable, "-c", script, "" if device is None else str(device)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, env=env, text=True,
    )
    try:
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError(
                f"the DCN echo child exited ({proc.wait()}) before listening"
            )
        info = json.loads(line)
        connect_dcn("127.0.0.1", info["p"])
        ch = Channel(ChannelOptions(timeout_ms=60000, ici_device=client_dev))
        assert ch.init("ici://slice0/chip5") == 0
        stub = echo_stub(ch)
        blob = b"\xa5" * (mb << 20)
        times = []
        for i in range(reps + 1):
            c = Controller()
            c.timeout_ms = 60000
            c.request_attachment.append(blob)
            t0 = time.perf_counter()
            stub.Echo(c, EchoRequest(message="bulk"))
            dt = time.perf_counter() - t0
            if c.failed():
                raise RuntimeError(f"DCN echo failed: {c.error_text()}")
            assert len(c.response_attachment) == mb << 20
            if i > 0:  # first rep warms both processes
                times.append(dt)
        ch.close()
        times.sort()
        med = times[len(times) // 2]
        return {
            "dcn_64mb_echo_gbps": round((2 * mb / 1024) / med, 2),
            "dcn_64mb_echo_s_median": round(med, 3),
            "dcn_64mb_echo_s_all": [round(t, 3) for t in times],
        }
    finally:
        proc.stdin.close()
        try:
            proc.wait(5)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def bench_python_protocols(duration_s=2.0, threads=4):
    """qps/latency for the non-tpu_std protocol paths.

    Headline http_echo_qps / redis_cmd_qps measure the NATIVE engine's
    C framers (multi-protocol sniffing port: HTTP raw echo handler,
    sharded redis KV) with the native pipelined load generators — the
    reference benchmarks its http/redis servers the same all-native
    way.  The *_py numbers keep the pure-Python transport path honest
    (epoll loop + scheduler; what a non-native deployment gets)."""
    out = {}
    out.update(_bench_native_http_redis())
    out.update(_bench_http(duration_s, threads))
    out.update(_bench_redis(duration_s, threads))
    return out


def _bench_native_http_redis():
    """HTTP + redis served by the C++ engine's protocol framers
    (raises NativeEngineError without the engine)."""
    from incubator_brpc_tpu_torch import native
    from incubator_brpc_tpu_torch.models.echo import EchoService
    from incubator_brpc_tpu_torch.protocols.redis import KVRedisService
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    native.require()
    srv = Server(
        ServerOptions(native_engine=True, redis_service=KVRedisService())
    )
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    out = {}
    try:
        best_h = None
        for conc, depth in ((1, 16), (1, 32), (2, 16)):
            h = native.bench_http(
                "127.0.0.1", srv.port, "/EchoService/Echo.raw", 4096,
                concurrency=conc, duration_ms=1500, depth=depth,
            )
            if h["failed"] == 0 and (
                best_h is None or h["qps"] > best_h["qps"]
            ):
                best_h = h
        if best_h is None:
            raise RuntimeError("every native HTTP load config failed calls")
        out.update(
            {
                "http_echo_qps": best_h["qps"],
                "http_echo_p50_us": best_h["p50_us"],
                "http_echo_p99_us": best_h["p99_us"],
                "http_echo_ok": best_h["ok"],
            }
        )
        best_r = None
        for conc, depth in ((1, 16), (1, 32), (2, 16)):
            r = native.bench_redis(
                "127.0.0.1", srv.port, 64, concurrency=conc,
                duration_ms=1500, depth=depth,
            )
            if r["failed"] == 0 and (
                best_r is None or r["qps"] > best_r["qps"]
            ):
                best_r = r
        if best_r is None:
            raise RuntimeError("every native redis load config failed calls")
        out.update(
            {
                "redis_cmd_qps": best_r["qps"],
                "redis_cmd_p50_us": best_r["p50_us"],
                "redis_cmd_p99_us": best_r["p99_us"],
                "redis_ok": best_r["ok"],
            }
        )
    finally:
        srv.stop()
    return out


def _bench_loop(duration_s, threads, fn):
    """Run fn() on N threads until the deadline; → (lat_us_list, wall)."""
    lat, lock = [], threading.Lock()
    deadline = time.monotonic() + duration_s

    def worker():
        local = []
        while time.monotonic() < deadline:
            t0 = time.perf_counter_ns()
            if fn():
                local.append((time.perf_counter_ns() - t0) // 1000)
        with lock:
            lat.extend(local)

    t0 = time.monotonic()
    ts = [threading.Thread(target=worker) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return lat, time.monotonic() - t0


def _bench_http(duration_s, threads):
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    srv = Server(ServerOptions(usercode_in_dispatcher=True))
    srv.add_service(EchoService(attach_echo=False))
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(protocol="http", timeout_ms=5000))
    ch.init(f"127.0.0.1:{srv.port}")
    stub = echo_stub(ch)
    req = EchoRequest(message="x" * 512)

    def one():
        c = Controller()
        stub.Echo(c, req)
        return not c.failed()

    one()  # warm
    lat, wall = _bench_loop(duration_s, threads, one)
    srv.stop()
    ch.close()
    lat.sort()
    n = len(lat)
    return {
        "http_echo_py_qps": round(n / wall, 1),
        "http_echo_py_p50_us": lat[n // 2] if n else None,
        "http_echo_py_p99_us": lat[min(n - 1, n * 99 // 100)] if n else None,
        "http_echo_py_ok": n,
    }


def _bench_redis(duration_s, threads):
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.protocols import redis as R
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    class KV(R.RedisService):
        def __init__(self):
            self._d = {}

        def get(self, key):
            return self._d.get(key)

        def set(self, key, value):
            self._d[key] = value
            return "OK"

    srv = Server(ServerOptions(redis_service=KV()))
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(protocol="redis", timeout_ms=5000))
    ch.init(f"127.0.0.1:{srv.port}")
    val = "v" * 64

    def one():
        req = R.RedisRequest()
        req.add_command("SET", "bench", val)
        req.add_command("GET", "bench")
        resp = R.RedisResponse()
        c = Controller()
        ch.call_method(R.redis_method_spec(), c, req, resp)
        return not c.failed()

    one()
    lat, wall = _bench_loop(duration_s, threads, one)
    srv.stop()
    ch.close()
    lat.sort()
    n = len(lat)
    return {
        # each round trip carries 2 pipelined commands
        "redis_cmd_py_qps": round(2 * n / wall, 1),
        "redis_pair_py_p50_us": lat[n // 2] if n else None,
        "redis_pair_py_p99_us": lat[min(n - 1, n * 99 // 100)] if n else None,
        "redis_py_ok": n,
    }


def bench_tail_cdf(qps=10000, duration_s=3.0, slow_ratio=0.01,
                   slow_sleep_us=5000):
    """The reference's signature threading-model experiment
    (docs/cn/benchmark.md:126-140): steady 10k qps where 1% of requests
    sleep 5ms in their handler; report the latency CDF of the fast 99%.
    A threading model that isolates slow requests keeps the fast p99
    near the no-tail p99; one that lets them block shared loops shows a
    tail cliff.  Here the fast path answers in the C++ engine workers
    while sleep-carrying requests decline to the Python handler pool —
    the same isolation the reference gets from bthreads.

    Load: paced bursts (one burst per 10ms tick) through the public
    async stub API; latencies come from controller.latency_us.

    Control stability: beyond the throwaway warmup run, each run TRIMS
    samples completed during its first trim_s (default 0.5s) — connect
    ramp, allocator warmup, and recorder-agent creation otherwise land
    their cold-start tail in the no-tail control's p999 and make the
    with/without comparison read backwards.  The p999 of a 25k-sample
    run is its top ~25 samples, so a single CPython gen-2 GC pause or
    scheduler hiccup rewrites it: the GC is paused across each run
    (collected between runs), and the control runs TWICE — once before
    and once after the tail run — with the better-behaved control used
    for the ratios (both are reported).  The p999 ratio is reported
    alongside p99 (fast_p999_ratio).
    """
    import threading as _th

    from incubator_brpc_tpu_torch import native
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    native.require()
    srv = Server(ServerOptions(native_engine=True))
    srv.add_service(EchoService(attach_echo=False))
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=10000, connection_type="native"))
    ch.init(f"127.0.0.1:{srv.port}")
    stub = echo_stub(ch)
    msg = "x" * 1024

    def run(ratio, trim_s=0.5):
        fast, slow = [], []
        done_ct = [0]
        total_sent = [0]
        fin = _th.Event()
        tick_s = 0.002  # finer bursts: intra-burst queueing otherwise
        per_tick = max(1, int(qps * tick_s))  # dominates the reported CDF
        n_ticks = int(duration_s / tick_s)
        total = per_tick * n_ticks
        slow_every = int(1 / ratio) if ratio > 0 else 0
        t_trim = time.monotonic() + trim_s

        def mk_done(c, is_slow):
            def d():
                # samples completing inside the trim window carry the
                # cold-start ramp, not steady-state latency
                if not c.error_code and time.monotonic() >= t_trim:
                    (slow if is_slow else fast).append(c.latency_us)
                done_ct[0] += 1
                if done_ct[0] >= total:
                    fin.set()
            return d

        t0 = time.monotonic()
        for tick in range(n_ticks):
            for i in range(per_tick):
                seq = total_sent[0]
                total_sent[0] += 1
                is_slow = slow_every > 0 and (seq % slow_every) == 0
                c = Controller()
                req = (
                    EchoRequest(message=msg, sleep_us=slow_sleep_us)
                    if is_slow
                    else EchoRequest(message=msg)
                )
                stub.Echo(c, req, done=mk_done(c, is_slow))
            # pace to the tick grid (skip sleeping if we're behind)
            target = t0 + (tick + 1) * tick_s
            now = time.monotonic()
            if target > now:
                time.sleep(target - now)
        fin.wait(30)
        achieved = total_sent[0] / (time.monotonic() - t0)
        fast.sort()
        slow.sort()
        n = len(fast)
        pct = lambda q: fast[min(n - 1, int(n * q))] if n else None  # noqa: E731
        return {
            "achieved_qps": round(achieved, 1),
            "fast_n": n,
            "fast_p50_us": pct(0.50),
            "fast_p99_us": pct(0.99),
            "fast_p999_us": pct(0.999),
            "slow_n": len(slow),
            "slow_p50_us": slow[len(slow) // 2] if slow else None,
        }

    import gc as _gc

    def run_nogc(ratio):
        _gc.collect()
        _gc.disable()
        try:
            return run(ratio)
        finally:
            _gc.enable()

    try:
        run(0.0)  # warmup: connects, allocator, recorder agents — the
        # control run otherwise wears the cold-start tail itself
        base_a = run_nogc(0.0)  # no-tail control, sandwiching the
        tail = run_nogc(slow_ratio)
        base_b = run_nogc(0.0)  # tail run (cancels slow drift)
        base = min(
            (base_a, base_b),
            key=lambda b: (b["fast_p999_us"] is None, b["fast_p999_us"] or 0),
        )
    finally:
        srv.stop()
        ch.close()
    ratio = (
        round(tail["fast_p99_us"] / base["fast_p99_us"], 2)
        if base["fast_p99_us"] and tail["fast_p99_us"] is not None
        else None
    )
    ratio999 = (
        round(tail["fast_p999_us"] / base["fast_p999_us"], 2)
        if base["fast_p999_us"] and tail["fast_p999_us"] is not None
        else None
    )
    return {
        "tail_cdf": {
            "config": {
                "qps": qps, "slow_ratio": slow_ratio,
                "slow_sleep_us": slow_sleep_us, "warmup_trim_s": 0.5,
            },
            "no_tail": base,
            "no_tail_controls": [base_a, base_b],
            "with_tail": tail,
            "fast_p99_ratio": ratio,
            "fast_p999_ratio": ratio999,
        }
    }


def _drift_cancelled_overhead(seg, set_on, set_off, pairs):
    """Shared OFF/ON/OFF estimator for hot-path overhead cases: a
    shared host drifts several percent over a few seconds
    (thermal/steal), so long A-then-B segments alias drift into the
    delta.  Segments run OFF,ON,OFF,ON,...,OFF and each ON segment is
    compared against the MEAN of its two neighbouring OFF segments
    (cancels linear drift exactly).  Returns (on_qps, off_qps,
    per-segment overhead %); report the MEDIAN of the deltas."""
    on_qps, off_qps = [], []
    seg()  # warmup: connect, allocator, recorder agents
    set_off()
    off_qps.append(seg())
    for _ in range(pairs):
        set_on()
        on_qps.append(seg())
        set_off()
        off_qps.append(seg())
    deltas = [
        100.0 * ((off_qps[i] + off_qps[i + 1]) / 2 - on)
        / ((off_qps[i] + off_qps[i + 1]) / 2)
        for i, on in enumerate(on_qps)
    ]
    return on_qps, off_qps, deltas


def bench_rpcz_overhead(payload=1024, seg_calls=500, pairs=8):
    """Observability cost on the echo hot path: the same sync echo
    loop over the PYTHON transport (the path that creates rpcz spans;
    the native engine answers off-GIL without spans) with rpcz_enabled
    true vs false (methodology: _drift_cancelled_overhead).

    Budget: <10%.  rpcz bounds its own hot-path cost by construction:
    span creation is sampled at rpcz_max_spans_per_second (default
    1000/s, the same budget the Collector used to enforce at submit
    time) so over-budget traffic skips span work entirely, and the
    per-message phase stamps are a handful of clock reads."""
    import statistics

    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
    from incubator_brpc_tpu_torch.utils.flags import set_flag

    srv = Server(ServerOptions(usercode_in_dispatcher=True))
    srv.add_service(EchoService(attach_echo=False))
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=10000))
    ch.init(f"127.0.0.1:{srv.port}")
    stub = echo_stub(ch)
    msg = "x" * payload

    def seg():
        t0 = time.monotonic()
        for _ in range(seg_calls):
            c = Controller()
            stub.Echo(c, EchoRequest(message=msg))
        return seg_calls / (time.monotonic() - t0)

    try:
        on_qps, off_qps, deltas = _drift_cancelled_overhead(
            seg,
            lambda: set_flag("rpcz_enabled", True),
            lambda: set_flag("rpcz_enabled", False),
            pairs,
        )
    finally:
        set_flag("rpcz_enabled", True)
        srv.stop()
        ch.close()
    return {
        "rpcz_overhead": {
            "echo_1kb_qps_rpcz_on": round(statistics.median(on_qps), 1),
            "echo_1kb_qps_rpcz_off": round(statistics.median(off_qps), 1),
            "overhead_pct": round(statistics.median(deltas), 2),
            "overhead_pct_segments": [round(d, 1) for d in deltas],
        }
    }


def bench_profiler_overhead(payload=1024, seg_calls=400, rows=4, tokens=16,
                            dim=16, pairs=6, device=None):
    """profiler_overhead: the DISARMED cost of the device-plane
    profilers (observability/profiling.py) — all three always-on
    halves toggled together: HBM accounting (adopt/release at every
    pinning site), kernel-section attribution (two clock reads per
    dispatch), and the occupancy sampler (per-task queue-in stamp).

    Two hot paths, each an OFF/ON/OFF drift-cancelled triplet
    (methodology: _drift_cancelled_overhead):

      * python-transport echo — the scheduler path every RPC takes:
        pays the occupancy observer's clock read per spawned task;
      * decode loop — the device path: pays kernel_section around
        every step plus one adopt/release per row lifetime.

    Budget: <1% median on each path.  The OFF state is the floor an
    operator reaches by flipping the three runtime flags; the ledger
    must stay balanced across the flips (adopt returns what release
    takes, so a row admitted ON and finished OFF nets zero)."""
    import statistics

    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
    from incubator_brpc_tpu_torch.streaming.generate import DecodeLoop
    from incubator_brpc_tpu_torch.utils.flags import set_flag

    flags = ("profiler_hbm_enabled", "profiler_device_enabled",
             "profiler_occupancy_enabled")

    def set_all(v):
        def inner():
            for f in flags:
                set_flag(f, v)
        return inner

    srv = Server(ServerOptions(usercode_in_dispatcher=True))
    srv.add_service(EchoService(attach_echo=False))
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=10000))
    ch.init(f"127.0.0.1:{srv.port}")
    stub = echo_stub(ch)
    msg = "x" * payload

    def echo_seg():
        t0 = time.monotonic()
        for _ in range(seg_calls):
            c = Controller()
            stub.Echo(c, EchoRequest(message=msg))
        return seg_calls / (time.monotonic() - t0)

    try:
        echo_on, echo_off, echo_deltas = _drift_cancelled_overhead(
            echo_seg, set_all(True), set_all(False), pairs
        )
    finally:
        set_all(True)()
        srv.stop()
        ch.close()

    loop = DecodeLoop(dim=dim, device=device)
    loop.prewarm()
    seq = [0]

    def decode_seg():
        done = threading.Event()
        left = [rows]

        def emit(token, row):
            pass

        def fin(row, ok):
            left[0] -= 1
            if left[0] == 0:
                done.set()

        seq[0] += 1
        t0 = time.monotonic()
        for i in range(rows):
            loop.admit(f"prof-bench-{seq[0]}-{i}", tokens, emit, fin)
        assert done.wait(60), "decode rows never finished"
        return rows * tokens / (time.monotonic() - t0)

    try:
        dec_on, dec_off, dec_deltas = _drift_cancelled_overhead(
            decode_seg, set_all(True), set_all(False), pairs
        )
    finally:
        set_all(True)()
        loop.stop()
    return {
        "profiler_overhead": {
            "echo_1kb_qps_profilers_on": round(statistics.median(echo_on), 1),
            "echo_1kb_qps_profilers_off": round(
                statistics.median(echo_off), 1),
            "echo_overhead_pct": round(statistics.median(echo_deltas), 2),
            "echo_overhead_pct_segments": [round(d, 1) for d in echo_deltas],
            "decode_tok_s_profilers_on": round(statistics.median(dec_on), 1),
            "decode_tok_s_profilers_off": round(statistics.median(dec_off), 1),
            "decode_overhead_pct": round(statistics.median(dec_deltas), 2),
            "decode_overhead_pct_segments": [
                round(d, 1) for d in dec_deltas],
        }
    }


def bench_chaos_overhead(payload=4096, seg_calls=500, pairs=8):
    """chaos_disarmed_overhead: cost of the fault-injection sites on
    the echo hot path while NO fault can fire.  Two states compared:

      OFF          — injector disarmed: every wired site is one module
                     attribute load (`if _chaos.armed:`), the
                     scheduler/dispatcher hook slots are None, and the
                     C engine gates on one relaxed atomic;
      ARMED-EMPTY  — a plan with zero specs armed: sites additionally
                     call check() (a dict miss) — the worst
                     adjacent-to-disarmed state.

    Runs over the PYTHON transport (the path that traverses every
    Python site) via _drift_cancelled_overhead.  Budget: <1% — the
    checks are a few global loads against a ~10us/call path, so
    anything visible above the noise floor means a site grew a lock
    or a loop."""
    import statistics

    from incubator_brpc_tpu_torch.chaos import FaultPlan
    from incubator_brpc_tpu_torch.chaos import injector as chaos_injector
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    srv = Server(ServerOptions(usercode_in_dispatcher=True))
    srv.add_service(EchoService(attach_echo=False))
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=10000))
    ch.init(f"127.0.0.1:{srv.port}")
    stub = echo_stub(ch)
    msg = "x" * payload
    empty_plan = FaultPlan([], seed=1, name="empty")

    def seg():
        t0 = time.monotonic()
        for _ in range(seg_calls):
            c = Controller()
            stub.Echo(c, EchoRequest(message=msg))
        return seg_calls / (time.monotonic() - t0)

    try:
        on_qps, off_qps, deltas = _drift_cancelled_overhead(
            seg,
            lambda: chaos_injector.arm(empty_plan),
            chaos_injector.disarm,
            pairs,
        )
    finally:
        chaos_injector.disarm()
        srv.stop()
        ch.close()
    return {
        "chaos_disarmed_overhead": {
            "echo_4kb_qps_chaos_off": round(statistics.median(off_qps), 1),
            "echo_4kb_qps_chaos_armed_empty": round(
                statistics.median(on_qps), 1
            ),
            "overhead_pct": round(statistics.median(deltas), 2),
            "overhead_pct_segments": [round(d, 1) for d in deltas],
        }
    }


def bench_ring_disabled_overhead(payload=4096, seg_calls=500, pairs=8):
    """ring_disabled_overhead: cost to the PER-CALL sync fast path of
    the submission/completion ring machinery when call_many is NOT in
    use.  Two states over the native transport (the path that shares
    the mux — and its completion routing — with the ring lane):

      OFF — no ring object on the channel; the engine's completion
            dispatch tests one tag bit per reply and never takes the
            ring branch;
      ON  — the channel's internal SubmissionRing instantiated and a
            ring-tag block reserved (the worst adjacent-to-unused
            state: the ring lane exists, its queues are allocated,
            but no window is ever submitted).

    Methodology: _drift_cancelled_overhead (OFF/ON/OFF triplets cancel
    a shared host's thermal/steal drift).  Budget: <1% — the ring must be
    pay-for-what-you-use; anything visible above the noise floor means
    the per-call path grew a lock or a branch on the ring's account."""
    import statistics

    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import (
        acquire_controller,
        release_controller,
    )
    from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
    from incubator_brpc_tpu_torch.server.service import RAW_RESPONSE

    srv = Server(ServerOptions(native_engine=True))
    srv.add_service(EchoService(attach_echo=False))
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=10000, connection_type="native"))
    ch.init(f"127.0.0.1:{srv.port}")
    stub = echo_stub(ch)
    packed_req = EchoRequest(message="x" * payload).SerializeToString()

    def seg():
        call = stub.Echo
        t0 = time.monotonic()
        for _ in range(seg_calls):
            c = acquire_controller()
            call(c, packed_req, response=RAW_RESPONSE)
            release_controller(c)
        return seg_calls / (time.monotonic() - t0)

    def set_on():
        with ch._ring_lock:
            ring = ch._submission_ring()
        mux = ch._native_mux()
        if mux is not None:
            mux.reserve_ring_tags(1)  # arm the lane; never submitted
        return ring

    def set_off():
        with ch._ring_lock:
            ch._ring_obj = None

    try:
        on_qps, off_qps, deltas = _drift_cancelled_overhead(
            seg, set_on, set_off, pairs
        )
    finally:
        srv.stop()
        ch.close()
    return {
        "ring_disabled_overhead": {
            "echo_4kb_qps_ring_absent": round(statistics.median(off_qps), 1),
            "echo_4kb_qps_ring_idle": round(statistics.median(on_qps), 1),
            "overhead_pct": round(statistics.median(deltas), 2),
            "overhead_pct_segments": [round(d, 1) for d in deltas],
        }
    }


def bench_cluster_scrape_overhead(payload=1024, seg_calls=500, pairs=8):
    """cluster_scrape_overhead: cost to the echo hot path of a sidecar
    continuously scraping this replica's /cluster surface — the state a
    pod actually serves in, with every replica answering
    /cluster/export (mergeable recorder state) plus self-targeted
    /cluster/metrics merges, back to back (methodology:
    _drift_cancelled_overhead; ON = scraper hammering, OFF = idle).

    Budget: <1%.  The export walks recorder/bucket state under the same
    short per-agent locks the 1 Hz sampler already takes, entirely off
    the RPC path; anything visible above the noise floor means the
    scrape grew a lock or an allocation onto the hot path."""
    import statistics
    import threading

    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
    from incubator_brpc_tpu_torch.tools.rpc_view import fetch_page

    srv = Server(ServerOptions(usercode_in_dispatcher=True))
    srv.add_service(EchoService(attach_echo=False))
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=10000))
    ch.init(f"127.0.0.1:{srv.port}")
    stub = echo_stub(ch)
    msg = "x" * payload
    ep = f"127.0.0.1:{srv.port}"

    active = threading.Event()
    stop = threading.Event()
    scrapes = [0]

    def scraper():
        while not stop.is_set():
            if not active.wait(0.05):
                continue
            try:
                fetch_page(ep, "cluster/export", timeout=2.0)
                fetch_page(ep, f"cluster/metrics?replicas={ep}", timeout=2.0)
                scrapes[0] += 1
            except OSError:
                time.sleep(0.01)

    scraper_thread = threading.Thread(
        target=scraper, daemon=True, name="cluster-scraper"
    )
    scraper_thread.start()

    def seg():
        t0 = time.monotonic()
        for _ in range(seg_calls):
            c = Controller()
            stub.Echo(c, EchoRequest(message=msg))
        return seg_calls / (time.monotonic() - t0)

    try:
        on_qps, off_qps, deltas = _drift_cancelled_overhead(
            seg, active.set, active.clear, pairs
        )
    finally:
        stop.set()
        active.set()  # release a scraper parked in wait()
        scraper_thread.join(timeout=5)
        srv.stop()
        ch.close()
    return {
        "cluster_scrape_overhead": {
            "echo_1kb_qps_scrape_on": round(statistics.median(on_qps), 1),
            "echo_1kb_qps_scrape_off": round(statistics.median(off_qps), 1),
            "scrape_rounds": scrapes[0],
            "overhead_pct": round(statistics.median(deltas), 2),
            "overhead_pct_segments": [round(d, 1) for d in deltas],
        }
    }


def bench_device_witness_overhead(rows=8, tokens=64, dim=32, pairs=6,
                                  device=None):
    """device_witness_overhead: cost of the device-plane transfer
    witness (analysis/device_witness.py) on the decode hot path — the
    path with the highest density of witnessed sites (one manifested
    allowed_transfer pull + one bounded FusedKernel dispatch per step).
    Two states compared (methodology: _drift_cancelled_overhead):

      OFF    — witness disarmed (the default serving state): every
               allowed_transfer() is one module-bool check returning a
               no-op context manager, numpy is untouched, FusedKernel
               retrace notes return immediately;
      ARMED  — the witness lane: numpy and tensor pulls wrapped and
               call-site-checked (on the card also the CUDA sync
               debug hook), every manifested pull validates its key
               and opens the allow window, retraces recorded.

    Budget: the DISARMED state must be ≈0% — its cost is also measured
    directly (disarmed_scope_ns, and as a fraction of one decode step)
    because an OFF-vs-OFF triplet can't resolve it; <1% of a step.  The
    armed lane is a debug/CI sweep with no budget, reported for scale.
    The armed segments double as proof the lane engages outside pytest:
    armed_manifested_pulls must be > 0 and armed_violations == 0."""
    import statistics

    from incubator_brpc_tpu_torch.analysis import device_witness
    from incubator_brpc_tpu_torch.streaming.generate import DecodeLoop

    # state-preserving under an armed witness lane: never reset() the
    # session's accumulated evidence, count our own pulls as a delta,
    # and restore the armed state on the way out
    was_enabled = device_witness.enabled()
    baseline = device_witness.cross_check()
    loop = DecodeLoop(dim=dim, device=device)
    loop.prewarm()
    # the port's allowed_transfer counts a scope disarmed too, so the
    # armed segments' pulls are summed between each arm and disarm
    armed_pulls = [0]
    arm_mark = [None]

    def arm():
        arm_mark[0] = sum(device_witness.transfer_counts().values())
        device_witness.enable()

    def disarm():
        device_witness.disable()
        if arm_mark[0] is not None:
            armed_pulls[0] += (
                sum(device_witness.transfer_counts().values()) - arm_mark[0]
            )
            arm_mark[0] = None

    def seg():
        done = threading.Event()
        left = [rows]

        def emit(token, row):
            pass

        def fin(row, ok):
            left[0] -= 1
            if left[0] == 0:
                done.set()

        t0 = time.monotonic()
        for i in range(rows):
            loop.admit(f"witness-bench-{i}", tokens, emit, fin)
        assert done.wait(60), "decode rows never finished"
        return rows * tokens / (time.monotonic() - t0)

    try:
        on_qps, off_qps, deltas = _drift_cancelled_overhead(
            seg, arm, disarm, pairs
        )
        armed = device_witness.cross_check()
    finally:
        device_witness.disable()
        loop.stop()

    # the disarmed site cost itself, measured directly: one no-op
    # allowed_transfer scope (the only thing instrumented code pays on
    # every un-witnessed run), as ns/site and as a share of one step
    n = 200_000
    t0 = time.monotonic()
    for _ in range(n):
        with device_witness.allowed_transfer("bench.device-witness"):
            pass
    disarmed_ns = (time.monotonic() - t0) / n * 1e9
    if was_enabled:
        device_witness.enable()
    step_ns = rows / statistics.median(off_qps) * 1e9
    pulls = armed_pulls[0]
    bad = (
        len(armed["violations"])
        + len(armed["retrace_contradictions"])
        - len(baseline["violations"])
        - len(baseline["retrace_contradictions"])
    )
    return {
        "device_witness_overhead": {
            "decode_tok_s_witness_off": round(statistics.median(off_qps), 1),
            "decode_tok_s_witness_armed": round(statistics.median(on_qps), 1),
            "armed_overhead_pct": round(statistics.median(deltas), 2),
            "armed_overhead_pct_segments": [round(d, 1) for d in deltas],
            "disarmed_scope_ns": round(disarmed_ns, 1),
            "disarmed_scope_pct_of_step": round(
                100.0 * disarmed_ns / step_ns, 4
            ),
            "armed_manifested_pulls": pulls,
            "armed_violations": bad,
        }
    }


def bench_hbm_cache(
    sizes=(4096, 1 << 20),
    seg_calls=200,
    mb_calls=24,
    proof_calls=25,
    cluster_keys=12,
    cluster_calls=120,
    pairs=4,
    overhead_calls=150,
    device=None,
):
    """hbm_cache: the HBM-resident cluster cache tier's data plane
    (docs/cache.md), measured end to end over real RESP.  Three lanes:

      * host-value vs device-value GET qps at each payload size, hit
        and miss: ONE HBMCacheService front serves an ICI peer (the
        value leaves as a DeviceRef segment, HBM-resident, zero
        device->host pulls) and a TCP client (the sanctioned
        ``cache.host-spill`` choke point materializes bytes per GET).
        The acceptance number rides the 1MB point: the device lane
        must meet or beat the host lane (no serialize/copy on the hot
        path).  A separate UNTIMED witness-armed segment re-drives the
        device hit path and proves it: zero cache.host-spill pulls,
        zero violations — and one armed TCP GET proves the witness
        lane itself engaged (spill_manifested_pulls > 0, so a silently
        dead witness cannot fake the zero).
      * local-ICI vs DCN-spill split through CacheChannel: two
        replicas — one in the client's ICI neighborhood, one across
        the fabric.  Healthy traffic must stay local (the >=90%
        locality acceptance); then the local replica dies and the
        spill lane (miss-then-refill against the survivor) is timed.
      * cache-disabled overhead triplet (<1% budget, methodology
        _drift_cancelled_overhead): the full redis GET path with the
        cache front in DISABLED mode (plain host-bytes dict — the
        no-accelerator fallback) vs the plain KVRedisService it
        shadows.  The tier's bookkeeping (budget lock, metric adders,
        chaos site, per-connection residency dispatch) must be
        invisible when the device plane is off.

    Every store, ici:// port and channel lives on ``device`` (each
    one's card when None).
    """
    import statistics

    from incubator_brpc_tpu_torch.analysis import device_witness
    from incubator_brpc_tpu_torch.cache import CacheChannel, HBMCacheService
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.protocols import redis as R
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    def rcall(ch, *commands):
        req = R.RedisRequest()
        for cmd in commands:
            req.add_command(*cmd)
        resp = R.RedisResponse()
        ctrl = Controller()
        ch.call_method(R.redis_method_spec(), ctrl, req, resp)
        assert not ctrl.failed(), ctrl.error_text()
        return resp

    def get_loop(ch, key, calls):
        t0 = time.monotonic()
        for _ in range(calls):
            rcall(ch, ("GET", key))
        return calls / (time.monotonic() - t0)

    # ---- single-replica host/device lanes (slices 120+: the test
    # modules own 40-99, the ICI bench cases slice 0) -------------------
    svc = HBMCacheService(device=device)
    srv_ici = Server(ServerOptions(redis_service=svc))
    assert srv_ici.start_ici(120, 1, device=device) == 0
    srv_tcp = Server(ServerOptions(redis_service=svc))  # same store
    assert srv_tcp.start(0) == 0
    ch_ici = Channel(ChannelOptions(protocol="redis", timeout_ms=60000,
                                    ici_device=device))
    assert ch_ici.init("ici://slice120/chip1") == 0
    ch_tcp = Channel(ChannelOptions(protocol="redis", timeout_ms=60000))
    assert ch_tcp.init(f"127.0.0.1:{srv_tcp.port}") == 0

    get_qps = {}
    was_armed = device_witness.enabled()
    try:
        for size in sizes:
            key = b"v%d" % size
            rcall(ch_ici, ("SET", key, b"\xa5" * size))
            # warm both lanes (first device RPC loads the kernel) and
            # assert residency where it's decided: DeviceRef over ICI,
            # exact bytes over TCP
            r = rcall(ch_ici, ("GET", key)).reply(0)
            assert r.device_array() is not None, "ICI GET lost residency"
            r = rcall(ch_tcp, ("GET", key)).reply(0)
            assert r.device_array() is None and len(r.bytes_value()) == size
            calls = seg_calls if size <= (64 << 10) else mb_calls
            dev = get_loop(ch_ici, key, calls)
            host = get_loop(ch_tcp, key, calls)
            get_qps[str(size)] = {
                "device_hit_qps": round(dev, 1),
                "host_hit_qps": round(host, 1),
                "device_over_host": round(dev / host, 2),
            }
        assert rcall(ch_ici, ("GET", b"absent")).reply(0).is_nil()
        device_miss = get_loop(ch_ici, b"absent", seg_calls)
        host_miss = get_loop(ch_tcp, b"absent", seg_calls)

        # ---- witness-armed proof segment (untimed): the device hit
        # path must stay pull-free while the armed TCP spill manifests.
        # The baseline is taken here: the port's allowed_transfer counts
        # a scope disarmed too, so the timed TCP GETs above spilled on it
        baseline = device_witness.cross_check()
        device_witness.enable()
        proof_key = b"v%d" % sizes[0]
        for _ in range(proof_calls):
            assert rcall(ch_ici, ("GET", proof_key)).reply(0).device_array() \
                is not None
        mid = device_witness.cross_check()
        rcall(ch_tcp, ("GET", proof_key))  # the sanctioned spill
        armed = device_witness.cross_check()
    finally:
        if not was_armed:
            device_witness.disable()
        srv_ici.stop()
        srv_tcp.stop()
        ch_ici.close()
        ch_tcp.close()
    scope = "cache.host-spill"
    hit_path_pulls = (
        mid["scope_uses"].get(scope, 0) - baseline["scope_uses"].get(scope, 0)
    )
    spill_pulls = armed["scope_uses"].get(scope, 0) - mid["scope_uses"].get(
        scope, 0
    )
    hit_path_violations = (
        len(armed["violations"]) + len(armed["retrace_contradictions"])
        - len(baseline["violations"])
        - len(baseline["retrace_contradictions"])
    )

    # ---- local-ICI vs DCN-spill split through CacheChannel -----------
    srv_local = Server(ServerOptions(
        redis_service=HBMCacheService(device=device)))
    assert srv_local.start_ici(120, 2, device=device) == 0
    srv_remote = Server(ServerOptions(
        redis_service=HBMCacheService(device=device)))
    assert srv_remote.start_ici(121, 1, device=device) == 0
    cc = CacheChannel(
        "list://ici://slice120/chip2,ici://slice121/chip1",
        local_coords=(120, 9),
        options=ChannelOptions(timeout_ms=30000, ici_device=device),
    )
    local_stopped = False
    try:
        keys = [f"loc-{i}" for i in range(cluster_keys)]
        for k in keys:
            cc.set(k, b"\x5a" * 4096)
        for k in keys:  # warm the dispatch path untimed
            assert cc.get(k) is not None
        t0 = time.monotonic()
        for i in range(cluster_calls):
            assert cc.get(keys[i % len(keys)]) is not None
        local_qps = cluster_calls / (time.monotonic() - t0)
        b = cc.balancer()
        locality = cc.locality_fraction()
        picks_local = b.picks_local
        # kill the local replica: the tier is unreplicated, so the
        # spill lane is miss-then-refill against the survivor
        srv_local.stop()
        local_stopped = True
        for k in keys:
            if cc.get(k) is None:
                cc.set(k, b"\x5a" * 4096)
        spill_hits = 0
        t0 = time.monotonic()
        for i in range(cluster_calls):
            if cc.get(keys[i % len(keys)]) is not None:
                spill_hits += 1
        spill_qps = cluster_calls / (time.monotonic() - t0)
        picks_remote = b.picks_remote
    finally:
        cc.close()
        if not local_stopped:
            srv_local.stop()
        srv_remote.stop()

    # ---- cache-disabled overhead triplet (<1%) -----------------------
    svc_dis = HBMCacheService(enabled=False, device=device)
    srv_dis = Server(ServerOptions(redis_service=svc_dis))
    assert srv_dis.start(0) == 0
    svc_plain = R.KVRedisService()
    srv_plain = Server(ServerOptions(redis_service=svc_plain))
    assert srv_plain.start(0) == 0
    ch_dis = Channel(ChannelOptions(protocol="redis", timeout_ms=30000))
    assert ch_dis.init(f"127.0.0.1:{srv_dis.port}") == 0
    ch_plain = Channel(ChannelOptions(protocol="redis", timeout_ms=30000))
    assert ch_plain.init(f"127.0.0.1:{srv_plain.port}") == 0
    rcall(ch_dis, ("SET", b"ov", b"\x11" * 4096))
    rcall(ch_plain, ("SET", b"ov", b"\x11" * 4096))
    target = [ch_plain]

    def seg():
        return get_loop(target[0], b"ov", overhead_calls)

    try:
        on_qps, off_qps, deltas = _drift_cancelled_overhead(
            seg,
            lambda: target.__setitem__(0, ch_dis),
            lambda: target.__setitem__(0, ch_plain),
            pairs,
        )
    finally:
        srv_dis.stop()
        srv_plain.stop()
        ch_dis.close()
        ch_plain.close()

    out = {
        "get_qps": get_qps,
        "device_miss_qps": round(device_miss, 1),
        "host_miss_qps": round(host_miss, 1),
        "witness_armed": True,
        "hit_path_spill_pulls": hit_path_pulls,
        "spill_manifested_pulls": spill_pulls,
        "hit_path_violations": hit_path_violations,
        "cluster": {
            "local_get_qps": round(local_qps, 1),
            "spill_get_qps": round(spill_qps, 1),
            "locality_fraction": round(locality, 3),
            "picks_local": picks_local,
            "picks_remote_after_kill": picks_remote,
            "spill_hits": spill_hits,
        },
        "cache_disabled_overhead": {
            "get_4kb_qps_cache_disabled": round(statistics.median(on_qps), 1),
            "get_4kb_qps_plain_kv": round(statistics.median(off_qps), 1),
            "overhead_pct": round(statistics.median(deltas), 2),
            "overhead_pct_segments": [round(d, 1) for d in deltas],
        },
    }
    if str(1 << 20) in get_qps:
        out["device_over_host_1mb"] = get_qps[str(1 << 20)]["device_over_host"]
    return {"hbm_cache": out}


def bench_batched_device_op(
    parallelism=(1, 8, 32),
    batch_sizes=(1, 8, 32),
    duration_s=1.0,
    dim=6144,
    device=None,
):
    """Server-side micro-batching on the PsService device op
    (docs/batching.md): N concurrent Forward calls (y = x @ W against a
    stored (dim, dim) parameter matrix), batching OFF vs ON at a
    max_batch_size sweep.  ON coalesces concurrent requests into ONE
    fused GEMM (batching/fused.FusedKernel) — this is where batching
    genuinely pays: each unbatched matvec streams all of W from memory
    (bandwidth-bound), while the batched (rows, dim) @ W streams W once
    for the whole batch, so per-row device cost collapses.  The
    acceptance shape is ≥3x the unbatched throughput at parallelism ≥16
    with p99 ≤ 2x the unbatched p50.

    Each point reports measured qps / p50 / p99 plus the server
    batcher's observed batch stats — a silently-disabled batcher shows
    up as observed_max_batch == 1 (the bench-smoke guard pins this).
    batch size 1 documents the off-equivalence: an off policy never
    builds a Batcher, so the point rides the existing dispatch path.
    W lives on ``device`` (the card when None).
    """
    import numpy as np

    from incubator_brpc_tpu_torch.batching.policy import BatchPolicy
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.parameter_server import (
        _FORWARD_KERNEL,
        PsService,
        ps_stub,
    )
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    srv = Server(ServerOptions())  # batching toggled per point below
    svc = PsService(device=device)
    srv.add_service(svc)
    assert srv.start(0) == 0
    # seed the store with a DEVICE parameter matrix directly: the fused
    # GEMM is server-side; TCP carries only the (dim,) input/output rows
    w_dev = torch.full((dim, dim), 1.0 / dim, dtype=torch.float32,
                       device=svc._device)
    svc._store["w"] = w_dev
    req = EchoRequest(message="w")
    x_bytes = np.ones(dim, np.float32).tobytes()

    def run_point(inflight, duration):
        """Drive `inflight` outstanding async Forwards for `duration`.

        Parallelism here = concurrent in-flight requests (the load-
        generator definition): each completion's done callback issues
        the next call, so offered concurrency stays constant without
        one blocked OS thread per request — N sync threads on a small
        host measure GIL/scheduler churn, not the server.  Connections
        and first calls warm up BEFORE the timed window (a cold-connect
        convoy inside a 1s window reads as a phantom p99)."""
        n_channels = min(4, inflight)
        channels, stubs = [], []
        for _ in range(n_channels):
            ch = Channel(ChannelOptions(timeout_ms=20000))
            ch.init(f"127.0.0.1:{srv.port}")
            stub = ps_stub(ch)
            for _ in range(2):  # connect + warm the path
                c = Controller()
                c.request_attachment.append_user_data(x_bytes)
                stub.Forward(c, req)
            channels.append(ch)
            stubs.append(stub)

        lats, oks, lock = [], [0], threading.Lock()
        active = [inflight]
        drained = threading.Event()
        stop_at = time.monotonic() + duration

        def issue(slot):
            c = Controller()
            c.request_attachment.append_user_data(x_bytes)
            t0 = time.monotonic_ns()

            def on_done():
                now = time.monotonic()
                with lock:
                    if not c.failed():
                        oks[0] += 1
                        lats.append((time.monotonic_ns() - t0) // 1000)
                if now < stop_at:
                    issue(slot)
                    return
                with lock:
                    active[0] -= 1
                    if active[0] == 0:
                        drained.set()

            stubs[slot % n_channels].Forward(c, req, done=on_done)

        for slot in range(inflight):
            issue(slot)
        drained.wait(timeout=duration + 60)
        for ch in channels:
            ch.close()
        lats.sort()
        pct = lambda p: lats[min(len(lats) - 1, int(len(lats) * p))] if lats else 0  # noqa: E731
        return {
            "qps": round(oks[0] / duration, 1),
            "ok": oks[0],
            "p50_us": pct(0.50),
            "p99_us": pct(0.99),
        }

    def buckets_to(b):
        out = [1]
        while out[-1] < b:
            out.append(out[-1] * 2)
        return tuple(out)

    # pre-warm the fused kernel at every padding bucket this sweep can
    # touch: the first product of a (bucket, dim) shape picks and loads
    # its GEMM kernel, and that landing inside a measured window would
    # read as a p99 outlier
    for b in buckets_to(max(batch_sizes)):
        _FORWARD_KERNEL(w_dev, torch.zeros((b, dim), dtype=torch.float32,
                                           device=w_dev.device))

    points = []
    try:
        for threads in parallelism:
            base = None
            for cfg in ["off"] + [f"on{b}" for b in batch_sizes]:
                if cfg == "off":
                    srv.disable_method_batching("PsService.Forward")
                    batcher = None
                else:
                    b = int(cfg[2:])
                    batcher = srv.enable_method_batching(
                        "PsService.Forward",
                        BatchPolicy(
                            max_batch_size=b,
                            max_wait_us=3000,
                            padding_buckets=buckets_to(b),
                        ),
                    )
                point = run_point(threads, duration_s)
                point.update(
                    {
                        "parallelism": threads,
                        "config": cfg,
                        "observed_max_batch": (
                            batcher.max_batch_seen if batcher else 1
                        ),
                        "observed_batches": batcher.batches if batcher else 0,
                    }
                )
                if cfg == "off":
                    base = point
                else:
                    point["speedup_vs_off"] = round(
                        point["qps"] / base["qps"], 2
                    ) if base and base["qps"] else 0.0
                    point["p99_vs_off_p50"] = round(
                        point["p99_us"] / base["p50_us"], 2
                    ) if base and base["p50_us"] else 0.0
                points.append(point)
    finally:
        srv.disable_method_batching("PsService.Forward")
        srv.stop()
    # headline: best ON speedup at the highest parallelism
    hi = max(parallelism)
    on_hi = [p for p in points if p["parallelism"] == hi and p["config"] != "off"]
    best = max(on_hi, key=lambda p: p["qps"]) if on_hi else None
    return {
        "batched_device_op": {
            "points": points,
            "best_speedup_at_p%d" % hi: best["speedup_vs_off"] if best else 0.0,
            "best_config_at_p%d" % hi: best["config"] if best else "",
        }
    }


def bench_sharded_ps(
    shards=(1, 2, 4, 8),
    parallelism=(1, 8, 32),
    duration_s=1.0,
    dim=2048,
    hbm_budget_bytes=8 << 20,
    device=None,
):
    """Pod-scale sharded parameter server (docs/sharded_ps.md): the
    batched PsService Forward with W row-sharded across a ("slice",
    "chip") mesh and the GEMM lowered through the port's
    ShardedFusedKernel — one sharded execution per batch, partials
    merged by ONE psum collective.  Sweeps shard count x parallelism;
    each point reports qps/p50/p99 plus the PROOF counters
    (fused_executions / collective_merges vs batches — step-log counts,
    never timing; the bench-smoke guard pins fused_executions ==
    batches so a silently-unsharded fallback fails loudly).

    Acceptance shape (the JAX bench's, on >=4 chips):
      * max-servable sweep: with a synthetic per-chip HBM budget,
        >=4 shards serve a W at least 2x the single-chip-servable d
        (verified by placement: no chip holds more than its budget);
      * sharded qps at the highest parallelism >= 0.8x the single-chip
        batched qps for a single-chip-sized W (sharding overhead
        bounded — the psum + resharded X cost);
      * sharded_unsharded_overhead: a mesh-enabled service serving an
        UNSHARDED key stays on the existing path at ~0% (<1% budget,
        OFF/ON/OFF triplets).

    Runs in this process on the port's single-controller mesh: chip
    ``j`` on ``device_for_chip(j, device)``, so on one card every shard
    count is virtual chips on ``cuda:0`` (``device`` given, every chip
    on it).  It never re-executes itself on virtual CPU devices, as the
    JAX bench does when it sees fewer than 4."""
    return {"sharded_ps": _bench_sharded_ps_impl(
        shards, parallelism, duration_s, dim, hbm_budget_bytes,
        device=device,
    )}


def _bench_sharded_ps_impl(
    shards=(1, 2, 4, 8),
    parallelism=(1, 8, 32),
    duration_s=1.0,
    dim=2048,
    hbm_budget_bytes=8 << 20,
    overhead_pairs=6,
    overhead_calls=120,
    device=None,
):
    import statistics

    import numpy as np

    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.parameter_server import (
        _FORWARD_KERNEL,
        PsService,
        max_servable_dim,
        ps_stub,
    )
    from incubator_brpc_tpu_torch.parallel.mesh import create_mesh
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest, EchoResponse
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    def mesh_of(k):
        # chip j of a (1, k) mesh: device_for_chip(j, device) — virtual
        # chips when k exceeds the cards
        return create_mesh(
            (1, k), devices=[device_for_chip(j, device) for j in range(k)]
        )
    req = EchoRequest(message="w")
    x_bytes = np.ones(dim, np.float32).tobytes()

    def run_point(port, inflight, duration):
        """Self-clocking async load (the bench_batched_device_op
        shape): `inflight` outstanding Forwards, completions reissue."""
        n_channels = min(4, inflight)
        channels, stubs = [], []
        for _ in range(n_channels):
            ch = Channel(ChannelOptions(timeout_ms=30000))
            ch.init(f"127.0.0.1:{port}")
            stub = ps_stub(ch)
            for _ in range(2):
                c = Controller()
                c.request_attachment.append_user_data(x_bytes)
                stub.Forward(c, req)
            channels.append(ch)
            stubs.append(stub)
        lats, oks, lock = [], [0], threading.Lock()
        active = [inflight]
        drained = threading.Event()
        stop_at = time.monotonic() + duration

        def issue(slot):
            c = Controller()
            c.request_attachment.append_user_data(x_bytes)
            t0 = time.monotonic_ns()

            def on_done():
                now = time.monotonic()
                with lock:
                    if not c.failed():
                        oks[0] += 1
                        lats.append((time.monotonic_ns() - t0) // 1000)
                if now < stop_at:
                    issue(slot)
                    return
                with lock:
                    active[0] -= 1
                    if active[0] == 0:
                        drained.set()

            stubs[slot % n_channels].Forward(c, req, done=on_done)

        for slot in range(inflight):
            issue(slot)
        drained.wait(timeout=duration + 60)
        for ch in channels:
            ch.close()
        lats.sort()
        pct = lambda p: lats[min(len(lats) - 1, int(len(lats) * p))] if lats else 0  # noqa: E731
        return {
            "qps": round(oks[0] / duration, 1),
            "ok": oks[0],
            "p50_us": pct(0.50),
            "p99_us": pct(0.99),
        }

    W = (np.random.RandomState(7).rand(dim, dim).astype(np.float32) / dim)
    points = []
    base_qps = {}
    for k in shards:
        mesh = mesh_of(k) if k > 1 else None
        svc = PsService(mesh=mesh, device=device)
        srv = Server(ServerOptions(enable_batching=True))
        srv.add_service(svc)
        assert srv.start(0) == 0
        sharded = svc.put_param("w", W)
        kern = svc.shard_kernel
        w_stored = svc._store["w"]
        # pre-warm every padding bucket this sweep can touch (a GEMM
        # kernel picked and loaded inside a measured window reads as a
        # phantom p99)
        for b in (1, 2, 4, 8, 16, 32):
            X = np.zeros((b, dim), np.float32)
            if sharded:
                kern(w_stored, X)
            else:
                _FORWARD_KERNEL(w_stored, torch.from_numpy(X).to(w_stored.device))
        batcher = srv.batcher("PsService.Forward")
        try:
            for par in parallelism:
                e0 = kern.executions if kern else 0
                m0 = kern.collective_merges if kern else 0
                b0 = batcher.batches
                point = run_point(srv.port, par, duration_s)
                point.update({
                    "shards": k,
                    "parallelism": par,
                    "sharded": bool(sharded),
                    "batches": batcher.batches - b0,
                    "fused_executions": (kern.executions - e0) if kern else 0,
                    "collective_merges": (
                        kern.collective_merges - m0
                    ) if kern else 0,
                    "observed_max_batch": batcher.max_batch_seen,
                })
                if k == shards[0]:
                    base_qps[par] = point["qps"]
                elif base_qps.get(par):
                    point["speedup_vs_unsharded"] = round(
                        point["qps"] / base_qps[par], 3
                    )
                points.append(point)
        finally:
            srv.stop()

    # ---- max-servable sweep: the HBM ceiling, proven by placement ----------
    servable = []
    for k in shards:
        d_k = max_servable_dim(hbm_budget_bytes, k)
        entry = {"shards": k, "max_servable_d": d_k,
                 "total_bytes": d_k * d_k * 4}
        if k > 1:
            mesh = mesh_of(k)
            svc = PsService(mesh=mesh, device=device)
            big = torch.zeros((d_k, d_k), dtype=torch.float32,
                              device=svc._device)
            assert svc.put_param("big", big) is True
            # ShardedTensor.shards: one tensor per chip, the port's
            # addressable_shards
            per_shard = max(int(t.nbytes) for t in svc._store["big"].shards)
            entry["per_shard_bytes"] = per_shard
            entry["fits_budget"] = per_shard <= hbm_budget_bytes
            # serve it: one batched Forward against the oversized W
            c = Controller()
            c.request_attachment.append_user_data(
                np.ones(d_k, np.float32).tobytes()
            )
            PsService.Forward(
                svc, c, EchoRequest(message="big"), EchoResponse(),
                lambda: None,
            )
            entry["served"] = not c.failed()
            del svc, big
        else:
            entry["per_shard_bytes"] = d_k * d_k * 4
            entry["fits_budget"] = True
            entry["served"] = True
        servable.append(entry)
    d_single = servable[0]["max_servable_d"]
    d_best = max(e["max_servable_d"] for e in servable)

    # ---- disabled-cost triplet: mesh-enabled service, UNSHARDED key --------
    mesh = mesh_of(shards[-1]) if shards[-1] > 1 else None
    # starts mesh-less; set_on attaches the kernel
    svc = PsService(device=device)
    shard_kernel = PsService(mesh=mesh, device=device).shard_kernel \
        if mesh is not None else None
    srv = Server(ServerOptions(enable_batching=True))
    srv.add_service(svc)
    assert srv.start(0) == 0
    svc.put_param("w", W)  # unsharded either way: rides the existing path
    _FORWARD_KERNEL(svc._store["w"], torch.zeros(
        (1, dim), dtype=torch.float32, device=svc._device))
    ch = Channel(ChannelOptions(timeout_ms=30000))
    ch.init(f"127.0.0.1:{srv.port}")
    stub = ps_stub(ch)

    def seg():
        t0 = time.monotonic()
        for _ in range(overhead_calls):
            c = Controller()
            c.request_attachment.append_user_data(x_bytes)
            stub.Forward(c, req)
        return overhead_calls / (time.monotonic() - t0)

    def set_on():
        svc._shard_kernel = shard_kernel

    def set_off():
        svc._shard_kernel = None

    try:
        on_qps, off_qps, deltas = _drift_cancelled_overhead(
            seg, set_on, set_off, overhead_pairs
        )
    finally:
        set_off()
        srv.stop()
        ch.close()

    hi = max(parallelism)
    hi_sharded = [
        p for p in points if p["parallelism"] == hi and p["sharded"]
    ]
    best_hi = max(hi_sharded, key=lambda p: p["qps"]) if hi_sharded else None
    return {
        "dim": dim,
        "points": points,
        "max_servable": {
            "per_chip_budget_bytes": hbm_budget_bytes,
            "sweep": servable,
            "single_chip_d": d_single,
            "best_sharded_d": d_best,
            "ratio_vs_single_chip": round(d_best / d_single, 2)
            if d_single else 0.0,
        },
        "sharded_vs_unsharded_qps_at_p%d" % hi: (
            best_hi.get("speedup_vs_unsharded", 0.0) if best_hi else 0.0
        ),
        "sharded_unsharded_overhead": {
            "qps_mesh_enabled": round(statistics.median(on_qps), 1),
            "qps_mesh_none": round(statistics.median(off_qps), 1),
            "overhead_pct": round(statistics.median(deltas), 2),
            "overhead_pct_segments": [round(d, 1) for d in deltas],
        },
    }


def bench_batching_off_overhead(payload=4096, seg_calls=500, pairs=8,
                                device=None):
    """batching_disabled_overhead: cost of the micro-batching dispatch
    gate on an UNBATCHED method's hot path.  Two states compared with
    the OFF/ON/OFF drift-cancelling triplets:

      OFF — no Batcher registered anywhere: the gate is one falsy
            empty-dict test per request;
      ON  — a live Batcher on a DIFFERENT method (PsService.Get), the
            worst adjacent state: the echo path additionally pays the
            dict lookup + miss.

    Budget: <1% — both states are a handful of ns against a ~10us/call
    path; anything visible means the gate grew a lock or a loop."""
    import statistics

    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
    from incubator_brpc_tpu_torch.models.parameter_server import PsService
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    srv = Server(ServerOptions(usercode_in_dispatcher=True))
    srv.add_service(EchoService(attach_echo=False))
    srv.add_service(PsService(device=device))
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=10000))
    ch.init(f"127.0.0.1:{srv.port}")
    stub = echo_stub(ch)
    msg = "x" * payload

    def seg():
        t0 = time.monotonic()
        for _ in range(seg_calls):
            c = Controller()
            stub.Echo(c, EchoRequest(message=msg))
        return seg_calls / (time.monotonic() - t0)

    try:
        on_qps, off_qps, deltas = _drift_cancelled_overhead(
            seg,
            lambda: srv.enable_method_batching("PsService.Get"),
            lambda: srv.disable_method_batching("PsService.Get"),
            pairs,
        )
    finally:
        srv.disable_method_batching("PsService.Get")
        srv.stop()
        ch.close()
    return {
        "batching_disabled_overhead": {
            "echo_4kb_qps_no_batchers": round(statistics.median(off_qps), 1),
            "echo_4kb_qps_other_method_batched": round(
                statistics.median(on_qps), 1
            ),
            "overhead_pct": round(statistics.median(deltas), 2),
            "overhead_pct_segments": [round(d, 1) for d in deltas],
        }
    }


def bench_streaming_generate(parallelism=(1, 8, 32), tokens=64, dim=64,
                             step_delay_s=0.0, device=None):
    """Continuous-batched token-streaming inference (streaming/
    generate.py; docs/streaming.md): P concurrent streamed Generate
    calls against ONE DecodeLoop.  Each decode step fuses every live
    row into one padded device execution and emits one token FRAME per
    row onto its stream, so tokens/s should scale with parallelism
    while per-step cost stays ~flat — the acceptance shape is ≥2x the
    single-stream tokens/s at parallelism 32 with rows joining and
    leaving mid-stream.

    Per point: aggregate tokens/s, per-stream inter-token gap p50/p99,
    median time-to-first-token, and the loop/service counters that
    prove the streams were real (every row streamed — zero unary
    fallbacks — and rows joined while others were mid-generation).
    """
    import statistics

    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.client.stream import Stream, StreamHandler
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server
    from incubator_brpc_tpu_torch.streaming.generate import (
        DecodeLoop,
        GenerateService,
        generate_stub,
    )

    # step_delay_s paces the decode loop (0 in the headline run): the
    # smoke guard uses a small delay so admission round trips land
    # INSIDE a generation deterministically — overlap by construction,
    # not by racing the decoder
    loop = DecodeLoop(dim=dim, step_delay_s=step_delay_s, device=device)
    loop.prewarm()  # no first-use kernel load inside a measured window
    svc = GenerateService(loop=loop)
    srv = Server()
    srv.add_service(svc)
    assert srv.start(0) == 0

    class _Sink(StreamHandler):
        def __init__(self):
            self.stamps = []
            self.closed = threading.Event()
            self.close_stamp = 0.0

        def on_received_messages(self, stream, messages):
            now = time.monotonic()
            self.stamps.extend(now for _ in messages)

        def on_closed(self, stream):
            self.close_stamp = time.monotonic()
            self.closed.set()

    def run_point(p):
        joins_before = loop.mid_stream_joins
        channels = []
        for _ in range(min(4, p)):
            ch = Channel(ChannelOptions(timeout_ms=60000))
            ch.init(f"127.0.0.1:{srv.port}")
            channels.append(ch)
        stubs = [generate_stub(ch) for ch in channels]
        sinks = []
        t0 = time.monotonic()
        for i in range(p):
            sink = _Sink()
            c = Controller()
            Stream.create(c, sink)
            r = stubs[i % len(stubs)].Generate(
                c, EchoRequest(message=f"prompt-{i}", code=tokens)
            )
            assert not c.failed(), c.error_text()
            assert r.message == "streaming", "silent unary fallback"
            sinks.append(sink)
        for sink in sinks:
            assert sink.closed.wait(120), "stream never closed"
        wall = time.monotonic() - t0
        for ch in channels:
            ch.close()
        got = sum(len(s.stamps) for s in sinks)
        gaps = []
        first_tokens = []
        progressive = 0
        for s in sinks:
            if s.stamps:
                first_tokens.append(s.stamps[0] - t0)
                if s.stamps[0] < s.close_stamp:
                    progressive += 1
            gaps.extend(
                b - a for a, b in zip(s.stamps, s.stamps[1:])
            )
        gaps.sort()
        pct = lambda q: (  # noqa: E731
            int(gaps[min(len(gaps) - 1, int(len(gaps) * q))] * 1e6)
            if gaps else 0
        )
        return {
            "parallelism": p,
            "tokens": got,
            "tokens_per_s": round(got / wall, 1),
            "inter_token_p50_us": pct(0.50),
            "inter_token_p99_us": pct(0.99),
            "first_token_ms_median": round(
                statistics.median(first_tokens) * 1000, 2
            ) if first_tokens else 0.0,
            "progressive_streams": progressive,
            "mid_stream_joins": loop.mid_stream_joins - joins_before,
            "max_fused": loop.max_fused,
        }

    points = []
    try:
        run_point(min(parallelism))  # warm connections + first frames
        for p in parallelism:
            points.append(run_point(p))
    finally:
        srv.stop()
        svc.close()
    base = next(p for p in points if p["parallelism"] == min(parallelism))
    hi = max(points, key=lambda p: p["parallelism"])
    return {
        "streaming_generate": {
            "points": points,
            "speedup_p%d_vs_p%d" % (hi["parallelism"], base["parallelism"]):
                round(hi["tokens_per_s"] / base["tokens_per_s"], 2)
                if base["tokens_per_s"] else 0.0,
            "streamed_rows": svc.streamed_rows,
            "unary_rows": svc.unary_rows,
        }
    }


def bench_disagg_serving(parallelism=(1, 8, 32), tokens=32, dim=32,
                         n_layers=3, n_replicas=2,
                         migrate_tokens=48, migrate_sessions=4,
                         migrate_step_delay_s=0.004, device=None):
    """Disaggregated prefill/decode serving (serving/; docs/serving.md)
    vs the monolithic decode loop behind GenerateService.  Three
    segments:

      points     — P concurrent sessions through the SessionChannel
                   (prefill ONCE per session, KV shipped HBM→HBM into
                   the cache, decode admitted by one fused DMGET) vs P
                   concurrent rows on ONE monolithic DecodeLoop:
                   aggregate tokens/s and median time-to-first-token
                   for each.  The acceptance shape is disagg tokens/s
                   within the same order as monolithic (the split must
                   not tax steady-state decode) while TTFT stays flat
                   as P grows — prefill batches, decode admission is a
                   cache pull.
      migration  — sessions in flight on a paced tier, half of them
                   live-migrated mid-generation: every session
                   completes, prefill_executions stays 1 per session
                   (the KV-reuse proof — migration NEVER recomputes
                   prefill) and the serving_prefill_reuse counter
                   advances once per re-homed leg.
      rpc_front  — one session over the real wire (Prefill RPC +
                   streamed Admit): the token front must be a real
                   stream, zero unary fallbacks.
    """
    import statistics

    from incubator_brpc_tpu_torch.cache.store import HBMCacheStore
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.client.stream import Stream, StreamHandler
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server
    from incubator_brpc_tpu_torch.serving import metrics as serving_metrics
    from incubator_brpc_tpu_torch.serving import session as sv_session
    from incubator_brpc_tpu_torch.serving.decode import DecodeService, decode_stub
    from incubator_brpc_tpu_torch.serving.prefill import PrefillService, prefill_stub
    from incubator_brpc_tpu_torch.serving.router import SessionChannel
    from incubator_brpc_tpu_torch.streaming.generate import DecodeLoop

    sv_session.clear_registry()
    counters0 = serving_metrics.snapshot()

    store = HBMCacheStore(hbm_budget_bytes=1 << 26, device=device)
    pf = PrefillService(store, dim=dim, n_layers=n_layers, device=device)
    reps = [
        DecodeService(store, DecodeLoop(dim=dim, device=device),
                      name=f"bench-d{i}", max_sessions=256)
        for i in range(n_replicas)
    ]
    ch = SessionChannel(pf, reps)
    mono = DecodeLoop(dim=dim, device=device)
    mono.prewarm()
    ch.generate("bd-warm", "warmup prompt", 2)  # first-use loads off-clock

    def run_point(p, tag):
        # -- disagg: P concurrent sessions through the router
        firsts = [None] * p
        t0 = time.monotonic()

        def sess(i):
            def on_token(idx, tok, i=i):
                if firsts[i] is None:
                    firsts[i] = time.monotonic() - t0

            r = ch.generate(f"bd-{tag}-{i}", f"point prompt {i}", tokens,
                            on_token=on_token)
            assert len(r.tokens) == tokens

        ts = [threading.Thread(target=sess, args=(i,)) for i in range(p)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
        disagg_wall = time.monotonic() - t0

        # -- monolithic: P rows on one DecodeLoop
        mono_firsts = [None] * p
        dones = [threading.Event() for _ in range(p)]
        m0 = time.monotonic()
        for i in range(p):
            def emit(tok, row, i=i):
                if mono_firsts[i] is None:
                    mono_firsts[i] = time.monotonic() - m0

            mono.admit(f"point prompt {i}", tokens, emit,
                       lambda row, ok, i=i: dones[i].set())
        for d in dones:
            assert d.wait(120), "monolithic row never finished"
        mono_wall = time.monotonic() - m0

        med = lambda xs: round(  # noqa: E731
            statistics.median([x for x in xs if x is not None]) * 1000, 2
        )
        return {
            "parallelism": p,
            "disagg_tokens_per_s": round(p * tokens / disagg_wall, 1),
            "mono_tokens_per_s": round(p * tokens / mono_wall, 1),
            "disagg_ttft_ms_median": med(firsts),
            "mono_ttft_ms_median": med(mono_firsts),
        }

    # -- migration-under-load segment: a paced tier so migrations land
    # mid-generation deterministically
    def run_migration():
        mstore = HBMCacheStore(hbm_budget_bytes=1 << 26, device=device)
        mpf = PrefillService(mstore, dim=dim, n_layers=n_layers,
                             device=device)
        mreps = [
            DecodeService(
                mstore,
                DecodeLoop(dim=dim, step_delay_s=migrate_step_delay_s,
                           device=device),
                name=f"bench-m{i}", max_sessions=256,
            )
            for i in range(max(2, n_replicas))
        ]
        mch = SessionChannel(mpf, mreps)
        results = [None] * migrate_sessions
        started = [threading.Event() for _ in range(migrate_sessions)]

        def sess(i):
            def on_token(idx, tok, i=i):
                started[i].set()

            results[i] = mch.generate(
                f"bd-mig-{i}", f"migration prompt {i}", migrate_tokens,
                on_token=on_token,
            )

        try:
            ts = [
                threading.Thread(target=sess, args=(i,))
                for i in range(migrate_sessions)
            ]
            t0 = time.monotonic()
            for t in ts:
                t.start()
            for ev in started:
                assert ev.wait(60), "session never produced a token"
            migrated = 0
            for i in range(0, migrate_sessions, 2):
                if mch.migrate(f"bd-mig-{i}", reason="bench rebalance"):
                    migrated += 1
            for t in ts:
                t.join(120)
            wall = time.monotonic() - t0
            assert all(r is not None for r in results)
            return {
                "sessions": migrate_sessions,
                "migrations_live": migrated,
                "completed": sum(
                    1 for r in results if len(r.tokens) == migrate_tokens
                ),
                "prefill_executions_max": max(
                    r.prefill_executions for r in results
                ),
                "tokens_per_s_under_migration": round(
                    migrate_sessions * migrate_tokens / wall, 1
                ),
            }
        finally:
            for r in mreps:
                r.close()

    # -- rpc_front segment: the wire shape, streamed-front proof
    def run_rpc_front():
        rstore = HBMCacheStore(hbm_budget_bytes=1 << 24, device=device)
        rpf = PrefillService(rstore, dim=dim, n_layers=n_layers,
                             device=device)
        rdec = DecodeService(rstore, DecodeLoop(dim=dim, device=device),
                             name="bench-rpc")
        psrv, dsrv = Server(), Server()
        psrv.add_service(rpf)
        dsrv.add_service(rdec)
        assert psrv.start(0) == 0 and dsrv.start(0) == 0
        pch = Channel(ChannelOptions(timeout_ms=30000))
        dch = Channel(ChannelOptions(timeout_ms=30000))
        assert pch.init(f"127.0.0.1:{psrv.port}") == 0
        assert dch.init(f"127.0.0.1:{dsrv.port}") == 0

        class _Sink(StreamHandler):
            def __init__(self):
                self.frames = []
                self.closed = threading.Event()

            def on_received_messages(self, stream, messages):
                self.frames.extend(messages)

            def on_closed(self, stream):
                self.closed.set()

        try:
            c = Controller()
            prefill_stub(pch).Prefill(c, EchoRequest(message=json.dumps(
                {"session": "bd-rpc", "prompt": "wire prompt"})))
            assert not c.failed(), c.error_text()
            sink = _Sink()
            c2 = Controller()
            stream = Stream.create(c2, sink)
            r2 = decode_stub(dch).Admit(c2, EchoRequest(message=json.dumps(
                {"session": "bd-rpc", "kv_epoch": 0, "n_layers": n_layers,
                 "max_tokens": tokens})))
            assert not c2.failed(), c2.error_text()
            assert r2.message == "streaming", "silent unary fallback"
            assert stream.wait_established(10)
            assert sink.closed.wait(60), "token stream never closed"
            return {
                "frames": len(sink.frames),
                "streamed_rows": rdec.streamed_rows,
                "unary_fallback_rows": rdec.unary_rows,
            }
        finally:
            pch.close()
            dch.close()
            psrv.stop()
            dsrv.stop()
            rdec.close()

    points = []
    try:
        run_point(min(parallelism), "pre")  # warm threads + connections
        for p in parallelism:
            points.append(run_point(p, f"p{p}"))
        migration = run_migration()
        rpc_front = run_rpc_front()
    finally:
        for r in reps:
            r.close()
        mono.stop()
        sv_session.clear_registry()

    counters = serving_metrics.snapshot()
    return {
        "disagg_serving": {
            "points": points,
            "migration": migration,
            "rpc_front": rpc_front,
            "prefill_reuse": counters["prefill_reuse"]
                - counters0["prefill_reuse"],
            "unary_fallback_rows": rpc_front["unary_fallback_rows"],
        }
    }


def bench_admission_off_overhead(payload=4096, seg_calls=500, pairs=8):
    """admission_disabled_overhead: cost of the unified admission gate
    on the echo hot path (docs/overload.md).  Two states compared with
    the OFF/ON/OFF drift-cancelling triplets:

      OFF — the default INACTIVE policy: admit() is one activity check
            plus the pre-existing concurrency-gate call;
      ON  — an ACTIVE policy (a bulk tier mapping for an unrelated
            tenant + a tenant quota), the worst adjacent state: the
            untenanted echo path additionally resolves its tier and
            takes the top-tier short-circuit.

    Budget: <1% — both states are a handful of dict reads against a
    ~10us/call path; anything visible means the gate grew a lock or an
    allocation."""
    import statistics

    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.admission import AdmissionPolicy
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    srv = Server(ServerOptions(usercode_in_dispatcher=True))
    srv.add_service(EchoService(attach_echo=False))
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=10000))
    ch.init(f"127.0.0.1:{srv.port}")
    stub = echo_stub(ch)
    msg = "x" * payload
    active = AdmissionPolicy(
        tenant_tiers={"batch-ingest": "bulk"},
        tenant_quotas={"batch-ingest": 8},
    )

    def seg():
        t0 = time.monotonic()
        for _ in range(seg_calls):
            c = Controller()
            stub.Echo(c, EchoRequest(message=msg))
        return seg_calls / (time.monotonic() - t0)

    try:
        on_qps, off_qps, deltas = _drift_cancelled_overhead(
            seg,
            lambda: srv.set_admission_policy(active),
            lambda: srv.set_admission_policy(None),
            pairs,
        )
    finally:
        srv.set_admission_policy(None)
        srv.stop()
        ch.close()
    return {
        "admission_disabled_overhead": {
            "echo_4kb_qps_admission_inactive": round(
                statistics.median(off_qps), 1
            ),
            "echo_4kb_qps_admission_active_other_tenant": round(
                statistics.median(on_qps), 1
            ),
            "overhead_pct": round(statistics.median(deltas), 2),
            "overhead_pct_segments": [round(d, 1) for d in deltas],
        }
    }


def bench_overload_storm(
    replicas=3,
    bulk_threads=4,
    interactive_threads=3,
    calls_per_thread=14,
    bulk_sleep_us=40_000,
    hedge_calls=24,
):
    """Multi-tenant overload under a chaos storm (docs/overload.md):

    Phase 1 — a cluster of `replicas` echo servers with a tiered
    admission policy (tenant "batch" → bulk) serving mixed interactive
    + bulk load, measured with the storm OFF then ON (seeded plan:
    25% link resets on every replica + one slow replica).  Reports
    per-tier qps / p50 / p99 and shed counts by tier — the acceptance
    shape is the interactive tier's p99 holding while sheds land on
    the bulk tier.

    Phase 2 — hedged requests vs a slow replica: a 2-replica cluster
    where s0 batches with a long window (rows queue ~300ms) and s1
    answers immediately; the same call sequence with backup_request_ms
    off vs on.  Hedging should collapse p99 toward the fast replica's
    latency, and loser cancellation is verified structurally: the slow
    replica's batch handler executes ZERO rows (cancel frames shed
    them while queued — `rpc_shed_total{reason="cancelled"}`)."""
    import statistics

    from incubator_brpc_tpu_torch.chaos import injector as chaos_injector
    from incubator_brpc_tpu_torch.chaos.storm import storm_plan
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest, EchoResponse
    from incubator_brpc_tpu_torch.server.admission import (
        AdmissionPolicy,
        rpc_shed_total,
    )
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
    from incubator_brpc_tpu_torch.server.service import Service, batched_method

    class TaggedEcho(EchoService):
        SERVICE_NAME = "EchoService"

        def __init__(self, tag):
            super().__init__(attach_echo=False)
            self.tag = tag

        def Echo(self, controller, request, response, done):
            response.message = self.tag
            if request.sleep_us:
                time.sleep(request.sleep_us / 1e6)
            done()

    servers = []
    for i in range(replicas):
        srv = Server(ServerOptions(
            method_max_concurrency="constant=2",
            admission_policy=AdmissionPolicy(
                tenant_tiers={"batch": "bulk"}
            ),
        ))
        srv.add_service(TaggedEcho(f"s{i}"))
        assert srv.start(0) == 0
        servers.append(srv)
    peers = [f"127.0.0.1:{s.port}" for s in servers]
    url = "list://" + ",".join(peers)
    group = iter(range(1, 1000))

    def shed_totals():
        out = {}
        for (method, tier, reason), var in rpc_shed_total.items():
            out.setdefault(tier, 0)
            out[tier] += var.get_value()
        return out

    def run_phase():
        lat = {"interactive": [], "bulk": []}
        lock = threading.Lock()
        before = shed_totals()

        def run(tier, tenant, sleep_us):
            ch = Channel(ChannelOptions(
                timeout_ms=3000, max_retry=3,
                connection_group=f"ovl{next(group)}",
            ))
            assert ch.init(url, "rr") == 0
            stub = echo_stub(ch)
            for _ in range(calls_per_thread):
                c = Controller()
                c.tenant = tenant
                t0 = time.monotonic()
                stub.Echo(c, EchoRequest(message="x", sleep_us=sleep_us))
                dt = time.monotonic() - t0
                if not c.failed():
                    with lock:
                        lat[tier].append(dt)
            ch.close()

        threads = [
            threading.Thread(target=run, args=("bulk", "batch", bulk_sleep_us))
            for _ in range(bulk_threads)
        ] + [
            threading.Thread(target=run, args=("interactive", "", 0))
            for _ in range(interactive_threads)
        ]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        after = shed_totals()
        sheds = {
            tier: after.get(tier, 0) - before.get(tier, 0)
            for tier in set(before) | set(after)
        }

        def tier_stats(tier):
            vals = sorted(lat[tier])
            pct = lambda q: (  # noqa: E731
                round(vals[min(len(vals) - 1, int(len(vals) * q))] * 1000, 2)
                if vals else 0.0
            )
            return {
                "completed": len(vals),
                "qps": round(len(vals) / wall, 1),
                "p50_ms": pct(0.5),
                "p99_ms": pct(0.99),
            }

        return {
            "interactive": tier_stats("interactive"),
            "bulk": tier_stats("bulk"),
            "sheds_by_tier": sheds,
        }

    plan = storm_plan(
        peers=peers, seed=20260804, reset_pct=0.25,
        slow_peer=peers[0], slow_delay_us=60_000, name="bench-storm",
    )
    try:
        storm_off = run_phase()
        chaos_injector.arm(plan)
        storm_on = run_phase()
    finally:
        chaos_injector.disarm()
        for srv in servers:
            srv.stop()
    total_on = sum(storm_on["sheds_by_tier"].values()) or 1
    bulk_fraction = storm_on["sheds_by_tier"].get("bulk", 0) / total_on

    # ---- phase 2: hedging vs a slow replica ----------------------------
    class BatchedEcho(Service):
        SERVICE_NAME = "EchoService"

        def __init__(self):
            self.handled_rows = 0

        @batched_method(EchoRequest, EchoResponse)
        def Echo(self, controllers, requests, responses, done):
            self.handled_rows += len(controllers)
            for resp in responses:
                resp.message = "slow"
            done()

    slow_svc = BatchedEcho()
    srv_slow = Server(ServerOptions(
        enable_batching=True,
        batch_policies={"EchoService.Echo": {
            "max_batch_size": 8, "max_wait_us": 300_000,
        }},
    ))
    srv_slow.add_service(slow_svc)
    assert srv_slow.start(0) == 0
    srv_fast = Server()
    srv_fast.add_service(TaggedEcho("fast"))
    assert srv_fast.start(0) == 0
    hedge_url = (
        f"list://127.0.0.1:{srv_slow.port},127.0.0.1:{srv_fast.port}"
    )

    def hedge_phase(backup_ms):
        ch = Channel(ChannelOptions(
            timeout_ms=4000, max_retry=1, backup_request_ms=backup_ms,
            connection_group=f"hedge{next(group)}",
        ))
        assert ch.init(hedge_url, "rr") == 0
        stub = echo_stub(ch)
        lats = []
        for _ in range(hedge_calls):
            c = Controller()
            t0 = time.monotonic()
            stub.Echo(c, EchoRequest(message="x"))
            if not c.failed():
                lats.append(time.monotonic() - t0)
        ch.close()
        lats.sort()
        pct = lambda q: (  # noqa: E731
            round(lats[min(len(lats) - 1, int(len(lats) * q))] * 1000, 2)
            if lats else 0.0
        )
        return {"completed": len(lats), "p50_ms": pct(0.5),
                "p99_ms": pct(0.99)}

    rows_before = slow_svc.handled_rows
    try:
        no_hedge = hedge_phase(-1)
        rows_no_hedge = slow_svc.handled_rows - rows_before
        rows_mark = slow_svc.handled_rows
        hedged = hedge_phase(50)
        time.sleep(0.5)  # let the slow batch windows drain/shed
        rows_hedged = slow_svc.handled_rows - rows_mark
    finally:
        srv_slow.stop()
        srv_fast.stop()
    return {
        "overload_storm": {
            "storm_off": storm_off,
            "storm_on": storm_on,
            "bulk_shed_fraction_storm_on": round(bulk_fraction, 3),
            "hedging": {
                "no_hedge": no_hedge,
                "hedged": hedged,
                "tail_cut_ratio": round(
                    no_hedge["p99_ms"] / hedged["p99_ms"], 2
                ) if hedged["p99_ms"] else 0.0,
                "slow_replica_rows_executed_no_hedge": rows_no_hedge,
                "slow_replica_rows_executed_hedged": rows_hedged,
            },
        }
    }


def bench_resharding(
    n_keys=48,
    dim=32,
    load_threads=2,
    phase_calls=60,
    device=None,
):
    """Live re-sharding under load (docs/resharding.md): a 2-shard PS
    cluster migrates to 4 shards (PREPARE → DUAL_WRITE → COPY →
    CUTOVER → DRAIN) while `load_threads` clients hammer a mixed
    Get + fan-out Forward workload through a DynamicShardChannel.

    Reports per-phase (pre / during / post-migration) qps and
    p50/p99 latency — the "dip" the zero-downtime claim bounds — plus
    the error count by code and the migration's own step log (epoch
    bump, moved-key count vs the planner's scheme delta, checksum
    failures).  The smoke guard asserts STRUCTURE: migration
    completed, epoch bumped once, moved == scheme delta, and zero
    non-ERPC error codes — never absolute qps."""
    import statistics

    import numpy as np

    from incubator_brpc_tpu_torch.client.combo import DynamicShardChannel
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.parameter_server import (
        PsService,
        ps_stub,
        sharded_ps_channel,
    )
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.resharding import (
        MigrationView,
        PsShardStore,
        ReshardCoordinator,
        moved_keys,
        shard_of,
    )
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    servers, svcs = [], []
    for _ in range(4):
        svc = PsService(device=device)
        srv = Server(ServerOptions())
        srv.add_service(svc)
        assert srv.start(0) == 0
        servers.append(srv)
        svcs.append(svc)
    eps = [f"127.0.0.1:{s.port}" for s in servers]

    old_ch = sharded_ps_channel(endpoints=eps[:2], timeout_ms=20000)
    new_ch = sharded_ps_channel(endpoints=eps, timeout_ms=20000)
    view = MigrationView()
    dyn = DynamicShardChannel(old_ch, new_ch, view)

    # KV keyspace (migrates by owner) + per-scheme scattered Forward
    # parameters (layout keys: excluded from the census via key_filter,
    # re-scattered per scheme up front)
    keys = [f"bkey{i}" for i in range(n_keys)]
    for k in keys:
        c = Controller()
        c.request_attachment.append(f"v-{k}".encode())
        ps_stub(dyn).Put(c, EchoRequest(message=k))
        assert not c.failed(), c.error_text()
    # per-scheme scattered Forward parameters, seeded through the
    # server-side store API (TCP attachments are host bytes; the
    # Forward kernel wants the 2-D row slice)
    W = np.random.rand(dim, dim).astype(np.float32)
    for n, key in ((2, "w2"), (4, "w4")):
        rows = dim // n
        for i in range(n):
            svcs[i].put_param(key, W[i * rows:(i + 1) * rows])
    planned = moved_keys(keys, 2, 4)

    phase_box = ["pre"]
    records = []  # (phase, latency_s, error_code)
    rec_lock = threading.Lock()
    stop = threading.Event()
    x = np.random.rand(dim).astype(np.float32)

    def load_loop():
        i = 0
        while not stop.is_set():
            phase = phase_box[0]
            t0 = time.perf_counter()
            if i % 4 == 3:
                # fan-out Forward on the scheme snapshot the channel
                # itself would take — atomic wrt the cutover bump
                primary = dyn.channels()[0]
                w_key = "w2" if primary is old_ch else "w4"
                c = Controller()
                c.request_attachment.append_user_data(x.tobytes())
                ps_stub(primary).Forward(c, EchoRequest(message=w_key))
            elif i % 8 == 1:
                k = keys[i % len(keys)]
                c = Controller()
                c.request_attachment.append(f"v-{k}".encode())
                ps_stub(dyn).Put(c, EchoRequest(message=k))
            else:
                k = keys[i % len(keys)]
                c = Controller()
                ps_stub(dyn).Get(c, EchoRequest(message=k))
            dt = time.perf_counter() - t0
            with rec_lock:
                records.append((phase, dt, c.error_code))
            i += 1

    threads = [threading.Thread(target=load_loop) for _ in range(load_threads)]
    for t in threads:
        t.start()

    def _count(phase):
        with rec_lock:
            return sum(1 for p, _, _ in records if p == phase)

    try:
        # pre window
        t_pre = time.perf_counter()
        while _count("pre") < phase_calls:
            time.sleep(0.005)
        pre_s = time.perf_counter() - t_pre

        phase_box[0] = "during"
        t_mig = time.perf_counter()
        coord = ReshardCoordinator(
            "bench",
            [PsShardStore(p) for p in old_ch.partitions()],
            [PsShardStore(p) for p in new_ch.partitions()],
            view=view,
            key_filter=lambda k: not k.startswith("w"),
        )
        mig_report = coord.run()
        mig_s = time.perf_counter() - t_mig

        phase_box[0] = "post"
        t_post = time.perf_counter()
        while _count("post") < phase_calls:
            time.sleep(0.005)
        post_s = time.perf_counter() - t_post
    finally:
        stop.set()
        for t in threads:
            t.join(10.0)
        for srv in servers:
            srv.stop()

    durations = {"pre": pre_s, "during": mig_s, "post": post_s}
    phases = {}
    errors_by_code = {}
    with rec_lock:
        for name in ("pre", "during", "post"):
            lats = sorted(dt for p, dt, _ in records if p == name)
            errs = [e for p, _, e in records if p == name and e]
            for e in errs:
                errors_by_code[e] = errors_by_code.get(e, 0) + 1
            if not lats:
                phases[name] = {"calls": 0}
                continue
            phases[name] = {
                "calls": len(lats),
                "qps": round(len(lats) / max(durations[name], 1e-9), 1),
                "p50_ms": round(
                    statistics.median(lats) * 1e3, 3
                ),
                "p99_ms": round(
                    lats[min(len(lats) - 1, int(len(lats) * 0.99))] * 1e3,
                    3,
                ),
                "errors": len(errs),
            }
    return {
        "resharding": {
            "phases": phases,
            "errors_by_code": errors_by_code,
            "migration": {
                "completed": mig_report["completed"],
                "phase": mig_report["phase"],
                "epoch": mig_report["epoch"],
                "keys_total": mig_report["counters"]["keys_total"],
                "keys_moved": mig_report["counters"]["keys_moved"],
                "planner_scheme_delta": len(planned),
                "checksum_failures": mig_report["counters"][
                    "checksum_failures"
                ],
                "wall_s": round(mig_s, 3),
            },
            "dual_writes": dyn.dual_writes,
            "reads_fell_back": dyn.reads_fell_back,
        }
    }


def bench_resharding_bulk_move(n_keys=64, value_bytes=4096, device=None):
    """Collective bulk-move COPY over the cache tier (the device data
    plane's resharding leg, docs/ici_pipeline.md bulk-move contract):
    a 2→4 cache migration where each (src, dst) range moves as ONE
    stacked DMGET + DMSET + verify-DMGET instead of 3 RPCs per key.

    Reports the step log (collective_steps vs keys_moved — the
    acceptance proof is collective_steps ≪ keys_moved) and the wall
    time against the same migration forced through the per-key engine
    (stores stripped of their bulk surface).  The smoke guard asserts
    structure only: both migrations complete, bulk moved every key in
    ≤ 3 steps per range, per-key moved them in ≥ 1 step per key."""
    from incubator_brpc_tpu_torch.cache.channel import CacheChannel
    from incubator_brpc_tpu_torch.cache.service import HBMCacheService
    from incubator_brpc_tpu_torch.client.channel import ChannelOptions
    from incubator_brpc_tpu_torch.resharding import (
        CacheShardStore,
        MigrationView,
        ReshardCoordinator,
        ReshardingState,
    )
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    class _PerKeyStore:
        """Bulk surface stripped: forces the per-key COPY engine."""

        def __init__(self, store):
            self.list_keys = store.list_keys
            self.read = store.read
            self.write = store.write
            self.delete = store.delete

    def _run(tag, strip_bulk):
        servers, chans = [], []
        try:
            for i in range(4):
                srv = Server(ServerOptions(
                    redis_service=HBMCacheService(device=device)))
                assert srv.start(0) == 0
                servers.append(srv)
            chans = [
                CacheChannel(
                    f"list://127.0.0.1:{s.port}", lb="rr",
                    options=ChannelOptions(timeout_ms=30000,
                                           ici_device=device),
                )
                for s in servers
            ]
            stores = [CacheShardStore(c) for c in chans]
            if strip_bulk:
                stores = [_PerKeyStore(s) for s in stores]
            from incubator_brpc_tpu_torch.resharding import shard_of

            payload = b"\xa5" * value_bytes
            for i in range(n_keys):
                k = f"bulk{i}"
                stores[shard_of(k, 2)].write(k, payload)
            view = MigrationView()
            state = ReshardingState(f"bulk-bench-{tag}", 2, 4)
            t0 = time.perf_counter()
            rep = ReshardCoordinator(
                f"bulk-bench-{tag}", stores[:2], stores, view=view,
                state=state,
            ).run()
            wall = time.perf_counter() - t0
            return {
                "completed": rep["completed"],
                "keys_moved": rep["counters"]["keys_moved"],
                "collective_steps": rep["counters"]["collective_steps"],
                "bulk_ranges": rep["counters"]["bulk_ranges"],
                "ranges_copied": rep["counters"]["ranges_copied"],
                "wall_ms": round(wall * 1e3, 1),
            }
        finally:
            for c in chans:
                c.close()
            for srv in servers:
                srv.stop()

    bulk = _run("collective", strip_bulk=False)
    per_key = _run("perkey", strip_bulk=True)
    out = {"bulk": bulk, "per_key": per_key}
    if bulk["wall_ms"] > 0 and per_key["wall_ms"] > 0:
        out["speedup"] = round(
            per_key["wall_ms"] / max(bulk["wall_ms"], 1e-9), 2
        )
    return {"resharding_bulk_move": out}


def bench_replicated_ps(
    n_keys=24,
    rf1_calls=120,
    rf3_calls=120,
    hedged_calls=48,
    slow_delay_us=60_000,
    hedge_ms=10,
    device=None,
):
    """The replicated HA tier (docs/replication.md), three segments:

    1. **RF=1 OFF/ON/OFF triplet** — the replicated channel with one
       replica per group must be byte-for-byte the unreplicated
       ShardRoutedChannel path (it delegates at construction), so the
       triplet overhead must be ≈0%.
    2. **RF=3 steady state** — qps/p50/p99 of a mixed Put/Get load
       over 2 groups x 3 replicas with quorum writes; the step log
       must show quorum_writes >= puts and ZERO leader changes (a
       silently-unreplicated or flapping run fails the smoke guard).
    3. **Hedged-read tail cut** — one replica slowed SERVER-side (its
       store's reads sleep on a server worker, the backup_request.py
       idiom: a client-side socket.read chaos delay would stall the
       one event-dispatcher thread and block the backup response too);
       read p99 through the hedged channel (backup_request_ms) vs a
       no-hedge control over the SAME groups.

    The smoke guard asserts structure and invariants, never absolute
    qps."""
    import statistics

    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.parameter_server import (
        PsService,
        ps_stub,
        sharded_ps_channel,
    )
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.replication import replicated_ps_channel
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    def _put(stub, key):
        c = Controller()
        c.request_attachment.append(f"v-{key}".encode())
        stub.Put(c, EchoRequest(message=key))
        return c

    def _get(stub, key):
        c = Controller()
        stub.Get(c, EchoRequest(message=key))
        return c

    def _timed_mixed(stub, keys, calls):
        lats, errs = [], 0
        t0 = time.perf_counter()
        for i in range(calls):
            k = keys[i % len(keys)]
            t1 = time.perf_counter()
            c = _put(stub, k) if i % 4 == 1 else _get(stub, k)
            lats.append(time.perf_counter() - t1)
            errs += 1 if c.failed() else 0
        wall = time.perf_counter() - t0
        lats.sort()
        return {
            "calls": calls,
            "qps": round(calls / max(wall, 1e-9), 1),
            "p50_ms": round(statistics.median(lats) * 1e3, 3),
            "p99_ms": round(
                lats[min(len(lats) - 1, int(len(lats) * 0.99))] * 1e3, 3
            ),
            "errors": errs,
        }

    class _SlowReadStore(dict):
        """Store whose reads sleep (server-side, on a worker): what a
        GC-wedged or fabric-degraded replica looks like to a reader."""

        delay_s = 0.0

        def get(self, key, default=None):
            if self.delay_s:
                time.sleep(self.delay_s)
            return super().get(key, default)

    servers, svc_by_ep = [], {}
    try:
        for _ in range(6):
            srv = Server(ServerOptions())
            svc = PsService(device=device)
            srv.add_service(svc)
            assert srv.start(0) == 0
            servers.append(srv)
            svc_by_ep[f"127.0.0.1:{srv.port}"] = svc
        eps = [f"127.0.0.1:{s.port}" for s in servers]
        keys = [f"rkey{i}" for i in range(n_keys)]

        # -- segment 1: RF=1 OFF/ON/OFF triplet ---------------------------
        plain = sharded_ps_channel(endpoints=eps[:2], timeout_ms=20000)
        rf1 = replicated_ps_channel(
            [[eps[0]], [eps[1]]], register=False, name_prefix="bench-rf1"
        )
        for k in keys:
            assert not _put(ps_stub(plain), k).failed()
        for warm in (plain, rf1):  # connections + codepaths out of the timing
            _get(ps_stub(warm), keys[0])
            _put(ps_stub(warm), keys[0])
        off1 = _timed_mixed(ps_stub(plain), keys, rf1_calls)
        on = _timed_mixed(ps_stub(rf1), keys, rf1_calls)
        off2 = _timed_mixed(ps_stub(plain), keys, rf1_calls)
        off_qps = (off1["qps"] + off2["qps"]) / 2.0
        rf1_overhead_pct = round((off_qps / max(on["qps"], 1e-9) - 1) * 100, 2)

        # -- segment 2: RF=3 quorum writes, steady state ------------------
        rep = replicated_ps_channel(
            [eps[:3], eps[3:]], register=False, name_prefix="bench-rf3",
            lease_ttl_s=5.0, hedge_ms=hedge_ms,
        )
        stub = ps_stub(rep)
        puts = 0
        for k in keys:
            assert not _put(stub, k).failed()
            puts += 1
        rf3 = _timed_mixed(stub, keys, rf3_calls)
        puts += sum(1 for i in range(rf3_calls) if i % 4 == 1)
        quorum_writes = sum(g.counters["quorum_writes"] for g in rep.groups)
        steady_leader_changes = sum(
            g.counters["leader_changes"] for g in rep.groups
        )

        # -- segment 3: hedged-read tail cut, one replica slowed ----------
        g0_keys = [k for k in keys if rep.shard_of(k) == 0] or keys[:1]
        # slow a FOLLOWER of group 0 so quorum writes stay unaffected
        leader_ep = rep.groups[0].ensure_leader().endpoint
        slow_ep = next(ep for ep in eps[:3] if ep != leader_ep)
        slow_svc = svc_by_ep[slow_ep]
        slow_store = _SlowReadStore(slow_svc._store)
        slow_svc._store = slow_store
        control = replicated_ps_channel(
            [eps[:3], eps[3:]], register=False, name_prefix="bench-ctl",
            lease_ttl_s=5.0, hedge_ms=-1,
        )
        _get(ps_stub(control), g0_keys[0])  # warm before the slowdown
        slow_store.delay_s = slow_delay_us / 1e6
        try:
            def _read_p99(s):
                # open-loop pacing: abandoned hedged originals sleep on
                # the slow server for delay_s each — issuing faster
                # than they drain measures worker starvation, not tails
                gap_s = slow_delay_us / 1e6 / 2.0
                lats = []
                for i in range(hedged_calls):
                    t1 = time.perf_counter()
                    _get(s, g0_keys[i % len(g0_keys)])
                    lats.append(time.perf_counter() - t1)
                    time.sleep(gap_s)
                lats.sort()
                return round(
                    lats[min(len(lats) - 1, int(len(lats) * 0.99))] * 1e3, 3
                )

            p99_nohedge = _read_p99(ps_stub(control))
            p99_hedged = _read_p99(stub)
        finally:
            slow_store.delay_s = 0.0
        hedged_count = sum(g.counters["hedged_reads"] for g in rep.groups)

        return {
            "replicated_ps": {
                "rf1_triplet": {
                    "off1": off1, "on": on, "off2": off2,
                    "overhead_pct": rf1_overhead_pct,
                },
                "rf3": rf3,
                "quorum_writes": quorum_writes,
                "puts": puts,
                "steady_leader_changes": steady_leader_changes,
                "hedged_tail": {
                    "slow_delay_ms": slow_delay_us / 1000.0,
                    "p99_ms_nohedge": p99_nohedge,
                    "p99_ms_hedged": p99_hedged,
                    "hedged_reads": hedged_count,
                },
            }
        }
    finally:
        for srv in servers:
            srv.stop()


def bench_shard_window(n_keys=64, shards=3, value_bytes=512, reps=3,
                       device=None):
    """shard_window: the windowed shard fan-out's crossings-per-call
    story (docs/fastpath.md "server ring" → shard windows), counted by
    the process-wide fanout step log rather than timed alone.  Two
    fan-out shapes, each measured per-call (one C-boundary crossing per
    key — the pre-window shape) and windowed (call_many / get_many —
    one crossing per SHARD):

      * ps_fanout — ShardRoutedChannel over ``shards`` native echo
        servers, ``n_keys`` pb requests per window.  Windowed crossings
        must equal the shard count with zero per-call fallbacks; the
        per-call loop crosses once per key by construction.
      * cache_window — CacheChannel over two ICI HBMCacheService
        replicas (slices 126/127 — tests own 40-99, bench_hbm_cache
        120-121) under the consistent-hash LB so keys span both nodes.
        set_many then get_many of ``n_keys`` keys: windowed crossings
        equal the number of balancer groups (== replicas holding
        keys); the per-call GET loop is one crossing per key.
    """
    from incubator_brpc_tpu_torch.cache import CacheChannel, HBMCacheService
    from incubator_brpc_tpu_torch.client.channel import ChannelOptions
    from incubator_brpc_tpu_torch.client.combo import ShardRoutedChannel
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.client.ring import fanout_log
    from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    out = {}

    # ---- PS-style fan-out over native TCP shards ------------------
    servers = []
    eps = []
    for _ in range(shards):
        srv = Server(ServerOptions(native_engine=True))
        srv.add_service(EchoService(attach_echo=False))
        assert srv.start(0) == 0
        servers.append(srv)
        eps.append(f"127.0.0.1:{srv.port}")
    try:
        ch = ShardRoutedChannel.from_endpoints(
            eps,
            channel_options=ChannelOptions(
                timeout_ms=10000, connection_type="native"
            ),
        )
        stub = echo_stub(ch)
        body = "x" * value_bytes
        reqs = [
            EchoRequest(message=f"k{i}-{body}") for i in range(n_keys)
        ]
        # per-call shape: every key is its own routed call_method —
        # one boundary crossing per key by construction
        t0 = time.monotonic()
        for _ in range(reps):
            for r in reqs:
                ctrl = Controller()
                resp = stub.Echo(ctrl, r)
                assert not ctrl.failed(), ctrl.error_text()
                assert resp.message == r.message
        percall_qps = (reps * n_keys) / (time.monotonic() - t0)

        from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoResponse

        before = fanout_log.counters()
        t0 = time.monotonic()
        for _ in range(reps):
            res = stub.call_many("Echo", reqs)  # raw reply bytes
            assert [
                EchoResponse.FromString(r).message for r in res
            ] == [r.message for r in reqs]
        windowed_qps = (reps * n_keys) / (time.monotonic() - t0)
        after = fanout_log.counters()
        crossings = after["crossings"] - before["crossings"]
        keys = after["keys"] - before["keys"]
        out["shard_window_ps"] = {
            "shards": shards,
            "n_keys": n_keys,
            "percall_qps": round(percall_qps, 1),
            "percall_crossings_per_call": 1.0,
            "windowed_qps": round(windowed_qps, 1),
            "windowed_crossings": crossings,
            "windowed_crossings_per_call": round(
                crossings / (reps * n_keys), 4
            ),
            "keys_per_crossing": round(keys / max(1, crossings), 2),
            "fallback_calls": after["fallback_calls"]
            - before["fallback_calls"],
            "windows": after["windows"] - before["windows"],
        }
    finally:
        for srv in servers:
            srv.stop()

    # ---- cache get_many/set_many over two ICI replicas ------------
    nodes = []
    for slice_id in (126, 127):
        srv = Server(ServerOptions(
            redis_service=HBMCacheService(device=device)))
        assert srv.start_ici(slice_id, 1, device=device) == 0
        nodes.append(srv)
    # consistent-hash LB (not mesh_locality) so the key space
    # actually spans both replicas — the point is the multi-group
    # windowed crossing count, not locality routing
    cc = CacheChannel(
        "list://ici://slice126/chip1,ici://slice127/chip1",
        lb="c_murmurhash",
        options=ChannelOptions(timeout_ms=30000, ici_device=device),
    )
    try:
        items = [
            (b"sw%d" % i, b"\xa5" * value_bytes) for i in range(n_keys)
        ]
        keys = [k for k, _ in items]
        before = fanout_log.counters()
        stored = cc.set_many(items)
        assert stored == n_keys, stored
        mid = fanout_log.counters()
        t0 = time.monotonic()
        for _ in range(reps):
            res = cc.get_many(keys)
            assert all(res.hit(i) for i in range(n_keys))
        windowed_qps = (reps * n_keys) / (time.monotonic() - t0)
        after = fanout_log.counters()
        # per-call shape: one GET per key through the same channel
        t0 = time.monotonic()
        for k in keys:
            r = cc.get(k)
            assert r is not None
        percall_qps = n_keys / (time.monotonic() - t0)
        set_cross = mid["crossings"] - before["crossings"]
        get_cross = after["crossings"] - mid["crossings"]
        out["shard_window_cache"] = {
            "replicas": len(nodes),
            "n_keys": n_keys,
            "set_many_crossings": set_cross,
            "get_many_crossings": get_cross,
            "get_many_crossings_per_call": round(
                get_cross / (reps * n_keys), 4
            ),
            "percall_qps": round(percall_qps, 1),
            "percall_crossings_per_call": 1.0,
            "windowed_qps": round(windowed_qps, 1),
            "fallback_calls": after["fallback_calls"]
            - before["fallback_calls"],
        }
    finally:
        cc.close()
        for srv in nodes:
            srv.stop()
    return out


def main():
    extra = {}
    extra.update(bench_tcp_echo())
    extra.update(bench_rpcz_overhead())
    extra.update(bench_profiler_overhead())
    extra.update(bench_chaos_overhead())
    extra.update(bench_ring_disabled_overhead())
    extra.update(bench_cluster_scrape_overhead())
    extra.update(bench_device_witness_overhead())
    extra.update(bench_hbm_cache())
    extra.update(bench_admission_off_overhead())
    extra.update(bench_overload_storm())
    extra.update(bench_resharding())
    extra.update(bench_resharding_bulk_move())
    extra.update(bench_replicated_ps())
    extra.update(bench_batched_device_op())
    extra.update(bench_sharded_ps())
    extra.update(bench_shard_window())
    extra.update(bench_batching_off_overhead())
    extra.update(bench_streaming_generate())
    extra.update(bench_disagg_serving())
    extra.update(bench_dcn_bulk())
    extra.update(bench_python_protocols())
    extra.update(bench_tail_cdf())
    extra.update(bench_transmit_op())
    # sweep first: the best chunk-policy config is applied to the
    # fabric before the headline end-to-end run measures it
    extra.update(bench_ici_pipeline_curve())
    extra.update(bench_ici_rpc())

    value = extra.get("ici_64mb_echo_gbps", 0.0)
    baseline = 2.3  # GB/s, reference peak throughput (BASELINE.md:16)
    print(
        json.dumps(
            {
                "metric": (
                    "64MB device-payload echo over ICI transport, end-to-end "
                    "measured (zero-copy off: request and response each "
                    "traverse device memory through the copy+checksum "
                    "transmit kernel inside the timed chain; completion "
                    "forced by data dependence; median marginal cost per "
                    "echo)"
                ),
                "value": value,
                "unit": "GB/s",
                "vs_baseline": round(value / baseline, 2),
                "card": card(),
                "extra": extra,
            }
        )
    )


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30,
    ).stdout.strip()


if __name__ == "__main__":
    main()
