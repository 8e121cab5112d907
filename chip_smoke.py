#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (incubator_brpc_tpu_torch).

    python3 chip_smoke.py
    python3 chip_smoke.py --times ROOT

Needs one CUDA card, ``nvcc`` and the repository checkout around this
file.  Phases, each fatal on failure:

1. build   — compile ops/csrc/*.cu for sm_90a (one nvcc per source, in
             parallel) and print the card's name and power limit;
2. kernels — hold each hand-written kernel against its plain PyTorch
             version on the card: copied bytes equal, and the lane
             accumulator (or checksum) of K1 whole frame, K1 chained
             chunks, K1 into a slot, K1 from a random carry, the fused
             chunk path, K2 and K2 into a slot bit-equal to the plain
             version's, which adds in the kernels' order; copy_blocks
             byte-equal, into its out= buffer or a fresh one.  The shapes
             are every main path's: the echo frame, the PS's W, and the
             cache and stream paths' lane views (a 1 MiB value as (256,
             4096) u8, the 4 KB value as (1, 4096) u8, the DMGET stack as
             (32, 1048576) u8, a stream frame as (256, 1024) f32);
3. echo    — the first main path: a 64 MB float32 (8192, 2048) tensor
             echoed through Server.start_ici / Channel under every chunk
             mode (off, fused, pipelined, pallas).  Per mode: the
             response equals the request, is a fresh CUDA tensor,
             carries the whole-frame checksum, and each kernel of the
             mode launched the expected number of times per hop (one
             launch per transmit: the fold is the kernels' tail).  Prints
             the marginal per-echo time (chained hi - lo echoes,
             synchronized);
4. ps      — the second main path: the batched parameter server at
             d = 6144 (bench.py's bench_batched_device_op width) on
             Server(enable_batching=True).start_ici.  A seeded (6144,
             6144) float32 W is Put and Got back over ici:// (byte-equal,
             a fresh CUDA tensor, K1's whole-frame checksum, one K1 per
             hop); Forward runs closed-loop at parallelism
             1 and 32 with batching off and on (bucket 32), every y held
             to x.double() @ W.double() within 2e-6 * (|x| @ |W|); a
             control product with TF32 on must fail that same check.
             Prints Put/Get time and GB/s, qps/p50/p99 per point, the
             on/off speedup and a profiler window's device-busy share;
5. cache   — the third main path: an HBMCacheService behind
             ServerOptions.redis_service on Server.start_ici over a 1 GiB
             store on the card.  2048 SETs of 1 MiB device values over
             ici:// (one K1 per hop; the store adopts each delivered
             tensor), so LRU eviction runs at scale and evictions and
             hbm_used must equal a plain LRU model's; GETs come back as
             fresh CUDA tensors with equal bytes (one K1 per hop); a
             DMGET of 32 keys is one fused gather and one 32 MiB stacked
             reply (one K1 per hop); a DMSET writes 32 keys; a TCP GET
             spills the exact bytes; a 4 KB value goes through both
             lanes.  Prints median SET/GET/DMGET times, launches,
             evictions, hbm_used and a device-busy share.  Then a stream
             over ici:// echoes 1 MiB device frames (one K1 per frame per
             hop);
6. dcn     — the DCN bridge: a second process started with subprocess
             (a fresh interpreter on the same card) hosts an echo server
             at ici://slice6/chip0 and a 1 GiB cache node at chip1 behind
             listen_dcn; tpu://fabric resolves both.  A 64 MB float32
             (8192, 2048) device tensor is echoed across the bridge (7
             reps, the first echo apart: bench_dcn_bulk's 64 MB) and a
             bfloat16 (4096, 1024) one once: byte-equal, fresh CUDA
             tensors on the parent's device, K1 on each receiving hop
             (the child's launches read back over its stdin/stdout), and
             K1 on the DCN-uploaded frame bit-equal to plain;
7. cluster — the clustered cache tier: three local 1 GiB nodes at
             ici://slice5/chip{0,1,2} and the child's node across DCN
             behind one CacheChannel (mesh_locality from slice5/chip0).
             2048 SETs and GETs of 1 MiB device values routed as the
             ring predicts (no eviction, hbm_used per node exact); the
             DCN node from a client in its own slice; a get_many of 32
             co-located keys is one DMGET and one stacked reply;
             failover (a stopped node's keys read as clean misses) and
             health-check revival (locality back >= 90%); a pallas-mode
             set_many of 32 values to one node is one stacked K2 launch,
             K2 on that stack bit-equal to plain and timed beside its
             bound; a replicated group of three (256 quorum puts, 64
             behind, one delete, repair_keys == 64); a live 2 -> 3
             reshard of 1024 keys with collective_steps < keys_moved;
8. serve   — the fourth main path: disaggregated prefill/decode serving
             (bench_disagg_serving's 3 layers, 2 decode replicas, 32
             tokens a session, parallelism 1, 8 and 32, a 64 MB store) at
             dim = 6144 against the monolithic DecodeLoop.  Disagg tokens
             equal the monolithic and the solo run at parallelism 1;
             prefill runs once per session; each KV pull is one fused
             gather; one checkpoint migration emits every token once and
             equals the unmigrated run.  Prints tokens/s and median TTFT
             of both, steps, max_fused, how many tokens at 8 and 32
             differ from each session's solo run (cuBLAS may pick another
             kernel per row count), and the p = 32 device-busy share.  The
             decode step at buckets 1, 8 and 32 is held to float64 as the
             Forward product is (states and row sums), and a TF32 step
             must fail that check;
9. times   — each kernel's time at the main path's shapes beside its
             bound, its plain version and x.clone(), K1 on the PS path's
             W and on one 8 MB chunk with a carry (the pipelined mode's
             launch, walked over a 64 MB frame so that the L2 is cold,
             as on the path), and on a 1 MiB cache value and the 32 MiB
             DMGET stack; the Forward product and the decode step
             (torch.matmul, XLA ops in the reference) per bucket.

The line before the last is the card's name and power limit; the last
line is {"ok": true, "device": {...}}.  Without a card, or without the
package beside this file, it exits non-zero and prints no result.

``--times ROOT`` runs only the build and the copy+checksum transmit
times of phase 9 (transmit_ms) for the package of the checkout at ROOT,
and prints them as one JSON line with the card's name and power limit.
Two commits compare on one card within one call: unpack the other with
``git archive`` under a directory that .gitignore lists and run the
two roots in turns (A, B, B, A).
"""

from __future__ import annotations

import argparse
import faulthandler
import gc
import json
import pathlib
import statistics
import subprocess
import sys
import threading
import time

SEED = 1234
RUN_DEADLINE_S = 1150  # the whole run's budget, inside its 1200 s limit
MAIN_SHAPE = (8192, 2048)  # 64 MB of float32: bench.py's bench_ici_rpc payload
CHUNK_ROWS = 1024  # one 8 MB chunk of MAIN_SHAPE: the pipelined mode's K1 launch
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
PS_DIM = 6144  # bench.py:2044, bench_batched_device_op's dim
PS_RTOL = 2e-6  # Forward y vs float64, relative to |x| @ |W|: f32 passes, TF32 fails
# the cache path (bench.py:1807 bench_hbm_cache's 1 MB and 4 KB values)
# at a cache node's size: 1 GiB of values, twice that SET through it
CACHE_BUDGET = 1 << 30
CACHE_VALUE = 1 << 20
CACHE_SETS = 2048
CACHE_GETS = 32
DMGET_KEYS = 32
CACHE_DMGETS = 8
CACHE_TCP_GETS = 8
SMALL_VALUE = 4096
STREAM_FRAMES = 8
# the serving path (bench.py:2732-2840 bench_disagg_serving's traffic)
# at the served matrix's width, the PS's d (bench.py:2044)
SERVE_DIM = 6144
SERVE_LAYERS = 3
SERVE_REPLICAS = 2
SERVE_TOKENS = 32
SERVE_P = (1, 8, 32)
SERVE_STORE = 64 << 20
# the DCN bridge (bench.py:872-951 bench_dcn_bulk: 64 MB, 7 reps, the
# first echo apart) and the clustered cache tier: three local nodes and
# the child's across DCN, each a cache node's 1 GiB store
DCN_SLICE = 6
DCN_REPS = 7
DCN_BF16_SHAPE = (4096, 1024)
CLUSTER_SLICE = 5
CLUSTER_KEYS = 2048
CLUSTER_DCN_KEYS = 64
REVIVE_DEADLINE_S = 10.0
REPL_PUTS = 256
REPL_BEHIND = 64
RESHARD_KEYS = 1024
SOURCE = "incubator_brpc_tpu_torch/ops/csrc/transfer.cu"
REPLACES = {
    "copy_csum_blocks": "incubator_brpc_tpu/ops/transfer.py:112 (+:176, :202)",
    "copy_csum_staged": "incubator_brpc_tpu/ops/transfer.py:388",
    "copy_blocks": "incubator_brpc_tpu/ops/transfer.py:68 (device_copy :59, _copy_kernel :54)",
}
# no path of either package calls device_copy: chip_smoke launches
# copy_blocks only in these phases, never on a main path
OFF_PATH = {"copy_blocks": "kernels, times"}
# per hop of a 64 MB frame at 8 MB chunks (8 chunks): expected launches
PER_HOP = {
    "off": {"copy_csum_blocks": 1, "copy_csum_staged": 0},
    "fused": {"copy_csum_blocks": 1, "copy_csum_staged": 0},
    "pipelined": {"copy_csum_blocks": 8, "copy_csum_staged": 0},
    "pallas": {"copy_csum_blocks": 0, "copy_csum_staged": 1},
}
for _per in PER_HOP.values():
    _per["copy_blocks"] = 0


def past_f64(got, ref, scale):
    """The products' check, |got - ref| <= PS_RTOL * scale per entry with
    ref in float64: (entries past it, worst |got - ref| / scale)."""
    err = (got.double() - ref).abs()
    return int((err > PS_RTOL * scale).sum()), (err / scale).max().item()


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over iters back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def device_profile(torch, fn):
    """Run fn() under torch.profiler; returns (wall_us, busy_us, by_name)
    with busy_us the summed device time of its CUDA events (one stream:
    they do not overlap) and by_name that time per event name."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    return wall_us, sum(by_name.values()), by_name


def make_payload(torch, shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        x = torch.randn(shape, generator=g).to(dtype)
    elif dtype == torch.uint8:
        x = torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)
    else:
        x = torch.randint(-(1 << 20), 1 << 20, shape, generator=g).to(dtype)
    return x.cuda()


def card(torch):
    """The device every phase's servers and channels use: the first card."""
    return torch.device("cuda", 0)


def phase_build():
    from incubator_brpc_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    secs = time.perf_counter() - t0
    print(f"[build] {sorted(libs)} in {secs:.1f} s (sm_90a)")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[build] card: {smi}")
    return smi


def phase_kernels(torch, T):
    """Kernel against plain on the card; returns (errs, main_csum), errs
    being each kernel's max |acc - plain| at the main path's shape (0:
    the accumulators are held bit-equal)."""
    cases = [
        (MAIN_SHAPE, torch.float32),
        ((PS_DIM, PS_DIM), torch.float32),  # the PS path's W: 2304 K1 CTAs
        ((320, 256), torch.float32),   # m not a chunk multiple
        ((1000, 128), torch.float32),  # block rows fall to 8
        ((1, 128), torch.float32),     # single row
        ((4096, 1024), torch.bfloat16),
        ((1000, 384), torch.uint8),
        ((512, 256), torch.int32),
        ((768, 512), torch.float16),
        # the cache and stream paths' lane views: a 1 MiB value, the 4 KB
        # value, the 32-key DMGET stack (one K1 over 16384 column tiles),
        # a stream frame
        ((256, 4096), torch.uint8),
        ((1, 4096), torch.uint8),
        ((DMGET_KEYS, CACHE_VALUE), torch.uint8),
        ((256, 1024), torch.float32),
    ]
    errs = {k: 0.0 for k in T.launches}
    main_csum = None
    for i, (shape, dtype) in enumerate(cases):
        x = make_payload(torch, shape, dtype, SEED + i)
        m, n = shape
        br = T._fit_block_rows(m)
        chunk_bytes = max(1, x.nbytes // 4)
        _, _, chunks = T.chunk_plan_for(x, chunk_bytes)

        out_p, acc_p = T.copy_csum_plain(x, None, br)
        out_w, acc_w = T._copy_csum(x, None, br)
        acc_c, outs = None, []
        for off, rows in chunks:
            oc, acc_c = T.device_copy_with_checksum_chunk(
                x[off:off + rows],
                acc_c if acc_c is not None
                else torch.zeros((1, n), dtype=torch.float32, device=x.device),
                br,
            )
            outs.append(oc)
        slot = torch.empty_like(x)
        out_s, acc_s = T.device_copy_with_checksum_chunk_into(
            x, torch.zeros((1, n), dtype=torch.float32, device=x.device), slot, br
        )
        out_f, csum_f = T._chunked_copy_csum(x, chunks, br)
        sr = T.pallas_stage_rows(x, br)
        out_k2, acc_k2 = T._staged_copy_csum(x, br, sr)
        slot2 = torch.empty_like(x)
        out_k2i, csum_k2i = T.device_copy_with_checksum_dma_into(x, slot2, br, sr)
        torch.cuda.synchronize()

        for name, o in [("plain", out_p), ("K1", out_w), ("K1 chained", torch.cat(outs)),
                        ("K1 slot", out_s), ("fused", out_f), ("K2", out_k2),
                        ("K2 slot", out_k2i)]:
            check(torch.equal(o, x), f"{name} copy differs for {dtype}{shape}")
        check(out_s.data_ptr() == slot.data_ptr(), "K1 slot path did not write the slot")
        # copy_blocks against its plain version: bytes equal, fresh or out=
        plain_copy = T.device_copy_plain(x)
        copy_out = T.device_copy(x)
        copy_slot = torch.empty_like(x)
        copy_into = T.device_copy(x, out=copy_slot)
        torch.cuda.synchronize()
        check(copy_out.data_ptr() != x.data_ptr(), "copy_blocks did not make a fresh buffer")
        check(copy_into.data_ptr() == copy_slot.data_ptr(), "copy_blocks did not write out=")
        for name, o in [("copy_blocks", copy_out), ("copy_blocks out=", copy_into)]:
            check(torch.equal(o.view(torch.uint8), plain_copy.view(torch.uint8)),
                  f"{name} differs from the plain copy for {dtype}{shape}")
        if shape == MAIN_SHAPE:
            errs["copy_blocks"] = (copy_out - plain_copy).abs().max().item()
        check(out_k2i.data_ptr() == slot2.data_ptr(), "K2 slot path did not write the slot")

        # every mode adds in the plain version's order: bit-equal to it
        csum_p = T.fold_checksum(acc_p)
        for name, acc in [("K1", acc_w), ("K1 chained", acc_c), ("K1 slot", acc_s),
                          ("K2", acc_k2)]:
            check(torch.equal(acc, acc_p),
                  f"{name} accumulator not bit-equal to plain ({dtype}{shape}): off by "
                  f"{(acc - acc_p).abs().max().item()}")
        for name, cs in [("fused", csum_f), ("K2 slot", csum_k2i)]:
            check(torch.equal(cs, csum_p), f"{name} checksum not bit-equal to plain ({dtype}{shape})")
        # K1 from a random carry
        carry = torch.randn((1, n), generator=torch.Generator().manual_seed(i)).cuda()
        _, acc_pc = T.copy_csum_plain(x, carry, br)
        out_kc, acc_kc = T._copy_csum(x, carry, br)
        torch.cuda.synchronize()
        check(torch.equal(out_kc, x), f"K1 carry copy differs for {dtype}{shape}")
        check(torch.equal(acc_kc, acc_pc),
              f"K1 carry accumulator not bit-equal to plain ({dtype}{shape})")
        if shape == MAIN_SHAPE:
            for key, acc in [("copy_csum_blocks", acc_w), ("copy_csum_staged", acc_k2)]:
                errs[key] = (acc - acc_p).abs().max().item()
            main_csum = csum_p
        print(f"[kernels] {str(dtype):15} {str(shape):13} br={br:3} chunks={len(chunks)} "
              f"stage_rows={sr} ok: every mode bit-equal to plain")
    print("[kernels] tolerance: accumulators and checksums of K1 (whole frame, chained, "
          "slot, carry), fused, K2 and K2 slot bit-equal to the plain version, which "
          "adds in the kernels' order; copies (K1, K2, copy_blocks) byte-equal")
    return errs, main_csum


def phase_echo(torch, T, main_csum, hi=24, lo=4, reps=7):
    """The main path: the 64 MB echo in every chunk mode."""
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
    from incubator_brpc_tpu_torch.parallel.ici import get_fabric, ici_pallas_frames
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    x0 = make_payload(torch, MAIN_SHAPE, torch.float32, SEED)
    fabric = get_fabric()
    check(fabric.zero_copy is False, "the fabric must copy by default")
    srv = Server(ServerOptions(usercode_in_dispatcher=True))
    srv.add_service(EchoService())
    check(srv.start_ici(0, 63) == 0, "start_ici failed")  # device defaults to cuda:0
    dev = srv._ici_port.device
    check(dev.type == "cuda", f"server port on {dev}")
    totals = {k: 0 for k in T.launches}
    try:
        ch = Channel(ChannelOptions(timeout_ms=30000, ici_device=dev))
        check(ch.init("ici://slice0/chip63") == 0, "channel init failed")
        stub = echo_stub(ch)
        req = EchoRequest(message="bulk")
        n_echoes = [0]

        def echo(cur):
            c = Controller()
            c.timeout_ms = 30000
            c.request_attachment.append_device(cur)
            stub.Echo(c, req)
            if c.failed():
                fail(f"echo failed: {c.error_text()}")
            segs = c.response_attachment.device_segments()
            check(len(segs) == 1 and segs[0].whole_array() is not None,
                  "response must be one whole device segment")
            n_echoes[0] += 1
            return segs[0]

        def chain(n):
            cur = x0
            t0 = time.perf_counter()
            for _ in range(n):
                cur = echo(cur).array
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        for mode in ("off", "fused", "pipelined", "pallas"):
            fabric.chunk_mode = mode
            n_echoes[0] = 0
            frames0 = int(ici_pallas_frames.get_value())
            T.reset_launch_counts()  # the main path's run starts here
            ref = echo(x0)
            out = ref.array
            torch.cuda.synchronize()
            check(out.is_cuda and out.device == dev, f"{mode}: response on {out.device}")
            check(out.data_ptr() != x0.data_ptr(), f"{mode}: response is not a fresh buffer")
            check(torch.equal(out, x0), f"{mode}: response differs from the request")
            check(ref.csum is not None and torch.equal(ref.csum, main_csum),
                  f"{mode}: frame checksum differs from K1's whole-frame checksum")
            chain(2)  # warm
            per = []
            for _ in range(reps):
                t_hi = chain(hi)
                t_lo = chain(lo)
                d = (t_hi - t_lo) / (hi - lo)
                if d > 0:  # host noise can invert a pair (bench.py:845 drops it too)
                    per.append(d)
            check(len(per) > 0, f"{mode}: every timing pair was inverted by host noise")
            counts = dict(T.launches)  # ... and ends here
            hops = 2 * n_echoes[0]
            for k, v in counts.items():
                totals[k] += v
                check(v == PER_HOP[mode][k] * hops,
                      f"{mode}: {k} launched {v} times for {hops} hops, "
                      f"expected {PER_HOP[mode][k]} per hop")
            frames = int(ici_pallas_frames.get_value()) - frames0
            check(frames == (hops if mode == "pallas" else 0),
                  f"{mode}: rpc_ici_pallas_frames moved by {frames} for {hops} hops")
            med = statistics.median(per)
            gbps = 2 * x0.nbytes / med / 1e9
            print(f"[echo] {mode:9} {med * 1e6:9.1f} us/echo (min {min(per) * 1e6:.1f}, "
                  f"max {max(per) * 1e6:.1f}, {len(per)}/{reps} pairs) {gbps:7.2f} GB/s "
                  f"over {n_echoes[0]} echoes; launches {counts}")
            # where the time goes: device-busy share over a short window
            wall_us, busy_us, by_name = device_profile(torch, lambda: chain(8))
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
            if busy_us > 0:
                print(f"[profile] {mode:9} 8 echoes: wall {wall_us:.0f} us, device busy "
                      f"{busy_us:.0f} us ({100 * busy_us / wall_us:.1f}%); top "
                      + ", ".join(f"{name[:40]} {us:.0f} us" for name, us in top))
            else:
                print(f"[profile] {mode:9} device time not measured (no CUDA events)")
        ch.close()
    finally:
        srv.stop()
        fabric.chunk_mode = "fused"
    return totals


def phase_ps(torch, T):
    """The second main path: the batched parameter server at d = 6144.
    Returns (launch counts of the path, product rows for the times
    line)."""
    import numpy as np

    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.parameter_server import (
        _FORWARD_KERNEL,
        PS_BATCH_POLICY,
        PsService,
        ps_stub,
    )
    from incubator_brpc_tpu_torch.parallel.ici import get_fabric
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    d = PS_DIM
    seconds, reps = 1.0, 3  # per Forward point; Put/Get pairs
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "TF32 must stay off: the Forward product is float32")
    fabric = get_fabric()
    check(fabric.chunk_mode == "fused", f"fabric left in {fabric.chunk_mode} mode")
    srv = Server(ServerOptions(enable_batching=True))
    svc = PsService()  # the card by default
    srv.add_service(svc)
    check(srv.start_ici(0, 62) == 0, "start_ici failed")  # device defaults to cuda:0
    port_dev = srv._ici_port.device
    check(port_dev.type == "cuda", f"server port on {port_dev}")
    g = torch.Generator(device=port_dev).manual_seed(SEED)
    W = torch.randn((d, d), generator=g, device=port_dev) / d ** 0.5
    w_csum = T.device_copy_with_checksum(W)[1]  # K1 whole frame, outside the count
    req = EchoRequest(message="w")
    channels = []
    try:
        ch = Channel(ChannelOptions(timeout_ms=60000, ici_device=port_dev))
        check(ch.init("ici://slice0/chip62") == 0, "channel init failed")
        channels.append(ch)
        stub = ps_stub(ch)

        # ---- Put / Get of W over ici:// -------------------------------
        T.reset_launch_counts()  # the PS path's run starts here
        put_s, get_s = [], []
        for _ in range(reps):
            c = Controller()
            c.timeout_ms = 60000
            c.request_attachment.append_device(W)
            t0 = time.perf_counter()
            stub.Put(c, req)
            torch.cuda.synchronize()
            put_s.append(time.perf_counter() - t0)
            check(not c.failed(), f"Put failed: {c.error_text()}")
            stored = svc._store["w"]
            check(stored.device == port_dev and stored.data_ptr() != W.data_ptr(),
                  "Put must store the fresh tensor the fabric delivered")
            c = Controller()
            c.timeout_ms = 60000
            t0 = time.perf_counter()
            stub.Get(c, req)
            torch.cuda.synchronize()
            get_s.append(time.perf_counter() - t0)
            check(not c.failed(), f"Get failed: {c.error_text()}")
            segs = c.response_attachment.device_segments()
            check(len(segs) == 1 and segs[0].whole_array() is not None,
                  "Get must return one whole device segment")
            got = segs[0].array
            check(got.device == port_dev and got.data_ptr() not in
                  (W.data_ptr(), stored.data_ptr()), "Get must return a fresh tensor")
            check(torch.equal(got, W), "Get returned other bytes than were Put")
            check(segs[0].csum is not None and torch.equal(segs[0].csum, w_csum),
                  "Get's frame checksum differs from K1's whole-frame checksum")
            del got, segs, c
        put_launches = dict(T.launches)
        hops = 2 * reps  # the Put request and the Get response carry W
        for k, v in put_launches.items():
            # fused mode: one K1 over the frame's chunk plan per hop
            per_hop = 1 if k == "copy_csum_blocks" else 0
            check(v == per_hop * hops, f"ps: {k} launched {v} times for {hops} "
                                       f"hops of W, expected {per_hop} per hop")
        mb = W.nbytes / 1e6
        for name, ts in [("Put", put_s), ("Get", get_s)]:
            med = statistics.median(ts)
            print(f"[ps] {name} of W ({d}, {d}) f32, {mb:.1f} MB over ici://: "
                  f"{med * 1e3:.3f} ms median of {reps} [{min(ts) * 1e3:.3f}, "
                  f"{max(ts) * 1e3:.3f}], {W.nbytes / med / 1e9:.2f} GB/s")

        # ---- Forward, closed loop ---------------------------------------
        w_dev = svc._store["w"]
        for b in PS_BATCH_POLICY.padding_buckets:  # cuBLAS set-up out of the windows
            _FORWARD_KERNEL(w_dev, torch.zeros((b, d), device=port_dev))
        xs = np.random.RandomState(SEED).randn(64, d).astype(np.float32)
        x_bytes = [x.tobytes() for x in xs]
        x_dev = torch.from_numpy(xs).to(port_dev).double()
        ref = x_dev @ W.double()
        scale = x_dev.abs() @ W.abs().double()
        while len(channels) < 4:
            extra = Channel(ChannelOptions(timeout_ms=60000, ici_device=port_dev))
            check(extra.init("ici://slice0/chip62") == 0, "channel init failed")
            channels.append(extra)
        stubs = [ps_stub(c) for c in channels]

        def run_point(inflight, duration):
            """bench.py:2089-2150: each completion issues the next call,
            so `inflight` calls stay outstanding for `duration`.  Also
            returns the point's oldest-generation GC pauses (ms): one
            stalls every call in flight, so they set the tail."""
            lats, ys, errs, lock = [], [], [], threading.Lock()
            gc_ms, gc_t0 = [], [0.0]

            def on_gc(phase, info):
                if info["generation"] != 2:
                    return
                if phase == "start":
                    gc_t0[0] = time.perf_counter()
                else:
                    gc_ms.append((time.perf_counter() - gc_t0[0]) * 1e3)
            active = [inflight]
            drained = threading.Event()
            stop_at = time.monotonic() + duration

            def issue(slot, k):
                c = Controller()
                c.timeout_ms = 20000
                idx = k % len(xs)
                c.request_attachment.append_user_data(x_bytes[idx])
                t0 = time.monotonic_ns()

                def on_done():
                    now = time.monotonic()
                    with lock:
                        if c.failed():
                            errs.append(c.error_text())
                        else:
                            lats.append((time.monotonic_ns() - t0) // 1000)
                            ys.append((idx, c.response_attachment.to_bytes()))
                    if now < stop_at:
                        issue(slot, k + inflight)
                        return
                    with lock:
                        active[0] -= 1
                        if active[0] == 0:
                            drained.set()

                stubs[slot % len(stubs)].Forward(c, req, done=on_done)

            gc.callbacks.append(on_gc)
            try:
                t_start = time.monotonic()
                for slot in range(inflight):
                    issue(slot, slot)
                check(drained.wait(timeout=duration + 60), "Forward load did not drain")
                wall = time.monotonic() - t_start
            finally:
                gc.callbacks.remove(on_gc)
            check(not errs, f"Forward failed: {errs[:3]}")
            lats.sort()
            return lats, ys, wall, gc_ms

        def off_by(got, idx):
            """Forward's check, |y - ref| <= PS_RTOL * (|x| @ |W|) per
            output: (outputs past it, worst |y - ref| / (|x| @ |W|))."""
            return past_f64(got, ref[idx], scale[idx])

        def verify(ys):
            idx = torch.tensor([i for i, _ in ys], device=port_dev)
            got = torch.from_numpy(
                np.frombuffer(bytearray(b"".join(y for _, y in ys)), np.float32)
                .reshape(len(ys), d)
            ).to(port_dev)
            bad, worst = off_by(got, idx)
            check(bad == 0, f"{bad} Forward outputs off by up to {worst:.3g} of |x| @ |W|")
            return worst

        pct = lambda lats, p: lats[min(len(lats) - 1, int(len(lats) * p))]  # noqa: E731
        points = {}
        for par in (1, 32):
            for cfg in ("off", "on"):
                if cfg == "off":
                    srv.disable_method_batching("PsService.Forward")
                else:  # the decorator's PS_BATCH_POLICY: buckets up to 32
                    srv.enable_method_batching("PsService.Forward")
                batcher = srv.batcher("PsService.Forward")
                run_point(min(par, 4), 0.1)  # warm
                rows0 = batcher.rows if batcher else 0
                batches0 = batcher.batches if batcher else 0
                lats, ys, wall, gc_ms = run_point(par, seconds)
                worst = verify(ys)
                rows = (batcher.rows - rows0) if batcher else len(ys)
                batches = (batcher.batches - batches0) if batcher else len(ys)
                seen = batcher.max_batch_seen if batcher else 1
                qps = len(lats) / wall
                points[(par, cfg)] = qps
                print(f"[ps] Forward parallelism {par:2} batching {cfg:3}: "
                      f"{qps:9.1f} qps, p50 {pct(lats, 0.5)} us, p99 {pct(lats, 0.99)} us "
                      f"over {len(lats)} calls in {wall:.2f} s; {batches} batches for "
                      f"{rows} rows, max batch {seen}; max |y - ref| / (|x| @ |W|) {worst:.3g}; "
                      f"gen-2 GC pauses {len(gc_ms)}, longest {max(gc_ms, default=0):.1f} ms")
                if (par, cfg) == (32, "on"):
                    check(seen >= 2, f"max_batch_seen {seen} at parallelism 32: "
                                     f"the batcher never coalesced")
                    check(batches < rows, f"{batches} batches for {rows} rows: nothing coalesced")
        for par in (1, 32):
            print(f"[ps] Forward on/off speedup at parallelism {par}: "
                  f"{points[(par, 'on')] / points[(par, 'off')]:.2f}x")
        traces = _FORWARD_KERNEL.trace_count()
        check(traces <= len(PS_BATCH_POLICY.padding_buckets),
              f"the Forward product traced {traces} shapes, bound "
              f"{len(PS_BATCH_POLICY.padding_buckets)}")
        counts = dict(T.launches)  # ... and ends here
        check(counts == put_launches, f"Forward launched copy kernels: {counts}")
        print(f"[ps] Forward product traces {traces} (bound "
              f"{len(PS_BATCH_POLICY.padding_buckets)}); launches {counts}")
        # control: the same check must refuse a TF32 product (bucket 32,
        # a traced shape); the flag is restored before anything else runs
        idx = torch.arange(32, device=port_dev)
        x32 = torch.from_numpy(xs[:32]).to(port_dev)
        sound = off_by(_FORWARD_KERNEL(w_dev, x32), idx)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = off_by(_FORWARD_KERNEL(w_dev, x32), idx)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        print(f"[ps] check control, 32 rows: float32 {sound[0]} outputs past {PS_RTOL}, "
              f"worst {sound[1]:.3g}; TF32 {tf32[0]} of {32 * d} past it, worst {tf32[1]:.3g}")
        check(sound[0] == 0, "the float32 product failed the Forward check")
        check(tf32[0] > 0, "the Forward check did not refuse a TF32 product")
        # where the time goes at parallelism 32, batching on
        wall_us, busy_us, by_name = device_profile(torch, lambda: run_point(32, 0.3))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        check(busy_us > 0, "the profiler saw no CUDA work in the Forward window")
        print(f"[profile] ps forward p32 on: wall {wall_us:.0f} us, device busy "
              f"{busy_us:.0f} us ({100 * busy_us / wall_us:.1f}%); top "
              + ", ".join(f"{name[:48]} {us:.0f} us" for name, us in top))
        products = phase_products(
            torch, _FORWARD_KERNEL, w_dev, "ps_forward",
            "incubator_brpc_tpu_torch/models/parameter_server.py",
            "incubator_brpc_tpu/models/parameter_server.py:101 "
            "(x @ w under jax.jit: an XLA op, not a TPU kernel)")
    finally:
        for c in channels:
            c.close()
        srv.stop()
    return counts, products


def phase_products(torch, step, w, name, source, replaces, row_bytes=0, row_ops=0,
                   buckets=(1, 8, 32), iters=20):
    """A product step(w, x) of x (bucket, d) with W alone, per bucket:
    device time from the profiler, beside its bound.  ``row_bytes`` and
    ``row_ops`` are what the step moves and does per row beyond x @ W."""
    d = w.shape[0]
    rows = []
    for b in buckets:
        x = torch.randn((b, d), generator=torch.Generator(device=w.device).manual_seed(b),
                        device=w.device)
        step(w, x)
        seen = profile_windows(torch, lambda: [step(w, x) for _ in range(iters)],
                               f"{name} at bucket {b}")
        busy_us = statistics.median(busy for busy, _ in seen)
        by_name = seen[0][1]
        ms = busy_us / iters / 1e3
        t_bytes = (w.nbytes + 2 * b * d * 4 + b * row_bytes) / HBM_BYTES_PER_S * 1e3
        t_ops = (2 * b * d * d + b * row_ops) / F32_OPS_PER_S * 1e3
        kernel = max(by_name, key=by_name.get)
        rows.append({
            "name": f"{name}_b{b}", "route": "torch.matmul", "source": source,
            "replaces": replaces, "ms": ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "kernel": kernel[:80],
        })
        print(f"[times] {name} b={b:2} d={d}: {ms:.4f} ms (bound "
              f"{max(t_bytes, t_ops):.4f} ms by {rows[-1]['bound_by']}); {kernel[:60]}")
    return rows


class LruModel:
    """The cache store's budget and LRU order, written plainly: what
    its evictions and bytes must be after the same SETs and GETs."""

    def __init__(self, budget):
        self.budget, self.sizes, self.evictions = budget, {}, 0

    def set(self, key, n):
        self.sizes.pop(key, None)
        while sum(self.sizes.values()) + n > self.budget and self.sizes:
            del self.sizes[next(iter(self.sizes))]
            self.evictions += 1
        self.sizes[key] = n

    def touch(self, key):
        if key in self.sizes:
            self.sizes[key] = self.sizes.pop(key)

    @property
    def used(self):
        return sum(self.sizes.values())


def median_ms(ts):
    return statistics.median(ts) * 1e3


def phase_cache(torch, T):
    """The third main path: the HBM cache tier at a cache node's size.
    Returns the launch counts of the path."""
    from incubator_brpc_tpu_torch.analysis.device_witness import transfer_counts
    from incubator_brpc_tpu_torch.cache import HBMCacheService, HBMCacheStore
    from incubator_brpc_tpu_torch.cache import store as cache_store
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.observability.profiling import kernel_snapshot
    from incubator_brpc_tpu_torch.protocols import redis as R
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    store = HBMCacheStore(CACHE_BUDGET)  # the card by default
    check(store.device.type == "cuda", f"cache store on {store.device}")
    svc = HBMCacheService(store=store)
    srv = Server(ServerOptions(redis_service=svc))
    check(srv.start_ici(0, 61) == 0, "start_ici failed")
    tcp_srv = Server(ServerOptions(redis_service=svc))  # the host lane, same store
    check(tcp_srv.start(0) == 0, "tcp start failed")
    dev = srv._ici_port.device
    g = torch.Generator(device=dev).manual_seed(SEED)
    vals = torch.randint(0, 256, (CACHE_SETS, CACHE_VALUE), generator=g,
                         dtype=torch.uint8, device=dev)
    key = lambda i: b"v%05d" % i  # noqa: E731
    model = LruModel(CACHE_BUDGET)
    channels = []

    def rcall(ch, *commands):
        req = R.RedisRequest()
        for cmd in commands:
            req.add_command(*cmd)
        resp = R.RedisResponse()
        c = Controller()
        c.timeout_ms = 60000
        t0 = time.perf_counter()
        ch.call_method(R.redis_method_spec(), c, req, resp)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check(not c.failed(), f"redis call {commands[0][0]} failed: {c.error_text()}")
        return resp, dt

    try:
        ch = Channel(ChannelOptions(protocol="redis", timeout_ms=60000, ici_device=dev))
        check(ch.init("ici://slice0/chip61") == 0, "ici channel init failed")
        tcp = Channel(ChannelOptions(protocol="redis", timeout_ms=60000))
        check(tcp.init(f"127.0.0.1:{tcp_srv.port}") == 0, "tcp channel init failed")
        channels += [ch, tcp]
        ev0 = cache_store.cache_evictions.get_value()

        T.reset_launch_counts()  # the cache path's run starts here
        # ---- SETs: 2048 device values of 1 MiB over ici:// ------------
        set_s = []
        for i in range(CACHE_SETS):
            resp, dt = rcall(ch, ("SET", key(i), vals[i]))
            check(resp.reply(0).value == "OK", f"SET {i}: {resp.reply(0).value!r}")
            set_s.append(dt)
            model.set(key(i), CACHE_VALUE)
        n_set = dict(T.launches)
        check(n_set["copy_csum_blocks"] == CACHE_SETS,
              f"{n_set} for {CACHE_SETS} SET hops: expected 1 K1 per hop")
        evictions = cache_store.cache_evictions.get_value() - ev0
        check(evictions == model.evictions == CACHE_SETS - CACHE_BUDGET // CACHE_VALUE,
              f"evictions {evictions}, expected {model.evictions}")
        check(store.hbm_used == model.used == CACHE_BUDGET,
              f"hbm_used {store.hbm_used}, expected {model.used}")
        check(store.keys() == list(model.sizes), "LRU order differs from the model")
        newest = store.get(key(CACHE_SETS - 1))
        check(newest.device == dev and newest.data_ptr() != vals[CACHE_SETS - 1].data_ptr()
              and newest.untyped_storage().nbytes() == CACHE_VALUE,
              "the store must adopt the fresh 1 MiB tensor the fabric delivered")

        # ---- GET over ici:// --------------------------------------------
        T.reset_launch_counts()
        get_s = []
        for j in range(CACHE_GETS):
            i = CACHE_SETS - 1 - j
            resp, dt = rcall(ch, ("GET", key(i)))
            model.touch(key(i))
            arr = resp.reply(0).device_array()
            check(arr is not None and arr.is_cuda and arr.device == dev,
                  "ICI GET must return a CUDA tensor")
            check(arr.data_ptr() != store.get(key(i)).data_ptr(),
                  "ICI GET must return a fresh tensor")
            check(torch.equal(arr, vals[i]), f"GET {i} returned other bytes than were SET")
            get_s.append(dt)
        n_get = dict(T.launches)
        check(n_get["copy_csum_blocks"] == CACHE_GETS,
              f"{n_get} for {CACHE_GETS} GET hops: expected 1 K1 per hop")

        # ---- DMGET of 32 same-length keys over ici:// --------------------
        T.reset_launch_counts()
        dm_keys = [key(i) for i in range(CACHE_SETS - DMGET_KEYS, CACHE_SETS)]
        dmget_s = []
        for _ in range(CACHE_DMGETS):
            gathers0 = kernel_snapshot().get("fused.cache.mget_gather", {}).get("executions", 0)
            resp, dt = rcall(ch, ("DMGET", *dm_keys))
            gathers = kernel_snapshot()["fused.cache.mget_gather"]["executions"] - gathers0
            for k in dm_keys:
                model.touch(k)
            fused, lengths, payload = resp.reply(0).value
            stacked = payload.device_array()
            check(fused.value == 1 and gathers == 1, f"DMGET fused={fused.value}, "
                  f"{gathers} gathers: expected one fused gather")
            check([x.value for x in lengths.value] == [CACHE_VALUE] * DMGET_KEYS,
                  "DMGET lengths")
            check(stacked is not None and stacked.is_cuda
                  and tuple(stacked.shape) == (DMGET_KEYS, CACHE_VALUE),
                  f"DMGET payload {None if stacked is None else tuple(stacked.shape)}")
            check(torch.equal(stacked, vals[CACHE_SETS - DMGET_KEYS:]),
                  "DMGET rows differ from what was SET")
            dmget_s.append(dt)
        n_dmget = dict(T.launches)
        check(n_dmget["copy_csum_blocks"] == CACHE_DMGETS,
              f"{n_dmget} for {CACHE_DMGETS} DMGET reply hops: expected 1 K1 per hop")

        # ---- DMSET of 32 keys over ici:// --------------------------------
        T.reset_launch_counts()
        pairs = []
        for i in range(DMGET_KEYS):
            pairs.extend((b"dm%02d" % i, vals[i]))
            model.set(b"dm%02d" % i, CACHE_VALUE)
        resp, dmset_dt = rcall(ch, ("DMSET", *pairs))
        check(resp.reply(0).value == DMGET_KEYS, f"DMSET stored {resp.reply(0).value}")
        n_dmset = dict(T.launches)
        for i in range(DMGET_KEYS):
            check(torch.equal(store.get(b"dm%02d" % i), vals[i]), f"DMSET key {i} differs")

        # ---- the TCP lane: GET spills to host bytes -----------------------
        T.reset_launch_counts()
        spills0 = transfer_counts().get("cache.host-spill", 0)
        tcp_s = []
        host_ref = vals[CACHE_SETS - 1].cpu().numpy().tobytes()
        for _ in range(CACHE_TCP_GETS):
            resp, dt = rcall(tcp, ("GET", key(CACHE_SETS - 1)))
            model.touch(key(CACHE_SETS - 1))
            r = resp.reply(0)
            check(r.device_array() is None and r.bytes_value() == host_ref,
                  "TCP GET must spill the exact bytes")
            tcp_s.append(dt)
        spills = transfer_counts().get("cache.host-spill", 0) - spills0
        check(spills == CACHE_TCP_GETS, f"{spills} host spills for {CACHE_TCP_GETS} TCP GETs")
        n_tcp = dict(T.launches)
        check(n_tcp["copy_csum_blocks"] == 0, f"TCP GETs launched {n_tcp}")

        # ---- a 4 KB value through both lanes --------------------------------
        T.reset_launch_counts()
        small = bytes(range(256)) * (SMALL_VALUE // 256)
        rcall(tcp, ("SET", b"small", small))  # host ingest: one h2d copy
        model.set(b"small", SMALL_VALUE)
        small_ici, small_tcp = [], []
        for _ in range(CACHE_GETS):
            resp, dt = rcall(ch, ("GET", b"small"))
            arr = resp.reply(0).device_array()
            check(arr is not None and arr.is_cuda and arr.cpu().numpy().tobytes() == small,
                  "4 KB ICI GET")
            small_ici.append(dt)
            resp, dt = rcall(tcp, ("GET", b"small"))
            check(resp.reply(0).bytes_value() == small, "4 KB TCP GET")
            small_tcp.append(dt)
            model.touch(b"small")
        n_small = dict(T.launches)
        check(n_small["copy_csum_blocks"] == CACHE_GETS,
              f"{n_small} for {CACHE_GETS} 4 KB ICI GETs: expected 1 K1 per hop")
        evictions = cache_store.cache_evictions.get_value() - ev0
        check(evictions == model.evictions and store.hbm_used == model.used
              and store.keys() == list(model.sizes),
              f"after DMSET and the 4 KB SET: evictions {evictions} (model "
              f"{model.evictions}), hbm_used {store.hbm_used} (model {model.used})")
        counts = {k: n_set[k] + n_get[k] + n_dmget[k] + n_dmset[k] + n_tcp[k] + n_small[k]
                  for k in T.launches}  # ... and ends here

        mb, size = CACHE_VALUE / 1e6, f"{CACHE_VALUE >> 10} KiB"
        print(f"[cache] store {CACHE_BUDGET >> 20} MiB on {dev}: {CACHE_SETS} SETs of {size} over "
              f"ici://, {median_ms(set_s):.3f} ms median [{min(set_s) * 1e3:.3f}, "
              f"{max(set_s) * 1e3:.3f}], {mb / statistics.median(set_s) / 1e3:.2f} GB/s; "
              f"evictions {evictions} (model {model.evictions}), hbm_used {store.hbm_used} "
              f"(model {model.used}), entries {len(store)}")
        print(f"[cache] GET {size} over ici://: {median_ms(get_s):.3f} ms median of "
              f"{CACHE_GETS} [{min(get_s) * 1e3:.3f}, {max(get_s) * 1e3:.3f}]; K1 per hop "
              f"{n_get['copy_csum_blocks'] / CACHE_GETS:g}")
        print(f"[cache] DMGET {DMGET_KEYS} x {size} over ici://: {median_ms(dmget_s):.3f} ms median of "
              f"{CACHE_DMGETS} [{min(dmget_s) * 1e3:.3f}, {max(dmget_s) * 1e3:.3f}], "
              f"{DMGET_KEYS * mb / statistics.median(dmget_s) / 1e3:.2f} GB/s; one fused "
              f"gather, K1 per hop {n_dmget['copy_csum_blocks'] / CACHE_DMGETS:g}")
        print(f"[cache] DMSET {DMGET_KEYS} x {size} over ici://: {dmset_dt * 1e3:.3f} ms; K1 "
              f"{n_dmset['copy_csum_blocks']} in its one request hop (one per value)")
        print(f"[cache] TCP GET {size} (host spill): {median_ms(tcp_s):.3f} ms median of "
              f"{CACHE_TCP_GETS}; {SMALL_VALUE} B GET: ici:// {median_ms(small_ici):.3f} ms, TCP "
              f"{median_ms(small_tcp):.3f} ms median of {CACHE_GETS}")
        print(f"[cache] launches {counts}")

        def window():
            for j in range(16):
                rcall(ch, ("GET", key(CACHE_SETS - 1 - j)))
            for _ in range(2):
                rcall(ch, ("DMGET", *dm_keys))
        wall_us, busy_us, by_name = device_profile(torch, window)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        check(busy_us > 0, "the profiler saw no CUDA work in the cache window")
        print(f"[profile] cache 16 GETs + 2 DMGETs: wall {wall_us:.0f} us, device busy "
              f"{busy_us:.0f} us ({100 * busy_us / wall_us:.1f}%); top "
              + ", ".join(f"{name[:40]} {us:.0f} us" for name, us in top))
    finally:
        for c in channels:
            c.close()
        srv.stop()
        tcp_srv.stop()
        store.flush()
    return counts


def phase_stream(torch, T):
    """A stream over ici://: the echo service sends each device frame
    back; one K1 per frame per hop.  Returns the launch counts."""
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.client.stream import Stream, StreamHandler
    from incubator_brpc_tpu_torch.models.streaming_echo import StreamingEchoService
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server
    from incubator_brpc_tpu_torch.server.service import ServiceStub

    class Collect(StreamHandler):
        def __init__(self):
            self.frames, self.cv = [], threading.Condition()

        def on_received_messages(self, stream, messages):
            with self.cv:
                self.frames.extend(messages)
                self.cv.notify_all()

    srv = Server()
    srv.add_service(StreamingEchoService())
    check(srv.start_ici(0, 60) == 0, "start_ici failed")
    dev = srv._ici_port.device
    x = make_payload(torch, (256, 1024), torch.float32, SEED)  # 1 MiB frames
    try:
        ch = Channel(ChannelOptions(timeout_ms=30000, ici_device=dev))
        check(ch.init("ici://slice0/chip60") == 0, "channel init failed")
        ctrl, sink = Controller(), Collect()
        stream = Stream.create(ctrl, sink)
        ServiceStub(ch, StreamingEchoService).StartStream(ctrl, EchoRequest(message="s"))
        check(not ctrl.failed() and stream.wait_established(10), "stream not established")
        T.reset_launch_counts()  # the stream path's run starts here
        for _ in range(STREAM_FRAMES):
            check(stream.write_device(x, timeout=30) == 0, "stream write failed")
        with sink.cv:
            check(sink.cv.wait_for(lambda: len(sink.frames) >= STREAM_FRAMES, 30),
                  f"{len(sink.frames)} of {STREAM_FRAMES} frames came back")
        torch.cuda.synchronize()
        counts = dict(T.launches)  # ... and ends here
        for f in sink.frames:
            arr = f.device_arrays()[0]
            check(arr.is_cuda and torch.equal(arr.view(torch.float32).reshape(x.shape), x),
                  "a streamed frame came back with other bytes")
        check(counts["copy_csum_blocks"] == 2 * STREAM_FRAMES,
              f"{counts} for {STREAM_FRAMES} frames echoed: expected 1 K1 per frame per hop")
        print(f"[stream] {STREAM_FRAMES} frames of {x.nbytes >> 10} KiB echoed over ici://, "
              f"device-resident both ways; launches {counts}")
        stream.close()
        ch.close()
    finally:
        srv.stop()
    return counts


CHILD_SRC = r'''
import json, sys
root, device, slice_id, budget = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
sys.path.insert(0, root)
import torch
from incubator_brpc_tpu_torch.cache import HBMCacheService, HBMCacheStore
from incubator_brpc_tpu_torch.models.echo import EchoService
from incubator_brpc_tpu_torch.ops import transfer as T
from incubator_brpc_tpu_torch.parallel.dcn import listen_dcn
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

dev = torch.device(device)
echo = Server()
echo.add_service(EchoService())
assert echo.start_ici(slice_id, 0, device=dev) == 0
store = HBMCacheStore(budget, device=dev)
cache = Server(ServerOptions(redis_service=HBMCacheService(store=store)))
assert cache.start_ici(slice_id, 1, device=dev) == 0
print(json.dumps({"dcn_port": listen_dcn(0, host="127.0.0.1"), "device": str(dev)}), flush=True)
for line in sys.stdin:  # one command a line, one JSON line back
    cmd = line.strip()
    if cmd == "launches":
        out = dict(T.launches)
    elif cmd == "reset":
        T.reset_launch_counts()
        out = {}
    elif cmd == "store":
        out = {"keys": len(store), "hbm_used": store.hbm_used}
    else:
        break
    print(json.dumps(out), flush=True)
echo.stop()
cache.stop()
store.flush()
'''


class SmokeChild:
    """The second process of the dcn and cluster phases: a fresh
    interpreter running the port on ``device``, with an echo server at
    ici://slice{slice_id}/chip0 and an HBM cache node (a 1 GiB store) at
    chip1, behind ``listen_dcn``.  ``cmd`` asks it for its launch
    counts (``launches``), resets them (``reset``) or reads its store
    (``store``)."""

    def __init__(self, device, slice_id):
        import tempfile

        self.slice = slice_id
        self.err = tempfile.TemporaryFile(mode="w+")
        root = str(pathlib.Path(__file__).resolve().parent)
        self.proc = subprocess.Popen(
            [sys.executable, "-c", CHILD_SRC, root, str(device), str(slice_id),
             str(CACHE_BUDGET)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self.err, text=True,
        )
        info = self._line()
        self.dcn_port = info["dcn_port"]
        check(info["device"] == str(device), f"child on {info['device']}, not {device}")

    def _line(self) -> dict:
        line = self.proc.stdout.readline()
        if not line.startswith("{"):
            self.err.seek(0)
            fail(f"the dcn child said {line!r}; its stderr ends:\n{self.err.read()[-3000:]}")
        return json.loads(line)

    def cmd(self, name: str) -> dict:
        self.proc.stdin.write(name + "\n")
        self.proc.stdin.flush()
        return self._line()

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.write("quit\n")
                self.proc.stdin.close()
                self.proc.wait(60)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait(10)
        self.err.close()


def phase_dcn(torch, T, child, main_csum):
    """The DCN bridge: a 64 MB float32 device tensor echoed through the
    child's echo server (bench_dcn_bulk's 64 MB, 7 reps, the first echo
    apart), then a bfloat16 one.  Returns (the parent's launch counts,
    the child's, K1's max |acc - plain| on a DCN-uploaded frame)."""
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.client.naming_service import TpuTopologyNamingService
    from incubator_brpc_tpu_torch.models.echo import echo_stub
    from incubator_brpc_tpu_torch.parallel import dcn
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest

    S = child.slice
    coords = dcn.connect_dcn("127.0.0.1", child.dcn_port)
    check({(S, 0), (S, 1)} <= set(coords), f"the bridge advertised {coords}")
    named = {n.endpoint.coords for n in TpuTopologyNamingService().get_servers("fabric")}
    check({(S, 0), (S, 1)} <= named, f"tpu://fabric resolved {sorted(named, key=str)}")
    peers = [c.peer for c in dcn.get_bridge()._conns if not c.closed]
    uds = any(p.startswith("uds:") for p in peers)
    dev = card(torch)
    uploads = []
    upload = dcn._upload

    def recording_upload(*args):
        t = upload(*args)
        uploads[:] = [t]  # the last DCN-uploaded tensor, for the kernel check
        return t

    ch = Channel(ChannelOptions(timeout_ms=60000, ici_device=dev))
    check(ch.init(f"ici://slice{S}/chip0") == 0, "dcn channel init failed")
    stub = echo_stub(ch)
    x = make_payload(torch, MAIN_SHAPE, torch.float32, SEED)
    xb = make_payload(torch, DCN_BF16_SHAPE, torch.bfloat16, SEED + 1)
    frames = [0]

    def echo(t):
        c = Controller()
        c.timeout_ms = 60000
        c.request_attachment.append_device(t)
        t0 = time.perf_counter()
        stub.Echo(c, EchoRequest(message="dcn"))
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        check(not c.failed(), f"dcn echo failed: {c.error_text()}")
        segs = c.response_attachment.device_segments()
        check(len(segs) == 1 and segs[0].whole_array() is not None,
              "the dcn response must be one whole device segment")
        out = segs[0].array
        check(out.is_cuda and out.device == dev, f"dcn response on {out.device}")
        check(out.data_ptr() != t.data_ptr(), "dcn response is not a fresh buffer")
        check(out.dtype == t.dtype and out.shape == t.shape and torch.equal(out, t),
              f"dcn {t.dtype} echo came back with other bytes")
        frames[0] += 1
        return segs[0], dt

    dcn._upload = recording_upload
    try:
        child.cmd("reset")
        T.reset_launch_counts()  # the dcn path's run starts here
        times = []
        for _ in range(DCN_REPS + 1):
            ref, dt = echo(x)
            # the parent's receiving hop ran K1 over the uploaded bytes
            check(ref.csum is not None and torch.equal(ref.csum, main_csum),
                  "the dcn response's checksum differs from K1's whole-frame checksum")
            times.append(dt)
        uploaded = uploads[0]
        _, bf16_dt = echo(xb)
        counts = dict(T.launches)  # ... and ends here
        child_counts = child.cmd("launches")
    finally:
        dcn._upload = upload
        ch.close()
    check(counts["copy_csum_blocks"] == frames[0],
          f"parent {counts} for {frames[0]} device frames received: expected 1 K1 each")
    check(child_counts["copy_csum_blocks"] >= frames[0],
          f"child {child_counts} for {frames[0]} device frames received: expected >= 1 K1 each")
    check(uploaded.is_cuda and uploaded.device == dev and uploaded.shape == x.shape,
          f"the DCN upload landed on {uploaded.device} as {tuple(uploaded.shape)}")
    # K1 on a DCN-uploaded 64 MB tensor against its plain version
    br = T._fit_block_rows(uploaded.shape[0])
    out_k, acc_k = T._copy_csum(uploaded, None, br)
    _, acc_p = T.copy_csum_plain(uploaded, None, br)
    torch.cuda.synchronize(dev)
    check(torch.equal(out_k, x) and torch.equal(acc_k, acc_p),
          "K1 on the DCN-uploaded frame is not bit-equal to the plain version")
    err = (acc_k - acc_p).abs().max().item()
    first, med = times[0], statistics.median(times[1:])
    gbps = 2 * x.nbytes / med / 1e9
    print(f"[dcn] child pid {child.proc.pid} on {dev}: ici://slice{S}/chip0 (echo) and "
          f"chip1 (cache) resolved by tpu://fabric; bridge {'UDS' if uds else 'TCP'} "
          f"({', '.join(peers)})")
    print(f"[dcn] 64 MB f32 {tuple(MAIN_SHAPE)} echo: {med * 1e3:.3f} ms median of {DCN_REPS} "
          f"[{min(times[1:]) * 1e3:.3f}, {max(times[1:]) * 1e3:.3f}], {gbps:.2f} GB/s "
          f"(2 x 64 MiB / time); first echo {first * 1e3:.3f} ms ({first / med:.2f}x)")
    print(f"[dcn] bf16 {tuple(DCN_BF16_SHAPE)} echo {bf16_dt * 1e3:.3f} ms, byte-equal; "
          f"launches parent {counts}, child {child_counts} for {frames[0]} device frames "
          f"each way; K1 on the uploaded frame bit-equal to plain")
    return counts, child_counts, err


def phase_cluster(torch, T, child):
    """The clustered cache tier: three local nodes and the child's node
    across DCN behind one CacheChannel (mesh_locality); routing,
    DMGET, failover and revival, the stacked K2 DMSET, a replicated
    group and a live 2 -> 3 reshard.  Returns (launch counts of the
    path, the K2 row's extra fields)."""
    from incubator_brpc_tpu_torch.cache import CacheChannel, HBMCacheService, HBMCacheStore
    from incubator_brpc_tpu_torch.cache import store as cache_store
    from incubator_brpc_tpu_torch.chaos.harness import wait_until
    from incubator_brpc_tpu_torch.client.channel import ChannelOptions
    from incubator_brpc_tpu_torch.client.load_balancer import SelectIn, create_load_balancer
    from incubator_brpc_tpu_torch.client.naming_service import ServerNode
    from incubator_brpc_tpu_torch.observability.profiling import kernel_snapshot
    from incubator_brpc_tpu_torch.parallel.ici import (
        get_fabric,
        ici_pallas_stacked_frames,
        ici_pallas_stacked_segments,
    )
    from incubator_brpc_tpu_torch.replication import replicated_cache_group
    from incubator_brpc_tpu_torch.resharding import (
        CacheShardStore,
        MigrationView,
        ReshardCoordinator,
        moved_keys,
        shard_of,
    )
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
    from incubator_brpc_tpu_torch.utils.endpoint import str2endpoint
    from incubator_brpc_tpu_torch.utils.hashes import murmur3_32

    dev = card(torch)
    TS, S = CLUSTER_SLICE, child.slice
    local_eps = [f"ici://slice{TS}/chip{j}" for j in range(3)]
    dcn_ep = f"ici://slice{S}/chip1"
    eps = local_eps + [dcn_ep]

    def start_node(j):
        store = HBMCacheStore(CACHE_BUDGET, device=dev)
        check(store.device == dev, f"cluster store on {store.device}")
        srv = Server(ServerOptions(redis_service=HBMCacheService(store=store)))
        check(srv.start_ici(TS, j, device=dev) == 0, f"start_ici of cluster node {j} failed")
        return store, srv

    def opts():
        return ChannelOptions(timeout_ms=60000, ici_device=dev)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    nodes = [start_node(j) for j in range(3)]
    stores = [n[0] for n in nodes]
    channels = []
    g = torch.Generator(device=dev).manual_seed(SEED)
    vals = torch.randint(0, 256, (CLUSTER_KEYS, CACHE_VALUE), generator=g,
                         dtype=torch.uint8, device=dev)
    steps = {}

    def step_counts(name):
        steps[name] = {k: v for k, v in T.launches.items() if v}
        T.reset_launch_counts()

    size = f"{CACHE_VALUE >> 10} KiB"
    t_phase = time.perf_counter()

    def say(msg):
        print(f"[cluster] {msg} [{time.perf_counter() - t_phase:.1f} s into the phase]")

    try:
        cc = CacheChannel("list://" + ",".join(eps), lb="mesh_locality",
                          local_coords=(TS, 0), options=opts())
        singles = {ep: CacheChannel(f"list://{ep}", lb="rr", options=opts()) for ep in eps}
        channels += [cc, *singles.values()]

        def flush_all():
            for ch in singles.values():
                ch.flush_all()
            check(all(len(s) == 0 for s in stores), "a local node kept keys after FLUSHALL")

        # ---- fill and route: 2048 SETs of 1 MiB, GETs of all -------------
        keys = [b"c%05d" % i for i in range(CLUSTER_KEYS)]
        ring = create_load_balancer("c_murmurhash")
        for ep in local_eps:  # mesh_locality: the ring restricted to the local slice
            ring.add_server(ServerNode(str2endpoint(ep)))
        owner = {k: str(ring.select_server(SelectIn(request_code=murmur3_32(k))).endpoint)
                 for k in keys}
        ev0 = cache_store.cache_evictions.get_value()
        T.reset_launch_counts()  # the cluster path's run starts here
        set_s = [timed(lambda i=i, k=k: cc.set(k, vals[i]))[1] for i, k in enumerate(keys)]
        step_counts("set")
        get_s = []
        for i, k in enumerate(keys):
            v, dt = timed(lambda k=k: cc.get(k))
            check(isinstance(v, torch.Tensor) and v.device == dev and torch.equal(v, vals[i]),
                  f"cluster GET {k!r} returned other bytes than were SET")
            get_s.append(dt)
        step_counts("get")
        check(cache_store.cache_evictions.get_value() == ev0, "the fill evicted")
        per_node = []
        for ep, store in zip(local_eps, stores):
            want = {k for k in keys if owner[k] == ep}
            check(set(store.keys()) == want,
                  f"{ep} holds {len(store)} keys, the ring predicts {len(want)}")
            check(store.hbm_used == len(want) * CACHE_VALUE,
                  f"{ep} hbm_used {store.hbm_used} for {len(want)} keys")
            per_node.append(len(want))
        check(singles[dcn_ep].keys() == [], "the DCN node took keys from a healthy local slice")
        check(cc.balancer().picks_remote == 0, "a healthy local slice spilled to DCN")
        say(f"nodes {local_eps} on {dev} + {dcn_ep} across DCN, {CACHE_BUDGET >> 20} MiB "
            f"stores; mesh_locality from (slice{TS}, chip0): {CLUSTER_KEYS} SETs of {size} "
            f"routed as the ring predicts, keys per node {per_node} + 0 on the DCN node, no "
            f"eviction; SET {median_ms(set_s):.3f} ms, GET {median_ms(get_s):.3f} ms median")

        # ---- where the time goes over GETs ------------------------------------
        def window():
            for k in keys[:16]:
                cc.get(k)
        wall_us, busy_us, by_name = device_profile(torch, window)
        if busy_us > 0:
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
            print(f"[profile] cluster 16 GETs: wall {wall_us:.0f} us, device busy "
                  f"{busy_us:.0f} us ({100 * busy_us / wall_us:.1f}%); top "
                  + ", ".join(f"{name[:40]} {us:.0f} us" for name, us in top))
        else:
            print(f"[profile] cluster 16 GETs: wall {wall_us:.0f} us, device time not "
                  f"measured (the profiler returned no CUDA events)")
        T.reset_launch_counts()  # the window's launches are not the path's

        # ---- the DCN node, from a client in its own slice ------------------
        cd = CacheChannel("list://" + ",".join(eps), lb="mesh_locality",
                          local_coords=(S, 0), options=opts())
        channels.append(cd)
        child.cmd("reset")
        dkeys = [b"d%03d" % j for j in range(CLUSTER_DCN_KEYS)]
        dset_s = [timed(lambda j=j, k=k: cd.set(k, vals[j]))[1] for j, k in enumerate(dkeys)]
        dget_s = []
        for j, k in enumerate(dkeys):
            v, dt = timed(lambda k=k: cd.get(k))
            check(isinstance(v, torch.Tensor) and v.device == dev and torch.equal(v, vals[j]),
                  f"DCN GET {k!r} returned other bytes")
            dget_s.append(dt)
        step_counts("dcn_node")
        child_node = child.cmd("store")
        child_k1 = child.cmd("launches")["copy_csum_blocks"]
        check(child_node == {"keys": CLUSTER_DCN_KEYS, "hbm_used": CLUSTER_DCN_KEYS * CACHE_VALUE},
              f"the DCN node holds {child_node}")
        check(steps["dcn_node"].get("copy_csum_blocks") == CLUSTER_DCN_KEYS
              and child_k1 == CLUSTER_DCN_KEYS,
              f"DCN node: parent {steps['dcn_node']}, child K1 {child_k1} for "
              f"{CLUSTER_DCN_KEYS} SETs and GETs (one K1 per receiving hop)")
        say(f"DCN node from its own slice: SET {median_ms(dset_s):.3f} ms, GET "
            f"{median_ms(dget_s):.3f} ms median of {CLUSTER_DCN_KEYS}; child K1 {child_k1}")

        # ---- DMGET: 32 co-located keys, one stacked reply ---------------------
        co = [i for i, k in enumerate(keys) if owner[k] == local_eps[1]][:DMGET_KEYS]
        dmget_s = []
        for _ in range(CACHE_DMGETS):
            gathers0 = kernel_snapshot().get("fused.cache.mget_gather", {}).get("executions", 0)
            res, dt = timed(lambda: cc.get_many([keys[i] for i in co]))
            gathers = kernel_snapshot()["fused.cache.mget_gather"]["executions"] - gathers0
            check(gathers == 1 and res.stacked is not None
                  and tuple(res.stacked.shape) == (DMGET_KEYS, CACHE_VALUE),
                  f"get_many of {DMGET_KEYS} co-located keys: {gathers} gathers, stacked "
                  f"{None if res.stacked is None else tuple(res.stacked.shape)}")
            for r, i in enumerate(co):
                row = res.row(r)
                check(row.data_ptr() == res.stacked[r].data_ptr() and torch.equal(row, vals[i]),
                      f"DMGET row {r} is not the stack's row with the SET bytes")
            dmget_s.append(dt)
        step_counts("dmget")
        say(f"get_many of {DMGET_KEYS} co-located keys: one DMGET, one stacked reply, "
            f"{median_ms(dmget_s):.3f} ms median of {CACHE_DMGETS}")

        # ---- failover and revival ---------------------------------------------
        node0 = ServerNode(str2endpoint(local_eps[0]))

        def isolated():
            st = cc._channel._lb._states.get(node0)
            return st is not None and st.breaker.is_isolated()

        def revived():  # the health check's probe connected and reset the breaker
            st = cc._channel._lb._states.get(node0)
            return (st is not None and st.health_task is not None
                    and st.health_task._stopped and not st.breaker.is_isolated())

        nodes[0][1].stop()
        stores[0].flush()
        fail_s, misses, hits = [], 0, 0
        for i, k in enumerate(keys):
            v, dt = timed(lambda k=k: cc.get(k))
            if owner[k] == local_eps[0]:
                check(v is None, f"{k!r} of the stopped node did not read as a clean miss")
                misses += 1
                fail_s.append(dt)
            else:
                check(v is not None and torch.equal(v, vals[i]), f"{k!r} lost by the failover")
                hits += 1
        check(isolated(), "the stopped node was never isolated")
        nodes[0] = start_node(0)
        stores[0] = nodes[0][0]
        t0 = time.perf_counter()
        check(wait_until(revived, timeout_s=REVIVE_DEADLINE_S),
              f"the health check did not revive node 0 within {REVIVE_DEADLINE_S} s")
        revive_s = time.perf_counter() - t0
        back = [i for i, k in enumerate(keys) if owner[k] == local_eps[0]][:20]
        for i in back:  # the restarted node's store is empty: miss, then refill
            check(cc.get(keys[i]) is None, "the restarted node answered from an old store")
            cc.set(keys[i], vals[i])
        b = cc.balancer()
        b.picks_local = b.picks_remote = 0
        for i in back:
            v = cc.get(keys[i])
            check(v is not None and torch.equal(v, vals[i]), "a refilled key lost its bytes")
        check(set(stores[0].keys()) == {keys[i] for i in back},
              "refilled keys did not route back to the revived node")
        locality = cc.locality_fraction()
        check(locality >= 0.9, f"locality {locality} after the revival")
        step_counts("failover")
        say(f"failover: node 0 stopped, {misses} clean misses ({median_ms(fail_s):.3f} ms "
            f"median), {hits} hits; revived by the health check in {revive_s:.2f} s "
            f"(deadline {REVIVE_DEADLINE_S} s), locality {locality:.2f}")

        # ---- one set_many of 32 values to one node: one stacked K2 --------
        flush_all()
        pkeys, i = [], 0
        while len(pkeys) < DMGET_KEYS:
            k = b"p%05d" % i
            if ring.select_server(SelectIn(request_code=murmur3_32(k))).endpoint == node0.endpoint:
                pkeys.append(k)
            i += 1
        pvals = [vals[j] for j in range(DMGET_KEYS)]
        fabric = get_fabric()
        saved = fabric.chunk_mode
        frames0 = int(ici_pallas_stacked_frames.get_value())
        segs0 = int(ici_pallas_stacked_segments.get_value())
        T.reset_launch_counts()
        fabric.chunk_mode = "pallas"
        try:
            stored, dmset_dt = timed(lambda: cc.set_many(list(zip(pkeys, pvals))))
        finally:
            fabric.chunk_mode = saved
        n_k2 = dict(T.launches)
        step_counts("stacked_dmset")
        frames = int(ici_pallas_stacked_frames.get_value()) - frames0
        segs = int(ici_pallas_stacked_segments.get_value()) - segs0
        check(stored == DMGET_KEYS and n_k2["copy_csum_staged"] == 1
              and n_k2["copy_csum_blocks"] == 0 and frames == 1 and segs == DMGET_KEYS,
              f"pallas-mode set_many of {DMGET_KEYS}: stored {stored}, launches {n_k2}, "
              f"stacked frames +{frames}, segments +{segs}: expected one K2")
        res = cc.get_many(pkeys)
        for r in range(DMGET_KEYS):
            check(torch.equal(res.row(r), pvals[r]), f"stacked DMSET value {r} read back differs")
        step_counts("stacked_readback")
        # K2 on the stack of those values against its plain version, then alone
        stack = torch.stack(pvals)
        m, n = stack.shape
        br = T._fit_block_rows(m)
        sr = T.pallas_stage_rows(stack, br)
        out_k2, acc_k2 = T._staged_copy_csum(stack, br, sr)
        _, acc_p = T.copy_csum_plain(stack, None, br)
        torch.cuda.synchronize(dev)
        check(torch.equal(out_k2, stack) and torch.equal(acc_k2, acc_p),
              "K2 on the DMSET stack is not bit-equal to the plain version")
        k2_err = (acc_k2 - acc_p).abs().max().item()
        k2_ms = device_ms(torch, lambda: T._staged_copy_csum(stack, br, sr, out=out_k2),
                          "copy_csum_staged")
        k2_bound = max((2 * stack.nbytes + 4 * n) / HBM_BYTES_PER_S, m * n / F32_OPS_PER_S) * 1e3
        say(f"pallas-mode set_many of {DMGET_KEYS} x {size} to one node: one stacked K2 "
            f"launch, {dmset_dt * 1e3:.3f} ms; K2 on the ({m}, {n}) u8 stack {k2_ms:.4f} ms "
            f"(bound {k2_bound:.4f} ms, {k2_ms / k2_bound:.2f}x), bit-equal to plain")

        # ---- a replicated group over the three local nodes ------------------
        flush_all()
        T.reset_launch_counts()
        group = replicated_cache_group("smoke.cache", [singles[ep] for ep in local_eps],
                                       endpoints=local_eps, register=False, lease_ttl_s=60.0)
        host = vals[:REPL_PUTS + REPL_BEHIND].cpu().numpy()
        rkeys = [f"q{i:05d}" for i in range(REPL_PUTS + REPL_BEHIND)]
        put_s = [timed(lambda i=i: group.put(rkeys[i], host[i].tobytes()))[1]
                 for i in range(REPL_PUTS)]
        check(group.counters["quorum_writes"] == REPL_PUTS,
              f"{group.counters['quorum_writes']} quorum writes for {REPL_PUTS} puts")
        behind = "smoke.cache.2"
        group.mark_dead(behind)
        for i in range(REPL_PUTS, REPL_PUTS + REPL_BEHIND):
            group.put(rkeys[i], host[i].tobytes())
        group.delete(rkeys[0])
        group.mark_alive(behind)
        copied, repair_dt = timed(lambda: group.repair(behind))
        check(copied == REPL_BEHIND and group.counters["repair_keys"] == REPL_BEHIND,
              f"repair copied {copied}, repair_keys {group.counters['repair_keys']}; "
              f"expected {REPL_BEHIND}")
        check(all(s.get(rkeys[0].encode()) is None for s in stores), "the deleted key came back")
        for i in range(1, REPL_PUTS + REPL_BEHIND):
            for s in stores:
                v = s.get(rkeys[i].encode())
                check(v is not None and torch.equal(v, vals[i]),
                      f"replica value {rkeys[i]} differs on a node")
        step_counts("replication")
        say(f"replicated group of 3: {REPL_PUTS} quorum puts of {size} "
            f"{median_ms(put_s):.3f} ms median; {REPL_BEHIND} behind + 1 delete repaired in "
            f"{repair_dt * 1e3:.1f} ms (repair_keys {copied}), every replica equal")

        # ---- live resharding 2 -> 3 over the local nodes -------------------
        flush_all()
        skeys = [f"r{i:05d}" for i in range(RESHARD_KEYS)]
        for i, k in enumerate(skeys):
            singles[local_eps[shard_of(k, 2)]].set(k, vals[i])
        step_counts("reshard_fill")
        planned = moved_keys(skeys, 2, 3)
        parts = [CacheShardStore(singles[ep]) for ep in local_eps]
        rep, reshard_dt = timed(lambda: ReshardCoordinator(
            "smoke-reshard", parts[:2], parts, view=MigrationView()).run())
        step_counts("reshard")
        c = rep["counters"]
        check(rep["completed"] and c["keys_moved"] == len(planned)
              and 0 < c["collective_steps"] <= 3 * c["bulk_ranges"]
              and c["collective_steps"] < c["keys_moved"] and c["checksum_failures"] == 0,
              f"reshard report {rep}")
        for i, k in enumerate(skeys):
            v = stores[shard_of(k, 3)].get(k.encode())
            check(v is not None and torch.equal(v, vals[i]), f"{k} not at shard_of(k, 3)")
            if k in planned:
                check(stores[planned[k][0]].get(k.encode()) is None, f"{k} left on its old shard")
        say(f"reshard 2 -> 3: {RESHARD_KEYS} keys of {size}, {c['keys_moved']} moved in "
            f"{reshard_dt:.3f} s ({c['keys_moved'] / reshard_dt:.1f} keys/s, "
            f"{c['keys_moved'] * CACHE_VALUE / reshard_dt / 1e9:.3f} GB/s); collective_steps "
            f"{c['collective_steps']}, bulk_ranges {c['bulk_ranges']}, checksum_failures "
            f"{c['checksum_failures']}")
        # the verify paths hash every value they read on the host: repair
        # both copies of each key the replicas share and each copied key
        # twice, the reshard each moved key twice
        one = host[0].tobytes()
        t0 = time.perf_counter()
        murmur3_32(one)
        hash_s = time.perf_counter() - t0
        hashes = {"repair": 2 * (REPL_PUTS - 1) + 2 * REPL_BEHIND, "reshard": 2 * c["keys_moved"]}
        say(f"murmur3_32 of one {size} value on the host: {hash_s:.3f} s; the repair's "
            f"{hashes['repair']} and the reshard's {hashes['reshard']} such hashes: "
            f"{hashes['repair'] * hash_s:.1f} s and {hashes['reshard'] * hash_s:.1f} s")

        flush_all()
    finally:
        for ch in channels:
            ch.close()
        for store, srv in nodes:
            srv.stop()
            store.flush()

    counts = {k: sum(s.get(k, 0) for s in steps.values()) for k in T.launches}
    say(f"launches per step {steps}")
    k2 = {"dmset_stack_ms": k2_ms, "dmset_stack_bound_ms": k2_bound,
          "dmset_stack_max_abs_err": k2_err, "dmset_stack_launches": steps["stacked_dmset"]
          .get("copy_csum_staged", 0)}
    return counts, k2


def phase_serve(torch):
    """The fourth main path: disaggregated prefill/decode serving at
    dim = 6144 against the monolithic decode loop.  Returns the decode
    step's product rows for the products line."""
    from incubator_brpc_tpu_torch.cache import HBMCacheStore
    from incubator_brpc_tpu_torch.serving import session as sv_session
    from incubator_brpc_tpu_torch.serving.decode import DecodeService
    from incubator_brpc_tpu_torch.serving.prefill import PrefillService
    from incubator_brpc_tpu_torch.serving.router import SessionChannel
    from incubator_brpc_tpu_torch.streaming.generate import DecodeLoop

    d, n_tok = SERVE_DIM, SERVE_TOKENS
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 must stay off")
    sv_session.clear_registry()
    t0 = time.perf_counter()
    store = HBMCacheStore(SERVE_STORE)  # the card by default
    loops = []
    try:
        pf = PrefillService(store, dim=d, n_layers=SERVE_LAYERS)
        reps = [DecodeService(store, DecodeLoop(dim=d), name=f"serve-d{i}", max_sessions=256)
                for i in range(SERVE_REPLICAS)]
        mono = DecodeLoop(dim=d)
        loops += [mono] + [r.loop for r in reps]
        for lp in loops:
            check(lp.device.type == "cuda", f"decode loop on {lp.device}")
            lp.prewarm()  # W placed once; every bucket's product set up
        pf.prewarm()
        ch = SessionChannel(pf, reps)
        ch.generate("serve-warm", "warmup prompt", 2)
        print(f"[serve] set-up: 4 seeded W of ({d}, {d}) f32 placed, buckets warmed in "
              f"{time.perf_counter() - t0:.1f} s")

        def mono_run(prompts, n):
            toks = [[] for _ in prompts]
            firsts = [None] * len(prompts)
            dones = [threading.Event() for _ in prompts]
            m0 = time.monotonic()
            for i, p in enumerate(prompts):
                def emit(tok, row, i=i):
                    if firsts[i] is None:
                        firsts[i] = time.monotonic() - m0
                    toks[i].append(tok)
                mono.admit(p, n, emit, lambda row, ok, i=i: dones[i].set())
            for ev in dones:
                check(ev.wait(120), "a monolithic row never finished")
            return toks, firsts, time.monotonic() - m0

        def disagg_run(tag, prompts, n):
            toks, firsts, errs = [None] * len(prompts), [None] * len(prompts), []
            d0 = time.monotonic()

            def sess(i):
                def on_token(idx, tok, i=i):
                    if firsts[i] is None:
                        firsts[i] = time.monotonic() - d0
                try:
                    res = ch.generate(f"sv-{tag}-{i}", prompts[i], n, on_token=on_token)
                    toks[i] = res.tokens
                    if res.prefill_executions != 1:
                        errs.append(f"session {i}: prefill ran {res.prefill_executions} times")
                except Exception as e:  # noqa: BLE001 — reported below
                    errs.append(f"session {i}: {e!r}")
            ts = [threading.Thread(target=sess, args=(i,)) for i in range(len(prompts))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(120)
            check(not any(t.is_alive() for t in ts), "a disagg session never finished")
            check(not errs, f"disagg sessions failed: {errs[:3]}")
            return toks, firsts, time.monotonic() - d0

        prompts = [f"point prompt {i}" for i in range(max(SERVE_P))]
        solo = [mono_run([p], n_tok)[0][0] for p in prompts]  # each alone: bucket 1
        med = lambda xs: statistics.median(xs) * 1e3  # noqa: E731
        for p in SERVE_P:
            steps0 = mono.steps
            mt, mf, mwall = mono_run(prompts[:p], n_tok)
            mono_steps = mono.steps - steps0
            dt, df, dwall = disagg_run(f"p{p}", prompts[:p], n_tok)
            for i in range(p):
                check(pf.prefill_executions[f"sv-p{p}-{i}"] == 1,
                      f"p{p} session {i}: prefill ran more than once")
            if p == 1:
                check(dt[0] == mt[0] == solo[0],
                      f"p1: disagg {dt[0][:4]} / mono {mt[0][:4]} / solo {solo[0][:4]} differ")
            diff = lambda runs: sum(a != b for r, s in zip(runs, solo) for a, b in zip(r, s))  # noqa: E731
            print(f"[serve] p{p:2}: disagg {p * n_tok / dwall:8.1f} tokens/s, TTFT median "
                  f"{med(df):.2f} ms; mono {p * n_tok / mwall:8.1f} tokens/s, TTFT median "
                  f"{med(mf):.2f} ms, {mono_steps} steps, max_fused {mono.max_fused}; tokens "
                  f"differing from each session's solo run: disagg {diff(dt)}, mono {diff(mt)} "
                  f"of {p * n_tok}")
        for r in reps:
            check(r.kv_pulls == r.fused_pulls,
                  f"{r.name}: {r.kv_pulls} KV pulls, {r.fused_pulls} fused")
        print("[serve] replicas: " + "; ".join(
            f"{r.name} {r.kv_pulls} KV pulls (all one fused gather each), "
            f"{r.loop.steps} steps, max_fused {r.loop.max_fused}" for r in reps)
            + f"; prefill windows {pf.batches}, store {store.hbm_used} B of {SERVE_STORE}")

        # ---- one checkpoint migration between the replicas --------------
        for r in reps:
            r.loop.step_delay_s = 0.004  # a migration lands mid-generation
        mig_prompt, got, seen = prompts[0], {}, []
        t = threading.Thread(target=lambda: got.setdefault("res", ch.generate(
            "sv-mig", mig_prompt, n_tok, lambda i, tok: seen.append(i))))
        t.start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            rec = sv_session.get_session("sv-mig")
            if rec is not None and len(rec.tokens) >= 8:
                break
            time.sleep(0.002)
        check(ch.migrate("sv-mig", "chip smoke") is True, "the migration was refused")
        t.join(60)
        check(not t.is_alive() and "res" in got, "the migrated session never finished")
        res = got["res"]
        kinds = [e["kind"] for e in res.record.migration_log]
        check(res.migrations == 1 and kinds == ["graceful"], f"migration log {kinds}")
        check(seen == list(range(n_tok)), f"token indices {seen}: not each exactly once")
        check(res.prefill_executions == 1 and pf.prefill_executions["sv-mig"] == 1,
              "the migration re-ran prefill")
        check(res.tokens == solo[0], "the migrated session's tokens differ from the unmigrated")
        print(f"[serve] migration: 1 graceful checkpoint hop "
              f"{res.record.migration_log[0]['from']} -> {res.record.replica} at token "
              f"{res.record.ckpt_tokens}; {n_tok} tokens each emitted once, equal to the "
              f"unmigrated run; prefill_executions 1")
        for r in reps:
            r.loop.step_delay_s = 0.0

        # where the time goes at p = 32
        p = max(SERVE_P)
        wall_us, busy_us, by_name = device_profile(
            torch, lambda: disagg_run("prof", prompts[:p], n_tok))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        check(busy_us > 0, "the profiler saw no CUDA work in the serving window")
        print(f"[profile] serve disagg p{p}: wall {wall_us:.0f} us, device busy "
              f"{busy_us:.0f} us ({100 * busy_us / wall_us:.1f}%); top "
              + ", ".join(f"{name[:40]} {us:.0f} us" for name, us in top))
        wall_us, busy_us, _ = device_profile(torch, lambda: mono_run(prompts[:p], n_tok))
        print(f"[profile] serve mono p{p}: wall {wall_us:.0f} us, device busy "
              f"{busy_us:.0f} us ({100 * busy_us / wall_us:.1f}%)")
        decode_check(torch, mono)
        # the step writes each row's state and sum, and does its tanh and sum
        products = phase_products(
            torch, mono._kernel, mono._ensure_w(), "decode_step",
            "incubator_brpc_tpu_torch/streaming/generate.py",
            "incubator_brpc_tpu/streaming/generate.py:161-178 "
            "(tanh(s @ w) under jax.jit: an XLA op, not a TPU kernel)",
            row_bytes=4, row_ops=2 * d)
    finally:
        for lp in loops:
            lp.stop()
        store.flush()
    return products


def decode_check(torch, loop, buckets=(1, 8, 32)):
    """The decode step at each bucket of the serving path held to float64:
    each state within PS_RTOL * (|x| @ |W|) of tanh(x @ W) (tanh is
    1-Lipschitz, so the product's bound carries), each row sum within the
    sum of its row's bounds.  A control step with TF32 on must fail the
    same check at bucket 32 (at bucket 1 cuBLAS may run a gemv, which
    has no TF32 path)."""
    w = loop._ensure_w()
    wd = w.double()
    wa = wd.abs()
    for b in buckets:
        x = torch.randn((b, loop.dim), generator=torch.Generator(device=w.device)
                        .manual_seed(SEED + b), device=w.device)
        xd = x.double()
        ref, scale = torch.tanh(xd @ wd), xd.abs() @ wa
        got = {}
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                new, sums = loop._kernel(w, x)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            got[tf32] = (past_f64(new, ref, scale),
                         past_f64(sums, ref.sum(-1), scale.sum(-1)))
        (st, sm), (tst, tsm) = got[False], got[True]
        print(f"[serve] check decode step b={b:2}: float32 states {st[0]} of {b * loop.dim} "
              f"past {PS_RTOL}, worst {st[1]:.3g}; sums {sm[0]} of {b} past, worst "
              f"{sm[1]:.3g}; control TF32 states {tst[0]} past, worst {tst[1]:.3g}; "
              f"sums {tsm[0]} past, worst {tsm[1]:.3g}")
        check(st[0] == 0 and sm[0] == 0, f"the float32 decode step at bucket {b} failed "
                                          f"its float64 check")
        if b == 32:
            check(tst[0] + tsm[0] > 0, "the decode check did not refuse a TF32 step")


def profile_windows(torch, fn, what, kernel=None, windows: int = 3, tries: int = 8):
    """Up to ``windows`` profiler windows over fn() that saw CUDA work
    (those whose name holds ``kernel``, or any), as (busy_us, by_name):
    now and then a window reads empty, as if it lost its events, so up
    to ``tries`` windows are taken.  Fails when none saw any."""
    seen = []
    for _ in range(tries):
        _, busy_us, by_name = device_profile(torch, fn)
        if kernel is not None:
            by_name = {k: v for k, v in by_name.items() if kernel in k}
            busy_us = sum(by_name.values())
        if busy_us > 0:
            seen.append((busy_us, by_name))
            if len(seen) == windows:
                break
    check(len(seen) > 0, f"the profiler saw no {what} in {tries} windows")
    return seen


def device_ms(torch, fn, kernel=None, iters: int = 20, windows: int = 3) -> float:
    """Device time per call of fn(), from the profiler's CUDA events over
    iters calls: those whose name holds ``kernel``, or all of them; the
    median of ``windows`` profiler windows that saw any.  Timing
    back-to-back launches with CUDA events instead would measure the
    host's launch rate for a kernel of a few microseconds."""
    fn()
    seen = profile_windows(torch, lambda: [fn() for _ in range(iters)],
                           kernel or "CUDA work", kernel, windows)
    return statistics.median(busy / iters / 1e3 for busy, _ in seen)


def chunk_walk(T, x, out, carry, br):
    """The pipelined mode's K1 launches over one frame: chunk k of x
    (CHUNK_ROWS rows) into chunk k of out, the carry chained."""
    for off in range(0, x.shape[0], CHUNK_ROWS):
        _, carry = T._copy_csum(x[off:off + CHUNK_ROWS], carry, br,
                                out=out[off:off + CHUNK_ROWS])
    return carry


def transmit_ms(torch, T, x, w):
    """Device ms per call of each copy+checksum transmit, every kernel
    the call launches summed (so a tree whose fold is a launch of its
    own is timed with its fold): ``chunk``, one CHUNK_ROWS-row chunk of
    the frame ``x`` with a carry into a slot, as the pipelined mode's
    ring hits run it, walked over the frame's chunks so that each finds
    the 50 MB L2 cold, as on the path; ``frame``, K1 on ``x``; ``w``, K1
    on the PS path's W ``w``; ``staged``, K2 on ``x``."""
    out, w_out = torch.empty_like(x), torch.empty_like(w)
    br, w_br = T._fit_block_rows(x.shape[0]), T._fit_block_rows(w.shape[0])
    sr = T.pallas_stage_rows(x, br)
    carry = torch.randn((1, x.shape[1]), generator=torch.Generator(device=x.device).manual_seed(7),
                        device=x.device)
    return {
        "chunk": device_ms(torch, lambda: chunk_walk(T, x, out, carry, br))
        / (x.shape[0] // CHUNK_ROWS),
        "frame": device_ms(torch, lambda: T._copy_csum(x, None, br, out=out)),
        "w": device_ms(torch, lambda: T._copy_csum(w, None, w_br, out=w_out)),
        "staged": device_ms(torch, lambda: T._staged_copy_csum(x, br, sr, out=out)),
    }


def phase_times(torch, T, errs, totals):
    """Each kernel alone at the main path's shapes: its device time
    from the profiler; plain versions and x.clone() by CUDA events."""
    x = make_payload(torch, MAIN_SHAPE, torch.float32, SEED)
    w = make_payload(torch, (PS_DIM, PS_DIM), torch.float32, SEED)
    m, n = MAIN_SHAPE
    br = T._fit_block_rows(m)
    out = torch.empty_like(x)
    ms = transmit_ms(torch, T, x, w)

    clone_ms = cuda_ms(torch, lambda: x.clone())
    plain_ms = cuda_ms(torch, lambda: T.copy_csum_plain(x, None, br), iters=5)
    # the function reads x and writes its copy and the (1, n) f32
    # accumulator; the kernels' own partial scratch is not counted
    copy_bytes = 2 * x.nbytes + 4 * n
    rows = []
    for name, k_ms, plain, nbytes, ops in [
        ("copy_csum_blocks", ms["frame"], plain_ms, copy_bytes, m * n),
        ("copy_csum_staged", ms["staged"], plain_ms, copy_bytes, m * n),
        # a pure copy does no arithmetic: bound by its 2 x 64 MiB alone
        ("copy_blocks", device_ms(torch, lambda: T._launch_copy_blocks(x, out),
                                  "copy_blocks_kernel"),
         cuda_ms(torch, lambda: T.device_copy_plain(x)), 2 * x.nbytes, 0),
    ]:
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        row = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": totals[name],
            "max_abs_err": errs[name], "ms": k_ms, "plain_ms": plain,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            # x.clone() computes device_copy's function in one call; no
            # torch call computes a copy plus its block checksums
            "library_ms": clone_ms if name == "copy_blocks" else None,
            "clone_ms": clone_ms,
        }
        if name in OFF_PATH:
            row["launched_in"] = OFF_PATH[name]
        rows.append(row)
        print(f"[times] {name:17} {k_ms:.4f} ms (bound {max(t_bytes, t_ops):.4f} ms, "
              f"plain {plain:.4f} ms, x.clone() {clone_ms:.4f} ms)")
    # K1 at the width the PS path gives it: W, (6144, 6144) f32
    w_bound = max((2 * w.nbytes + 4 * PS_DIM) / HBM_BYTES_PER_S,
                  w.numel() / F32_OPS_PER_S) * 1e3
    rows[0].update(ps_w_ms=ms["w"], ps_w_bound_ms=w_bound)
    print(f"[times] copy_csum_blocks on W {w.shape[0]}x{w.shape[1]} f32: {ms['w']:.4f} ms "
          f"(bound {w_bound:.4f} ms, {ms['w'] / w_bound:.2f}x)")
    # K1 at the pipelined mode's chunk: one 8 MB (1024, 2048) f32 chunk
    # with a carry, L2 cold (transmit_ms)
    per_walk = m // CHUNK_ROWS
    c_bound = max((2 * x.nbytes // per_walk + 8 * n) / HBM_BYTES_PER_S,
                  m * n // per_walk / F32_OPS_PER_S) * 1e3
    rows[0].update(chunk_ms=ms["chunk"], chunk_bound_ms=c_bound)
    print(f"[times] copy_csum_blocks on a chunk ({CHUNK_ROWS}, {n}) f32 with a carry, "
          f"L2 cold: {ms['chunk']:.4f} ms (bound {c_bound:.4f} ms, {ms['chunk'] / c_bound:.2f}x)")
    # K1 at the cache path's lane views: a 1 MiB value and the DMGET stack
    for key, shape in [("cache_value", (256, 4096)), ("dmget_stack", (DMGET_KEYS, CACHE_VALUE))]:
        v = make_payload(torch, shape, torch.uint8, SEED)
        v_out, v_br = torch.empty_like(v), T._fit_block_rows(shape[0])
        v_ms = device_ms(torch, lambda: T._copy_csum(v, None, v_br, out=v_out))
        v_bound = max((2 * v.nbytes + 4 * shape[1]) / HBM_BYTES_PER_S,
                      v.numel() / F32_OPS_PER_S) * 1e3
        rows[0].update({f"{key}_ms": v_ms, f"{key}_bound_ms": v_bound})
        print(f"[times] copy_csum_blocks on {key} {shape} u8: {v_ms:.4f} ms "
              f"(bound {v_bound:.4f} ms, {v_ms / v_bound:.2f}x)")
    return rows


def times_main(root: str) -> int:
    """``--times ROOT``: the transmit times of the package under ROOT."""
    path = pathlib.Path(root).resolve()
    check((path / "incubator_brpc_tpu_torch").is_dir(),
          f"no incubator_brpc_tpu_torch under {path}")
    sys.path.insert(0, str(path))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from incubator_brpc_tpu_torch.ops import transfer as T

    check(pathlib.Path(T.__file__).resolve().is_relative_to(path),
          f"imported {T.__file__}, not the package under {path}")
    smi = phase_build()
    x = make_payload(torch, MAIN_SHAPE, torch.float32, SEED)
    w = make_payload(torch, (PS_DIM, PS_DIM), torch.float32, SEED)
    ms = transmit_ms(torch, T, x, w)
    for k, v in ms.items():
        print(f"[times] {path.name}: {k:6} {v:.5f} ms")
    print(json.dumps({"root": str(path), "card": smi, "ms": ms}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--times", metavar="ROOT",
                    help="only the transmit times, for the package of the checkout at ROOT")
    args = ap.parse_args()
    if args.times is not None:
        return times_main(args.times)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from incubator_brpc_tpu_torch.ops import transfer as T

    # a run that outlives its budget dumps every thread's stack and exits
    faulthandler.dump_traceback_later(RUN_DEADLINE_S, exit=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    smi = phase_build()
    errs, main_csum = phase_kernels(torch, T)
    echo_counts = phase_echo(torch, T, main_csum)
    ps_counts, products = phase_ps(torch, T)
    cache_counts = phase_cache(torch, T)
    stream_counts = phase_stream(torch, T)
    child = SmokeChild(card(torch), DCN_SLICE)
    try:
        dcn_counts, dcn_child_counts, dcn_err = phase_dcn(torch, T, child, main_csum)
        cluster_counts, k2_stack = phase_cluster(torch, T, child)
    finally:
        child.close()
    T.reset_launch_counts()  # the serving path: its own products, no copy kernel
    products += phase_serve(torch)
    serve_counts = dict(T.launches)
    check(not any(serve_counts.values()), f"the serving path launched {serve_counts}")
    paths = [echo_counts, ps_counts, cache_counts, stream_counts, dcn_counts, cluster_counts]
    totals = {k: sum(c[k] for c in paths) for k in T.launches}
    print(f"[paths] launches: echo {echo_counts}; ps {ps_counts}; cache {cache_counts}; "
          f"stream {stream_counts}; dcn {dcn_counts} (child {dcn_child_counts}); "
          f"cluster {cluster_counts}; serve {serve_counts}")
    for name, c in [("dcn", dcn_counts), ("cluster", cluster_counts)]:
        check(c["copy_csum_blocks"] > 0, f"K1 never launched on the {name} path")
    check(cluster_counts["copy_csum_staged"] > 0, "K2 never launched on the cluster path")
    for k, v in totals.items():
        if k in OFF_PATH:  # no caller in either package: never on a path
            check(v == 0, f"kernel {k} launched {v} times on a main path")
        else:
            check(v > 0, f"kernel {k} never launched on the main paths")
    rows = phase_times(torch, T, errs, totals)
    rows[0]["dcn_frame_max_abs_err"] = dcn_err
    rows[1].update(k2_stack)
    print(json.dumps({"products": products}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
