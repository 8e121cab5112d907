#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (incubator_brpc_tpu_torch).

    python3 chip_smoke.py
    python3 chip_smoke.py --times ROOT
    python3 chip_smoke.py --tune

Needs one CUDA card, ``nvcc`` and the repository checkout around this
file.  Phases, each fatal on failure:

1. build   — compile ops/csrc/*.cu for sm_90a (one nvcc per source, in
             parallel), print the card's name and power limit and, from
             cuobjdump -sass of the built library where the toolkit has
             it, the bulk-copy instructions in K2's code (UTMALDG and
             UTMASTG) and copy_blocks' (UBLKCP), failing without them;
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
5. shard   — the sharded PS at d = 6144: four PsService shard servers
             at ici://slice0/chip{0..3} on the card behind
             sharded_ps_channel (each sub-channel's timeout stated).
             scatter_param sends W as 4 Puts of (1536, 6144) f32, one K1
             per hop, and each shard's Get returns its rows bit-equal;
             every fan-out Forward issues one leg per shard and its y is
             held to float64 as the ps phase holds it, at parallelism 1
             and 32 with batching off and on, beside the unsharded
             figures; keyed Get/Put land one RPC on shard_of(key), which
             equals the JAX package's on a golden list; a replicated PS
             of 2 groups x 3 replicas (RF=1 delegates to the plain
             channel; 256 quorum Puts and Gets of (64, 6144) f32 values;
             a replica 64 writes behind repaired; a leader killed mid-
             write with no acked write lost); a live 2 -> 4 reshard of
             256 such keys under 2 threads of Get/Put/fan-out Forward
             (moved == the scheme delta, one epoch bump, no checksum
             failure, only ERPC error codes).  The native murmur3_32
             must be in use;
6. cache   — the third main path: an HBMCacheService behind
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
7. dcn     — the DCN bridge: a second process started with subprocess
             (a fresh interpreter on the same card) hosts an echo server
             at ici://slice6/chip0 and a 1 GiB cache node at chip1 behind
             listen_dcn; tpu://fabric resolves both.  A 64 MB float32
             (8192, 2048) device tensor is echoed across the bridge (7
             reps, the first echo apart: bench_dcn_bulk's 64 MB) and a
             bfloat16 (4096, 1024) one once: byte-equal, fresh CUDA
             tensors on the parent's device, K1 on each receiving hop
             (the child's launches read back over its stdin/stdout), and
             K1 on the DCN-uploaded frame bit-equal to plain;
8. cluster — the clustered cache tier: three local 1 GiB nodes at
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
             the native murmur3_32 must be in use, and is timed;
9. serve   — the fourth main path: disaggregated prefill/decode serving
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
10. http   — the HTTP front on the card: GenerateSSE over
             Channel(protocol="http") on a d = 6144 decode loop, its
             tokens equal to the tpu_std stream path's at p = 1 (at p = 8
             the differing tokens are counted), with time to the first
             data event and tokens/s of both; AdmitSSE on a d = 6144
             DecodeService behind a PrefillService, equal to the stream
             Admit with prefill_executions 1; every builtin page of a
             server that has just run PS Put/Get/Forward at d = 6144 and
             64 MB echoes answers with the JAX package's status code
             (/status counts, /metrics Prometheus text, /rpcz spans,
             /cache, /serving, /replication and /resharding live);
             /hotspots/device?seconds=2 under 64 MB echoes (fused and
             pallas in turns) with no trace_error, ici.* families, K1 in
             the exported torch.profiler trace with its CUDA time and K1
             launches grown; /hotspots/hbm's tags, census and <dark>, 0
             up to the allocator's rounding after ?rebase=1; the pages on
             internal_port only; rpc_dump of PS Forward calls (device x
             over ici://, one host-view pull per sample) replayed by
             rpc_replay to a fresh server, each y held to float64;
11. mesh   — the single-controller mesh (parallel/mesh.py) of 4 virtual
             chips on the card: each collective lowering over a (4 *
             2048, 2048) f32 tensor held to a plain version (gather,
             all_to_all, the ppermute ring and the hedged pick
             byte-equal, the psum bit-equal to the chip-order sum) with
             its CUDA time; PsService(mesh=) at d = 6144 on
             Server(enable_batching=True).start_ici: W Put and Got over
             ici:// (one K1 a hop, 4 row shards, the assembled W
             byte-equal), Forward closed loop at p = 1 off and p = 32 on
             beside the unsharded ps points (every y held to float64,
             executions == merges == batches), 16 Forwards of a device x
             (one K1 a hop), a chaos merge reset failing only its
             key-group, a live remesh to 2 chips under p = 8 load (no
             Forward fails, 1 re-placed) and the servable-dim ceiling by
             placement; PrefillService(mesh=) at d = 6144 with the serve
             phase's layers and prompts (every layer held to float64,
             prefill once a session); make_training_step on a (2, 2)
             mesh at dim 6144, batch 256, 5 steps (the loss falls at
             every step, step 1 held to a float64 plain step, the median
             step time);
12. native — the C++ engine (incubator_brpc_tpu_torch/native/, built
             with g++ and gcc at first use, beside the nvcc builds; the
             call boundary, fastcall or ctypes, printed): rpc_press
             --native's 4 KB echo for 2 s against a native server, the
             Python API's sync echo over connection_type="native", a
             call_many window of 32 against 32 per-call calls (every
             reply equal to its request); PsService at d = 6144 on the
             card behind Server(native_engine=True, enable_batching=True)
             over TCP: W's bytes Put and Got back, Forward at p = 1 off and
             p = 32 on from async callers on one native connection (qps,
             p50, p99, device busy, beside [ps]; every y held to float64
             as [ps] holds it; uploads = executions = ps.forward-pull =
             batches; the frames per engine dispatch and the batch
             sizes), a call_many window of 32 Gets of device-resident
             (64, 6144) f32 values batched (max_batch_seen >= 16, at
             most 2 batches a window, every value's bytes equal) against
             32 per-call Gets; four native shard servers behind
             sharded_ps_channel, a window of 64 keyed Gets crossing into C
             once per shard; one port answering HTTP and redis in C and
             by the Python fallback; a native.srv_write short-write plan
             under which every call ends once, answered or failed with an
             ERPC code; call_many Get windows read each value from its
             reply (a RingReply's attachment); the slowest 1% of the
             p = 32 Forward rows printed with the dispatches (start, rows,
             time) that ran while each waited, the dispatch gaps and the
             GC pauses of the window;
13. proto  — the other protocols on one port Server on one TCP port: a
             PsService holding W at d = 6144 on the card (batching on), an
             echo service, and the thrift, mongo, nshead and RTMP
             adaptors.  A tpu_std Forward load at p = 8 (every y held to
             float64 as [ps] holds it) runs while grpc, hulu, sofa, nova,
             public, ubrpc, nshead_mcpack, thrift and mongo clients each
             complete 100 calls on that port (and esp, which has no
             server side, against a peer of its own), every reply
             checked byte for byte (calls, qps, p50, p99 a protocol); a
             4 MB gRPC message over TLS with the "h2" ALPN token; a
             seeded FLV stream published and played back over RTMP, its
             HLS segments, playlist and FLV archive equal to a plain
             segmenter's and writer's; Server.stop() sending GOAWAY with
             4 h2 streams in flight, each finishing with its reply;
14. witness — the analysis toolchain's runtime witnesses on the card,
             in a child interpreter (this script with --witness-child)
             that arms the lock witness and the transfer guard before
             the port creates a lock: a seeded .item() of a CUDA tensor
             must raise TransferWitnessError, and so must a hidden
             bool() sync on the main thread and on a server worker
             thread (the sync hook); then the 64 MB echo in fused and
             pallas mode (launches per hop as in [echo]), PS Put/Get of
             W at d = 6144 and 1 s of Forward at p = 8 with batching on
             (one ps.forward-pull per batch), 16 cache SETs and GET hits
             of 1 MiB device values over ici:// (no spill, no host view),
             8 decode steps at the serve width (one decode.token-sums a
             step), the sharded Forward over a (1, 4) virtual-chip mesh
             a PS Get of W over TLS/TCP with an Authenticator (one
             iobuf.host-view a frame) and a native-engine Forward loop at
             p = 8 with batching on (one ps.forward-pull per batch).  Fails on any violation, lock or
             retrace contradiction.  Prints the child's launches per
             kernel, the guard's overhead (the echo and the Forward point
             armed against disarmed, in ABBA turns; "unresolved" when the
             difference is inside the disarmed turns' spread) and the
             phase's wall time with the card's name and power limit;
15. times  — each kernel's time at the main path's shapes beside its
             bound, its plain version and its library call: the whole-frame
             transmits (K1 and K2 on the 64 MB frame, K2 on the 32 MiB u8
             stack, with the median and spread of their windows), and
             copy_blocks beside out.copy_(src), walked over distinct buffers (each
             frame cold in the 50 MB L2, as on the path) and run back to
             back behind a sleep kernel, so each pays for the write-back
             of its predecessor's output (the profiler's kernel span
             between host-spaced launches, which leaves part of that
             write-back to the idle gap, is kept as "span"), K1 on the PS path's W and on
             one 8 MB chunk with a carry (the pipelined mode's launch,
             walked over a 64 MB frame), and on a 1 MiB cache value and
             the 32 MiB DMGET stack; the Forward product and the decode
             step (torch.matmul, XLA ops in the reference) per bucket.

The line before the last is the card's name and power limit; the last
line is {"ok": true, "device": {...}}.  Without a card, or without the
package beside this file, it exits non-zero and prints no result.

``--times ROOT`` runs only the build and the copy+checksum transmit
times of phase 15 (transmit_ms: K2 on the stack and copy_blocks beside
out.copy_ included) for the package of the checkout at ROOT,
and prints them as one JSON line with the card's name and power limit.
Two commits compare on one card within one call: unpack the other with
``git archive`` under a directory that .gitignore lists and run the
two roots in turns (A, B, B, A).

``--tune`` builds transfer.cu once for each of TUNE_VARIANTS (the bulk-
copy rings' stages, stage bytes, CTAs an SM, store lags and L2 policies;
one nvcc each, in parallel), holds each variant's K2 and copy_blocks
bit-equal to plain, and prints K2's times on the 64 MB frame and the u8
stack and copy_blocks' on the frame per variant, in alternating turns,
beside K1 and out.copy_(src): how the constants in transfer.cu were
chosen.
"""

from __future__ import annotations

import argparse
import ctypes
import faulthandler
import gc
import itertools
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import tracemalloc
import urllib.error
import urllib.request

SEED = 1234
RUN_DEADLINE_S = 1150  # the whole run's budget, inside its 1200 s limit
MAIN_SHAPE = (8192, 2048)  # 64 MB of float32: bench.py's bench_ici_rpc payload
CHUNK_ROWS = 1024  # one 8 MB chunk of MAIN_SHAPE: the pipelined mode's K1 launch
COLD_PAIRS = 3  # [times]: launches walk over this many (source, destination) pairs
SLEEP_CYCLES = 20_000_000  # [times]: about 10 ms of card sleep, the calls queue behind it
SLEEP_TRIES = 5  # ... doubled after each window the host did not fill in time
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
# the sharded PS (docs/sharded_ps.md, bench.py:3277 bench_resharding,
# :3554 bench_replicated_ps) at the PS's width: W row-scattered over
# four shard servers on the card, 1.5 MiB (64, 6144) f32 values
SHARDS = 4
SHARD_CHIPS = (0, 1, 2, 3)  # ici://slice0/chip{k}: cuda:(k % count), one card
REPL_CHIPS = (4, 5, 6, 7, 8, 9)  # 2 groups x 3 replicas
SHARD_TIMEOUT_MS = 60000  # each shard sub-channel's, stated: not the 1000 ms default
SHARD_VALUE = (64, PS_DIM)
SHARD_KEYS = 256
KEYED_KEYS = 32
# shard_of("key0".."key15") under seed 0 over 4 shards: the JAX
# package's ShardRoutedChannel.shard_of (murmur3_32) on the same keys
# http: the SSE fronts, the builtin pages, rpc_dump
HTTP_SLICE = 8  # ici://slice8/chip0: the pages' server; chip1: the dumping server
HTTP_TOKENS = 32
HTTP_SSE_P = 8  # prompts, run one at a time (p = 1) and all at once
HTTP_ADMITS = 4
HTTP_FORWARDS = 16
HTTP_ECHOES = 4
HTTP_CACHE = 64 << 20
HTTP_CAPTURE_S = 2
HTTP_DUMPS = 16
# the mesh phase: virtual chips on the one card (parallel/mesh.py)
MESH_SLICE = 9  # ici://slice9/chip0: the in-mesh sharded PS
MESH_CHIPS = 4
MESH_BLOCK = (2048, 2048)  # each chip's block of the collectives' (4 * 2048, 2048) f32
MESH_DEVICE_X = 16  # Forwards whose x rides ici:// as a device tensor
MESH_CHIP_BUDGET = 64 << 20  # the servable-dim check's synthetic budget a chip
MESH_BATCH = 256
MESH_STEPS = 5
# every page JAX register_builtin_services registers, with the status
# the JAX package answers to a GET of it on a fresh server
# (tests/test_torch_builtin.py holds both packages to this list)
BUILTIN_STATUS = {
    "/": 200,
    "/admission": 200,
    "/batching": 200,
    "/bthreads": 200,
    "/cache": 200,
    "/chaos": 200,
    "/cluster/export": 200,
    "/cluster/latency_breakdown": 400,
    "/cluster/metrics": 400,
    "/cluster/stragglers": 200,
    "/connections": 200,
    "/dir": 403,
    "/flags": 200,
    "/health": 200,
    "/hotspots/contention": 200,
    "/hotspots/cpu": 200,
    "/hotspots/device": 200,
    "/hotspots/growth": 200,
    "/hotspots/hbm": 200,
    "/hotspots/heap": 200,
    "/hotspots/runtime": 200,
    "/ids": 200,
    "/index": 200,
    "/latency_breakdown": 200,
    "/list": 200,
    "/metrics": 200,
    "/pprof/cmdline": 200,
    "/pprof/growth": 200,
    "/pprof/heap": 200,
    "/pprof/profile": 200,
    "/pprof/symbol": 200,
    "/protobufs": 200,
    "/replication": 200,
    "/resharding": 200,
    "/rpc_dump": 200,
    "/rpcz": 200,
    "/rpcz/export": 400,
    "/serving": 200,
    "/sockets": 200,
    "/status": 200,
    "/threads": 200,
    "/vars": 200,
    "/version": 200,
    "/vlog": 200,
}
BUILTIN_QUERY = {"/pprof/profile": "?seconds=0.1", "/hotspots/cpu": "?seconds=0.1"}
SHARD_GOLDEN = [3, 1, 0, 0, 1, 3, 3, 1, 2, 2, 1, 0, 3, 0, 3, 0]
REPL_OPS = 256
RF1_KEYS = 24
RF1_CALLS = 120
RF3_CALLS = 120
KILL_PUTS = 64
RESHARD_THREADS = 2
RESHARD_PHASE_CALLS = 60
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


def phase_build(need_bulk: bool = True):
    from incubator_brpc_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    secs = time.perf_counter() - t0
    print(f"[build] {sorted(libs)} in {secs:.1f} s (sm_90a)")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    sass_bulk_ops(_build, need_bulk)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[build] card: {smi}")
    return smi


# the bulk-copy engine's instructions each kernel's SASS must hold: the
# tensor map's load and store (K2) and the 1D bulk copy (copy_blocks)
BULK_SASS = {"copy_csum_staged_kernel": ("UTMALDG", "UTMASTG"),
             "copy_blocks_kernel": ("UBLKCP",)}


def sass_bulk_ops(_build, need: bool = True) -> None:
    """From cuobjdump -sass of transfer.cu's library: which bulk-copy
    instructions each function of K2 and copy_blocks holds.  Fails when
    one lacks them (unless ``need`` is false: ``--times`` of an older
    tree); says so where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(tool).exists():
        print("[build] SASS: no cuobjdump in this toolkit, bulk-copy instructions not read")
        return
    out = subprocess.run([tool, "-sass", str(_build._target("transfer"))], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    for kernel, want in BULK_SASS.items():
        bodies = [f for f in out.split("Function : ")[1:] if kernel in f.split("\n", 1)[0]]
        check(bodies, f"no {kernel} in the SASS of the built library")
        seen = {op: sum(len(re.findall(rf"\b{op}\b", b)) for b in bodies) for op in want}
        print(f"[build] SASS: {kernel} ({len(bodies)} instantiations): "
              + ", ".join(f"{op} x{n}" for op, n in seen.items()))
        check(not need or all(bool(re.search(rf"\b{op}\b", b)) for b in bodies for op in want),
              f"an instantiation of {kernel} lacks one of {want}: the kernel does not use "
              f"the bulk-copy engine")


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
        plan = T.staged_plan(x, br)
        sr = plan.stage_rows
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
              f"K2 {plan.ntiles} tiles x {sr} rows ok: every mode bit-equal to plain")
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
    line, {(parallelism, batching): (qps, p50 us, p99 us)} of Forward
    with the Put/Get medians under "put_ms"/"get_ms")."""
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
        summary = {"put_ms": statistics.median(put_s) * 1e3,
                   "get_ms": statistics.median(get_s) * 1e3}
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
            return closed_loop(stubs, req, x_bytes, inflight, duration)

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
                summary[(par, cfg)] = (qps, pct(lats, 0.5), pct(lats, 0.99))
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
    return counts, products, summary


def phase_shard(torch, T, ps_summary):
    """The sharded PS at d = 6144: four PsService shard servers on the
    card behind sharded_ps_channel; W row-scattered by scatter_param,
    fan-out Forward, keyed routing, a replicated PS of 2 groups x 3
    replicas and a live 2 -> 4 reshard under load.  Returns the launch
    counts of the path and the keyed Get median (for [native])."""
    import numpy as np

    from incubator_brpc_tpu_torch.chaos.harness import ERROR_WHITELIST
    from incubator_brpc_tpu_torch.client.channel import ChannelOptions
    from incubator_brpc_tpu_torch.client.combo import DynamicShardChannel, ShardRoutedChannel
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.parameter_server import (
        _FORWARD_KERNEL,
        PS_BATCH_POLICY,
        PsService,
        ps_stub,
        scatter_param,
        sharded_ps_channel,
    )
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.replication import replicated_ps_channel
    from incubator_brpc_tpu_torch.resharding import (
        MigrationView,
        PsShardStore,
        ReshardCoordinator,
        moved_keys,
        shard_of,
    )
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
    from incubator_brpc_tpu_torch.utils.hashes import murmur3_native

    check(murmur3_native(), "the native murmur3_32 is not in use: the verify paths "
                            "would hash in Python")
    dev = card(torch)
    d, n = PS_DIM, SHARDS
    rows = d // n
    t_phase = time.perf_counter()

    def say(msg):
        print(f"[shard] {msg} [{time.perf_counter() - t_phase:.1f} s into the phase]")

    def opts():
        return ChannelOptions(timeout_ms=SHARD_TIMEOUT_MS, ici_device=dev)

    class CountingPs(PsService):
        """Counts the calls its unbatched dispatch serves (a batched
        window goes to PsService's batch function, the batcher's rows
        count those)."""

        def __init__(self):
            super().__init__()  # the card
            self.calls = {"Put": 0, "Get": 0, "Forward": 0}

        def Put(self, controller, request, response, done):
            self.calls["Put"] += 1
            return PsService.Put(self, controller, request, response, done)

        def Get(self, controller, request, response, done):
            self.calls["Get"] += 1
            return PsService.Get(self, controller, request, response, done)

        def Forward(self, controller, request, response, done):
            self.calls["Forward"] += 1
            return PsService.Forward(self, controller, request, response, done)

    def start(chip, svc, batching=False):
        srv = Server(ServerOptions(enable_batching=batching))
        srv.add_service(svc)
        check(srv.start_ici(0, chip) == 0, f"start_ici of ici://slice0/chip{chip} failed")
        port_dev = srv._ici_port.device
        check(port_dev == dev, f"shard server on {port_dev}, not {dev}")
        return srv

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    def timing(call, method, into):
        """``call`` (a sub-channel's call_method) that appends the
        synchronized wall time of each synchronous ``method`` call to
        ``into``."""
        def timed_call(method_spec, controller, request, response, done=None):
            t0 = time.perf_counter()
            out = call(method_spec, controller, request, response, done)
            if method_spec.method_name == method and done is None:
                torch.cuda.synchronize(dev)
                into.append(time.perf_counter() - t0)
            return out
        return timed_call

    def calls(name):
        return [s.calls[name] for s in svcs]

    def delta(before, name):
        return [a - b for a, b in zip(calls(name), before)]

    def same_value(att, want, want_host):
        """``att`` holds ``want``: as one device tensor equal to it, or as
        its bytes (a replicated or migrated value moves as bytes)."""
        try:
            arrs = att.device_arrays()
        except ValueError:
            arrs = None
        if arrs:
            return len(arrs) == 1 and torch.equal(arrs[0], want)
        return att.to_bytes() == want_host.tobytes()

    steps = {}

    def step_counts(name):
        steps[name] = {k: v for k, v in T.launches.items() if v}
        T.reset_launch_counts()

    svcs = [CountingPs() for _ in range(n)]
    servers = []
    channels = []
    try:
        for chip, svc in zip(SHARD_CHIPS, svcs):
            servers.append(start(chip, svc, batching=True))
            # batching stays on for Forward alone (toggled per point below)
            servers[-1].disable_method_batching("PsService.Put")
            servers[-1].disable_method_batching("PsService.Get")
        eps = [f"ici://slice0/chip{c}" for c in SHARD_CHIPS]
        sh = sharded_ps_channel(endpoints=eps, timeout_ms=SHARD_TIMEOUT_MS,
                                channel_options=opts())
        channels.append(sh)
        g = torch.Generator(device=dev).manual_seed(SEED)
        W = torch.randn((d, d), generator=g, device=dev) / d ** 0.5
        check(T.device_copy_with_checksum(W)[1] is not None, "K1 on W")  # outside the count

        # ---- scatter: W as 4 Puts of (1536, 6144) f32, one K1 per hop ------
        T.reset_launch_counts()  # the shard path's run starts here
        scatter_s, put_s, reps = [], [], 3
        parts = sh.partitions()
        for part in parts:  # each of scatter_param's Puts, timed on its sub-channel
            part.call_method = timing(part.call_method, "Put", put_s)
        try:
            for _ in range(reps):
                before = calls("Put")
                scatter_s.append(timed(lambda: scatter_param(sh, "w", W))[1])
                check(delta(before, "Put") == [1] * n,
                      f"scatter Puts per shard {delta(before, 'Put')}")
        finally:
            for part in parts:
                del part.call_method
        check(len(put_s) == reps * n, f"{len(put_s)} timed scatter Puts for {reps * n}")
        step_counts("scatter")
        check(steps["scatter"] == {"copy_csum_blocks": reps * n},
              f"scatter launched {steps['scatter']}: expected one K1 per Put hop, "
              f"{reps * n} in all")
        get_s = []
        for i, (svc, part) in enumerate(zip(svcs, sh.partitions())):
            stored = svc._store["w"]
            check(stored.device == dev and tuple(stored.shape) == (rows, d)
                  and torch.equal(stored, W[i * rows:(i + 1) * rows]),
                  f"shard {i} does not hold W's rows {i * rows}:{(i + 1) * rows}")
            check(not (W.data_ptr() <= stored.data_ptr() < W.data_ptr() + W.nbytes),
                  f"shard {i} stores a view of W, not the delivered tensor")
            c = Controller()
            _, dt = timed(lambda: ps_stub(part).Get(c, EchoRequest(message="w")))
            check(not c.failed(), f"shard {i} Get failed: {c.error_text()}")
            got = c.response_attachment.device_arrays()
            check(len(got) == 1 and got[0].device == dev
                  and torch.equal(got[0], W[i * rows:(i + 1) * rows]),
                  f"shard {i} Get returned other rows")
            get_s.append(dt)
        step_counts("shard_gets")
        check(steps["shard_gets"] == {"copy_csum_blocks": n},
              f"shard Gets launched {steps['shard_gets']}: expected one K1 per response hop")
        mb = W[:rows].nbytes / 1e6
        say(f"{n} PsService shards at {eps} on {dev}; scatter_param of W ({d}, {d}) f32 as "
            f"{n} Puts of ({rows}, {d}), {mb:.1f} MB each: {median_ms(scatter_s):.3f} ms median "
            f"of {reps} scatters ({W.nbytes / statistics.median(scatter_s) / 1e9:.2f} GB/s); "
            f"each Put {median_ms(put_s):.3f} ms median of {len(put_s)} [{min(put_s) * 1e3:.3f}, "
            f"{max(put_s) * 1e3:.3f}]; each shard's Get "
            f"{median_ms(get_s):.3f} ms median [{min(get_s) * 1e3:.3f}, "
            f"{max(get_s) * 1e3:.3f}], rows bit-equal; K1 1 per hop")

        # ---- fan-out Forward, closed loop --------------------------------
        traces0 = _FORWARD_KERNEL.trace_count()
        w_shard = svcs[0]._store["w"]
        for b in PS_BATCH_POLICY.padding_buckets:  # cuBLAS set-up out of the windows
            _FORWARD_KERNEL(w_shard, torch.zeros((b, rows), device=dev))
        xs = np.random.RandomState(SEED).randn(64, d).astype(np.float32)
        x_bytes = [x.tobytes() for x in xs]
        x_dev = torch.from_numpy(xs).to(dev).double()
        ref = x_dev @ W.double()
        scale = x_dev.abs() @ W.abs().double()
        while len(channels) < 4:
            channels.append(sharded_ps_channel(endpoints=eps, timeout_ms=SHARD_TIMEOUT_MS,
                                               channel_options=opts()))
        stubs = [ps_stub(c) for c in channels]
        req = EchoRequest(message="w")

        def verify(ys):
            idx = torch.tensor([i for i, _ in ys], device=dev)
            got = torch.from_numpy(
                np.frombuffer(bytearray(b"".join(y for _, y in ys)), np.float32)
                .reshape(len(ys), d)).to(dev)
            bad, worst = past_f64(got, ref[idx], scale[idx])
            check(bad == 0, f"{bad} fan-out Forward outputs off by up to {worst:.3g} of |x| @ |W|")
            return worst

        # one leg per shard per Forward (unbatched dispatch counts them)
        for srv in servers:
            srv.disable_method_batching("PsService.Forward")
        for k in range(4):
            before = calls("Forward")
            c = Controller()
            c.request_attachment.append_user_data(x_bytes[k])
            r = stubs[0].Forward(c, req)
            check(not c.failed() and r.message == "w", f"fan-out Forward failed: {c.error_text()}")
            check(delta(before, "Forward") == [1] * n,
                  f"a fan-out Forward issued legs {delta(before, 'Forward')}, expected [1] * {n}")
            verify([(k, c.response_attachment.to_bytes())])
        sharded = {}
        for par in (1, 32):
            for cfg in ("off", "on"):
                for srv in servers:
                    if cfg == "off":
                        srv.disable_method_batching("PsService.Forward")
                    else:
                        srv.enable_method_batching("PsService.Forward")
                batchers = [srv.batcher("PsService.Forward") for srv in servers]
                closed_loop(stubs, req, x_bytes, min(par, 4), 0.1)  # warm
                before = calls("Forward")
                rows0 = [b.rows if b else 0 for b in batchers]
                batches0 = [b.batches if b else 0 for b in batchers]
                lats, ys, wall, gc_ms = closed_loop(stubs, req, x_bytes, par, 1.0)
                worst = verify(ys)
                if cfg == "off":
                    legs = delta(before, "Forward")
                    batches = sum(legs)
                else:
                    legs = [b.rows - r0 for b, r0 in zip(batchers, rows0)]
                    batches = sum(b.batches - b0 for b, b0 in zip(batchers, batches0))
                check(legs == [len(ys)] * n, f"{len(ys)} fan-out Forwards, legs per shard {legs}")
                qps = len(lats) / wall
                sharded[(par, cfg)] = (qps, pct(lats, 0.5), pct(lats, 0.99))
                uq, u50, u99 = ps_summary[(par, cfg)]
                seen = max(b.max_batch_seen for b in batchers) if cfg == "on" else 1
                say(f"fan-out Forward parallelism {par:2} batching {cfg:3}: {qps:9.1f} qps, "
                    f"p50 {pct(lats, 0.5)} us, p99 {pct(lats, 0.99)} us over {len(lats)} calls "
                    f"in {wall:.2f} s ({n} legs each, {batches} shard batches for {sum(legs)} "
                    f"legs, max batch {seen}); unsharded [ps]: {uq:.1f} qps, p50 {u50} us, "
                    f"p99 {u99} us; max |y - ref| / (|x| @ |W|) {worst:.3g}; gen-2 GC pauses "
                    f"{len(gc_ms)}, longest {max(gc_ms, default=0):.1f} ms")
                if (par, cfg) == (32, "on"):
                    check(seen >= 2, f"max_batch_seen {seen} at parallelism 32: no shard coalesced")
        traces = _FORWARD_KERNEL.trace_count() - traces0
        check(traces <= len(PS_BATCH_POLICY.padding_buckets),
              f"the shard product traced {traces} new shapes")
        step_counts("forward")
        check(not steps["forward"], f"fan-out Forward launched copy kernels: {steps['forward']}")
        wall_us, busy_us, by_name = device_profile(
            torch, lambda: closed_loop(stubs, req, x_bytes, 32, 0.3))
        T.reset_launch_counts()
        if busy_us > 0:
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
            print(f"[profile] shard fan-out forward p32 on: wall {wall_us:.0f} us, device busy "
                  f"{busy_us:.0f} us ({100 * busy_us / wall_us:.1f}%); top "
                  + ", ".join(f"{name[:40]} {us:.0f} us" for name, us in top))
        else:
            print(f"[profile] shard fan-out forward p32 on: wall {wall_us:.0f} us, device "
                  f"time not measured (the profiler returned no CUDA events)")

        # ---- keyed routing: Get/Put on the owning shard only -------------
        keys = [f"key{i}" for i in range(SHARD_KEYS)]
        check([sh.shard_of(k) for k in keys[:16]] == SHARD_GOLDEN,
              f"shard_of differs from the JAX package's: {[sh.shard_of(k) for k in keys[:16]]}")
        vals = torch.randn((SHARD_KEYS, *SHARD_VALUE), generator=g, device=dev)
        host_vals = vals.cpu().numpy()
        stub = ps_stub(sh)
        kput_s, kget_s = [], []
        for i, k in enumerate(keys[:KEYED_KEYS]):
            owner = sh.shard_of(k)
            before = calls("Put")
            c = Controller()
            c.request_attachment.append_device(vals[i])
            _, dt = timed(lambda: stub.Put(c, EchoRequest(message=k)))
            check(not c.failed(), f"keyed Put {k} failed: {c.error_text()}")
            kput_s.append(dt)
            check(c.shard_index == owner and delta(before, "Put") == [int(j == owner) for j in range(n)],
                  f"keyed Put {k}: shard {c.shard_index}, deltas {delta(before, 'Put')}, owner {owner}")
            check([j for j, s in enumerate(svcs) if k in s._store] == [owner],
                  f"{k} is not on its owner alone")
            before = calls("Get")
            c = Controller()
            _, dt = timed(lambda: stub.Get(c, EchoRequest(message=k)))
            check(not c.failed(), f"keyed Get {k} failed: {c.error_text()}")
            kget_s.append(dt)
            got = c.response_attachment.device_arrays()
            check(len(got) == 1 and torch.equal(got[0], vals[i]), f"keyed Get {k}: other bytes")
            check(delta(before, "Get") == [int(j == owner) for j in range(n)],
                  f"keyed Get {k}: deltas {delta(before, 'Get')}, owner {owner}")
        for k in keys[:KEYED_KEYS]:  # leave the shards to the reshard's keyspace
            c = Controller()
            r = stub.Delete(c, EchoRequest(message=k))
            check(not c.failed() and r.message == "1", f"Delete {k}: {c.error_text()}")
        step_counts("keyed")
        check(steps["keyed"] == {"copy_csum_blocks": 2 * KEYED_KEYS},
              f"keyed Put/Get launched {steps['keyed']}: expected one K1 per hop")
        vmb = vals[0].nbytes / (1 << 20)
        keyed_get_ms = median_ms(kget_s)
        say(f"keyed routing: {KEYED_KEYS} Puts and Gets of ({SHARD_VALUE[0]}, {d}) f32 "
            f"({vmb:.1f} MiB) each one RPC on shard_of(key); shard_of equals the JAX package's "
            f"golden list; Put {median_ms(kput_s):.3f} ms, Get {median_ms(kget_s):.3f} ms median")

        # ---- the replicated PS: 2 groups x 3 replicas -------------------
        rsvcs = [PsService() for _ in range(6)]
        rservers = [start(c, s) for c, s in zip(REPL_CHIPS, rsvcs)]
        servers += rservers
        reps_ep = [f"ici://slice0/chip{c}" for c in REPL_CHIPS]

        def put(stub, k, i):
            c = Controller()
            c.request_attachment.append_device(vals[i])
            stub.Put(c, EchoRequest(message=k))
            return c

        def get_ok(stub, k, i):
            c = Controller()
            stub.Get(c, EchoRequest(message=k))
            return c, (not c.failed() and same_value(c.response_attachment, vals[i], host_vals[i]))

        def mixed(stub, rkeys, ncalls):
            lats, errs = [], 0
            t0 = time.perf_counter()
            for j in range(ncalls):
                t1 = time.perf_counter()
                if j % 4 == 1:
                    ok = not put(stub, rkeys[j % len(rkeys)], j % len(rkeys)).failed()
                else:
                    ok = get_ok(stub, rkeys[j % len(rkeys)], j % len(rkeys))[1]
                lats.append(time.perf_counter() - t1)
                errs += 0 if ok else 1
            wall = time.perf_counter() - t0
            lats.sort()
            return ncalls / wall, pct(lats, 0.5) * 1e3, pct(lats, 0.99) * 1e3, errs

        rkeys = [f"rkey{i}" for i in range(REPL_OPS)]
        # RF=1: one replica per group delegates to the plain ShardRoutedChannel
        plain = sharded_ps_channel(endpoints=[reps_ep[0], reps_ep[3]],
                                   timeout_ms=SHARD_TIMEOUT_MS, channel_options=opts())
        rf1 = replicated_ps_channel([[reps_ep[0]], [reps_ep[3]]], register=False,
                                    name_prefix="smoke-rf1", channel_options=opts(),
                                    timeout_ms=SHARD_TIMEOUT_MS)
        check(rf1.rf1 and isinstance(rf1._direct, ShardRoutedChannel),
              "RF=1 did not delegate to the plain ShardRoutedChannel")
        for i, k in enumerate(rkeys[:RF1_KEYS]):
            check(not put(ps_stub(plain), k, i).failed(), f"RF=1 fill Put {k}")
        for warm in (plain, rf1):  # connections and code paths out of the timing
            mixed(ps_stub(warm), rkeys[:RF1_KEYS], RF1_KEYS)
        off1 = mixed(ps_stub(plain), rkeys[:RF1_KEYS], RF1_CALLS)
        on = mixed(ps_stub(rf1), rkeys[:RF1_KEYS], RF1_CALLS)
        off2 = mixed(ps_stub(plain), rkeys[:RF1_KEYS], RF1_CALLS)
        check(off1[3] == on[3] == off2[3] == 0, f"RF=1 errors {off1[3]}, {on[3]}, {off2[3]}")
        check(all(v == 0 for grp in rf1.groups for v in grp.counters.values()),
              "RF=1 ran replication (its counters moved)")
        rf1_pct = ((off1[0] + off2[0]) / 2 / on[0] - 1) * 100
        step_counts("replicated_rf1")
        say(f"RF=1 (2 groups x 1): plain {off1[0]:.1f} / {off2[0]:.1f} qps, replicated channel "
            f"{on[0]:.1f} qps (overhead {rf1_pct:.1f}%), p99 {on[2]:.3f} ms; delegates to "
            f"ShardRoutedChannel, counters 0")
        for c in (plain, rf1):
            for p in (c.partitions() if hasattr(c, "partitions") else c._direct.partitions()):
                p.close()

        rep = replicated_ps_channel([reps_ep[:3], reps_ep[3:]], register=False,
                                    name_prefix="smoke-rf3", lease_ttl_s=5.0, hedge_ms=10,
                                    channel_options=opts(), timeout_ms=SHARD_TIMEOUT_MS)
        rstub = ps_stub(rep)
        qput_s, qget_s = [], []
        for i, k in enumerate(rkeys):
            c, dt = timed(lambda: put(rstub, k, i))
            check(not c.failed(), f"quorum Put {k} failed: {c.error_text()}")
            qput_s.append(dt)
        for i, k in enumerate(rkeys):
            (c, ok), dt = timed(lambda: get_ok(rstub, k, i))
            check(ok, f"replicated Get {k}: {c.error_text() if c.failed() else 'other bytes'}")
            qget_s.append(dt)
        rf3 = mixed(rstub, rkeys, RF3_CALLS)
        puts = REPL_OPS + sum(1 for j in range(RF3_CALLS) if j % 4 == 1)
        qw = sum(grp.counters["quorum_writes"] for grp in rep.groups)
        lc = sum(grp.counters["leader_changes"] for grp in rep.groups)
        check(rf3[3] == 0 and qw >= puts and lc == 0,
              f"RF=3: {rf3[3]} errors, quorum_writes {qw} for {puts} puts, leader_changes {lc}")
        step_counts("replicated_rf3")
        say(f"RF=3 (2 groups x 3 replicas): {REPL_OPS} quorum Puts of {vmb:.1f} MiB "
            f"{median_ms(qput_s):.3f} ms, {REPL_OPS} Gets {median_ms(qget_s):.3f} ms median; "
            f"mixed {rf3[0]:.1f} qps, p50 {rf3[1]:.3f} ms, p99 {rf3[2]:.3f} ms; quorum_writes "
            f"{qw} >= puts {puts}, leader changes {lc}")

        # a replica 64 writes behind, repaired from the group
        g1 = rep.groups[1]
        lagger = next(nd for nd in g1.nodes if nd is not g1.ensure_leader())
        g1.mark_dead(lagger.name)
        behind = [k for k in rkeys if rep.shard_of(k) == 1][:REPL_BEHIND]
        check(len(behind) == REPL_BEHIND, f"only {len(behind)} keys on group 1")
        for k in behind:  # new values while the lagger is out
            i = rkeys.index(k)
            j = (i + 1) % REPL_OPS
            c = put(rstub, k, j)
            check(not c.failed(), f"Put {k} with a replica out: {c.error_text()}")
        g1.mark_alive(lagger.name)
        copied, repair_dt = timed(lambda: g1.repair(lagger.name))
        check(copied == REPL_BEHIND and g1.counters["repair_keys"] == REPL_BEHIND,
              f"repair copied {copied}, repair_keys {g1.counters['repair_keys']}; "
              f"expected {REPL_BEHIND}")
        for k in behind:
            j = (rkeys.index(k) + 1) % REPL_OPS
            v = lagger.store.read(k)
            check(v == host_vals[j].tobytes(), f"the repaired replica's {k} differs")
        step_counts("repair")
        say(f"repair of a replica {REPL_BEHIND} writes behind: {repair_dt * 1e3:.1f} ms "
            f"(repair_keys {copied}), its values equal the group's")

        # kill group 0's leader mid-write: every acked write reads back
        kill = replicated_ps_channel([reps_ep[:3]], register=False, name_prefix="smoke-kill",
                                     lease_ttl_s=1.0, hedge_ms=20, channel_options=opts(),
                                     timeout_ms=SHARD_TIMEOUT_MS)
        kstub = ps_stub(kill)
        g0 = kill.groups[0]
        leader = g0.ensure_leader()
        check(leader is not None, "no leader elected")
        victim = rservers[reps_ep.index(leader.endpoint)]
        acked, codes, timing = {}, [], {}
        for j in range(KILL_PUTS):
            k = f"wk{j}"
            c = put(kstub, k, j)
            codes.append(c.error_code)
            if not c.failed():
                acked[k] = j
                if "killed" in timing and "recovered" not in timing:
                    timing["recovered"] = time.monotonic()
            if j == KILL_PUTS // 4:
                victim.stop()
                g0.mark_dead(leader.name)
                timing["killed"] = time.monotonic()
        lost = [k for k, j in acked.items() if not get_ok(kstub, k, j)[1]]
        check(not lost, f"{len(lost)} acked writes lost after the leader kill: {lost[:5]}")
        check("recovered" in timing, "no write acked after the leader kill")
        check(all(cd in ERROR_WHITELIST for cd in codes), f"non-ERPC codes {set(codes)}")
        failover = timing["recovered"] - timing["killed"]
        check(failover < g0.lease_ttl_s + 2.0 and g0.counters["leader_changes"] >= 1,
              f"failover {failover:.2f} s, leader changes {g0.counters['leader_changes']}")
        step_counts("leader_kill")
        say(f"leader killed at write {KILL_PUTS // 4} of {KILL_PUTS}: {len(acked)} acked, 0 "
            f"lost, failover {failover:.3f} s (lease {g0.lease_ttl_s} s), leader changes "
            f"{g0.counters['leader_changes']}, error codes {sorted(set(codes))}")

        # ---- live reshard 2 -> 4 under load ----------------------------
        old_ch = sharded_ps_channel(endpoints=eps[:2], timeout_ms=SHARD_TIMEOUT_MS,
                                    channel_options=opts())
        channels.append(old_ch)
        view = MigrationView()
        dyn = DynamicShardChannel(old_ch, sh, view)
        scatter_param(old_ch, "w2", W)  # the old scheme's layout; "w" is the new one's
        bkeys = [f"bkey{i}" for i in range(SHARD_KEYS)]
        dstub = ps_stub(dyn)
        for i, k in enumerate(bkeys):
            c = put(dstub, k, i)
            check(not c.failed(), f"reshard fill Put {k}: {c.error_text()}")
        step_counts("reshard_fill")
        planned = moved_keys(bkeys, 2, 4)
        phase_box = ["pre"]
        records, wrong, lock = [], [], threading.Lock()
        stop = threading.Event()
        x0 = x_bytes[0]

        def load_loop():
            j = 0
            while not stop.is_set():
                phase = phase_box[0]
                t0 = time.perf_counter()
                if j % 4 == 3:  # fan-out Forward on the scheme the channel would take
                    primary = dyn.channels()[0]
                    c = Controller()
                    c.request_attachment.append_user_data(x0)
                    ps_stub(primary).Forward(
                        c, EchoRequest(message="w2" if primary is old_ch else "w"))
                    if not c.failed():
                        y = torch.from_numpy(np.frombuffer(
                            bytearray(c.response_attachment.to_bytes()), np.float32)).to(dev)
                        if past_f64(y, ref[0], scale[0])[0]:
                            wrong.append(("Forward", phase))
                else:
                    i = j % len(bkeys)
                    if j % 8 == 1:
                        c = put(dstub, bkeys[i], i)
                    else:
                        c, ok = get_ok(dstub, bkeys[i], i)
                        if not c.failed() and not ok:
                            wrong.append((bkeys[i], phase))
                dt = time.perf_counter() - t0
                with lock:
                    records.append((phase, dt, c.error_code))
                j += 1

        def count(phase):
            with lock:
                return sum(1 for p, _, _ in records if p == phase)

        threads = [threading.Thread(target=load_loop) for _ in range(RESHARD_THREADS)]
        for t in threads:
            t.start()
        durations = {}
        try:
            t0 = time.perf_counter()
            while count("pre") < RESHARD_PHASE_CALLS:
                time.sleep(0.005)
            durations["pre"] = time.perf_counter() - t0
            phase_box[0] = "during"
            coord = ReshardCoordinator(
                "smoke-ps", [PsShardStore(p) for p in old_ch.partitions()],
                [PsShardStore(p) for p in sh.partitions()], view=view,
                key_filter=lambda k: not k.startswith("w"))
            mig, mig_s = timed(coord.run)
            durations["during"] = mig_s
            phase_box[0] = "post"
            t0 = time.perf_counter()
            while count("post") < RESHARD_PHASE_CALLS:
                time.sleep(0.005)
            durations["post"] = time.perf_counter() - t0
        finally:
            stop.set()
            for t in threads:
                t.join(60.0)
        check(not any(t.is_alive() for t in threads), "a reshard load thread hung")
        cnt = mig["counters"]
        codes = [e for _, _, e in records if e]
        check(mig["completed"] and mig["epoch"] == 1 and cnt["keys_moved"] == len(planned)
              and cnt["checksum_failures"] == 0,
              f"reshard: completed {mig['completed']}, epoch {mig['epoch']}, moved "
              f"{cnt['keys_moved']} of the scheme delta {len(planned)}, checksum failures "
              f"{cnt['checksum_failures']}")
        check(all(cd in ERROR_WHITELIST for cd in codes), f"non-ERPC codes {set(codes)}")
        check(not wrong, f"{len(wrong)} wrong answers under the reshard: {wrong[:5]}")
        for i, k in enumerate(bkeys):
            holders = [j for j, s in enumerate(svcs) if k in s._store]
            check(holders == [shard_of(k, 4)], f"{k} on shards {holders}, not {shard_of(k, 4)}")
        step_counts("reshard")
        with lock:
            for name in ("pre", "during", "post"):
                lats = sorted(dt for p, dt, _ in records if p == name)
                errs = sum(1 for p, _, e in records if p == name and e)
                say(f"reshard load {name:6}: {len(lats)} calls in {durations[name]:.3f} s, "
                    f"{len(lats) / durations[name]:.1f} qps, p50 {pct(lats, 0.5) * 1e3:.3f} ms, "
                    f"p99 {pct(lats, 0.99) * 1e3:.3f} ms, errors {errs}")
        say(f"reshard 2 -> 4 under {RESHARD_THREADS} threads of Get/Put/fan-out Forward: "
            f"{SHARD_KEYS} keys of {vmb:.1f} MiB, {cnt['keys_moved']} moved (scheme delta "
            f"{len(planned)}) in {mig_s:.3f} s, {cnt['keys_moved'] / mig_s:.1f} keys/s, "
            f"{cnt['keys_moved'] * vals[0].nbytes / mig_s / 1e9:.3f} GB/s; epoch {mig['epoch']}, "
            f"checksum failures 0, error codes {sorted(set(codes))}, dual writes "
            f"{dyn.dual_writes}, reads fell back {dyn.reads_fell_back}")
    finally:
        for ch in channels:
            for p in ch.partitions():
                p.close()
        for srv in servers:
            srv.stop()

    counts = {k: sum(s.get(k, 0) for s in steps.values()) for k in T.launches}
    say(f"launches per step {steps}")
    return counts, {"keyed_get_ms": keyed_get_ms}


def closed_loop(stubs, req, x_bytes, inflight, duration, spans=None):
    """bench.py:2089-2150: Forward x_bytes[k % len] through the stubs in
    turn, each completion issuing the next call, so `inflight` calls
    stay outstanding for `duration`.  Returns (sorted latencies in us,
    (x index, y bytes) per call, wall s, the window's oldest-generation
    GC pauses in ms: one stalls every call in flight, so they set the
    tail).  ``spans``, when given, gets each call's (issue, completion)
    monotonic ns."""
    from incubator_brpc_tpu_torch.client.controller import Controller

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
        idx = k % len(x_bytes)
        c.request_attachment.append_user_data(x_bytes[idx])
        t0 = time.monotonic_ns()

        def on_done():
            now = time.monotonic()
            with lock:
                if c.failed():
                    errs.append(c.error_text())
                else:
                    t1 = time.monotonic_ns()
                    lats.append((t1 - t0) // 1000)
                    ys.append((idx, c.response_attachment.to_bytes()))
                    if spans is not None:
                        spans.append((t0, t1))
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


def pct(lats, p):
    return lats[min(len(lats) - 1, int(len(lats) * p))]


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


def _echo_message(cls, raw):
    """The message field of a serialized EchoResponse."""
    e = cls()
    e.ParseFromString(raw)
    return e.message


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
    from incubator_brpc_tpu_torch.utils.hashes import murmur3_32, murmur3_32_py, murmur3_native

    check(murmur3_native(), "the native murmur3_32 is not in use: repair and reshard "
                            "would hash in Python")
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
        sr = T.staged_plan(stack, br).stage_rows
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
        hash_ts = []
        for _ in range(20):
            t0 = time.perf_counter()
            murmur3_32(one)
            hash_ts.append(time.perf_counter() - t0)
        hash_s = statistics.median(hash_ts)
        t0 = time.perf_counter()
        check(murmur3_32_py(one) == murmur3_32(one), "native and Python murmur3_32 differ")
        py_s = time.perf_counter() - t0
        hashes = {"repair": 2 * (REPL_PUTS - 1) + 2 * REPL_BEHIND, "reshard": 2 * c["keys_moved"]}
        say(f"murmur3_32 of one {size} value on the host, native: {hash_s * 1e3:.3f} ms "
            f"median of 20 (the Python one: {py_s:.3f} s, equal); the repair's "
            f"{hashes['repair']} and the reshard's {hashes['reshard']} such hashes: "
            f"{hashes['repair'] * hash_s:.3f} s and {hashes['reshard'] * hash_s:.3f} s")

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


def http_get(port, path, method="GET", body=b""):
    """One HTTP/1.1 request to 127.0.0.1:port: (status, body text)."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method,
                                 data=body or None)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read().decode("utf-8", "replace")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8", "replace")


PROM_LINE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})? -?([0-9.eE+-]+|NaN|[+-]?Inf)$')
PROM_TYPE = re.compile(r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge|summary|histogram|untyped)$")


def check_prometheus(text):
    """Every line of /metrics is a # TYPE/# HELP line or a sample."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    samples = 0
    for ln in lines:
        if ln.startswith("# TYPE"):
            check(PROM_TYPE.match(ln) is not None, f"/metrics: bad TYPE line {ln!r}")
        elif ln.startswith("#"):
            check(ln.startswith("# HELP "), f"/metrics: bad comment {ln!r}")
        else:
            check(PROM_LINE.match(ln) is not None, f"/metrics: not a sample {ln!r}")
            samples += 1
    return samples


class TokenSink:
    """A stream handler that keeps each frame's text and the first
    frame's arrival time."""

    def __init__(self, t0):
        self.t0, self.first = t0, None
        self.frames, self.failures = [], []
        self.closed = threading.Event()

    def on_received_messages(self, stream, messages):
        if self.first is None:
            self.first = time.monotonic() - self.t0
        self.frames.extend(m.to_bytes().decode() for m in messages)

    def on_half_close(self, stream):
        pass

    def on_closed(self, stream):
        self.closed.set()

    def on_failed(self, stream, code, text):
        self.failures.append((code, text))
        self.closed.set()


def sse_call(stub_method, req):
    """One SSE call read progressively: (data events without the
    terminator, seconds to the first data event, seconds to [DONE])."""
    from incubator_brpc_tpu_torch.client.controller import Controller

    c = Controller()
    c.response_will_be_read_progressively()
    t0 = time.monotonic()
    stub_method(c, req)
    check(not c.failed(), f"SSE call failed: {c.error_text()}")
    parts, first, end = [], [None], threading.Event()

    def reader(part):
        if part is None:
            end.set()
            return
        if first[0] is None and b"data: " in part:
            first[0] = time.monotonic() - t0
        parts.append(part)

    check(c.read_progressive_attachment(reader) == 0, "the SSE response is not progressive")
    check(end.wait(120), "an SSE stream never finished")
    body = b"".join(parts).decode()
    events = [ln[6:] for ln in body.split("\n") if ln.startswith("data: ")]
    check(events and events[-1] == "[DONE]", f"SSE stream without [DONE]: {events[-2:]}")
    return events[:-1], first[0], time.monotonic() - t0


def run_parallel(fn, args):
    """fn(*a) for every a at once, one thread each; the results in order."""
    out, errs = [None] * len(args), []

    def one(i):
        try:
            out[i] = fn(*args[i])
        except BaseException as e:  # noqa: BLE001 — a failed check, reported below
            errs.append(f"{i}: {e!r}")
    ts = [threading.Thread(target=one, args=(i,)) for i in range(len(args))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(180)
    check(not any(t.is_alive() for t in ts), "a parallel call never finished")
    check(not errs, f"parallel calls failed: {errs[:3]}")
    return out


def http_generate_sse(torch, dev):
    """GenerateSSE over Channel(protocol="http") against the tpu_std
    stream path (Generate) of the same server, both at d = 6144."""
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server
    from incubator_brpc_tpu_torch.streaming.generate import (
        DecodeLoop,
        GenerateService,
        generate_stub,
    )
    from incubator_brpc_tpu_torch.streaming.stream import Stream

    n, prompts = HTTP_TOKENS, [f"sse prompt {i}" for i in range(HTTP_SSE_P)]
    gen = GenerateService(DecodeLoop(dim=SERVE_DIM, device=dev))
    srv = Server()
    srv.add_service(gen)
    check(srv.start(0) == 0, "GenerateService server failed to start")
    channels = []
    try:
        gen.loop.prewarm()
        check(gen.loop.device == dev, f"decode loop on {gen.loop.device}")
        http = Channel(ChannelOptions(protocol="http", timeout_ms=120000))
        std = Channel(ChannelOptions(timeout_ms=120000))
        for ch in (http, std):
            check(ch.init(f"127.0.0.1:{srv.port}") == 0, "channel init failed")
            channels.append(ch)

        def sse(prompt):
            return sse_call(generate_stub(http).GenerateSSE,
                            EchoRequest(message=prompt, code=n))

        def stream(prompt):
            t0 = time.monotonic()
            sink, c = TokenSink(t0), Controller()
            s = Stream.create(c, sink)
            r = generate_stub(std).Generate(c, EchoRequest(message=prompt, code=n))
            check(not c.failed() and r.message == "streaming", f"Generate: {c.error_text()}")
            check(s.wait_established(30) and sink.closed.wait(120), "a token stream never closed")
            check(not sink.failures, f"token stream failed: {sink.failures}")
            return sink.frames, sink.first, time.monotonic() - t0

        sse("warm up"), stream("warm up")
        solo = {}
        for p in (1, HTTP_SSE_P):
            runs = {}
            for name, fn in (("sse", sse), ("stream", stream)):
                t0 = time.monotonic()
                if p == 1:
                    out = [fn(q) for q in prompts]
                else:
                    out = run_parallel(fn, [(q,) for q in prompts])
                wall = time.monotonic() - t0
                for q, (toks, _, _) in zip(prompts, out):
                    check(len(toks) == n, f"{name}: {len(toks)} tokens of {n} for {q!r}")
                runs[name] = ([o[0] for o in out], [o[1] for o in out], wall)
            if p == 1:
                for q, a, b in zip(prompts, runs["sse"][0], runs["stream"][0]):
                    check(a == b, f"p1 {q!r}: SSE tokens {a[:4]} differ from the stream's {b[:4]}")
                solo = dict(zip(prompts, runs["sse"][0]))
            diff = {k: sum(x != y for q, toks in zip(prompts, v[0])
                           for x, y in zip(toks, solo[q])) for k, v in runs.items()}
            calls = len(prompts) if p == 1 else p
            print(f"[http] GenerateSSE p{p}: " + "; ".join(
                f"{k} {calls * n / v[2]:.1f} tokens/s, first data median "
                f"{statistics.median(v[1]) * 1e3:.2f} ms" for k, v in runs.items())
                + (f"; every SSE token equal to the stream's ({len(prompts)} prompts x {n})"
                   if p == 1 else
                   f"; tokens differing from each prompt's p1 run: sse {diff['sse']}, "
                   f"stream {diff['stream']} of {p * n}"))
        check(gen.sse_rows >= 1 + len(prompts) * 2, f"sse_rows {gen.sse_rows}")
    finally:
        for ch in channels:
            ch.close()
        srv.stop()
        gen.close()


def http_admit_sse(torch, dev):
    """AdmitSSE on a DecodeService at d = 6144 behind a PrefillService
    (the serve phase's layout) against the stream Admit."""
    from incubator_brpc_tpu_torch.cache import HBMCacheStore
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server
    from incubator_brpc_tpu_torch.serving.decode import DecodeService, decode_stub
    from incubator_brpc_tpu_torch.serving.prefill import PrefillService, prefill_stub
    from incubator_brpc_tpu_torch.serving.router import SessionChannel
    from incubator_brpc_tpu_torch.streaming.generate import DecodeLoop
    from incubator_brpc_tpu_torch.streaming.stream import Stream

    n, layers = HTTP_TOKENS, SERVE_LAYERS
    store = HBMCacheStore(SERVE_STORE, device=dev)
    pf = PrefillService(store, dim=SERVE_DIM, n_layers=layers, device=dev)
    dec = DecodeService(store, DecodeLoop(dim=SERVE_DIM, device=dev), name="http-d0")
    srv = Server()
    srv.add_service(pf)
    srv.add_service(dec)
    check(srv.start(0) == 0, "prefill/decode server failed to start")
    channels = []
    try:
        pf.prewarm()
        dec.loop.prewarm()
        http = Channel(ChannelOptions(protocol="http", timeout_ms=120000))
        std = Channel(ChannelOptions(timeout_ms=120000))
        for ch in (http, std):
            check(ch.init(f"127.0.0.1:{srv.port}") == 0, "channel init failed")
            channels.append(ch)

        def prefill(session, prompt):
            c = Controller()
            r = prefill_stub(std).Prefill(c, EchoRequest(message=json.dumps(
                {"session": session, "prompt": prompt})))
            check(not c.failed(), f"Prefill {session}: {c.error_text()}")
            check(json.loads(r.message)["prefill_executions"] == 1, f"{session}: {r.message}")

        def admit_req(session):
            return EchoRequest(message=json.dumps(
                {"session": session, "kv_epoch": 0, "n_layers": layers, "max_tokens": n}))

        def stream_admit(session):
            t0 = time.monotonic()
            sink, c = TokenSink(t0), Controller()
            s = Stream.create(c, sink)
            r = decode_stub(std).Admit(c, admit_req(session))
            check(not c.failed() and r.message == "streaming", f"Admit: {c.error_text()}")
            check(s.wait_established(30) and sink.closed.wait(120), "an Admit stream never closed")
            check(not sink.failures, f"Admit stream failed: {sink.failures}")
            return sink.frames, sink.first, time.monotonic() - t0

        rows = []
        for i in range(HTTP_ADMITS):
            prompt = f"admit prompt {i}"
            for sid in (f"http-sse-{i}", f"http-std-{i}"):
                prefill(sid, prompt)
            ev, first, wall = sse_call(decode_stub(http).AdmitSSE, admit_req(f"http-sse-{i}"))
            fr, sfirst, swall = stream_admit(f"http-std-{i}")
            check([e.split()[0] for e in ev] == [str(k) for k in range(n)],
                  f"AdmitSSE indices {[e.split()[0] for e in ev][:4]}")
            check([e.split()[1] for e in ev] == [f.split()[1] for f in fr],
                  f"AdmitSSE tokens differ from the stream Admit's for {prompt!r}")
            for sid in (f"http-sse-{i}", f"http-std-{i}"):
                check(pf.prefill_executions[sid] == 1, f"{sid}: prefill ran more than once")
            rows.append((first, wall, sfirst, swall))
            if i == 0:
                sse_first = [e.split()[1] for e in ev]
        # one session through the router, for /serving: the same tokens
        routed = SessionChannel(pf, [dec]).generate("http-router", "admit prompt 0", n)
        check(routed.tokens == sse_first and routed.prefill_executions == 1,
              "the routed session's tokens differ from AdmitSSE's")
        med = lambda k: statistics.median(r[k] for r in rows) * 1e3  # noqa: E731
        print(f"[http] AdmitSSE p1 at d = {SERVE_DIM} behind prefill ({layers} layers): "
              f"{HTTP_ADMITS} sessions x {n} tokens equal to the stream Admit's, "
              f"prefill_executions 1 each; first data median {med(0):.2f} ms, "
              f"{n / (med(1) / 1e3):.1f} tokens/s (stream Admit {med(2):.2f} ms, "
              f"{n / (med(3) / 1e3):.1f} tokens/s); sse_rows {dec.sse_rows}")
    finally:
        for ch in channels:
            ch.close()
        srv.stop()
        dec.close()
        store.flush()


def ps_forward_ref(torch, W, x_rows):
    """float64 reference and scale of y = x @ W for the check."""
    x = x_rows.double()
    return x @ W.double(), x.abs() @ W.abs().double()


def http_pages(torch, T, dev):
    """The builtin pages over HTTP from a server that has just run PS
    Forward at d = 6144 and 64 MB echoes; then /hotspots/device while a
    client thread echoes, /hotspots/hbm with a rebase.  Returns the
    copy kernels' launch counts of the phase's main path."""
    import numpy as np

    from incubator_brpc_tpu_torch.cache import CacheChannel, HBMCacheService, HBMCacheStore
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
    from incubator_brpc_tpu_torch.models.parameter_server import PsService, ps_stub
    from incubator_brpc_tpu_torch.parallel.ici import get_fabric
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.replication import replicated_cache_group
    from incubator_brpc_tpu_torch.replication.group import unregister_group
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    d = PS_DIM
    fabric = get_fabric()
    check(fabric.chunk_mode == "fused", f"fabric left in {fabric.chunk_mode} mode")
    store = HBMCacheStore(HTTP_CACHE, device=dev)
    srv = Server(ServerOptions(redis_service=HBMCacheService(store=store)))
    ps = PsService(device=dev)
    srv.add_service(ps)
    srv.add_service(EchoService())
    check(srv.start(0) == 0 and srv.start_ici(HTTP_SLICE, 0, device=dev) == 0,
          "the pages' server failed to start")
    ep = f"ici://slice{HTTP_SLICE}/chip0"
    opts = ChannelOptions(timeout_ms=60000, ici_device=dev)
    ch, cc = Channel(opts), None
    try:
        check(ch.init(ep) == 0, "ici channel init failed")
        T.reset_launch_counts()  # the path's run starts here
        g = torch.Generator(device=dev).manual_seed(SEED)
        W = torch.randn((d, d), generator=g, device=dev) / d ** 0.5
        c = Controller()
        c.request_attachment.append_device(W)
        ps_stub(ch).Put(c, EchoRequest(message="w"))
        check(not c.failed(), f"Put of W: {c.error_text()}")
        c = Controller()
        ps_stub(ch).Get(c, EchoRequest(message="w"))
        check(not c.failed() and torch.equal(c.response_attachment.device_arrays()[0], W),
              f"Get of W: {c.error_text()}")
        xs = torch.randn((HTTP_FORWARDS, d), generator=g, device=dev)
        ref, scale = ps_forward_ref(torch, W, xs)
        xh = xs.cpu().numpy()
        for i in range(HTTP_FORWARDS):
            c = Controller()
            c.request_attachment.append_user_data(xh[i].tobytes())
            ps_stub(ch).Forward(c, EchoRequest(message="w"))
            check(not c.failed(), f"Forward: {c.error_text()}")
            y = torch.from_numpy(np.frombuffer(bytearray(c.response_attachment.to_bytes()),
                                               np.float32)).to(dev)
            bad, worst = past_f64(y, ref[i], scale[i])
            check(bad == 0, f"Forward {i}: {bad} outputs off by up to {worst:.3g}")
        x0 = make_payload(torch, MAIN_SHAPE, torch.float32, SEED)

        def echo(x):
            c = Controller()
            c.request_attachment.append_device(x)
            echo_stub(ch).Echo(c, EchoRequest(message="pages"))
            check(not c.failed(), f"64 MB echo: {c.error_text()}")
            return c.response_attachment.device_arrays()[0]

        for _ in range(HTTP_ECHOES):
            check(torch.equal(echo(x0), x0), "the 64 MB echo came back changed")
        cc = CacheChannel(f"list://{ep}", lb="rr", options=opts)
        group = replicated_cache_group("smoke.http", [cc], endpoints=[ep])
        value = bytes(range(256)) * 16  # the replicated group moves host bytes
        check(group.put("http-key", value), "a quorum put to the pages' cache failed")
        check(cc.get_host("http-key") == value, "the cache read back other bytes")

        # ---- every registered page, with the JAX package's status code --
        t0 = time.perf_counter()
        tracing, page_s = tracemalloc.is_tracing(), {}
        try:
            for page, want in BUILTIN_STATUS.items():
                t1 = time.perf_counter()
                st, body = http_get(srv.port, page + BUILTIN_QUERY.get(page, ""))
                page_s[page] = time.perf_counter() - t1
                check(st == want, f"{page}: status {st}, the JAX package answers {want}: "
                                  f"{body[:200]!r}")
        finally:
            if not tracing:  # the heap pages start tracemalloc; it slows every later phase
                tracemalloc.stop()
        check(set(srv._builtin_handlers) == set(BUILTIN_STATUS),
              f"registered pages {sorted(set(srv._builtin_handlers) ^ set(BUILTIN_STATUS))} "
              f"differ from the JAX package's")
        pages_s = time.perf_counter() - t0
        _, status = http_get(srv.port, "/status")
        counts = {m: int(re.search(rf"^{re.escape(m)}:\n  count=(\d+)", status, re.M).group(1))
                  for m in ("PsService.Put", "PsService.Get", "PsService.Forward")}
        check(all(v > 0 for v in counts.values()), f"/status counts {counts}")
        samples = check_prometheus(http_get(srv.port, "/metrics")[1])
        _, rpcz = http_get(srv.port, "/rpcz")
        check("PsService.Forward" in rpcz and "EchoService.Echo" in rpcz, "/rpcz has no spans")
        cache = json.loads(http_get(srv.port, "/cache")[1])
        check(cache["enabled"] and cache["stores"][0]["entries"] >= 1, f"/cache {cache}")
        serving = json.loads(http_get(srv.port, "/serving")[1])
        check("http-router" in serving["sessions"], "/serving does not list the routed session")
        repl = json.loads(http_get(srv.port, "/replication")[1])
        check("smoke.http" in repl["groups"], f"/replication {sorted(repl['groups'])}")
        mig = json.loads(http_get(srv.port, "/resharding")[1])["migrations"]
        check(len(mig) > 0, "/resharding lists no migration")
        slowest = sorted(page_s.items(), key=lambda kv: -kv[1])[:4]
        print(f"[http] builtin pages: {len(BUILTIN_STATUS)} answered with the JAX package's "
              f"status codes in {pages_s:.2f} s (slowest "
              + ", ".join(f"{k} {v:.2f} s" for k, v in slowest)
              + f"); /status counts {counts}; /metrics "
              f"{samples} Prometheus samples; /rpcz spans of Forward and Echo; /cache "
              f"{cache["stores"][0]["entries"]} entries; /serving {len(serving['sessions'])} "
              f"sessions; /replication {sorted(repl['groups'])}; /resharding {sorted(mig)}")

        kernels_seen = http_capture(torch, T, srv.port, echo, x0)
        http_hbm(srv.port)
        counts = dict(T.launches)  # ... and ends here
        unregister_group("smoke.http")
    finally:
        if cc is not None:
            cc.close()
        ch.close()
        srv.stop()
        store.flush()
    return counts, kernels_seen


def http_capture(torch, T, port, echo, x0):
    """/hotspots/device?seconds=N while a client thread echoes 64 MB over
    ici://, fused and pallas in turns (the fused transmit has no
    dispatch-window family in either package; pallas has ici.pallas).
    Returns K1's (and K2's) mean CUDA time from the exported trace."""
    from incubator_brpc_tpu_torch.observability import profiling
    from incubator_brpc_tpu_torch.parallel.ici import get_fabric

    fabric = get_fabric()
    profiling.device_capture(0.1)  # the profiler's first start, outside the window
    stop, seen = threading.Event(), []

    def load():
        for mode in itertools.cycle(("fused", "pallas")):
            if stop.is_set():
                return
            fabric.chunk_mode = mode
            seen.append(torch.equal(echo(x0), x0))

    k1_0, k2_0 = T.launches["copy_csum_blocks"], T.launches["copy_csum_staged"]
    t = threading.Thread(target=load)
    t.start()
    try:
        st, text = http_get(port, f"/hotspots/device?seconds={HTTP_CAPTURE_S}")
    finally:
        stop.set()
        t.join(60)
        fabric.chunk_mode = "fused"
    check(not t.is_alive() and seen and all(seen), "the capture's echo load failed")
    check(st == 200, f"/hotspots/device: {st} {text[:300]!r}")
    check("trace: unavailable" not in text, f"trace_error set: {text[:400]!r}")
    fams = {m.group(3): (int(m.group(1)), float(m.group(2))) for m in re.finditer(
        r"^\s+(\d+)\s+([0-9.]+)\s+[0-9.]+\s+(\S+)$", text, re.M)}
    ici = {k: v for k, v in fams.items() if k.startswith("ici.")}
    check(ici and all(v[0] > 0 for v in ici.values()), f"no ici.* family in {fams}")
    trace_dir = re.search(r"^trace_dir: (.+)$", text, re.M).group(1)
    trace = json.loads((pathlib.Path(trace_dir) / profiling.TRACE_FILE).read_text())
    kern = {}
    for e in trace.get("traceEvents", []):
        if e.get("cat") == "kernel":
            kern.setdefault(e["name"], []).append(float(e.get("dur", 0.0)))
    k1 = [v for k, v in kern.items() if "copy_csum_blocks_kernel" in k]
    k2 = [v for k, v in kern.items() if "copy_csum_staged" in k]
    k1_us = [x for v in k1 for x in v]
    k2_us = [x for v in k2 for x in v]
    check(len(k1_us) > 0, f"the trace names no K1 kernel: {sorted(kern)[:8]}")
    grew = T.launches["copy_csum_blocks"] - k1_0
    check(grew > 0, "K1 launches did not grow during the capture")
    print(f"[http] /hotspots/device?seconds={HTTP_CAPTURE_S}: {len(seen)} 64 MB echoes "
          f"(fused and pallas in turns) during the window; families "
          f"{ {k: v[0] for k, v in ici.items()} }; trace {trace_dir}: K1 "
          f"{len(k1_us)} launches, mean {statistics.mean(k1_us) / 1e3:.4f} ms of CUDA time"
          + (f", K2 {len(k2_us)}, mean {statistics.mean(k2_us) / 1e3:.4f} ms" if k2_us else "")
          + f"; K1 launches counted {grew}, K2 "
          f"{T.launches['copy_csum_staged'] - k2_0}")
    kernels_seen = {"k1_trace_ms": statistics.mean(k1_us) / 1e3}
    if k2_us:
        kernels_seen["k2_trace_ms"] = statistics.mean(k2_us) / 1e3
    return kernels_seen


def http_hbm(port):
    """/hotspots/hbm: the ledger's tags, the census and <dark>; after
    ?rebase=1, <dark> is 0 up to the allocator's rounding."""

    def hbm():
        text = http_get(port, "/hotspots/hbm")[1]
        cen = re.search(r"^census: source=(\S+) bytes=(\d+) baseline=(\d+)"
                        r"(?: rounding=(\d+))?", text, re.M)
        dark = int(re.search(r"^<dark>: (\d+) bytes", text, re.M).group(1))
        tags = {m.group(3): int(m.group(1)) for m in re.finditer(
            r"^\s+(\d+)\s+(\d+) @ (\S+)$", text, re.M)}
        return cen, dark, tags, text

    cen, dark, tags, _ = hbm()
    check(cen is not None and cen.group(1) == "memory_stats", "/hotspots/hbm has no census")
    print(f"[http] /hotspots/hbm: tags {tags}; census memory_stats {cen.group(2)} B, "
          f"rounding {cen.group(4)} B; <dark> {dark} B")
    st, text = http_get(port, "/hotspots/hbm?rebase=1")
    check(st == 200 and "rebased" in text, f"rebase: {text!r}")
    cen, dark, tags, text = hbm()
    rounding = int(cen.group(4) or 0)
    check(dark <= rounding, f"<dark> {dark} B after the rebase, past the allocator's "
                            f"rounding {rounding} B: {text[:400]!r}")
    print(f"[http] /hotspots/hbm after ?rebase=1: baseline {cen.group(3)} B, <dark> "
          f"{dark} B (the page states the allocator's rounding: {rounding} B)")


def http_internal_port():
    """internal_port: the pages answer there and are refused on the
    public port, where pb services still answer."""
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    srv = Server(ServerOptions(internal_port=0))
    srv.add_service(EchoService())
    check(srv.start(0) == 0 and srv.internal_port > 0, "internal_port did not start")
    try:
        codes = {}
        for page in ("/status", "/vars", "/hotspots/hbm"):
            codes[page] = (http_get(srv.internal_port, page)[0], http_get(srv.port, page)[0])
            check(codes[page] == (200, 403), f"{page}: internal/public {codes[page]}")
        ch = Channel(ChannelOptions(timeout_ms=10000))
        check(ch.init(f"127.0.0.1:{srv.port}") == 0, "channel init failed")
        c = Controller()
        r = echo_stub(ch).Echo(c, EchoRequest(message="public"))
        check(not c.failed() and r.message == "public", f"Echo on the public port: {c.error_text()}")
        ch.close()
        st, _ = http_get(srv.internal_port, "/EchoService/Echo", "POST", b'{"message": "x"}')
        check(st == 404, f"a pb call on the internal port answered {st}")
        print(f"[http] internal_port {srv.internal_port}: pages internal/public {codes}; "
              f"Echo answers on the public port only")
    finally:
        srv.stop()


def http_rpc_dump(torch, dev, tmp):
    """rpc_dump samples PS Forward calls carrying device x over ici://
    (the same calls run unsampled first: Forward reads x as bytes, so
    each call pulls it to the host once either way); rpc_replay sends
    the samples to a fresh server, whose every y is held to float64."""
    import numpy as np

    from incubator_brpc_tpu_torch.analysis.device_witness import transfer_counts
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.parameter_server import PsService, ps_stub
    from incubator_brpc_tpu_torch.observability.rpc_dump import list_dump_files, read_samples
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
    from incubator_brpc_tpu_torch.tools.rpc_replay import replay

    d, dump_dir = PS_DIM, str(tmp / "rpc_dump")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    W = torch.randn((d, d), generator=g, device=dev) / d ** 0.5
    src = Server(ServerOptions(rpc_dump_dir=dump_dir))
    ps = PsService(device=dev)
    ps.put_param("w", W)
    src.add_service(ps)
    check(src.start(0) == 0 and src.start_ici(HTTP_SLICE, 1, device=dev) == 0,
          "the dumping server failed to start")
    # the replay is fire-and-forget: the target's own Forward keeps each
    # call's (x, y) bytes for the check
    replayed = []
    dst_ps = PsService(device=dev)
    dst_ps.put_param("w", W)
    forward = dst_ps.Forward

    def recorded(controller, request, response, done):
        def done_recording():
            replayed.append((controller.request_attachment.to_bytes(),
                             controller.response_attachment.to_bytes()))
            done()
        return forward(controller, request, response, done_recording)

    dst_ps.Forward = recorded  # add_service binds the instance's attribute
    dst = Server()
    dst.add_service(dst_ps)
    check(dst.start(0) == 0, "the replay target failed to start")
    ch = Channel(ChannelOptions(timeout_ms=60000, ici_device=dev))
    try:
        check(ch.init(f"ici://slice{HTTP_SLICE}/chip1") == 0, "ici channel init failed")
        xs = torch.randn((HTTP_DUMPS, d), generator=g, device=dev)

        def forwards():
            pulls0 = transfer_counts().get("iobuf.host-view", 0)
            for i in range(HTTP_DUMPS):
                c = Controller()
                c.request_attachment.append_device(xs[i].clone())
                ps_stub(ch).Forward(c, EchoRequest(message="w"))
                check(not c.failed(), f"Forward {i}: {c.error_text()}")
            return transfer_counts().get("iobuf.host-view", 0) - pulls0

        st, body = http_get(src.port, "/rpc_dump?disable=1", "POST")
        check(st == 200 and src._rpc_dump_ctx is None, f"disarming rpc_dump: {body}")
        pulls_off = forwards()
        st, body = http_get(src.port, f"/rpc_dump?dir={dump_dir}&ratio=1", "POST")
        check(st == 200 and json.loads(body)["enabled"], f"arming rpc_dump: {body}")
        pulls = forwards()
        ctx = src._rpc_dump_ctx
        samples = [s for f in list_dump_files(dump_dir) for s in read_samples(f)]
        check(ctx.sampled == len(samples) == HTTP_DUMPS,
              f"{ctx.sampled} sampled, {len(samples)} read back, {HTTP_DUMPS} calls")
        check(pulls == len(samples), f"{pulls} host-view pulls for {len(samples)} samples")
        n = replay(f"127.0.0.1:{dst.port}", dump_dir, qps=1000, report=lambda *_: None)
        check(n == len(samples), f"replayed {n} of {len(samples)}")
        deadline = time.monotonic() + 60
        while len(replayed) < n and time.monotonic() < deadline:
            time.sleep(0.01)
        check(len(replayed) == n, f"the replay target answered {len(replayed)} of {n}")
        worst = 0.0
        for xb, yb in replayed:
            x = torch.from_numpy(np.frombuffer(bytearray(xb), np.float32)).to(dev)
            y = torch.from_numpy(np.frombuffer(bytearray(yb), np.float32)).to(dev)
            ref, scale = ps_forward_ref(torch, W, x[None])
            bad, w = past_f64(y, ref[0], scale[0])
            check(bad == 0, f"a replayed y is off by up to {w:.3g} of |x| @ |W|")
            worst = max(worst, w)
        print(f"[http] rpc_dump: {len(samples)} Forward calls (device x over ici://) "
              f"sampled into {len(list_dump_files(dump_dir))} file(s), {pulls} host-view "
              f"pulls ({pulls_off} for the same calls unsampled); rpc_replay sent {n} to a fresh server, every y within {PS_RTOL} of "
              f"|x| @ |W| (worst {worst:.3g})")
    finally:
        ch.close()
        src.stop()
        dst.stop()


def phase_http(torch, T):
    """The HTTP front on the card: SSE token streaming, the builtin
    pages with the device profiler, internal_port, rpc_dump and replay.
    Returns (launch counts of the path, trace kernel times)."""
    import tempfile

    dev = card(torch)
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 must stay off")
    t0 = time.perf_counter()
    http_generate_sse(torch, dev)
    http_admit_sse(torch, dev)
    counts, kernels_seen = http_pages(torch, T, dev)
    http_internal_port()
    with tempfile.TemporaryDirectory(prefix="smoke-dump-") as tmp:
        http_rpc_dump(torch, dev, pathlib.Path(tmp))
    print(f"[http] phase {time.perf_counter() - t0:.1f} s; launches {counts}")
    return counts, kernels_seen


def same_bytes(torch, a, b) -> bool:
    """a and b hold the same bytes (shape and dtype equal)."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def mesh_collectives(torch, dev):
    """Each lowering of parallel/collectives.py on a (1, MESH_CHIPS)
    mesh of virtual chips on ``dev`` over a (MESH_CHIPS * 2048, 2048)
    f32 tensor, held to a plain version written here: gather,
    all_to_all, the ppermute ring and the hedged pick byte-equal, the
    psum bit-equal to the chip-order sum.  Prints each one's CUDA time
    (the profiler's kernel spans) and its time a call back to back
    (``queued_ms``) beside its HBM bound."""
    from incubator_brpc_tpu_torch.parallel import collectives as C
    from incubator_brpc_tpu_torch.parallel.mesh import create_mesh

    n = MESH_CHIPS
    mesh = create_mesh((1, n), devices=[dev] * n)
    rows, cols = MESH_BLOCK
    x = make_payload(torch, (n * rows, cols), torch.float32, SEED)
    blocks = list(x.split(rows))
    xs = C.shard_tensor(x, mesh, C.P("chip"))
    xs2 = C.shard_tensor(x, mesh, C.P("chip", None))
    flags = torch.tensor([0.0, 0.0, 1.0, 1.0] + [1.0] * (n - 4), device=dev)
    vs = C.shard_tensor(flags, mesh, C.P("chip"))
    block_b = rows * cols * 4

    psum_plain = blocks[0].clone()
    for b in blocks[1:]:
        psum_plain += b
    cn = cols // n
    a2a_plain = [torch.cat([b[:, i * cn:(i + 1) * cn] for b in blocks]) for i in range(n)]
    ring_plain = []
    for k in range(n):
        acc = blocks[k]
        for hop in range(1, n):
            acc = acc + blocks[(k - hop) % n]
        ring_plain.append(acc)
    hedged_plain = torch.zeros_like(blocks[0])
    for k in range(n):
        hedged_plain += blocks[k] if k == 2 else torch.zeros_like(blocks[k])
    cases = [
        # name, lowering, its input, plain per chip, bytes the function moves
        ("psum", lambda: C.parallel_merge(mesh, "chip", "sum")(xs), [psum_plain] * n,
         n * block_b + block_b),
        ("all_gather", lambda: C.parallel_broadcast_gather(mesh, "chip")(xs), [x] * n,
         2 * n * block_b),
        ("all_to_all", lambda: C.partition_reshard(mesh, "chip")(xs2), a2a_plain,
         2 * n * block_b),
        ("ppermute_ring", lambda: C.ring_stream(mesh, "chip")(xs), ring_plain,
         2 * n * block_b),
        # this run's flags pick chip 2: its block is read, the result written
        ("hedged_first_valid", lambda: C.hedged_first_valid(mesh, "chip")(xs, vs),
         [hedged_plain] * n, 2 * block_b + n * 4),
    ]
    out = {}
    for name, fn, plain, nbytes in cases:
        got = fn()
        torch.cuda.synchronize(dev)
        check(len(got.shards) == n, f"{name}: {len(got.shards)} shards for {n} chips")
        for k, (g, p) in enumerate(zip(got.shards, plain)):
            check(same_bytes(torch, g, p), f"{name}: chip {k}'s result differs from the plain "
                                           f"version's bytes")
        cuda = device_ms(torch, fn, iters=10)
        ms = queued_ms(torch, fn, iters=10)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = {"ms": ms, "cuda_ms": cuda, "bound_ms": bound}
        print(f"[mesh] {name:18} on a (1, {n}) mesh of {dev}, ({n * rows}, {cols}) f32: "
              f"{cuda:.4f} ms of CUDA time in the profiler, {ms:.4f} ms a call back to back "
              f"(bound {bound:.4f} ms by bytes); each chip's result "
              f"byte-equal to the plain version" + (" (the chip-order sum)" if name == "psum"
                                                    else ""))
    return out


def mesh_ps(torch, T, dev, ps_summary):
    """The in-mesh sharded PS at d = 6144 on a (1, MESH_CHIPS) mesh of
    virtual chips: W Put and Got over ici:// (one K1 a hop), stored as
    MESH_CHIPS row shards; Forward closed loop beside the unsharded
    [ps] points, one execution and one merge per batch; device x over
    ici:// (one K1 a hop); a chaos merge reset failing only its group;
    a live remesh to 2 chips under load; the servable-dim ceiling."""
    import numpy as np

    from incubator_brpc_tpu_torch import errors
    from incubator_brpc_tpu_torch.chaos import injector
    from incubator_brpc_tpu_torch.chaos.plan import FaultPlan, FaultSpec
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.parameter_server import (
        PS_BATCH_POLICY,
        PsService,
        max_servable_dim,
        ps_stub,
    )
    from incubator_brpc_tpu_torch.parallel.collectives import ShardedTensor
    from incubator_brpc_tpu_torch.parallel.mesh import create_mesh
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest, EchoResponse
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    d, n = PS_DIM, MESH_CHIPS
    rows = d // n
    mesh = create_mesh((1, n), devices=[dev] * n)
    svc = PsService(mesh=mesh)
    kern = svc.shard_kernel
    check(svc._device == dev and kern is not None and kern.n_shards() == n,
          f"PsService(mesh=) on {svc._device} with {kern and kern.n_shards()} shards")
    srv = Server(ServerOptions(enable_batching=True))
    srv.add_service(svc)
    check(srv.start_ici(MESH_SLICE, 0) == 0, "start_ici of the mesh server failed")
    srv.disable_method_batching("PsService.Put")
    srv.disable_method_batching("PsService.Get")
    ep = f"ici://slice{MESH_SLICE}/chip0"
    g = torch.Generator(device=dev).manual_seed(SEED)
    W = torch.randn((d, d), generator=g, device=dev) / d ** 0.5
    w_csum = T.device_copy_with_checksum(W)[1]  # outside the count
    req = EchoRequest(message="w")
    channels = []
    summary = {}
    try:
        for _ in range(4):
            ch = Channel(ChannelOptions(timeout_ms=60000, ici_device=dev))
            check(ch.init(ep) == 0, "mesh channel init failed")
            channels.append(ch)
        stubs = [ps_stub(c) for c in channels]

        # ---- Put / Get of W over ici:// ---------------------------------
        T.reset_launch_counts()  # the mesh path's run starts here
        c = Controller()
        c.request_attachment.append_device(W)
        t0 = time.perf_counter()
        stubs[0].Put(c, req)
        torch.cuda.synchronize(dev)
        put_ms = (time.perf_counter() - t0) * 1e3
        check(not c.failed(), f"mesh Put failed: {c.error_text()}")
        stored = svc._store["w"]
        check(isinstance(stored, ShardedTensor) and "w" in svc._sharded_keys,
              "the mesh Put did not shard W")
        check([tuple(s.shape) for s in stored.shards] == [(rows, d)] * n,
              f"W stored as {[tuple(s.shape) for s in stored.shards]}, not {n} x ({rows}, {d})")
        for k, shard in enumerate(stored.shards):
            check(shard.device == dev and shard.is_contiguous()
                  and shard.untyped_storage().nbytes() == rows * d * 4
                  and same_bytes(torch, shard, W[k * rows:(k + 1) * rows]),
                  f"chip {k}'s shard is not a copy of its own of W's rows")
        c = Controller()
        t0 = time.perf_counter()
        stubs[0].Get(c, req)
        torch.cuda.synchronize(dev)
        get_ms = (time.perf_counter() - t0) * 1e3
        check(not c.failed(), f"mesh Get failed: {c.error_text()}")
        segs = c.response_attachment.device_segments()
        check(len(segs) == 1 and same_bytes(torch, segs[0].array, W),
              "the mesh Get did not return W's bytes")
        check(segs[0].csum is not None and torch.equal(segs[0].csum, w_csum),
              "the mesh Get's frame checksum differs from K1's whole-frame checksum")
        del segs, c
        hop_counts = dict(T.launches)
        check(hop_counts["copy_csum_blocks"] == 2 and hop_counts["copy_csum_staged"] == 0,
              f"mesh Put + Get launched {hop_counts}: expected one K1 per hop of W")
        print(f"[mesh] PsService(mesh=create_mesh((1, {n}), devices=[{dev}] * {n})) at {ep}: "
              f"Put of W ({d}, {d}) f32 over ici:// {put_ms:.3f} ms, stored as {n} row shards "
              f"({rows}, {d}) each a copy on {dev}; Get {get_ms:.3f} ms, the assembled W "
              f"byte-equal with K1's checksum; K1 1 per hop")

        # ---- Forward, closed loop ---------------------------------------
        xs = np.random.RandomState(SEED).randn(64, d).astype(np.float32)
        x_bytes = [x.tobytes() for x in xs]
        x_dev = torch.from_numpy(xs).to(dev).double()
        ref = x_dev @ W.double()
        scale = x_dev.abs() @ W.abs().double()

        def verify(ys, what):
            idx = torch.tensor([i for i, _ in ys], device=dev)
            got = torch.from_numpy(
                np.frombuffer(bytearray(b"".join(y for _, y in ys)), np.float32)
                .reshape(len(ys), d)).to(dev)
            bad, worst = past_f64(got, ref[idx], scale[idx])
            check(bad == 0, f"{what}: {bad} Forward outputs off by up to {worst:.3g} of |x| @ |W|")
            return worst

        for b in PS_BATCH_POLICY.padding_buckets:  # cuBLAS set-up out of the windows
            kern(stored, np.zeros((b, d), np.float32))
        for par, cfg in ((1, "off"), (32, "on")):
            if cfg == "off":
                srv.disable_method_batching("PsService.Forward")
            else:
                srv.enable_method_batching("PsService.Forward")
            batcher = srv.batcher("PsService.Forward")
            closed_loop(stubs, req, x_bytes, min(par, 4), 0.1)  # warm
            b0 = batcher.batches if batcher else 0
            e0, m0 = kern.executions, kern.collective_merges
            lats, ys, wall, _ = closed_loop(stubs, req, x_bytes, par, 1.0)
            worst = verify(ys, f"p{par} {cfg}")
            batches = (batcher.batches - b0) if batcher else len(ys)
            execs, merges = kern.executions - e0, kern.collective_merges - m0
            check(execs == merges == batches, f"p{par} {cfg}: {execs} executions, {merges} "
                                              f"merges for {batches} batches")
            qps = len(lats) / wall
            summary[(par, cfg)] = (qps, pct(lats, 0.5), pct(lats, 0.99))
            uq, up50, up99 = ps_summary[(par, cfg)]
            print(f"[mesh] sharded Forward p{par:2} batching {cfg:3}: {qps:9.1f} qps, p50 "
                  f"{pct(lats, 0.5)} us, p99 {pct(lats, 0.99)} us over {len(lats)} calls "
                  f"[unsharded ps: {uq:.1f} qps, p50 {up50} us, p99 {up99} us; "
                  f"{qps / uq:.2f}x]; {batches} batches = {execs} executions = {merges} "
                  f"merges; max |y - ref| / (|x| @ |W|) {worst:.3g}")
        wall_us, busy_us, by_name = device_profile(
            torch, lambda: closed_loop(stubs, req, x_bytes, 32, 0.3))
        check(busy_us > 0, "the profiler saw no CUDA work in the sharded Forward window")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        summary["busy"] = 100 * busy_us / wall_us
        print(f"[profile] mesh forward p32 on: wall {wall_us:.0f} us, device busy "
              f"{busy_us:.0f} us ({summary['busy']:.1f}%); top "
              + ", ".join(f"{name[:40]} {us:.0f} us" for name, us in top))

        # ---- device x over ici://: one K1 on each request hop -----------
        k1 = T.launches["copy_csum_blocks"]
        ys = []
        for i in range(MESH_DEVICE_X):
            c = Controller()
            c.request_attachment.append_device(torch.from_numpy(xs[i]).to(dev))
            stubs[0].Forward(c, req)
            check(not c.failed(), f"Forward of a device x failed: {c.error_text()}")
            ys.append((i, c.response_attachment.to_bytes()))
        verify(ys, "device x")
        dx = T.launches["copy_csum_blocks"] - k1
        check(dx == MESH_DEVICE_X, f"{MESH_DEVICE_X} Forwards of a device x launched {dx} K1")
        print(f"[mesh] {MESH_DEVICE_X} Forwards with x a device tensor over ici://: K1 1 per "
              f"request hop, every y within {PS_RTOL} of |x| @ |W|")

        # ---- a chaos merge reset fails only its key-group ----------------
        svc.put_param("odd", torch.randn((d - 2, 8), generator=g, device=dev))
        check("odd" not in svc._sharded_keys, "a (6142, 8) W must not shard over 4 chips")

        def batch(keys_xs):
            ctrls = []
            for key, x in keys_xs:
                c = Controller()
                c.request_attachment.append_user_data(x.tobytes())
                ctrls.append(c)
            PsService.Forward.__batch_fn__(
                svc, ctrls, [EchoRequest(message=k) for k, _ in keys_xs],
                [EchoResponse() for _ in keys_xs], lambda: None)
            return ctrls

        mix = [("w", xs[0]), ("odd", xs[1][:d - 2].copy()), ("w", xs[2])]
        e0 = kern.executions
        injector.arm(FaultPlan([FaultSpec("collective.merge", "reset", probability=1.0,
                                          match={"method": "PsService.Forward"})],
                               seed=SEED, name="mesh-merge-reset"))
        try:
            armed = batch(mix)
        finally:
            injector.disarm()
        check([c.failed() for c in armed] == [True, False, True]
              and armed[0].error_code == armed[2].error_code == errors.EINTERNAL,
              "the merge reset must fail the sharded group's rows only, EINTERNAL: "
              f"{[(c.failed(), c.error_code) for c in armed]}")
        check(kern.executions == e0, "the reset batch executed (or was retried on one chip)")
        after = batch(mix)
        check(not any(c.failed() for c in after), "disarmed traffic did not recover")
        verify([(0, after[0].response_attachment.to_bytes()),
                (2, after[2].response_attachment.to_bytes())], "after the reset")
        print("[mesh] chaos collective.merge reset: the sharded group's 2 rows failed "
              "EINTERNAL, the single-chip group's row in the same batch ran; not executed, "
              "not retried; disarmed, all 3 rows held")

        # ---- a live remesh to 2 chips under p = 8 load -------------------
        srv.enable_method_batching("PsService.Forward")
        half = create_mesh((1, 2), devices=[dev] * 2)
        e0 = kern.executions
        box = {}

        def load():
            box["run"] = closed_loop(stubs, req, x_bytes, 8, 1.5)

        t = threading.Thread(target=load)
        t.start()
        time.sleep(0.5)
        t0 = time.perf_counter()
        replaced = svc.remesh(half)
        remesh_ms = (time.perf_counter() - t0) * 1e3
        e_cut = kern.executions
        t.join(60)
        check(not t.is_alive() and "run" in box, "the load across the remesh never finished")
        lats, ys, wall, _ = box["run"]  # closed_loop fails on any failed Forward
        worst = verify(ys, "across the remesh")
        check(replaced == 1, f"remesh re-placed {replaced} parameters, not 1")
        check(svc.shard_kernel is kern and kern.n_shards() == 2
              and [tuple(s.shape) for s in svc._store["w"].shards] == [(d // 2, d)] * 2,
              "after the remesh W is not on 2 chips")
        check(kern.executions > e_cut > e0, "no batch ran on one side of the cutover")
        summary["remesh_ms"] = remesh_ms
        print(f"[mesh] live remesh {n} -> 2 chips under p = 8 load: {remesh_ms:.3f} ms, "
              f"re-placed 1 (odd stays single-chip); {len(lats)} Forwards in {wall:.2f} s, "
              f"none failed, {e_cut - e0} executions before the cutover and "
              f"{kern.executions - e_cut} after; max |y - ref| / (|x| @ |W|) {worst:.3g}")
        counts = dict(T.launches)  # ... and ends here

        # ---- the servable-dim ceiling, proven by placement ---------------
        budget = MESH_CHIP_BUDGET
        d1, dn = max_servable_dim(budget, 1), max_servable_dim(budget, n)
        wide = PsService(mesh=mesh)
        big = torch.zeros((dn, dn), device=dev)
        check(wide.put_param("big", big) is True, "the ceiling matrix did not shard")
        per_chip = [s.nbytes for s in wide._store["big"].shards]
        check(dn >= 2 * d1 and max(per_chip) <= budget < big.nbytes,
              f"ceiling: d1 {d1}, d{n} {dn}, per chip {per_chip} of {budget}")
        print(f"[mesh] max_servable_dim at {budget >> 20} MiB a chip: {d1} on one chip, {dn} "
              f"on {n}; ({dn}, {dn}) f32 placed at {max(per_chip)} B a chip, "
              f"{big.nbytes} B in all")
        del wide, big
    finally:
        for ch in channels:
            ch.close()
        srv.stop()
    summary["put_ms"], summary["get_ms"] = put_ms, get_ms
    return counts, summary


def mesh_prefill(torch, dev):
    """PrefillService(mesh=) at SERVE_DIM with the [serve] phase's layer
    count and prompts: every KV layer within PS_RTOL * (|s| @ |W|) of
    tanh(s @ W) in float64 from the layer below, prefill once a
    session, one sharded execution and merge per layer."""
    from incubator_brpc_tpu_torch.cache import HBMCacheStore
    from incubator_brpc_tpu_torch.parallel.mesh import create_mesh
    from incubator_brpc_tpu_torch.serving.prefill import PrefillService, prompt_seed_state
    from incubator_brpc_tpu_torch.serving.session import kv_layer_keys

    d, n = SERVE_DIM, MESH_CHIPS
    store = HBMCacheStore(SERVE_STORE)
    pf = PrefillService(store, dim=d, n_layers=SERVE_LAYERS,
                        mesh=create_mesh((1, n), devices=[dev] * n))
    check(pf.device == dev and [tuple(s.shape) for s in pf._w_dev.shards] == [(d // n, d)] * n,
          "the prefill W is not row-sharded over the mesh")
    pf.prefill_sessions([("mesh-warm", "warmup prompt")])
    prompts = [f"point prompt {i}" for i in range(max(SERVE_P))]
    reqs = [(f"mesh-{i}", p) for i, p in enumerate(prompts)]
    e0, m0 = pf._sharded.executions, pf._sharded.collective_merges
    t0 = time.perf_counter()
    out = pf.prefill_sessions(reqs)
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3
    check(pf._sharded.executions - e0 == pf._sharded.collective_merges - m0 == SERVE_LAYERS - 1,
          "the window ran other than one sharded execution and merge per layer")
    check(all(out[s]["prefill_executions"] == 1 == pf.prefill_executions[s] for s, _ in reqs),
          "a session was prefilled more than once")
    wd = torch.from_numpy(pf._w).to(dev).double()
    wa = wd.abs()
    worst = 0.0
    try:
        for sid, prompt in reqs:
            layers = [store.get(k) for k in kv_layer_keys(sid, 0, SERVE_LAYERS)]
            check(all(v is not None for v in layers), f"{sid}: a KV layer is missing")
            seed = torch.from_numpy(prompt_seed_state(prompt, d)).to(dev)
            check(same_bytes(torch, layers[0], seed), f"{sid}: layer 0 is not the seed state")
            for lo, hi in zip(layers, layers[1:]):
                s_in = lo.double()
                bad, w_ = past_f64(hi, torch.tanh(s_in @ wd), s_in.abs() @ wa)
                check(bad == 0, f"{sid}: {bad} KV entries off by up to {w_:.3g} of |s| @ |W|")
                worst = max(worst, w_)
    finally:
        store.flush()
    print(f"[mesh] sharded prefill d = {d}, {SERVE_LAYERS} layers on {n} virtual chips: "
          f"{len(reqs)} sessions in one window {ms:.2f} ms, {SERVE_LAYERS - 1} sharded "
          f"executions; prefill_executions 1 each; every layer within {PS_RTOL} of "
          f"|s| @ |W| of the float64 recurrence (worst {worst:.3g})")
    return {"prefill_ms": ms}


def mesh_train(torch, dev):
    """make_training_step on a (2, 2) mesh of virtual chips at dim =
    SERVE_DIM, batch MESH_BATCH, MESH_STEPS steps: the loss falls at
    every step, step 1's parameters within PS_RTOL of a float64 step of
    the plain unsharded version (scale |w| + lr * the step's gradient
    with every term's magnitude), and the median step time."""
    from incubator_brpc_tpu_torch.models.parameter_server import make_training_step
    from incubator_brpc_tpu_torch.parallel.mesh import create_mesh

    d, b, lr = SERVE_DIM, MESH_BATCH, 0.01
    mesh = create_mesh((2, 2), devices=[dev] * 4)
    step, params, x = make_training_step(mesh, dim=d, batch=b, lr=lr)
    # the plain unsharded step in float64, and each gradient's magnitude
    w1, w2, xf = (t.full().double() for t in (params["w1"], params["w2"], x))
    a = xf @ w1
    mask = (a > 0).double()
    h = a * mask
    y = h @ w2
    dy = 2 * y / (b * d)
    g2 = h.T @ dy
    g1 = xf.T @ ((dy @ w2.T) * mask)
    loss64 = (y * y).mean().item()
    ha = (xf.abs() @ w1.abs()) * mask
    dya = 2 * (ha @ w2.abs()) / (b * d)
    g2a = ha.T @ dya
    g1a = xf.abs().T @ ((dya @ w2.abs().T) * mask)
    ref = {"w1": (w1 - lr * g1, w1.abs() + lr * g1a), "w2": (w2 - lr * g2, w2.abs() + lr * g2a)}
    del a, mask, h, y, dy, ha, dya
    losses, times = [], []
    for i in range(MESH_STEPS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, loss = step(params, x)
        loss = loss.item()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if i == 0:
            check(abs(loss - loss64) <= PS_RTOL * loss64, f"step 1 loss {loss} vs float64 {loss64}")
            for name, (want, sc) in ref.items():
                bad, worst = past_f64(params[name].full(), want, sc)
                check(bad == 0, f"step 1 {name}: {bad} entries off by up to {worst:.3g} of "
                                f"|w| + lr * |grad|")
                print(f"[mesh] train step 1 {name}: every entry within {PS_RTOL} of "
                      f"|w| + lr * |grad| of the float64 plain step (worst {worst:.3g})")
    del ref, w1, w2, xf, g1, g2, g1a, g2a
    check(all(nxt < prev for prev, nxt in zip(losses, losses[1:])),
          f"the loss did not fall at every step: {losses}")
    med = statistics.median(times[1:])
    print(f"[mesh] make_training_step on a (2, 2) mesh of {dev}, dim {d}, batch {b}: losses "
          + ", ".join(f"{v:.6f}" for v in losses)
          + f" (falling at every step; float64 step 1 {loss64:.6f}); step {med:.3f} ms median "
          f"of steps 2-{MESH_STEPS} (step 1 {times[0]:.3f} ms)")
    return {"train_step_ms": med}


def phase_mesh(torch, T, ps_summary):
    """The single-controller mesh on the card: the collectives, the
    in-mesh sharded PS, the sharded prefill and the dp x tp training
    step.  Returns (launch counts of the path, its figures)."""
    dev = card(torch)
    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 must stay off")
    t0 = time.perf_counter()
    times = mesh_collectives(torch, dev)
    counts, summary = mesh_ps(torch, T, dev, ps_summary)
    T.reset_launch_counts()  # prefill and training hop nothing over ici://
    summary.update(mesh_prefill(torch, dev))
    summary.update(mesh_train(torch, dev))
    rest = {k: v for k, v in T.launches.items() if v}
    check(not rest, f"the mesh's prefill and training step launched {rest}")
    summary["collectives"] = times
    print(f"[mesh] phase {time.perf_counter() - t0:.1f} s; launches {counts}")
    return counts, summary


# ---------------------------------------------------------------------------
# [witness]: the analysis toolchain's two runtime witnesses, armed on the card
# ---------------------------------------------------------------------------

# ---- [native]: the C++ engine (native/) serving the PS on the card --------
NATIVE_PAYLOAD = 4096  # bench.py's echo_4kb message size
NATIVE_PRESS_S = 2.0  # press_native's run, both ends on the engine
NATIVE_SYNC_CALLS = 2000  # Python API sync echoes over connection_type="native"
NATIVE_WINDOW = 32  # a call_many window (tests/test_ring.py:750's shape, doubled)
NATIVE_WINDOW_REPS = 8
NATIVE_GET_KEYS = 32  # device-resident (64, 6144) f32 values: the [shard] value shape
NATIVE_SHARD_KEYS = 64  # bench_shard_window's keyed window, on PS shards
NATIVE_FAULT_CALLS = 64
NATIVE_TIMEOUT_MS = 30000  # every native channel's, stated


class _CountingTorch:
    """Stands in for ``torch`` inside models/parameter_server.py while
    [native] runs: counts ``from_numpy``, the Forward's one host stack a
    key-group handed to the device (one upload), and delegates the rest."""

    def __init__(self, torch):
        self._torch = torch
        self.uploads = 0

    def from_numpy(self, a):
        self.uploads += 1
        return self._torch.from_numpy(a)

    def __getattr__(self, name):
        return getattr(self._torch, name)


def start_native_build():
    """Build the engine (g++ engine.cpp, gcc fastcall.c) in a thread
    beside the kernels' nvcc builds; [native] joins it."""
    out = {}

    def build():
        from incubator_brpc_tpu_torch import native

        t0 = time.perf_counter()
        try:
            prebuilt = native.engine_path().exists()
            native.require()
            out.update(s=time.perf_counter() - t0, prebuilt=prebuilt,
                       boundary=native.call_boundary())
        except Exception as e:  # noqa: BLE001 — reported by [native]
            out["error"] = repr(e)

    t = threading.Thread(target=build, name="native-build", daemon=True)
    t.start()
    return t, out


def frames_in(frame: bytes) -> int:
    """tpu_std frames in one engine dispatch (b"TRPC" u32 meta u32 body)."""
    n = off = 0
    while off + 12 <= len(frame) and frame[off:off + 4] == b"TRPC":
        meta, body = int.from_bytes(frame[off + 4:off + 8], "big"), int.from_bytes(
            frame[off + 8:off + 12], "big")
        off += 12 + meta + body
        n += 1
    return n


def native_echo(torch, smi):
    """press_native against a port native server, the Python API's sync
    path, and a call_many window against per-call sync calls."""
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.client.ring import RingFailure
    from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest, EchoResponse
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
    from incubator_brpc_tpu_torch.tools.rpc_press import press_native

    srv = Server(ServerOptions(native_engine=True))
    srv.add_service(EchoService())
    check(srv.start(0) == 0 and srv._native_engine is not None, "native echo server did not start")
    ch = Channel(ChannelOptions(timeout_ms=NATIVE_TIMEOUT_MS, connection_type="native"))
    out = {}
    try:
        lines = []
        r = press_native(f"127.0.0.1:{srv.port}", payload_len=NATIVE_PAYLOAD,
                         duration_s=NATIVE_PRESS_S, report=lines.append)
        check(r is not None and r["ok"] > 0 and r["failed"] == 0, f"press_native: {r} {lines}")
        out["press"] = r
        print(f"[native] rpc_press --native, {NATIVE_PAYLOAD} B echo, {NATIVE_PRESS_S} s, "
              f"8 workers x depth 1 on one connection each: {r['qps']} qps, p50 {r['p50_us']} us, "
              f"p99 {r['p99_us']} us, {r['ok']} ok, {r['failed']} failed")
        check(ch.init(f"127.0.0.1:{srv.port}") == 0, "native channel init failed")
        stub = echo_stub(ch)
        msg = "x" * NATIVE_PAYLOAD
        lats = []
        t0 = time.perf_counter()
        for i in range(NATIVE_SYNC_CALLS):
            c = Controller()
            m = f"{i:08d}" + msg[8:]
            t1 = time.monotonic_ns()
            resp = stub.Echo(c, EchoRequest(message=m))
            lats.append((time.monotonic_ns() - t1) // 1000)
            check(not c.failed() and resp.message == m, f"native sync echo {i}: {c.error_text()}")
        wall = time.perf_counter() - t0
        lats.sort()
        out["sync"] = (NATIVE_SYNC_CALLS / wall, pct(lats, 0.5), pct(lats, 0.99))
        print(f"[native] Python API sync echo over connection_type=native, {NATIVE_PAYLOAD} B, "
              f"one thread: {out['sync'][0]:.1f} qps, p50 {out['sync'][1]} us, "
              f"p99 {out['sync'][2]} us over {NATIVE_SYNC_CALLS} calls, every reply equal")
        reqs = [EchoRequest(message=f"{i:04d}" + msg[4:]).SerializeToString()
                for i in range(NATIVE_WINDOW)]
        win_s, per_s = [], []
        for _ in range(NATIVE_WINDOW_REPS):
            t0 = time.perf_counter()
            res = stub.call_many("Echo", reqs)
            win_s.append(time.perf_counter() - t0)
            for i, b in enumerate(res):
                check(not isinstance(b, RingFailure), f"window call {i} failed: {b}")
                e = EchoResponse()
                e.ParseFromString(b)
                check(e.message == f"{i:04d}" + msg[4:], f"window reply {i} differs")
            t0 = time.perf_counter()
            for i in range(NATIVE_WINDOW):
                c = Controller()
                resp = stub.Echo(c, EchoRequest(message=f"{i:04d}" + msg[4:]))
                check(not c.failed() and resp.message == f"{i:04d}" + msg[4:],
                      f"per-call echo {i}: {c.error_text()}")
            per_s.append(time.perf_counter() - t0)
        rs = ch._ring_obj.counters()
        check(rs["fallback_calls"] == 0 and rs["double_resolves"] == 0, f"ring counters {rs}")
        out["window_ms"], out["per_call_ms"] = median_ms(win_s), median_ms(per_s)
        print(f"[native] call_many window of {NATIVE_WINDOW} x {NATIVE_PAYLOAD} B echoes "
              f"{out['window_ms']:.3f} ms against {NATIVE_WINDOW} per-call sync calls "
              f"{out['per_call_ms']:.3f} ms (median of {NATIVE_WINDOW_REPS}; ring "
              f"{rs['boundary_crossings']} crossings for {rs['submissions']} calls, "
              f"0 fallbacks)")
    finally:
        ch.close()
        srv.stop()
    return out


def native_ps(torch, ps_summary):
    """The batched PS at d = 6144 on the card behind the engine: W's
    bytes over TCP, Forward closed loops with the read-burst collector,
    a call_many window of device-resident Gets."""
    import numpy as np

    from incubator_brpc_tpu_torch.analysis.device_witness import transfer_counts
    from incubator_brpc_tpu_torch.batching.policy import BatchPolicy
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.client.ring import RingFailure, RingReply
    from incubator_brpc_tpu_torch.models import parameter_server as ps_mod
    from incubator_brpc_tpu_torch.models.parameter_server import (
        _FORWARD_KERNEL,
        PS_BATCH_POLICY,
        PsService,
        ps_stub,
    )
    from incubator_brpc_tpu_torch.observability.profiling import kernel_snapshot
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest, EchoResponse
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    dev, d = card(torch), PS_DIM
    srv = Server(ServerOptions(native_engine=True, enable_batching=True, batch_policies={
        "PsService.Get": BatchPolicy(max_batch_size=NATIVE_WINDOW, max_wait_us=1000)}))
    svc = PsService(device=dev)
    srv.add_service(svc)
    bursts = []  # frames per engine dispatch, for the Forward windows
    process = srv._process_native_frame

    def counted(conn_id, frame):
        bursts.append(frames_in(frame))
        process(conn_id, frame)

    srv._process_native_frame = counted  # looked up per dispatch
    check(srv.start(0) == 0 and srv._native_engine is not None, "native PS did not start")
    g = torch.Generator(device=dev).manual_seed(SEED)
    W = torch.randn((d, d), generator=g, device=dev) / d ** 0.5
    svc.put_param("w", W)  # W stays on the card for Forward
    ch = Channel(ChannelOptions(timeout_ms=NATIVE_TIMEOUT_MS, connection_type="native"))
    counting = _CountingTorch(torch)
    out = {}
    try:
        check(ch.init(f"127.0.0.1:{srv.port}") == 0, "native PS channel init failed")
        stub = ps_stub(ch)
        # ---- W's bytes over TCP: a Put stores them, a Get returns them -----
        w_host = W.cpu().numpy().tobytes()
        put_s, get_s = [], []
        for _ in range(3):
            c = Controller()
            c.request_attachment.append(w_host)
            t0 = time.perf_counter()
            stub.Put(c, EchoRequest(message="w_tcp"))
            put_s.append(time.perf_counter() - t0)
            check(not c.failed(), f"native Put of W: {c.error_text()}")
            c = Controller()
            t0 = time.perf_counter()
            stub.Get(c, EchoRequest(message="w_tcp"))
            get_s.append(time.perf_counter() - t0)
            check(not c.failed() and c.response_attachment.to_bytes() == w_host,
                  f"native Get of W returned other bytes: {c.error_text()}")
        out["put_ms"], out["get_ms"] = median_ms(put_s), median_ms(get_s)
        print(f"[native] Put / Get of W's {len(w_host) / 1e6:.1f} MB as bytes over TCP through "
              f"the engine: {out['put_ms']:.3f} / {out['get_ms']:.3f} ms median of 3, bytes "
              f"equal ([ps] over ici:// {ps_summary['put_ms']:.3f} / {ps_summary['get_ms']:.3f} ms)")
        # ---- Forward: p = 1 batching off, p = 32 on -------------------------
        xs = np.random.RandomState(SEED).randn(64, d).astype(np.float32)
        x_bytes = [x.tobytes() for x in xs]
        x_dev = torch.from_numpy(xs).to(dev).double()
        ref, scale = x_dev @ W.double(), x_dev.abs() @ W.abs().double()
        req = EchoRequest(message="w")
        stubs = [stub]  # every caller on the one mux connection
        traces0 = _FORWARD_KERNEL.trace_count()
        ps_mod.torch = counting
        for par, cfg in ((1, "off"), (32, "on")):
            if cfg == "off":
                srv.disable_method_batching("PsService.Forward")
            else:
                srv.enable_method_batching("PsService.Forward")
            batcher = srv.batcher("PsService.Forward")
            closed_loop(stubs, req, x_bytes, min(par, 4), 0.1)  # warm
            rows0 = batcher.rows if batcher else 0
            b0 = batcher.batches if batcher else 0
            up0, pull0 = counting.uploads, transfer_counts().get("ps.forward-pull", 0)
            ex0 = kernel_snapshot().get("ps.forward", {}).get("executions", 0)
            del bursts[:]
            spans, flushes = [], []
            if batcher is not None:  # each dispatch's (start, end, rows)
                flush = batcher._flush  # looked up per dispatch

                def timed(rows, _f=flush):
                    t0 = time.monotonic_ns()
                    _f(rows)
                    flushes.append((t0, time.monotonic_ns(), len(rows)))

                batcher._flush = timed
            try:
                lats, ys, wall, gcs = closed_loop(stubs, req, x_bytes, par, 1.0, spans)
            finally:
                if batcher is not None:
                    del batcher._flush
            frames = list(bursts)
            uploads = counting.uploads - up0
            pulls = transfer_counts().get("ps.forward-pull", 0) - pull0
            execs = kernel_snapshot()["ps.forward"]["executions"] - ex0
            rows = (batcher.rows - rows0) if batcher else len(ys)
            batches = (batcher.batches - b0) if batcher else len(ys)
            check(uploads == execs == pulls == batches > 0,
                  f"Forward p{par} {cfg}: {uploads} uploads, {execs} executions, {pulls} pulls "
                  f"for {batches} batches: each batch must upload once and pull once")
            idx = torch.tensor([i for i, _ in ys], device=dev)
            got = torch.from_numpy(np.frombuffer(bytearray(b"".join(y for _, y in ys)),
                                                 np.float32).reshape(len(ys), d)).to(dev)
            bad, worst = past_f64(got, ref[idx], scale[idx])
            check(bad == 0, f"native Forward: {bad} outputs off by up to {worst:.3g} of |x| @ |W|")
            qps = len(lats) / wall
            uq, u50, u99 = ps_summary[(par, cfg)]
            out[(par, cfg)] = (qps, pct(lats, 0.5), pct(lats, 0.99))
            hist = {k: frames.count(k) for k in sorted(set(frames))}
            print(f"[native] Forward p{par:2} batching {cfg:3}: {qps:9.1f} qps, p50 "
                  f"{pct(lats, 0.5)} us, p99 {pct(lats, 0.99)} us over {len(lats)} calls "
                  f"([ps] ici:// {uq:.1f} qps, p50 {u50} us, p99 {u99} us); {batches} batches "
                  f"for {rows} rows (mean {rows / max(batches, 1):.2f}, max "
                  f"{batcher.max_batch_seen if batcher else 1}); uploads = executions = "
                  f"ps.forward-pull = {batches}; frames per engine dispatch {hist}; max |y - "
                  f"ref| / (|x| @ |W|) {worst:.3g}")
            if cfg == "on":
                out["burst_frames"] = hist
                out["mean_batch"] = rows / max(batches, 1)
                check(batches < rows, f"{batches} batches for {rows} rows: nothing coalesced")
                out["tail"] = native_tail(spans, flushes, gcs, bursts=frames)
        wall_us, busy_us, _ = device_profile(torch, lambda: closed_loop(stubs, req, x_bytes, 32, 0.3))
        check(busy_us > 0, "the profiler saw no CUDA work in the native Forward window")
        out["busy"] = 100 * busy_us / wall_us
        print(f"[profile] native ps forward p32 on: wall {wall_us:.0f} us, device busy "
              f"{busy_us:.0f} us ({out['busy']:.1f}%)")
        traces = _FORWARD_KERNEL.trace_count() - traces0
        check(traces <= len(PS_BATCH_POLICY.padding_buckets),
              f"the native Forward traced {traces} new product shapes")
        # ---- a call_many window of device-resident Gets --------------------
        vals = torch.randn((NATIVE_GET_KEYS, *SHARD_VALUE), generator=g, device=dev)
        keys = [f"v{i}" for i in range(NATIVE_GET_KEYS)]
        for k, v in zip(keys, vals):
            svc.put_param(k, v)
        want = {k: v.cpu().numpy().tobytes() for k, v in zip(keys, vals)}
        gb = srv.batcher("PsService.Get")
        win_s, per_s, batches_per = [], [], []
        packed = [EchoRequest(message=k).SerializeToString() for k in keys]
        for rep in range(NATIVE_WINDOW_REPS):
            b0, seen0 = gb.batches, gb.max_batch_seen
            t0 = time.perf_counter()
            res = stub.call_many("Get", packed)
            win_s.append(time.perf_counter() - t0)
            batches_per.append(gb.batches - b0)
            check(not any(isinstance(r, RingFailure) for r in res), f"Get window: {res[:2]}")
            check(all(isinstance(r, RingReply) for r in res), "Get window: a reply lost its value")
            got = {_echo_message(EchoResponse, r): r.attachment.to_bytes() for r in res}
            check(got == want, f"Get window rep {rep}: {len(got)} replies, values differ")
            t0 = time.perf_counter()
            for k in keys:
                c = Controller()
                stub.Get(c, EchoRequest(message=k))
                check(not c.failed() and c.response_attachment.to_bytes() == want[k],
                      f"per-call Get {k}: {c.error_text()}")
            per_s.append(time.perf_counter() - t0)
        check(gb.max_batch_seen >= NATIVE_WINDOW // 2 and max(batches_per) <= 2,
              f"Get window: max_batch_seen {gb.max_batch_seen}, batches a window {batches_per}")
        out["get_window_ms"], out["get_per_call_ms"] = median_ms(win_s), median_ms(per_s)
        out["get_batches"] = batches_per
        print(f"[native] call_many window of {NATIVE_GET_KEYS} Gets of device-resident "
              f"{SHARD_VALUE} f32 values, PsService.Get batched: {out['get_window_ms']:.3f} ms "
              f"against {NATIVE_GET_KEYS} per-call sync Gets {out['get_per_call_ms']:.3f} ms "
              f"(median of {NATIVE_WINDOW_REPS}); batches a window {batches_per}, max_batch_seen "
              f"{gb.max_batch_seen}; every reply's bytes equal its value's")
    finally:
        ps_mod.torch = torch
        ch.close()
        srv.stop()
    return out


def native_tail(spans, flushes, gcs, bursts, top=0.01, shown=6):
    """Where the Forward's slowest 1% of rows spent their time: for each
    (at most ``shown``, slowest first) its issue and completion times
    from the window's start, and the batcher dispatches that ran while it
    waited (start, rows, ms), beside the window's dispatch sizes and
    gaps and its oldest-generation GC pauses.  Printed as one line."""
    if not spans or not flushes:
        return {}
    t_base = min(t0 for t0, _ in spans)
    slow = sorted(spans, key=lambda s: s[0] - s[1])[:max(1, int(len(spans) * top))]
    starts = sorted(f[0] for f in flushes)
    gaps = [(b - a) / 1e6 for a, b in zip(starts, starts[1:])]
    rows = []
    for t0, t1 in slow[:shown]:
        inside = [f for f in flushes if f[1] >= t0 and f[0] <= t1]
        rows.append({"issued_ms": round((t0 - t_base) / 1e6, 3),
                     "done_ms": round((t1 - t_base) / 1e6, 3),
                     "dispatches": [[round((a - t_base) / 1e6, 3), n, round((b - a) / 1e6, 3)]
                                    for a, b, n in inside]})
    sizes = [n for _, _, n in flushes]
    tail = {"slow_rows": len(slow), "of_rows": len(spans),
            "slow_us_min": min(t1 - t0 for t0, t1 in slow) // 1000,
            "dispatches": len(flushes), "rows_per_dispatch_mean": sum(sizes) / len(sizes),
            "rows_per_dispatch_max": max(sizes),
            "dispatch_ms_max": max((b - a) / 1e6 for a, b, _ in flushes),
            "dispatch_gap_ms_max": max(gaps) if gaps else 0.0,
            "gc_pauses_ms": [round(g, 3) for g in gcs], "engine_bursts": len(bursts),
            "slowest": rows}
    print(f"[native] tail of Forward p32 on: {json.dumps(tail)}")
    return tail


def native_shard(torch, shard_summary):
    """Four native PsService shard servers on the card behind
    sharded_ps_channel over native sub-channels: a window of keyed Gets
    crosses into C once per shard."""
    from incubator_brpc_tpu_torch.client.channel import ChannelOptions
    from incubator_brpc_tpu_torch.client.ring import RingFailure, RingReply, fanout_log
    from incubator_brpc_tpu_torch.models.parameter_server import (
        PsService,
        ps_stub,
        sharded_ps_channel,
    )
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest, EchoResponse
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    dev = card(torch)
    servers, svcs, eps = [], [], []
    out = {}
    try:
        for _ in range(SHARDS):
            svc = PsService(device=dev)
            srv = Server(ServerOptions(native_engine=True))
            srv.add_service(svc)
            check(srv.start(0) == 0, "a native shard server did not start")
            servers.append(srv)
            svcs.append(svc)
            eps.append(f"127.0.0.1:{srv.port}")
        sh = sharded_ps_channel(endpoints=eps, channel_options=ChannelOptions(
            timeout_ms=NATIVE_TIMEOUT_MS, connection_type="native"))
        g = torch.Generator(device=dev).manual_seed(SEED + 1)
        keys = [f"key{i}" for i in range(NATIVE_SHARD_KEYS)]
        vals = torch.randn((NATIVE_SHARD_KEYS, *SHARD_VALUE), generator=g, device=dev)
        for k, v in zip(keys, vals):  # each value on its owner's card store
            svcs[sh.shard_of(k)].put_param(k, v)
        want = {k: v.cpu().numpy().tobytes() for k, v in zip(keys, vals)}
        win_s = []
        for rep in range(3):
            before = fanout_log.counters()
            t0 = time.perf_counter()
            res = ps_stub(sh).call_many("Get", [EchoRequest(message=k) for k in keys])
            win_s.append(time.perf_counter() - t0)
            after = fanout_log.counters()
            cross = after["crossings"] - before["crossings"]
            fb = after["fallback_calls"] - before["fallback_calls"]
            check(cross == SHARDS and fb == 0,
                  f"shard window: {cross} crossings, {fb} per-call fallbacks")
            check(not any(isinstance(r, RingFailure) for r in res), f"shard window: {res[:2]}")
            check(all(isinstance(r, RingReply) for r in res), "shard window: a reply lost its value")
            got = {_echo_message(EchoResponse, r): r.attachment.to_bytes() for r in res}
            check(got == want, f"shard window rep {rep}: values differ from their Puts")
        out["window_ms"] = median_ms(win_s)
        print(f"[native] sharded_ps_channel over {SHARDS} native shard servers on {dev} "
              f"(sub-channel timeout {NATIVE_TIMEOUT_MS} ms): a call_many window of "
              f"{NATIVE_SHARD_KEYS} keyed Gets of {SHARD_VALUE} f32 crossed into C {SHARDS} times "
              f"(once per shard), 0 per-call fallbacks, {out['window_ms']:.3f} ms median of 3, "
              f"every value equal ([shard] keyed Get over ici:// one at a time "
              f"{shard_summary['keyed_get_ms']:.3f} ms each)")
    finally:
        for srv in servers:
            srv.stop()
    return out


def native_multiproto():
    """One native port answering HTTP and redis: the C fast paths (no
    Python dispatch) and a Python fallback for each."""
    import socket

    from incubator_brpc_tpu_torch import native
    from incubator_brpc_tpu_torch.models.echo import EchoService
    from incubator_brpc_tpu_torch.protocols.redis import KVRedisService
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    class SmokeRedis(KVRedisService):
        def echo(self, value):  # the engine's KV has no ECHO: Python answers
            return bytes(value)

    kv = SmokeRedis()
    srv = Server(ServerOptions(native_engine=True, redis_service=kv))
    srv.add_service(EchoService())
    dispatched = {native.PROTO_HTTP: 0, native.PROTO_REDIS: 0, native.PROTO_TPU_STD: 0}
    fallback = srv._native_fallback_frame

    def counted(conn_id, proto, frame):
        dispatched[proto] += 1
        fallback(conn_id, proto, frame)

    srv._native_fallback_frame = counted  # bound at start
    check(srv.start(0) == 0, "the multiprotocol native server did not start")
    try:
        body = b"native-http-echo"
        r = urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/EchoService/Echo.raw", data=body, method="POST"),
            timeout=10).read()
        check(r == body and dispatched[native.PROTO_HTTP] == 0,
              f"native HTTP echo: {r!r}, Python dispatches {dispatched}")
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=10)

        def cmd(*parts):
            s.sendall(b"*%d\r\n" % len(parts) + b"".join(
                b"$%d\r\n%s\r\n" % (len(p), p) for p in parts))
            data = b""
            while not data.endswith(b"\r\n") or (data.startswith(b"$") and data.count(b"\r\n") < 2
                                                 and not data.startswith(b"$-1")):
                data += s.recv(65536)
            return data

        try:
            check(cmd(b"SET", b"smoke", b"v1") == b"+OK\r\n", "native SET")
            check(cmd(b"GET", b"smoke") == b"$2\r\nv1\r\n", "native GET")
            check(dispatched[native.PROTO_REDIS] == 0 and kv.get(b"smoke") is None,
                  f"redis SET/GET reached Python: {dispatched}")
            check(cmd(b"ECHO", b"py") == b"$2\r\npy\r\n", "the Python redis fallback")
            check(dispatched[native.PROTO_REDIS] == 1, f"redis fallback dispatches {dispatched}")
        finally:
            s.close()
        r = json.loads(urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/EchoService/Echo",
            data=json.dumps({"message": "py-route"}).encode(),
            headers={"Content-Type": "application/json"}), timeout=10).read())
        check(r.get("message") == "py-route" and dispatched[native.PROTO_HTTP] == 1,
              f"the Python HTTP fallback: {r}, dispatches {dispatched}")
    finally:
        srv.stop()
    print("[native] one port, three protocols: HTTP POST /EchoService/Echo.raw and redis "
          "SET/GET answered in C (0 Python dispatches; the Python KV never saw the key), "
          "then the JSON route and redis ECHO answered by the Python fallback (1 dispatch each)")


def native_fault():
    """A native.srv_write short-write plan on the port's injector: hits
    counted, every call ends once, answered or failed with an ERPC code."""
    from incubator_brpc_tpu_torch import errors
    from incubator_brpc_tpu_torch.chaos import FaultPlan, FaultSpec, injector
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.client.ring import RingFailure
    from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest, EchoResponse
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    srv = Server(ServerOptions(native_engine=True))
    srv.add_service(EchoService())
    check(srv.start(0) == 0, "the native fault server did not start")
    ch = Channel(ChannelOptions(timeout_ms=5000, connection_type="native"))
    codes = {v for k, v in vars(errors).items() if k.startswith("E") and isinstance(v, int)}
    try:
        check(ch.init(f"127.0.0.1:{srv.port}") == 0, "native channel init failed")
        stub = echo_stub(ch)
        injector.arm(FaultPlan([FaultSpec("native.srv_write", "short_write", arg=512,
                                          probability=1.0, max_hits=100000)], seed=SEED))
        msg = "f" * 20000
        ended = [0] * NATIVE_FAULT_CALLS
        done = [threading.Event() for _ in range(NATIVE_FAULT_CALLS)]
        ctrls = []
        for i in range(NATIVE_FAULT_CALLS):
            c = Controller()

            def on_done(i=i):
                ended[i] += 1
                done[i].set()

            stub.Echo(c, EchoRequest(message=f"{i:05d}" + msg), done=on_done)
            ctrls.append(c)
        res = stub.call_many("Echo", [EchoRequest(message=f"{i:05d}" + msg).SerializeToString()
                                      for i in range(NATIVE_FAULT_CALLS)])
        check(all(e.wait(30) for e in done), "an async call under the fault never ended")
        time.sleep(0.2)  # a second completion would land by now
        check(ended == [1] * NATIVE_FAULT_CALLS, f"async calls ended {set(ended)} times")
        answered = failed = 0
        for c in ctrls:
            if c.failed():
                check(c.error_code in codes, f"a non-ERPC code {c.error_code}")
                failed += 1
            else:
                answered += 1
        for i, r in enumerate(res):
            if isinstance(r, RingFailure):
                check(r.error_code in codes, f"a non-ERPC ring code {r.error_code}")
                failed += 1
            else:
                e = EchoResponse()
                e.ParseFromString(r)
                check(e.message == f"{i:05d}" + msg, f"window reply {i} differs")
                answered += 1
        check(ch._ring_obj.counters()["double_resolves"] == 0, "a ring slot resolved twice")
        injector.disarm()
        hits = injector.site_hits().get("native.srv_write", {}).get("short_write", 0)
        check(hits > 0, "native.srv_write never fired")
    finally:
        injector.disarm()
        ch.close()
        srv.stop()
    print(f"[native] native.srv_write short_write (512 B) armed on the port's injector: {hits} "
          f"hits; {2 * NATIVE_FAULT_CALLS} calls (async and one call_many window of 20 KB "
          f"echoes) each ended once: {answered} answered byte-equal, {failed} failed with an "
          f"ERPC code")
    return {"hits": hits, "answered": answered, "failed": failed}


def phase_native(torch, T, smi, build, ps_summary, shard_summary):
    """[native]: the C++ engine serving the PS on the card.  Returns the
    launch counts of the path (TCP frames carry host bytes: none)."""
    thread, built = build
    t_phase = time.perf_counter()
    thread.join(timeout=600)
    check("error" not in built and "s" in built, f"the native engine did not build: {built}")
    boundary, why = built["boundary"]
    print(f"[native] engine {'loaded (built earlier)' if built['prebuilt'] else 'built'} in "
          f"{built['s']:.1f} s (g++ engine.cpp, gcc fastcall.c, beside the nvcc builds); call "
          f"boundary {boundary}" + (f" ({why})" if why else ""))
    T.reset_launch_counts()
    out = {"boundary": boundary, "echo": native_echo(torch, smi)}
    out["ps"] = native_ps(torch, ps_summary)
    out["shard"] = native_shard(torch, shard_summary)
    native_multiproto()
    out["fault"] = native_fault()
    counts = dict(T.launches)
    out["s"] = time.perf_counter() - t_phase
    print(f"[native] phase {out['s']:.1f} s on {smi}; launches {counts} (the engine's TCP "
          f"frames carry host bytes)")
    return counts, out


PROTO_CALLS = 100  # each protocol client's calls, under the Forward load
PROTO_FORWARD_P = 8  # the tpu_std Forward load on the same port
PROTO_TLS_MESSAGE = 4 << 20  # one gRPC message over TLS, through h2 flow control
PROTO_GOAWAY_STREAMS = 4  # h2 streams in flight when Server.stop() sends GOAWAY
PROTO_HLS_TARGET_S = 1.0
PROTO_MEDIA_SECONDS = 4.0
# the pb protocols a port channel speaks to the server (esp has no server
# side in either package: its client calls an esp peer of its own)
PROTO_CHANNELS = ["grpc", "hulu_pbrpc", "sofa_pbrpc", "nova_pbrpc", "public_pbrpc", "ubrpc",
                  "nshead_mcpack"]


def proto_nshead_router():
    """A server's nshead adaptor owns all of its nshead traffic, so the
    one port that faces nova, public, ubrpc and nshead_mcpack clients
    routes each frame by its head and body: the nova provider, a public
    envelope naming a service, a ubrpc mcpack ``content`` list, else an
    nshead_mcpack body."""
    from incubator_brpc_tpu_torch.protocols import legacy
    from incubator_brpc_tpu_torch.protos import legacy_meta_pb2
    from incubator_brpc_tpu_torch.serialization import mcpack

    class Router(legacy.NsheadService):
        def __init__(self):
            self.ubrpc, self.mcpack = legacy.UbrpcAdaptor(), legacy.NsheadMcpackAdaptor()
            self.routed = {"nova": 0, "public": 0, "ubrpc": 0, "nshead_mcpack": 0}

        def process(self, controller, request):
            body = bytes(request.body.as_view())
            sock = controller._server_socket
            if request.provider.startswith(b"nova-pbrpc"):
                self.routed["nova"] += 1
                return legacy._nova_process_request(request, sock)
            env = legacy_meta_pb2.PublicPbrpcRequest()
            try:
                env.ParseFromString(body)
                public = bool(env.requestBody) and bool(env.requestBody[0].service)
            except Exception:  # noqa: BLE001 - not a public envelope
                public = False
            if public:
                self.routed["public"] += 1
                return legacy._public_process_request(request, sock, env)
            try:
                doc = mcpack.loads(body)
            except Exception:  # noqa: BLE001 - not an mcpack object
                doc = None
            if isinstance(doc, dict) and "content" in doc:
                self.routed["ubrpc"] += 1
                return self.ubrpc.process(controller, request)
            self.routed["nshead_mcpack"] += 1
            return self.mcpack.process(controller, request)

    return Router()


def proto_thrift_service():
    from incubator_brpc_tpu_torch.protocols import thrift

    svc = thrift.ThriftService()

    def echo(ctrl, fields, done):
        msg = fields.get(1, (thrift.T_STRING, b""))[1]
        done({0: (thrift.T_STRUCT, {1: (thrift.T_STRING, msg), 2: (thrift.T_I32, len(msg))})})

    svc.add_method("Echo", echo)
    return svc


def proto_mongo_adaptor():
    from incubator_brpc_tpu_torch.protocols import mongo

    class Adaptor(mongo.MongoServiceAdaptor):
        def handle(self, controller, doc):
            if "echo" in doc:
                return {"ok": 1.0, "you_sent": doc["echo"]}
            return {"ok": 0.0, "errmsg": "unknown command", "code": 59}

    return Adaptor()


class EspPeer:
    """An esp-speaking peer on its own port: answers each frame with its
    body reversed (esp is a client protocol in both packages)."""

    def __init__(self):
        import socket

        self.ls = socket.socket()
        self.ls.bind(("127.0.0.1", 0))
        self.ls.listen(4)
        self.port = self.ls.getsockname()[1]
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        while True:
            try:
                conn, _ = self.ls.accept()
            except OSError:
                return
            threading.Thread(target=self._conn, args=(conn,), daemon=True).start()

    @staticmethod
    def _conn(conn):
        import struct

        def read(n):
            out = b""
            while len(out) < n:
                got = conn.recv(n - len(out))
                if not got:
                    raise EOFError
                out += got
            return out

        try:
            while True:
                frm, to, msg, msg_id, blen = struct.unpack("<QQIQi", read(32))
                reply = read(blen)[::-1]
                conn.sendall(struct.pack("<QQIQi", to, frm, msg, msg_id, len(reply)) + reply)
        except (EOFError, OSError):
            conn.close()

    def close(self):
        self.ls.close()


def proto_message(rng, n):
    """A seeded printable message of n characters."""
    return "".join(chr(c) for c in rng.randint(0x20, 0x7F, size=n))


def proto_client(proto, port, esp_port, seed):
    """One protocol client's PROTO_CALLS calls against the port (esp:
    against its peer), every reply checked byte for byte.  Returns the
    sorted latencies in us and the wall time."""
    import socket
    import struct

    import numpy as np

    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import echo_stub
    from incubator_brpc_tpu_torch.protocols import legacy, mongo, thrift
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest, EchoResponse
    from incubator_brpc_tpu_torch.server.service import MethodSpec

    rng = np.random.RandomState(seed)
    lats = []
    t_start = time.perf_counter()
    if proto == "mongo":
        with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
            for i in range(PROTO_CALLS):
                doc = {"echo": {"s": proto_message(rng, 1 + i % 200), "i": i}}
                want = mongo.pack_op_msg(i + 1, {"ok": 1.0, "you_sent": doc["echo"]})
                t0 = time.perf_counter_ns()
                s.sendall(mongo.pack_op_msg(0, doc, request_id=i + 1))
                data = b""
                while len(data) < 4 or len(data) < struct.unpack_from("<i", data)[0]:
                    got = s.recv(65536)
                    check(bool(got), "mongo: the server closed the connection")
                    data += got
                lats.append((time.perf_counter_ns() - t0) // 1000)
                check(data[:4] == want[:4] and data[8:] == want[8:],
                      f"mongo reply {i} differs from its expectation")
        return sorted(lats), time.perf_counter() - t_start
    ch = Channel(ChannelOptions(protocol=proto, timeout_ms=30000,
                                connection_group=f"proto-{proto}"))
    check(ch.init(f"127.0.0.1:{esp_port if proto == 'esp' else port}") == 0,
          f"{proto}: channel init failed")
    try:
        stub = echo_stub(ch)
        tstub = thrift.ThriftStub(ch) if proto == "thrift" else None
        espec = MethodSpec("esp", "msg", legacy.EspMessage, bytes)
        for i in range(PROTO_CALLS):
            text = proto_message(rng, 1 + i % 200)
            c = Controller()
            t0 = time.perf_counter_ns()
            if proto == "thrift":
                res = tstub.call(c, "Echo", {1: (thrift.T_STRING, text.encode())})
                ok = not c.failed() and res == {0: (thrift.T_STRUCT, {
                    1: (thrift.T_STRING, text.encode()), 2: (thrift.T_I32, len(text))})}
            elif proto == "esp":
                body = text.encode()
                ch.call_method(espec, c, legacy.EspMessage(to=9, msg=1, body=body), None)
                ok = not c.failed() and c.response_attachment.to_bytes() == body[::-1]
            else:
                r = stub.Echo(c, EchoRequest(message=text, code=i))
                ok = (not c.failed() and r.SerializeToString()
                      == EchoResponse(message=text, code=i).SerializeToString())
            lats.append((time.perf_counter_ns() - t0) // 1000)
            check(ok, f"{proto} reply {i} differs from its request: {c.error_text()}")
    finally:
        ch.close()
    return sorted(lats), time.perf_counter() - t_start


def proto_stream(rtmp, seed):
    """A seeded synthetic A/V stream as RTMP messages: onMetaData, the AVC
    and AAC sequence headers, 25 fps H.264 frames (a keyframe each
    second, NALs of random size and bytes) and an AAC frame every 23 ms,
    in timestamp order."""
    import struct

    import numpy as np

    rng = np.random.RandomState(seed)
    sps, pps = b"\x67\x42\x00\x1e\xab", b"\x68\xce\x06\xe2"
    avcc = (b"\x01\x42\x00\x1e\xff\xe1" + struct.pack(">H", len(sps)) + sps
            + b"\x01" + struct.pack(">H", len(pps)) + pps)
    msgs = [rtmp.RtmpMessage(rtmp.MSG_DATA_AMF0, 1, 0, rtmp.amf0_encode(
                "onMetaData", {"width": 640.0, "height": 360.0, "framerate": 25.0})),
            rtmp.RtmpMessage(rtmp.MSG_VIDEO, 1, 0, b"\x17\x00\x00\x00\x00" + avcc),
            rtmp.RtmpMessage(rtmp.MSG_AUDIO, 1, 0, b"\xaf\x00" + bytes([0b00010010, 0b00010000]))]
    frames = []
    ms_end = int(PROTO_MEDIA_SECONDS * 1000)
    for i, ms in enumerate(range(0, ms_end, 40)):
        key = i % 25 == 0
        nal = (b"\x65" if key else b"\x41") + rng.randint(0, 256, int(rng.randint(20, 3000))).astype(
            np.uint8).tobytes()
        frames.append((ms, 0, rtmp.MSG_VIDEO, (b"\x17" if key else b"\x27") + b"\x01\x00\x00\x00"
                       + struct.pack(">I", len(nal)) + nal))
    for ms in range(0, ms_end, 23):
        frames.append((ms, 1, rtmp.MSG_AUDIO, b"\xaf\x01" + rng.randint(
            0, 256, int(rng.randint(8, 400))).astype(np.uint8).tobytes()))
    frames.sort()
    return msgs + [rtmp.RtmpMessage(t, 1, ms, body) for ms, _, t, body in frames]


def proto_rtmp(port, gw):
    """Publish the seeded stream as FLV tags over RTMP, play it back, and
    hold the gateway's HLS segments and FLV archive to a plain HLS
    segmenter and FLV writer fed the same messages."""
    from incubator_brpc_tpu_torch.protocols import flv, rtmp, ts

    msgs = proto_stream(rtmp, SEED)
    # the published stream is an FLV file: written, then read back as tags
    w = flv.FlvWriter()
    for m in msgs:
        w.write_message(m)
    reader = flv.FlvReader()
    reader.feed(w.getvalue())
    tags = []
    while (t := reader.read_message()) is not None:
        tags.append(t)
    check([(t.type_id, t.timestamp, t.payload) for t in tags]
          == [(m.type_id, m.timestamp, m.payload) for m in msgs], "the FLV file lost a tag")
    got, done = [], threading.Event()

    def on_media(msg):
        got.append((msg.type_id, msg.timestamp, msg.payload))
        if len(got) >= len(tags):
            done.set()

    t0 = time.perf_counter()
    sub = rtmp.RtmpClient("127.0.0.1", port, app="live", on_media=on_media)
    pub = rtmp.RtmpClient("127.0.0.1", port, app="live")
    try:
        sub.play(sub.create_stream(), "room")
        psid = pub.create_stream()
        pub.publish(psid, "room")
        for t in tags:
            pub.write_frame(psid, t.type_id, t.timestamp, t.payload)
        check(done.wait(30), f"RTMP play got {len(got)} of {len(tags)} messages")
    finally:
        pub.close()
        sub.close()
    relay_s = time.perf_counter() - t0
    check(got == [(t.type_id, t.timestamp, t.payload) for t in tags],
          "RTMP play returned other messages than were published")
    plain = ts.HlsSegmenter(target_duration_s=PROTO_HLS_TARGET_S, window=64)
    plain_flv = flv.FlvWriter()
    for t in tags:
        plain.on_message(t)
        try:
            plain_flv.write_message(t)
        except ValueError:
            pass
    deadline = time.monotonic() + 10
    while len(gw.flv_snapshot("room")) < len(plain_flv.getvalue()) and time.monotonic() < deadline:
        time.sleep(0.02)
    gw.finish("room")
    plain.finish_segment()
    segs = [(s.seq, gw.segment("room", s.seq)) for s in plain.segments]
    check(all(seg == bytes(s.data) for (_, seg), s in zip(segs, plain.segments)),
          "an HLS segment differs from the plain segmenter's")
    check(gw.playlist("room", end=True) == plain.playlist(end=True), "the HLS playlists differ")
    check(gw.flv_snapshot("room") == plain_flv.getvalue(), "the FLV archive differs")
    for _, seg in segs:
        check(len(seg) % 188 == 0 and seg[0] == 0x47 and (seg[1] & 0x1F, seg[2]) == (0, 0),
              "an HLS segment does not open with a PAT packet")
    return {"messages": len(tags), "segments": len(segs), "relay_ms": relay_s * 1e3,
            "segment_bytes": sum(len(s) for _, s in segs)}


def proto_tls():
    """gRPC over TLS: ALPN settles on "h2", and one 4 MB message goes
    through h2 flow control and back."""
    import socket
    import ssl
    import tempfile

    import numpy as np

    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
    from incubator_brpc_tpu_torch.transport import ssl_helper

    d = tempfile.mkdtemp(prefix="proto-tls-")
    cert, key = f"{d}/cert.pem", f"{d}/key.pem"
    made = subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", key,
         "-out", cert, "-days", "2", "-subj", "/CN=localhost",
         "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
        capture_output=True, text=True, timeout=60)
    check(made.returncode == 0, f"openssl could not make a certificate: {made.stderr[-300:]}")
    srv = Server(ServerOptions(ssl_options=ssl_helper.ServerSSLOptions(
        default_cert=ssl_helper.CertInfo(certificate=cert, private_key=key))))
    srv.add_service(EchoService())
    check(srv.start(0) == 0, "the TLS server did not start")
    ch = Channel(ChannelOptions(protocol="grpc", timeout_ms=60000, ssl_options=(
        ssl_helper.ChannelSSLOptions(ca_file=cert, sni_name="localhost", verify_hostname=True))))
    try:
        ctx = ssl.create_default_context(cafile=cert)
        ctx.set_alpn_protocols(["h2"])
        with socket.create_connection(("127.0.0.1", srv.port), timeout=10) as raw:
            with ctx.wrap_socket(raw, server_hostname="localhost") as tls:
                alpn = tls.selected_alpn_protocol()
        check(alpn == "h2", f"ALPN settled on {alpn!r}, not h2")
        check(ch.init(f"127.0.0.1:{srv.port}") == 0, "gRPC TLS channel init failed")
        text = proto_message(np.random.RandomState(SEED), PROTO_TLS_MESSAGE)
        c = Controller()
        t0 = time.perf_counter()
        r = echo_stub(ch).Echo(c, EchoRequest(message=text, code=4))
        ms = (time.perf_counter() - t0) * 1e3
        check(not c.failed() and r.message == text and r.code == 4,
              f"the 4 MB gRPC message over TLS came back otherwise: {c.error_text()}")
    finally:
        ch.close()
        srv.stop()
    return {"alpn": alpn, "ms": ms, "bytes": PROTO_TLS_MESSAGE}


def proto_goaway(srv):
    """Server.stop() with h2 streams in flight: it sends GOAWAY, and the
    streams it covers finish with their replies."""
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import echo_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest

    ch = Channel(ChannelOptions(protocol="grpc", timeout_ms=10000, max_retry=0,
                                connection_group="proto-goaway"))
    check(ch.init(f"127.0.0.1:{srv.port}") == 0, "gRPC channel init failed")
    stub = echo_stub(ch)
    c0 = Controller()
    check(stub.Echo(c0, EchoRequest(message="warm")).message == "warm", "gRPC warm-up failed")
    results = [None] * PROTO_GOAWAY_STREAMS

    def call(i):
        c = Controller()
        r = stub.Echo(c, EchoRequest(message=f"inflight{i}", sleep_us=400_000))
        results[i] = (c.failed(), r.message if not c.failed() else c.error_text())

    threads = [threading.Thread(target=call, args=(i,)) for i in range(PROTO_GOAWAY_STREAMS)]
    for t in threads:
        t.start()
    time.sleep(0.15)  # the streams are in their handlers now
    sent = [s for s in srv._acceptor.connections()
            if s is not None and s.h2_ctx is not None and not s.failed]
    t0 = time.perf_counter()
    srv.stop()
    stop_ms = (time.perf_counter() - t0) * 1e3
    for t in threads:
        t.join(15)
    ch.close()
    check(sent and all(s.h2_ctx.goaway_sent for s in sent),
          "Server.stop() sent no GOAWAY on its h2 connections")
    check(results == [(False, f"inflight{i}") for i in range(PROTO_GOAWAY_STREAMS)],
          f"h2 streams in flight across Server.stop(): {results}")
    return {"streams": PROTO_GOAWAY_STREAMS, "stop_ms": stop_ms}


def phase_proto(torch, T, smi, ps_summary, dev=None):
    """[proto]: one port Server on one TCP port with a PsService holding
    W at d = 6144 on the card (batching on), an echo service, and the
    thrift, mongo, nshead and RTMP adaptors.  A tpu_std Forward load at
    p = 8 runs while every other protocol's client completes its calls;
    then gRPC over TLS, RTMP publish/play with the HLS remux, and
    Server.stop()'s GOAWAY drain.  Returns the path's launch counts (the
    protocols carry host bytes: none)."""
    import numpy as np

    from incubator_brpc_tpu_torch.models.echo import EchoService
    from incubator_brpc_tpu_torch.models.parameter_server import PsService, ps_stub
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.protocols.media_gateway import MediaGatewayService
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    t_phase = time.perf_counter()
    dev, d = dev or card(torch), PS_DIM
    T.reset_launch_counts()
    router, gw = proto_nshead_router(), MediaGatewayService(
        target_duration_s=PROTO_HLS_TARGET_S, window=64)
    srv = Server(ServerOptions(
        enable_batching=True, nova_service=EchoService(), nshead_service=router,
        thrift_service=proto_thrift_service(), mongo_service_adaptor=proto_mongo_adaptor(),
        rtmp_service=gw))
    svc = PsService(device=dev)
    srv.add_service(EchoService())
    srv.add_service(svc)
    check(srv.start(0) == 0, "the [proto] server did not start")
    g = torch.Generator(device=dev).manual_seed(SEED)
    W = torch.randn((d, d), generator=g, device=dev) / d ** 0.5
    svc.put_param("w", W)
    esp = EspPeer()
    chs = []
    out = {"protocols": {}}
    stopped = False
    try:
        xs = np.random.RandomState(SEED + 11).randn(64, d).astype(np.float32)
        x_bytes = [x.tobytes() for x in xs]
        stubs = []
        for i in range(PROTO_FORWARD_P):
            ch = Channel(ChannelOptions(timeout_ms=30000, connection_group=f"proto-fwd{i}"))
            check(ch.init(f"127.0.0.1:{srv.port}") == 0, "tpu_std channel init failed")
            chs.append(ch)
            stubs.append(ps_stub(ch))
        req = EchoRequest(message="w")
        closed_loop(stubs, req, x_bytes, PROTO_FORWARD_P, 0.2)  # warm the product
        clients = PROTO_CHANNELS + ["esp", "thrift", "mongo"]
        results, errors_ = {}, []

        def run(proto, seed):
            try:
                results[proto] = proto_client(proto, srv.port, esp.port, seed)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors_.append((proto, e))

        load = {}
        loader = threading.Thread(target=lambda: load.update(res=closed_loop(
            stubs, req, x_bytes, PROTO_FORWARD_P, 4.0)))
        loader.start()
        time.sleep(0.2)  # the load is on
        workers = [threading.Thread(target=run, args=(p, SEED + i)) for i, p in enumerate(clients)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(120)
        loader.join(120)
        check(not errors_, f"[proto] clients failed: {errors_[:2]}")
        check(set(results) == set(clients), f"[proto] clients missing: {set(clients) - set(results)}")
        check("res" in load, "the Forward load did not finish")
        lats, ys, wall, _ = load["res"]
        x_dev = torch.from_numpy(xs).to(dev).double()
        ref, scale = x_dev @ W.double(), x_dev.abs() @ W.abs().double()
        idx = torch.tensor([i for i, _ in ys], device=dev)
        got = torch.from_numpy(np.frombuffer(bytearray(b"".join(y for _, y in ys)),
                                             np.float32).reshape(len(ys), d)).to(dev)
        bad, worst = past_f64(got, ref[idx], scale[idx])
        check(bad == 0, f"[proto] Forward: {bad} outputs off by up to {worst:.3g} of |x| @ |W|")
        out["forward"] = (len(lats) / wall, pct(lats, 0.5), pct(lats, 0.99), len(lats))
        uq, u50, u99 = ps_summary.get((32, "on"), (0.0, 0, 0))
        print(f"[proto] tpu_std Forward p{PROTO_FORWARD_P} batching on, on the shared port "
              f"beside {len(clients)} protocol clients: {out['forward'][0]:.1f} qps, p50 "
              f"{out['forward'][1]} us, p99 {out['forward'][2]} us over {len(lats)} calls, every "
              f"y within {PS_RTOL:g} of |x| @ |W| of float64 (max {worst:.3g}); [ps] ici:// p32 on "
              f"{uq:.1f} qps, p50 {u50} us, p99 {u99} us")
        for proto in clients:
            plats, pwall = results[proto]
            row = {"calls": len(plats), "qps": len(plats) / pwall, "p50_us": pct(plats, 0.5),
                   "p99_us": pct(plats, 0.99)}
            out["protocols"][proto] = row
            print(f"[proto] {proto:13}: {row['calls']} calls, {row['qps']:8.1f} qps, p50 "
                  f"{row['p50_us']} us, p99 {row['p99_us']} us under the Forward load, every "
                  f"reply byte-equal to its expectation"
                  + (" (esp has no server side: its own peer)" if proto == "esp" else ""))
        check(all(v == PROTO_CALLS for v in router.routed.values()),
              f"the nshead router saw {router.routed}, not {PROTO_CALLS} of each")
        out["tls"] = proto_tls()
        print(f"[proto] gRPC over TLS: ALPN {out['tls']['alpn']}, one {PROTO_TLS_MESSAGE} B "
              f"message through h2 flow control and back in {out['tls']['ms']:.1f} ms")
        out["rtmp"] = proto_rtmp(srv.port, gw)
        print(f"[proto] RTMP: {out['rtmp']['messages']} messages of a seeded FLV stream published "
              f"and played back byte-equal in {out['rtmp']['relay_ms']:.1f} ms; "
              f"{out['rtmp']['segments']} HLS segments ({out['rtmp']['segment_bytes']} B), the "
              f"playlist and the FLV archive equal to a plain segmenter's and writer's")
        out["goaway"] = proto_goaway(srv)
        stopped = True
        print(f"[proto] Server.stop() with {PROTO_GOAWAY_STREAMS} h2 streams in flight: GOAWAY "
              f"sent, every stream finished with its reply; stop took "
              f"{out['goaway']['stop_ms']:.1f} ms")
    finally:
        for ch in chs:
            ch.close()
        esp.close()
        if not stopped:
            srv.stop()
    counts = dict(T.launches)
    out["s"] = time.perf_counter() - t_phase
    print(f"[proto] phase {out['s']:.1f} s on {smi}; launches {counts} (the protocols carry "
          f"host bytes)")
    print(json.dumps({"proto": out["protocols"]}))
    return counts, out


WITNESS_SLICE = 10  # ici://slice10/chip{0..3}: the child's servers
WITNESS_ECHOES = 4  # per chunk mode, each checked
WITNESS_TIMED = 24  # echoes per overhead turn
WITNESS_FORWARD_S = 1.0  # seconds of Forward per overhead turn
WITNESS_ABBA = 3  # ABBA rounds of the overhead turns
WITNESS_CACHE_VALUES = 16
WITNESS_DECODE_STEPS = 8
WITNESS_TLS_GETS = 3
WITNESS_FORWARD_P = 8
WITNESS_NATIVE_S = 0.5  # the native engine's armed Forward loop
# the seeded module the guard must refuse (written under an extra scope
# root, so its call sites are guarded like the package's)
WITNESS_SEEDED_SRC = '''\
import threading

from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest, EchoResponse
from incubator_brpc_tpu_torch.server.service import Service, rpc_method


def pull(x):
    return x.item()


def hidden(x):
    return bool(x.sum() > 0)


class HiddenSync(Service):
    """A handler that syncs without a wrapped spelling, on a server
    worker thread: only the sync hook can see it."""

    def __init__(self, x):
        self.x = x
        self.outcome = None

    @rpc_method(EchoRequest, EchoResponse)
    def Probe(self, controller, request, response, done):
        try:
            hidden(self.x)
            self.outcome = ("not raised", threading.current_thread().name)
        except Exception as e:  # noqa: BLE001 - the outcome is the probe's result
            self.outcome = (type(e).__name__, threading.current_thread().name)
        response.message = request.message
        done()
'''


def witness_say(msg: str) -> None:
    print(f"[witness] {msg}", flush=True)


def witness_launches(T, base):
    """Launches per kernel since the snapshot ``base`` of T.launches."""
    return {k: v - base.get(k, 0) for k, v in T.launches.items()}


def witness_teeth(dw, torch, dev, seeded):
    """A seeded .item() of a device tensor, and a hidden sync on the main
    thread and on a server worker thread: the outcome of each, for the
    parent to hold (each must raise TransferWitnessError)."""
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server
    from incubator_brpc_tpu_torch.server.service import ServiceStub

    x = torch.ones(4, device=dev)
    try:
        seeded.pull(x)
        item = "not raised"
    except dw.TransferWitnessError as e:
        item = "raised"
        witness_say(f"teeth: a seeded .item() of a tensor on {dev} raised "
                    f"TransferWitnessError ({str(e)[:60]}...)")
    try:
        seeded.hidden(x)
        main = "not raised"
    except dw.TransferWitnessError:
        main = "raised"
    svc = seeded.HiddenSync(x)
    srv = Server()
    srv.add_service(svc)
    check(srv.start_ici(WITNESS_SLICE, 3, device=dev) == 0, "start_ici of the probe failed")
    ch = Channel(ChannelOptions(timeout_ms=30000, ici_device=dev))
    try:
        check(ch.init(f"ici://slice{WITNESS_SLICE}/chip3") == 0, "probe channel init failed")
        c = Controller()
        ServiceStub(ch, seeded.HiddenSync).Probe(c, EchoRequest(message="probe"))
        check(not c.failed(), f"probe failed: {c.error_text()}")
    finally:
        ch.close()
        srv.stop()
    worker, thread = svc.outcome
    report = dw.cross_check()
    syncs = [v for v in report["violations"] if v["kind"] == "sync"]
    witness_say(f"sync hook (sync debug mode 'warn' once, showwarning hook): armed "
                f"{report['sync_hook']}; a hidden sync (bool of a device tensor) on the "
                f"main thread: {main}; on server worker thread {thread!r}: {worker}; "
                f"{report['sync_warnings']} torch sync warnings seen, {len(syncs)} refused")
    return {"item": item, "hook_armed": report["sync_hook"], "hidden_main": main,
            "hidden_worker": worker, "worker_thread": thread,
            "sync_warnings": report["sync_warnings"], "sync_refused": len(syncs)}


def witness_echo(torch, T, dev, mb, pulls):
    """The echo in fused and pallas mode: launches per hop as [echo]'s,
    no host view.  Returns a closure timing one echo turn."""
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
    from incubator_brpc_tpu_torch.parallel.ici import get_fabric
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server

    srv = Server()
    srv.add_service(EchoService())
    check(srv.start_ici(WITNESS_SLICE, 0, device=dev) == 0, "start_ici of the echo failed")
    ch = Channel(ChannelOptions(timeout_ms=60000, ici_device=dev))
    check(ch.init(f"ici://slice{WITNESS_SLICE}/chip0") == 0, "echo channel init failed")
    stub = echo_stub(ch)
    x0 = make_payload(torch, mb, torch.float32, SEED)
    fabric = get_fabric()

    def echo(x):
        c = Controller()
        c.timeout_ms = 60000
        c.request_attachment.append_device(x)
        stub.Echo(c, EchoRequest(message="bulk"))
        check(not c.failed(), f"witness echo failed: {c.error_text()}")
        (seg,) = c.response_attachment.device_segments()
        return seg.array

    counts = {}
    for mode in ("fused", "pallas"):
        fabric.chunk_mode = mode
        views0, base = pulls("iobuf.host-view"), dict(T.launches)
        for _ in range(WITNESS_ECHOES):
            check(torch.equal(echo(x0), x0), f"witness {mode} echo changed the bytes")
        counts[mode] = witness_launches(T, base)
        hops = 2 * WITNESS_ECHOES
        for k, v in counts[mode].items():
            check(v == PER_HOP[mode][k] * hops,
                  f"witness {mode}: {k} launched {v} times for {hops} hops, "
                  f"expected {PER_HOP[mode][k]} per hop as in [echo]")
        check(pulls("iobuf.host-view") == views0, f"witness {mode}: an ICI hop took a host view")
    fabric.chunk_mode = "fused"
    witness_say(f"echo {tuple(mb)} f32 over ici:// in fused and pallas mode, "
                f"{WITNESS_ECHOES} each: launches {counts} (per hop as in [echo]); "
                f"iobuf.host-view 0")

    def turn():
        ts = []
        for _ in range(WITNESS_TIMED):
            t0 = time.perf_counter()
            echo(x0)
            torch.cuda.synchronize(dev)
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts) * 1e3

    def close():
        ch.close()
        srv.stop()

    return counts, turn, close


def witness_ps(torch, T, dev, d, pulls, mesh=None):
    """PS Put/Get of W over ici:// (one K1 a hop, no host view) and a
    closed-loop Forward at p = WITNESS_FORWARD_P with batching on: one
    ps.forward-pull per batch.  Over a mesh, one execution and one
    merge per batch too.  Returns (figures, a Forward turn, close)."""
    import numpy as np

    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.parameter_server import PsService, ps_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    chip = 1 if mesh is None else 2
    svc = PsService(device=dev) if mesh is None else PsService(mesh=mesh)
    srv = Server(ServerOptions(enable_batching=True))
    srv.add_service(svc)
    check(srv.start_ici(WITNESS_SLICE, chip, device=dev) == 0, "start_ici of the PS failed")
    ep = f"ici://slice{WITNESS_SLICE}/chip{chip}"
    g = torch.Generator(device=dev).manual_seed(SEED)
    W = torch.randn((d, d), generator=g, device=dev) / d ** 0.5
    req = EchoRequest(message="w")
    channels = []
    for _ in range(4):
        ch = Channel(ChannelOptions(timeout_ms=60000, ici_device=dev))
        check(ch.init(ep) == 0, "PS channel init failed")
        channels.append(ch)
    stubs = [ps_stub(c) for c in channels]
    what = "mesh" if mesh is not None else "ps"
    views0, base = pulls("iobuf.host-view"), dict(T.launches)
    c = Controller()
    c.request_attachment.append_device(W)
    stubs[0].Put(c, req)
    check(not c.failed(), f"witness {what} Put failed: {c.error_text()}")
    c = Controller()
    stubs[0].Get(c, req)
    check(not c.failed(), f"witness {what} Get failed: {c.error_text()}")
    (seg,) = c.response_attachment.device_segments()
    check(same_bytes(torch, seg.array, W), f"witness {what} Get returned other bytes")
    hops = witness_launches(T, base)
    check(hops["copy_csum_blocks"] == 2 and hops["copy_csum_staged"] == 0,
          f"witness {what} Put + Get launched {hops}: expected one K1 per hop of W")
    check(pulls("iobuf.host-view") == views0, f"witness {what}: Put/Get took a host view")
    xs = np.random.RandomState(SEED).randn(64, d).astype(np.float32)
    x_bytes = [x.tobytes() for x in xs]
    ref = torch.from_numpy(xs).to(dev).double() @ W.double()
    scale = torch.from_numpy(np.abs(xs)).to(dev).double() @ W.abs().double()
    batcher = srv.batcher("PsService.Forward")
    kern = svc.shard_kernel
    closed_loop(stubs, req, x_bytes, 4, 0.2)  # warm
    b0, f0 = batcher.batches, pulls("ps.forward-pull")
    e0, m0 = (kern.executions, kern.collective_merges) if kern else (0, 0)
    lats, ys, wall, _ = closed_loop(stubs, req, x_bytes, WITNESS_FORWARD_P, 1.0)
    batches, fwd = batcher.batches - b0, pulls("ps.forward-pull") - f0
    check(fwd == batches > 0, f"witness {what}: {fwd} ps.forward-pull for {batches} batches")
    if kern is not None:
        execs, merges = kern.executions - e0, kern.collective_merges - m0
        check(execs == merges == batches, f"witness mesh: {execs} executions, {merges} "
                                          f"merges for {batches} batches")
    idx = torch.tensor([i for i, _ in ys], device=dev)
    got = torch.from_numpy(np.frombuffer(bytearray(b"".join(y for _, y in ys)),
                                         np.float32).reshape(len(ys), d)).to(dev)
    bad, worst = past_f64(got, ref[idx], scale[idx])
    check(bad == 0, f"witness {what}: {bad} Forward outputs off by up to {worst:.3g}")
    qps = len(lats) / wall
    witness_say(f"{what} W ({d}, {d}) f32 Put/Get over ici:// (K1 1 per hop, host view 0); "
                f"Forward p{WITNESS_FORWARD_P} batching on: {qps:.1f} qps, {batches} batches "
                f"= {fwd} ps.forward-pull" + (" = executions = merges" if kern else "")
                + f"; max |y - ref| / (|x| @ |W|) {worst:.3g}")

    def turn():
        lats, _, wall, _ = closed_loop(stubs, req, x_bytes, WITNESS_FORWARD_P,
                                       WITNESS_FORWARD_S)
        return len(lats) / wall

    def close():
        for ch in channels:
            ch.close()
        srv.stop()

    return {"qps": qps, "batches": batches, "forward_pulls": fwd}, turn, close, W


def witness_cache(torch, T, dev, value, pulls):
    """SETs of device values and GET hits over ici://: no spill, no
    host view, one K1 a hop."""
    from incubator_brpc_tpu_torch.cache import HBMCacheService, HBMCacheStore
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.protocols import redis as R
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    store = HBMCacheStore(64 << 20, device=dev)
    srv = Server(ServerOptions(redis_service=HBMCacheService(store=store)))
    check(srv.start_ici(WITNESS_SLICE, 4, device=dev) == 0, "start_ici of the cache failed")
    ch = Channel(ChannelOptions(protocol="redis", timeout_ms=60000, ici_device=dev))
    g = torch.Generator(device=dev).manual_seed(SEED)
    vals = torch.randint(0, 256, (WITNESS_CACHE_VALUES, value), generator=g,
                         dtype=torch.uint8, device=dev)

    def rcall(*cmd):
        req, resp, c = R.RedisRequest(), R.RedisResponse(), Controller()
        req.add_command(*cmd)
        ch.call_method(R.redis_method_spec(), c, req, resp)
        check(not c.failed(), f"witness redis {cmd[0]} failed: {c.error_text()}")
        return resp.reply(0)

    try:
        check(ch.init(f"ici://slice{WITNESS_SLICE}/chip4") == 0, "cache channel init failed")
        base = dict(T.launches)
        for i in range(WITNESS_CACHE_VALUES):
            check(rcall("SET", b"w%02d" % i, vals[i]).value == "OK", "witness SET failed")
        spills0, views0 = pulls("cache.host-spill"), pulls("iobuf.host-view")
        for i in range(WITNESS_CACHE_VALUES):
            got = rcall("GET", b"w%02d" % i).device_array()
            check(got is not None and same_bytes(torch, got, vals[i]),
                  "witness GET hit did not return the value's bytes")
        spills = pulls("cache.host-spill") - spills0
        views = pulls("iobuf.host-view") - views0
        k1 = witness_launches(T, base)["copy_csum_blocks"]
        check(spills == 0 and views == 0, f"witness cache: ICI GET hits took {spills} "
                                          f"spills and {views} host views")
        check(k1 == 2 * WITNESS_CACHE_VALUES,
              f"witness cache: {k1} K1 for {2 * WITNESS_CACHE_VALUES} hops")
    finally:
        ch.close()
        srv.stop()
    witness_say(f"cache {WITNESS_CACHE_VALUES} SETs and GET hits of {value} B device values "
                f"over ici://: cache.host-spill 0, iobuf.host-view 0, K1 1 per hop")
    return {"spills": spills, "views": views}


def witness_decode(torch, dev, dim, pulls):
    """WITNESS_DECODE_STEPS decode steps at the serve cell's width: one
    decode.token-sums pull per step."""
    import threading as _threading

    from incubator_brpc_tpu_torch.streaming.generate import DecodeLoop

    loop = DecodeLoop(dim=dim, device=dev)
    try:
        s0, steps0 = pulls("decode.token-sums"), loop.steps
        done, toks = _threading.Event(), []
        loop.admit("witness", WITNESS_DECODE_STEPS, lambda t, r: toks.append(t),
                   lambda r, ok: done.set())
        check(done.wait(120), "witness decode did not finish")
        sums, steps = pulls("decode.token-sums") - s0, loop.steps - steps0
    finally:
        loop.stop()
    check(len(toks) == WITNESS_DECODE_STEPS and sums == steps == WITNESS_DECODE_STEPS,
          f"witness decode: {len(toks)} tokens, {steps} steps, {sums} decode.token-sums")
    witness_say(f"decode at dim {dim}: {steps} steps, {sums} decode.token-sums pulls")
    return {"steps": steps, "token_sums": sums}


def witness_tls(torch, dev, W, pulls):
    """A PS Get of W over TLS/TCP with an Authenticator: one host view
    per frame.  Needs the openssl CLI for the certificate."""
    import tempfile

    from incubator_brpc_tpu_torch.client.auth import Authenticator
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.parameter_server import PsService, ps_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
    from incubator_brpc_tpu_torch.transport import ssl_helper

    d = tempfile.mkdtemp(prefix="witness-tls-")
    cert, key = f"{d}/cert.pem", f"{d}/key.pem"
    made = subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", key,
         "-out", cert, "-days", "2", "-subj", "/CN=localhost",
         "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
        capture_output=True, text=True, timeout=60)
    check(made.returncode == 0, f"openssl could not make a certificate: {made.stderr[-300:]}")

    class Token(Authenticator):
        def generate_credential(self):
            return "witness-token"

        def verify_credential(self, auth_str, peer, context=None):
            return 0 if auth_str == "witness-token" else 1

    svc = PsService(device=dev)
    svc.put_param("w", W)
    srv = Server(ServerOptions(auth=Token(), ssl_options=ssl_helper.ServerSSLOptions(
        default_cert=ssl_helper.CertInfo(certificate=cert, private_key=key))))
    srv.add_service(svc)
    check(srv.start(0) == 0, "the TLS server did not start")
    ch = Channel(ChannelOptions(timeout_ms=60000, auth=Token(), ssl_options=(
        ssl_helper.ChannelSSLOptions(ca_file=cert))))
    want = W.cpu().numpy().tobytes()
    try:
        check(ch.init(f"127.0.0.1:{srv.port}") == 0, "TLS channel init failed")
        views0 = pulls("iobuf.host-view")
        for _ in range(WITNESS_TLS_GETS):
            c = Controller()
            ps_stub(ch).Get(c, EchoRequest(message="w"))
            check(not c.failed(), f"TLS Get failed: {c.error_text()}")
            check(c.response_attachment.to_bytes() == want, "TLS Get returned other bytes")
        views = pulls("iobuf.host-view") - views0
    finally:
        ch.close()
        srv.stop()
    check(views == WITNESS_TLS_GETS, f"witness TLS: {views} host views for "
                                     f"{WITNESS_TLS_GETS} frames of W")
    witness_say(f"TLS/TCP PS Get of W with an Authenticator, {WITNESS_TLS_GETS} frames: "
                f"iobuf.host-view {views} (one per frame), bytes equal")
    return {"frames": WITNESS_TLS_GETS, "views": views}


def witness_native(torch, dev, W, pulls):
    """A short native Forward loop, armed: PsService on the card behind
    the C++ engine with batching on, p = WITNESS_FORWARD_P async callers
    on one native channel; one ps.forward-pull per batch."""
    import numpy as np

    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.models.parameter_server import PsService, ps_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    d = W.shape[0]
    svc = PsService(device=dev)
    svc.put_param("w", W)
    srv = Server(ServerOptions(native_engine=True, enable_batching=True))
    srv.add_service(svc)
    check(srv.start(0) == 0 and srv._native_engine is not None, "the native PS did not start")
    ch = Channel(ChannelOptions(timeout_ms=60000, connection_type="native"))
    try:
        check(ch.init(f"127.0.0.1:{srv.port}") == 0, "native channel init failed")
        stubs, req = [ps_stub(ch)], EchoRequest(message="w")
        xs = np.random.RandomState(SEED + 2).randn(64, d).astype(np.float32)
        x_bytes = [x.tobytes() for x in xs]
        closed_loop(stubs, req, x_bytes, 4, 0.2)  # warm
        batcher = srv.batcher("PsService.Forward")
        b0, f0 = batcher.batches, pulls("ps.forward-pull")
        lats, ys, wall, _ = closed_loop(stubs, req, x_bytes, WITNESS_FORWARD_P, WITNESS_NATIVE_S)
        batches, fwd = batcher.batches - b0, pulls("ps.forward-pull") - f0
        check(fwd == batches > 0, f"witness native: {fwd} ps.forward-pull for {batches} batches")
        ref = torch.from_numpy(xs).to(dev).double() @ W.double()
        scale = torch.from_numpy(np.abs(xs)).to(dev).double() @ W.abs().double()
        idx = torch.tensor([i for i, _ in ys], device=dev)
        got = torch.from_numpy(np.frombuffer(bytearray(b"".join(y for _, y in ys)),
                                             np.float32).reshape(len(ys), d)).to(dev)
        bad, worst = past_f64(got, ref[idx], scale[idx])
        check(bad == 0, f"witness native: {bad} Forward outputs off by up to {worst:.3g}")
    finally:
        ch.close()
        srv.stop()
    qps = len(lats) / wall
    witness_say(f"native engine PS Forward p{WITNESS_FORWARD_P} batching on, "
                f"{WITNESS_NATIVE_S} s: {qps:.1f} qps, {batches} batches = {fwd} "
                f"ps.forward-pull; max |y - ref| / (|x| @ |W|) {worst:.3g}")
    return {"qps": qps, "batches": batches, "forward_pulls": fwd}


def witness_child(device_name: str) -> int:
    """The [witness] phase's child interpreter, on the card: both
    witnesses armed before the port creates its locks, then every guarded
    path.  Prints [witness] lines and, last, one WITNESS_RESULT JSON line
    (with the child's launches per kernel, the overhead turns included)."""
    import tempfile

    from incubator_brpc_tpu_torch.analysis import device_witness as dw
    from incubator_brpc_tpu_torch.analysis import witness as lw

    faulthandler.dump_traceback_later(600, exit=True)
    seeded_root = tempfile.mkdtemp(prefix="witness-seeded-")
    pathlib.Path(seeded_root, "seeded_witness.py").write_text(WITNESS_SEEDED_SRC)
    lw.enable()
    dw.enable(extra_scopes=[seeded_root])
    sys.path.insert(0, seeded_root)
    import seeded_witness
    import torch

    from incubator_brpc_tpu_torch.ops import transfer as T

    dev = torch.device(device_name)
    check(dev.type == "cuda" and torch.cuda.is_available(),
          f"the witness child runs on a CUDA device, not {dev}")
    T.reset_launch_counts()

    def pulls(key):
        return dw.transfer_counts().get(key, 0)

    t0 = time.perf_counter()
    result = {"device": str(dev), "teeth": witness_teeth(dw, torch, dev, seeded_witness)}
    dw.reset()  # the seeded refusals are the teeth, not the paths' record
    echo_counts, echo_turn, echo_close = witness_echo(torch, T, dev, MAIN_SHAPE, pulls)
    ps, fwd_turn, ps_close, W = witness_ps(torch, T, dev, PS_DIM, pulls)
    result.update(echo=echo_counts, ps=ps,
                  cache=witness_cache(torch, T, dev, CACHE_VALUE, pulls),
                  decode=witness_decode(torch, dev, SERVE_DIM, pulls))
    from incubator_brpc_tpu_torch.parallel.mesh import create_mesh

    mesh_fig, _, mesh_close, _ = witness_ps(
        torch, T, dev, PS_DIM, pulls, mesh=create_mesh((1, MESH_CHIPS), devices=[dev] * MESH_CHIPS))
    mesh_close()
    result["mesh"] = mesh_fig
    result["tls"] = witness_tls(torch, dev, W, pulls)
    result["native"] = witness_native(torch, dev, W, pulls)
    report = dw.cross_check()
    locks = lw.cross_check()
    result.update(violations=report["violations"], scope_uses=report["scope_uses"],
                  retrace=report["retrace_contradictions"], sync_warnings=report["sync_warnings"],
                  lock_contradictions=locks["contradictions"], lock_sites=locks["witnessed_sites"],
                  lock_edges=locks["checked"], lock_new_edges=locks["new_edges"])
    witness_say(f"report: {len(report['violations'])} violations, "
                f"{len(report['retrace_contradictions'])} retrace contradictions, scope uses "
                f"{report['scope_uses']}, {report['sync_warnings']} torch sync warnings "
                f"passed by the hook; lock witness {locks['witnessed_sites']} sites, "
                f"{locks['checked']} mapped edges, {len(locks['new_edges'])} unmanifested, "
                f"{len(locks['contradictions'])} contradictions")
    check(not report["violations"], f"witness violations: {report['violations'][:3]}")
    check(not locks["contradictions"], f"lock contradictions: {locks['contradictions'][:3]}")
    check(not report["retrace_contradictions"],
          f"retrace contradictions: {report['retrace_contradictions'][:3]}")
    result["paths_s"] = time.perf_counter() - t0
    # the guard's cost: the same echo and Forward point, armed against
    # disarmed, in turns (ABBA WITNESS_ABBA times, after one warm turn);
    # the lock witness stays on in every turn
    overhead = {"echo_ms": {"armed": [], "disarmed": []},
                "forward_qps": {"armed": [], "disarmed": []}}
    echo_turn()
    fwd_turn()
    for armed in (True, False, False, True) * WITNESS_ABBA:
        if armed:
            dw.enable(extra_scopes=[seeded_root])
        else:
            dw.disable()
        side = "armed" if armed else "disarmed"
        overhead["echo_ms"][side].append(echo_turn())
        overhead["forward_qps"][side].append(fwd_turn())
    check(dw.enabled() and not dw.cross_check()["violations"],
          "the overhead turns recorded a violation")
    echo_close()
    ps_close()
    result["overhead"] = overhead
    result["launches"] = dict(T.launches)
    result["child_s"] = time.perf_counter() - t0
    print("WITNESS_RESULT " + json.dumps(result, default=repr), flush=True)
    return 0


def phase_witness(torch, smi):
    """[witness]: the child arms the lock witness and the transfer guard
    before the port creates its locks, proves the guard's teeth on the
    card and drives the echo, PS, cache, decode, mesh and TLS paths;
    this side checks its report.  Returns the report."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(pathlib.Path(__file__).resolve()), "--witness-child",
         str(card(torch))],
        capture_output=True, text=True, timeout=900,
    )
    for line in proc.stdout.splitlines():
        if line.startswith("[witness]"):
            print(line)
    check(proc.returncode == 0, f"the witness child exited {proc.returncode}; its stdout "
                                f"ends:\n{proc.stdout[-2000:]}\nits stderr ends:\n"
                                f"{proc.stderr[-3000:]}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("WITNESS_RESULT ")]
    check(len(lines) == 1, "the witness child printed no result")
    r = json.loads(lines[0][len("WITNESS_RESULT "):])
    teeth = r["teeth"]
    check(teeth["item"] == "raised", f"the guard did not refuse the seeded .item(): {teeth}")
    check(teeth["hook_armed"] and teeth["hidden_main"] == "raised",
          f"the sync hook did not refuse a hidden sync on the main thread: {teeth}")
    check(teeth["hidden_worker"] == "TransferWitnessError",
          f"the sync hook did not refuse a hidden sync on a server worker thread: {teeth}")
    check(teeth["sync_warnings"] > 0 and teeth["sync_refused"] >= 2 and r["sync_warnings"] > 0,
          f"the sync hook saw no torch sync warning: teeth {teeth}, paths {r['sync_warnings']}")
    check(not r["violations"] and not r["lock_contradictions"] and not r["retrace"],
          "the witness child reported violations or contradictions")
    check("cache.host-spill" not in r["scope_uses"], f"a spill: {r['scope_uses']}")
    check(r["cache"] == {"spills": 0, "views": 0}, f"ICI cache hits pulled: {r['cache']}")
    for path in ("ps", "mesh", "native"):
        check(r[path]["forward_pulls"] == r[path]["batches"] > 0,
              f"{path}: {r[path]['forward_pulls']} pulls for {r[path]['batches']} batches")
    check(r["decode"]["token_sums"] == r["decode"]["steps"] == WITNESS_DECODE_STEPS,
          f"decode: {r['decode']}")
    check(r["tls"]["views"] == r["tls"]["frames"] == WITNESS_TLS_GETS, f"TLS: {r['tls']}")
    hops = 2 * WITNESS_ECHOES
    for mode, counts in r["echo"].items():
        check(counts == {k: v * hops for k, v in PER_HOP[mode].items()},
              f"witness {mode} echo launched {counts}, not [echo]'s per hop")
    secs = time.perf_counter() - t0

    def overhead(name, unit, fmt):
        """armed against disarmed, as medians; 'unresolved' when the
        difference is inside the disarmed turns' own spread"""
        armed, disarmed = (r["overhead"][name][s] for s in ("armed", "disarmed"))
        a, b = statistics.median(armed), statistics.median(disarmed)
        diff, spread = 100 * (a / b - 1), 100 * (max(disarmed) - min(disarmed)) / b
        verdict = "resolved" if abs(diff) > spread else "unresolved"
        return (f"{a:{fmt}} {unit} armed, {b:{fmt}} disarmed ({diff:+.1f}%; the disarmed "
                f"turns spread {spread:.1f}%: {verdict})")

    turns = 2 * WITNESS_ABBA
    print(f"[witness] guard overhead on {smi}: 64 MB fused echo "
          f"{overhead('echo_ms', 'ms', '.3f')}; PS Forward p{WITNESS_FORWARD_P} batching on "
          f"{overhead('forward_qps', 'qps', '.1f')} (medians of {turns} turns each, "
          f"ABBA x{WITNESS_ABBA}, {WITNESS_TIMED} echoes or {WITNESS_FORWARD_S} s a turn; "
          f"the lock witness on in every turn)")
    print(f"[witness] lock witness: {r['lock_sites']} sites, {r['lock_edges']} mapped edges, "
          f"0 contradictions; unmanifested (not in lock_order.json, none contradicting it): "
          + ("; ".join(f"{e['edge']} x{e['count']}" for e in r["lock_new_edges"]) or "none"))
    print(f"[witness] phase {secs:.1f} s wall on {smi} (child {r['child_s']:.1f} s, its "
          f"guarded paths {r['paths_s']:.1f} s)")
    return r


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


def queued_windows(torch, fn, iters: int = 20, windows: int = 3) -> list:
    """Device ms per call of fn() in each of ``windows`` windows, the
    calls run back to back: they are queued behind a sleep kernel, so
    the card runs them with no host gap between and each pays for the
    write-back of the output its predecessor left dirty in the L2.
    (Between launches spaced by the host, that write-back drains in the
    idle gap after the kernel's span ends, so a span alone can read
    under the HBM bound.)  The events bracket the calls alone.  A window
    whose calls took the host longer to enqueue than the card slept is
    taken again with twice the sleep; after SLEEP_TRIES such windows it
    fails."""
    fn()
    seen, cycles, tries = [], SLEEP_CYCLES, 0
    while len(seen) < windows:
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        slept = ev[0].elapsed_time(ev[1])
        if host_ms < slept:
            seen.append(ev[1].elapsed_time(ev[2]) / iters)
            continue
        tries += 1
        check(tries < SLEEP_TRIES, f"enqueueing {iters} calls took {host_ms:.2f} ms, longer "
                                   f"than the card's {slept:.2f} ms sleep, {tries} times")
        cycles *= 2
    return seen


def queued_ms(torch, fn, iters: int = 20, windows: int = 3) -> float:
    """The median of queued_windows."""
    return statistics.median(queued_windows(torch, fn, iters, windows))


def cold_pairs(torch, x):
    """COLD_PAIRS distinct (source, destination) pairs of x's shape, x's
    bytes in each source: launches walked over them in turn each find
    their frame cold, the previous launch having touched another pair
    (a 64 MB frame and its copy are 2.6x the 50 MB L2)."""
    return [(x if i == 0 else x.clone(), torch.empty_like(x)) for i in range(COLD_PAIRS)]


def walk(fn, pairs):
    """fn(src, dst) over ``pairs`` in turn, one pair a call."""
    it = itertools.cycle(pairs)
    return lambda: fn(*next(it))


def stage_rows_of(T, v, br):
    """K2's stage rows for lane view v: the planner's, or, in a checkout
    from before the planner (``--times`` of an older tree), its
    pallas_stage_rows."""
    if hasattr(T, "staged_plan"):
        return T.staged_plan(v, br).stage_rows
    return T.pallas_stage_rows(v, br)


def transmit_ms(torch, T, x, w):
    """Device ms per call of each copy+checksum transmit, every kernel
    the call launches included (so a tree whose fold is a launch of its
    own is timed with its fold), each launch finding its frame cold in
    the 50 MB L2, as on the path: ``chunk``, one CHUNK_ROWS-row chunk of
    the frame ``x`` with a carry into a slot, as the pipelined mode's
    ring hits run it, walked over the frame's chunks (the profiler's
    kernel spans); ``frame``, K1 on ``x``, and ``w``, K1 on the PS
    path's W ``w``, each walked over distinct buffers (``cold_pairs``)
    and run back to back (``queued_ms``); ``staged``, K2 on ``x``, and
    ``staged_stack``, K2 on the (DMGET_KEYS, CACHE_VALUE) u8 stack of a
    stacked DMSET, likewise, each with its windows (``*_windows``);
    ``copy_blocks`` and ``copy_``, the plain copy and out.copy_(src) on
    ``x``, likewise.  ``frame_span`` and ``w_span`` are K1's kernel
    spans in the profiler between launches spaced by the host, on one
    buffer."""
    out, w_out = torch.empty_like(x), torch.empty_like(w)
    br, w_br = T._fit_block_rows(x.shape[0]), T._fit_block_rows(w.shape[0])
    sr = stage_rows_of(T, x, br)
    stack = make_payload(torch, (DMGET_KEYS, CACHE_VALUE), torch.uint8, SEED)
    s_br = T._fit_block_rows(DMGET_KEYS)
    s_sr = stage_rows_of(T, stack, s_br)
    carry = torch.randn((1, x.shape[1]), generator=torch.Generator(device=x.device).manual_seed(7),
                        device=x.device)
    xs, ws, ss = cold_pairs(torch, x), cold_pairs(torch, w), cold_pairs(torch, stack)
    staged = queued_windows(torch, walk(lambda s, o: T._staged_copy_csum(s, br, sr, out=o), xs),
                            windows=5)
    staged_stack = queued_windows(
        torch, walk(lambda s, o: T._staged_copy_csum(s, s_br, s_sr, out=o), ss), windows=5)
    return {
        "chunk": device_ms(torch, lambda: chunk_walk(T, x, out, carry, br))
        / (x.shape[0] // CHUNK_ROWS),
        "frame": queued_ms(torch, walk(lambda s, o: T._copy_csum(s, None, br, out=o), xs)),
        "w": queued_ms(torch, walk(lambda s, o: T._copy_csum(s, None, w_br, out=o), ws)),
        "staged": statistics.median(staged),
        "staged_windows": staged,
        "staged_stack": statistics.median(staged_stack),
        "staged_stack_windows": staged_stack,
        "copy_blocks": queued_ms(torch, walk(T._launch_copy_blocks, xs)),
        "copy_": queued_ms(torch, walk(lambda s, o: o.copy_(s), xs)),
        "frame_span": device_ms(torch, lambda: T._copy_csum(x, None, br, out=out)),
        "w_span": device_ms(torch, lambda: T._copy_csum(w, None, w_br, out=w_out)),
    }


def copy_bound_ms(nbytes: int, elements: int, n: int) -> float:
    """A copy+checksum's bound: it reads the payload and writes its copy
    and the (1, n) f32 accumulator, one addition an element (the
    kernels' partial scratch is not counted)."""
    return max((2 * nbytes + 4 * n) / HBM_BYTES_PER_S, elements / F32_OPS_PER_S) * 1e3


def phase_times(torch, T, errs, totals):
    """Each kernel alone at the main path's shapes (transmit_ms); the
    plain versions and x.clone() by CUDA events."""
    x = make_payload(torch, MAIN_SHAPE, torch.float32, SEED)
    w = make_payload(torch, (PS_DIM, PS_DIM), torch.float32, SEED)
    m, n = MAIN_SHAPE
    br = T._fit_block_rows(m)
    out = torch.empty_like(x)
    ms = transmit_ms(torch, T, x, w)

    clone_ms = cuda_ms(torch, lambda: x.clone())
    plain_ms = cuda_ms(torch, lambda: T.copy_csum_plain(x, None, br), iters=5)
    copy_bytes = 2 * x.nbytes + 4 * n
    rows = []
    for name, k_ms, plain, nbytes, ops in [
        ("copy_csum_blocks", ms["frame"], plain_ms, copy_bytes, m * n),
        ("copy_csum_staged", ms["staged"], plain_ms, copy_bytes, m * n),
        # a pure copy does no arithmetic: bound by its 2 x 64 MiB alone
        ("copy_blocks", ms["copy_blocks"], cuda_ms(torch, lambda: T.device_copy_plain(x)),
         2 * x.nbytes, 0),
    ]:
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        row = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": totals[name],
            "max_abs_err": errs[name], "ms": k_ms, "plain_ms": plain,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            # out.copy_(src) computes device_copy's function in one call,
            # timed as the kernel is (queued, cold pairs); x.clone(), by
            # CUDA events on one buffer, is kept beside it.  No torch call
            # computes a copy plus its block checksums
            "library_ms": ms["copy_"] if name == "copy_blocks" else None,
            "clone_ms": clone_ms,
        }
        if name in OFF_PATH:
            row["launched_in"] = OFF_PATH[name]
            row["span_ms"] = device_ms(torch, lambda: T._launch_copy_blocks(x, out),
                                       "copy_blocks_kernel")
        rows.append(row)
        print(f"[times] {name:17} {k_ms:.4f} ms (bound {max(t_bytes, t_ops):.4f} ms, "
              f"{max(t_bytes, t_ops) / k_ms:.0%} of it; plain {plain:.4f} ms, "
              f"x.clone() {clone_ms:.4f} ms)")
    print(f"[times] copy_blocks {ms['copy_blocks']:.4f} ms against out.copy_(src) "
          f"{ms['copy_']:.4f} ms, both back to back over {COLD_PAIRS} cold pairs "
          f"({ms['copy_blocks'] / ms['copy_']:.3f}x); x.clone() on one buffer by CUDA events "
          f"{clone_ms:.4f} ms")
    # K2 at both of its path shapes, back to back: the 64 MB frame and the
    # stacked DMSET's (32, 1048576) u8 stack, each with its windows' spread
    s_bound = copy_bound_ms(DMGET_KEYS * CACHE_VALUE, DMGET_KEYS * CACHE_VALUE, CACHE_VALUE)
    rows[1].update(ms_windows=ms["staged_windows"], stack_ms=ms["staged_stack"],
                   stack_ms_windows=ms["staged_stack_windows"], stack_bound_ms=s_bound)
    for what, key, bound in [("64 MB frame", "staged", rows[1]["bound_ms"]),
                             (f"({DMGET_KEYS}, {CACHE_VALUE}) u8 stack", "staged_stack", s_bound)]:
        win = ms[f"{key}_windows"]
        print(f"[times] copy_csum_staged on the {what}: {ms[key]:.4f} ms median of "
              f"{len(win)} windows ({min(win):.4f}-{max(win):.4f}), bound {bound:.4f} ms, "
              f"{bound / ms[key]:.0%} of it; K1 on the frame {ms['frame']:.4f} ms")
    # K1 at the width the PS path gives it: W, (6144, 6144) f32
    w_bound = copy_bound_ms(w.nbytes, w.numel(), PS_DIM)
    rows[0].update(ps_w_ms=ms["w"], ps_w_bound_ms=w_bound, span_ms=ms["frame_span"],
                   ps_w_span_ms=ms["w_span"])
    print(f"[times] kernel spans in the profiler, launches spaced by the host on one buffer "
          f"(part of the output drains from the L2 after the span): copy_csum_blocks 64 MB "
          f"{ms['frame_span']:.4f} ms, on W {ms['w_span']:.4f} ms, copy_blocks "
          f"{rows[2]['span_ms']:.4f} ms")
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
    smi = phase_build(need_bulk=False)
    x = make_payload(torch, MAIN_SHAPE, torch.float32, SEED)
    w = make_payload(torch, (PS_DIM, PS_DIM), torch.float32, SEED)
    ms = transmit_ms(torch, T, x, w)
    for k, v in ms.items():
        if not k.endswith("_windows"):
            print(f"[times] {path.name}: {k:12} {v:.5f} ms")
    print(json.dumps({"root": str(path), "card": smi, "ms": ms}))
    return 0


# --tune: the bulk-copy rings' constants tried on the card.  A variant is
# transfer.cu with the named constants replaced (ops/transfer.py's
# mirrors of STAGE_BYTES and of both CTAs-an-SM set to match, for the
# stage rows and the grids).  The first row is the constants the tree
# holds.
TUNE_VARIANTS = [
    {"STAGES": 6, "STAGE_BYTES": 32768, "STAGED_CTAS_PER_SM": 1, "STORE_LAG": 1,
     "COPY_STAGES": 12, "COPY_CHUNK": 16384, "COPY_CTAS_PER_SM": 1, "COPY_STORE_LAG": 2,
     "LOAD_EVICT": 1, "STORE_EVICT": 1},
    {"STAGES": 4, "STAGE_BYTES": 32768, "STAGED_CTAS_PER_SM": 1, "STORE_LAG": 1,
     "COPY_STAGES": 4, "COPY_CHUNK": 32768, "COPY_CTAS_PER_SM": 1, "COPY_STORE_LAG": 2,
     "LOAD_EVICT": 1, "STORE_EVICT": 1},
    {"STAGES": 3, "STAGE_BYTES": 32768, "STAGED_CTAS_PER_SM": 1, "STORE_LAG": 1,
     "COPY_STAGES": 6, "COPY_CHUNK": 16384, "COPY_CTAS_PER_SM": 2, "COPY_STORE_LAG": 2,
     "LOAD_EVICT": 1, "STORE_EVICT": 1},
    {"STAGES": 2, "STAGE_BYTES": 32768, "STAGED_CTAS_PER_SM": 2, "STORE_LAG": 1,
     "COPY_STAGES": 24, "COPY_CHUNK": 8192, "COPY_CTAS_PER_SM": 1, "COPY_STORE_LAG": 4,
     "LOAD_EVICT": 1, "STORE_EVICT": 1},
    {"STAGES": 4, "STAGE_BYTES": 16384, "STAGED_CTAS_PER_SM": 2, "STORE_LAG": 2,
     "COPY_STAGES": 12, "COPY_CHUNK": 16384, "COPY_CTAS_PER_SM": 1, "COPY_STORE_LAG": 1,
     "LOAD_EVICT": 1, "STORE_EVICT": 1},
    {"STAGES": 6, "STAGE_BYTES": 32768, "STAGED_CTAS_PER_SM": 1, "STORE_LAG": 2,
     "COPY_STAGES": 14, "COPY_CHUNK": 16384, "COPY_CTAS_PER_SM": 1, "COPY_STORE_LAG": 3,
     "LOAD_EVICT": 1, "STORE_EVICT": 1},
    {"STAGES": 6, "STAGE_BYTES": 32768, "STAGED_CTAS_PER_SM": 1, "STORE_LAG": 1,
     "COPY_STAGES": 12, "COPY_CHUNK": 16384, "COPY_CTAS_PER_SM": 1, "COPY_STORE_LAG": 2,
     "LOAD_EVICT": 1, "STORE_EVICT": 0},
    {"STAGES": 6, "STAGE_BYTES": 32768, "STAGED_CTAS_PER_SM": 1, "STORE_LAG": 1,
     "COPY_STAGES": 12, "COPY_CHUNK": 16384, "COPY_CTAS_PER_SM": 1, "COPY_STORE_LAG": 2,
     "LOAD_EVICT": 0, "STORE_EVICT": 1},
    {"STAGES": 6, "STAGE_BYTES": 32768, "STAGED_CTAS_PER_SM": 1, "STORE_LAG": 1,
     "COPY_STAGES": 12, "COPY_CHUNK": 16384, "COPY_CTAS_PER_SM": 1, "COPY_STORE_LAG": 2,
     "LOAD_EVICT": 1, "STORE_EVICT": 2},
    {"STAGES": 6, "STAGE_BYTES": 32768, "STAGED_CTAS_PER_SM": 1, "STORE_LAG": 1,
     "COPY_STAGES": 12, "COPY_CHUNK": 16384, "COPY_CTAS_PER_SM": 1, "COPY_STORE_LAG": 2,
     "LOAD_EVICT": 2, "STORE_EVICT": 1},
]
TUNE_ROUNDS = 4


def build_variants(_build, variants):
    """One library per variant of transfer.cu, built in parallel (one
    nvcc each) under ops/_build/tune/."""
    src = (_build.CSRC / "transfer.cu").read_text()
    out_dir = _build.BUILD_DIR / "tune"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, variant in enumerate(variants):
        text = src
        for name, val in variant.items():
            text, hits = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {val};",
                                 text)
            check(hits == 1, f"transfer.cu holds no single constexpr int {name}")
        cu, so = out_dir / f"transfer_v{i}.cu", out_dir / f"libtransfer_v{i}.so"
        cu.write_text(text)
        procs.append((so, subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                                            str(cu)], stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    libs = []
    for i, (so, proc) in enumerate(procs):
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"variant {i} did not build:\n{log}")
        libs.append(ctypes.CDLL(str(so)))
    return libs


def tune_main() -> int:
    """``--tune``: K2 on the 64 MB frame and the u8 stack and copy_blocks
    on the frame, under each of TUNE_VARIANTS, in TUNE_ROUNDS turns that
    alternate the variants' order, beside K1 and out.copy_(src); every
    variant's K2 and copy_blocks held bit-equal first."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from incubator_brpc_tpu_torch.ops import _build
    from incubator_brpc_tpu_torch.ops import transfer as T

    smi = phase_build()
    libs = [T.bind(lib) for lib in build_variants(_build, TUNE_VARIANTS)]
    x = make_payload(torch, MAIN_SHAPE, torch.float32, SEED)
    stack = make_payload(torch, (DMGET_KEYS, CACHE_VALUE), torch.uint8, SEED)
    br, s_br = T._fit_block_rows(x.shape[0]), T._fit_block_rows(DMGET_KEYS)
    xs, ss = cold_pairs(torch, x), cold_pairs(torch, stack)
    keys = ("staged", "staged_stack", "copy_blocks")
    got = [{k: [] for k in keys} for _ in TUNE_VARIANTS]
    ref = {"frame": [], "copy_": []}
    saved = (T._lib, T._STAGE_BYTES, T._STAGED_CTAS_PER_SM, T._COPY_CTAS_PER_SM)
    try:
        for rnd in range(TUNE_ROUNDS):
            order = list(range(len(libs)))
            for i in (order if rnd % 2 == 0 else order[::-1]):
                v = TUNE_VARIANTS[i]
                T._lib, T._STAGE_BYTES = libs[i], v["STAGE_BYTES"]
                T._STAGED_CTAS_PER_SM, T._COPY_CTAS_PER_SM = (v["STAGED_CTAS_PER_SM"],
                                                              v["COPY_CTAS_PER_SM"])
                sr, s_sr = T.staged_plan(x, br).stage_rows, T.staged_plan(stack, s_br).stage_rows
                if rnd == 0:
                    for v, b, r in ((x, br, sr), (stack, s_br, s_sr)):
                        o, a = T._staged_copy_csum(v, b, r)
                        c = T.device_copy(v)
                        torch.cuda.synchronize()
                        check(torch.equal(o, v) and torch.equal(c, v)
                              and torch.equal(a, T.copy_csum_plain(v, None, b)[1]),
                              f"variant {TUNE_VARIANTS[i]} is not bit-equal to plain on "
                              f"{tuple(v.shape)} {v.dtype}")
                got[i]["staged"] += queued_windows(
                    torch, walk(lambda s, o: T._staged_copy_csum(s, br, sr, out=o), xs))
                got[i]["staged_stack"] += queued_windows(
                    torch, walk(lambda s, o: T._staged_copy_csum(s, s_br, s_sr, out=o), ss))
                got[i]["copy_blocks"] += queued_windows(torch, walk(T._launch_copy_blocks, xs))
            T._lib, T._STAGE_BYTES, T._STAGED_CTAS_PER_SM, T._COPY_CTAS_PER_SM = saved
            ref["frame"] += queued_windows(
                torch, walk(lambda s, o: T._copy_csum(s, None, br, out=o), xs))
            ref["copy_"] += queued_windows(torch, walk(lambda s, o: o.copy_(s), xs))
    finally:
        T._lib, T._STAGE_BYTES, T._STAGED_CTAS_PER_SM, T._COPY_CTAS_PER_SM = saved
    bounds = {"staged": copy_bound_ms(x.nbytes, x.numel(), x.shape[1]),
              "staged_stack": copy_bound_ms(stack.nbytes, stack.numel(), stack.shape[1]),
              "copy_blocks": 2 * x.nbytes / HBM_BYTES_PER_S * 1e3}

    def spread(win):
        return f"{statistics.median(win):.4f} ({min(win):.4f}-{max(win):.4f})"

    print(f"[tune] {smi}; ms a call, median (min-max) of {TUNE_ROUNDS} x 3 windows, back to "
          f"back over {COLD_PAIRS} cold pairs; K1 on the frame {spread(ref['frame'])}, "
          f"out.copy_(src) {spread(ref['copy_'])}; bounds "
          + ", ".join(f"{k} {v:.4f}" for k, v in bounds.items()))
    for variant, row in zip(TUNE_VARIANTS, got):
        print(f"[tune] K2 {variant['STAGES']} x {variant['STAGE_BYTES']} B, "
              f"{variant['STAGED_CTAS_PER_SM']} CTA/SM; copy_blocks {variant['COPY_STAGES']} x "
              f"{variant['COPY_CHUNK']} B, {variant['COPY_CTAS_PER_SM']} CTA/SM; store lags "
              f"{variant['STORE_LAG']}, {variant['COPY_STORE_LAG']}; L2 evict (0 normal, 1 first, "
              f"2 last) loads {variant['LOAD_EVICT']}, stores {variant['STORE_EVICT']}: "
              + "; ".join(f"{k} {spread(row[k])} {bounds[k] / statistics.median(row[k]):.0%}"
                          for k in keys))
    print(json.dumps({"card": smi, "variants": TUNE_VARIANTS, "ms": got, "ref": ref,
                      "bounds": bounds}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--times", metavar="ROOT",
                    help="only the transmit times, for the package of the checkout at ROOT")
    ap.add_argument("--tune", action="store_true",
                    help="only K2's and copy_blocks' times under each of TUNE_VARIANTS")
    ap.add_argument("--witness-child", metavar="DEVICE", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.times is not None:
        return times_main(args.times)
    if args.tune:
        return tune_main()
    if args.witness_child is not None:  # [witness]'s child: arms before torch loads
        return witness_child(args.witness_child)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from incubator_brpc_tpu_torch.ops import transfer as T

    # a run that outlives its budget dumps every thread's stack and exits
    faulthandler.dump_traceback_later(RUN_DEADLINE_S, exit=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    native_build = start_native_build()  # g++/gcc beside the nvcc builds
    smi = phase_build()
    errs, main_csum = phase_kernels(torch, T)
    echo_counts = phase_echo(torch, T, main_csum)
    ps_counts, products, ps_summary = phase_ps(torch, T)
    shard_counts, shard_summary = phase_shard(torch, T, ps_summary)
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
    http_counts, http_trace = phase_http(torch, T)
    mesh_counts, _ = phase_mesh(torch, T, ps_summary)
    native_counts, _ = phase_native(torch, T, smi, native_build, ps_summary, shard_summary)
    check(not any(native_counts.values()), f"the native path launched {native_counts}")
    proto_counts, _ = phase_proto(torch, T, smi, ps_summary)
    check(not any(proto_counts.values()), f"the protocols' path launched {proto_counts}")
    witness = phase_witness(torch, smi)
    paths = [echo_counts, ps_counts, shard_counts, cache_counts, stream_counts, dcn_counts,
             cluster_counts, http_counts, mesh_counts, native_counts, proto_counts]
    totals = {k: sum(c[k] for c in paths) for k in T.launches}
    print(f"[paths] launches: echo {echo_counts}; ps {ps_counts}; shard {shard_counts}; "
          f"cache {cache_counts}; stream {stream_counts}; dcn {dcn_counts} (child "
          f"{dcn_child_counts}); cluster {cluster_counts}; serve {serve_counts}; "
          f"http {http_counts}; mesh {mesh_counts}; native {native_counts}; proto "
          f"{proto_counts}; witness "
          f"(child, its whole run) "
          f"{witness['launches']}")
    for name, c in [("shard", shard_counts), ("dcn", dcn_counts), ("cluster", cluster_counts),
                    ("http", http_counts), ("mesh", mesh_counts)]:
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
    # the /hotspots/device capture's profiler trace, beside [times]
    rows[0]["http_capture_trace_ms"] = http_trace["k1_trace_ms"]
    if "k2_trace_ms" in http_trace:
        rows[1]["http_capture_trace_ms"] = http_trace["k2_trace_ms"]
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
