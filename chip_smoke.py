#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (incubator_brpc_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout around this
file.  Phases, each fatal on failure:

1. build   — compile ops/csrc/*.cu for sm_90a (one nvcc per source, in
             parallel) and print the card's name and power limit;
2. kernels — hold each hand-written kernel against its plain PyTorch
             version on the card: copied bytes equal, lane accumulator
             within 1e-5 * sum|x| per lane, and the checksum bit-equal
             across K1 whole frame, K1 chained chunks, K1 into a slot,
             the fused chunk path and K2; copy_blocks byte-equal, into
             its out= buffer or a fresh one;
3. echo    — the first main path: a 64 MB float32 (8192, 2048) tensor
             echoed through Server.start_ici / Channel under every chunk
             mode (off, fused, pipelined, pallas).  Per mode: the
             response equals the request, is a fresh CUDA tensor,
             carries the whole-frame checksum, and each kernel of the
             mode launched the expected number of times per hop.  Prints
             the marginal per-echo time (chained hi - lo echoes,
             synchronized);
4. ps      — the second main path: the batched parameter server at
             d = 6144 (bench.py's bench_batched_device_op width) on
             Server(enable_batching=True).start_ici.  A seeded (6144,
             6144) float32 W is Put and Got back over ici:// (byte-equal,
             a fresh CUDA tensor, K1's whole-frame checksum, one K1 and
             one fold per hop); Forward runs closed-loop at parallelism
             1 and 32 with batching off and on (bucket 32), every y held
             to x.double() @ W.double() within 2e-6 * (|x| @ |W|); a
             control product with TF32 on must fail that same check.
             Prints Put/Get time and GB/s, qps/p50/p99 per point, the
             on/off speedup and a profiler window's device-busy share;
5. times   — each kernel's time at the main path's shapes beside its
             bound, its plain version and x.clone(), and K1 on the PS
             path's W; the Forward product (torch.matmul, an XLA op in
             the reference) per bucket.

The line before the last is the card's name and power limit; the last
line is {"ok": true, "device": {...}}.  Without a card, or without the
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import threading
import time

SEED = 1234
MAIN_SHAPE = (8192, 2048)  # 64 MB of float32: bench.py's bench_ici_rpc payload
RTOL = 1e-5  # lane accumulator vs plain, relative to sum|x| per lane
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
PS_DIM = 6144  # bench.py:2044, bench_batched_device_op's dim
PS_RTOL = 2e-6  # Forward y vs float64, relative to |x| @ |W|: f32 passes, TF32 fails
SOURCE = "incubator_brpc_tpu_torch/ops/csrc/transfer.cu"
REPLACES = {
    "copy_csum_blocks": "incubator_brpc_tpu/ops/transfer.py:112 (+:176, :202)",
    "fold_blocks": "incubator_brpc_tpu/ops/transfer.py:112 (+:176, :202, :388; the lane carry)",
    "copy_csum_staged": "incubator_brpc_tpu/ops/transfer.py:388",
    "copy_blocks": "incubator_brpc_tpu/ops/transfer.py:68 (device_copy :59, _copy_kernel :54)",
}
# no path of either package calls device_copy: chip_smoke launches
# copy_blocks only in these phases, never on a main path
OFF_PATH = {"copy_blocks": "kernels, times"}
# per hop of a 64 MB frame at 8 MB chunks (8 chunks): expected launches
PER_HOP = {
    "off": {"copy_csum_blocks": 1, "fold_blocks": 1, "copy_csum_staged": 0},
    "fused": {"copy_csum_blocks": 1, "fold_blocks": 1, "copy_csum_staged": 0},
    "pipelined": {"copy_csum_blocks": 8, "fold_blocks": 8, "copy_csum_staged": 0},
    "pallas": {"copy_csum_blocks": 0, "fold_blocks": 1, "copy_csum_staged": 1},
}
for _per in PER_HOP.values():
    _per["copy_blocks"] = 0


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
    being each kernel's max |acc - plain| at the main path's shape."""
    cases = [
        (MAIN_SHAPE, torch.float32),
        ((PS_DIM, PS_DIM), torch.float32),  # the PS path's W: 1152 K1 CTAs
        ((320, 256), torch.float32),   # m not a chunk multiple
        ((1000, 128), torch.float32),  # block rows fall to 8
        ((1, 128), torch.float32),     # single row
        ((4096, 1024), torch.bfloat16),
        ((1000, 384), torch.uint8),
        ((512, 256), torch.int32),
        ((768, 512), torch.float16),
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

        tol = RTOL * x.float().abs().sum(0, keepdim=True)
        for key, acc in [("copy_csum_blocks", acc_w), ("copy_csum_staged", acc_k2)]:
            err = (acc - acc_p).abs()
            check(bool((err <= tol).all()),
                  f"{key} lane accumulator off by {err.max().item()} for {dtype}{shape}")
            if shape == MAIN_SHAPE:
                errs[key] = err.max().item()
        for name, acc in [("K1 chained", acc_c), ("K1 slot", acc_s), ("K2", acc_k2)]:
            check(torch.equal(acc, acc_w), f"{name} accumulator not bit-equal to K1 ({dtype}{shape})")
        csum_w = T.fold_checksum(acc_w)
        for name, cs in [("fused", csum_f), ("K2 slot", csum_k2i)]:
            check(torch.equal(cs, csum_w), f"{name} checksum not bit-equal to K1 ({dtype}{shape})")

        # the fold alone against its plain loop (same order: bit-equal)
        partial = torch.randn((m // br, n), generator=torch.Generator().manual_seed(i)).cuda()
        carry = torch.randn((1, n), generator=torch.Generator().manual_seed(-i - 1)).cuda()
        ref = carry.clone()
        for b in range(partial.shape[0]):
            ref = ref + partial[b:b + 1]
        got = T._launch_fold_blocks(partial, carry)
        check(torch.equal(got, ref), f"fold_blocks differs from its plain loop ({shape})")
        if shape == MAIN_SHAPE:
            errs["fold_blocks"] = (got - ref).abs().max().item()
            main_csum = csum_w
        print(f"[kernels] {str(dtype):15} {str(shape):13} br={br:3} chunks={len(chunks)} "
              f"stage_rows={sr} ok; K1 err {(acc_w - acc_p).abs().max().item():.3g}, "
              f"K2 err {(acc_k2 - acc_p).abs().max().item():.3g}")
    print(f"[kernels] tolerance: |acc - plain| <= {RTOL} * sum|x| per lane; "
          f"copies (K1, K2, copy_blocks) byte-equal; checksums bit-equal across "
          f"K1/chained/slot/fused/K2")
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
            # fused mode: one K1 over the frame's chunk plan and one fold per hop
            per_hop = 1 if k in ("copy_csum_blocks", "fold_blocks") else 0
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
            err = (got.double() - ref[idx]).abs()
            return int((err > PS_RTOL * scale[idx]).sum()), (err / scale[idx]).max().item()

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
        products = phase_products(torch, w_dev)
    finally:
        for c in channels:
            c.close()
        srv.stop()
    return counts, products


def phase_products(torch, w, buckets=(1, 8, 32), iters=20):
    """The Forward product (bucket, d) @ W alone, per bucket: device time
    from the profiler, beside its bound."""
    d = w.shape[0]
    from incubator_brpc_tpu_torch.models.parameter_server import _FORWARD_KERNEL

    rows = []
    for b in buckets:
        x = torch.randn((b, d), generator=torch.Generator(device=w.device).manual_seed(b),
                        device=w.device)
        _FORWARD_KERNEL(w, x)
        _, busy_us, by_name = device_profile(
            torch, lambda: [_FORWARD_KERNEL(w, x) for _ in range(iters)])
        check(busy_us > 0, f"the profiler saw no product at bucket {b}")
        ms = busy_us / iters / 1e3
        t_bytes = (w.nbytes + 2 * b * d * 4) / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * b * d * d / F32_OPS_PER_S * 1e3
        kernel = max(by_name, key=by_name.get)
        rows.append({
            "name": f"ps_forward_b{b}", "route": "torch.matmul",
            "source": "incubator_brpc_tpu_torch/models/parameter_server.py",
            "replaces": "incubator_brpc_tpu/models/parameter_server.py:101 "
                        "(x @ w under jax.jit: an XLA op, not a TPU kernel)",
            "ms": ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "kernel": kernel[:80],
        })
        print(f"[times] Forward product b={b:2} d={d}: {ms:.4f} ms (bound "
              f"{max(t_bytes, t_ops):.4f} ms by {rows[-1]['bound_by']}); {kernel[:60]}")
    return rows


def kernel_ms(torch, fn, kernel: str, iters: int = 20) -> float:
    """Device time of one launch of ``kernel`` (a substring of its
    symbol), from the profiler's CUDA events over iters calls of fn.
    Timing back-to-back launches with CUDA events instead would measure
    the host's launch rate for a kernel of a few microseconds."""
    fn()
    _, _, by_name = device_profile(torch, lambda: [fn() for _ in range(iters)])
    us = sum(v for k, v in by_name.items() if kernel in k)
    check(us > 0, f"the profiler saw no {kernel} launch")
    return us / iters / 1e3


def phase_times(torch, T, errs, totals):
    """Each kernel alone at the main path's shapes: its device time
    from the profiler; plain versions and x.clone() by CUDA events."""
    x = make_payload(torch, MAIN_SHAPE, torch.float32, SEED)
    m, n = MAIN_SHAPE
    br = T._fit_block_rows(m)
    sr = T.pallas_stage_rows(x, br)
    nb = m // br
    out = torch.empty_like(x)
    partial = torch.empty((nb, n), dtype=torch.float32, device=x.device)
    T._launch_copy_csum_blocks(x, out, partial, br)

    def plain_fold():
        acc = torch.zeros((1, n), dtype=torch.float32, device=x.device)
        for b in range(nb):
            acc = acc + partial[b:b + 1]
        return acc

    clone_ms = cuda_ms(torch, lambda: x.clone())
    plain_ms = cuda_ms(torch, lambda: T.copy_csum_plain(x, None, br), iters=5)
    # the function reads x and writes its copy and the (1, n) f32
    # accumulator; the kernels' own partial scratch is not counted
    copy_bytes = 2 * x.nbytes + 4 * n
    fold_bytes = partial.nbytes + 4 * n
    rows = []
    for name, fn, plain, nbytes, ops in [
        ("copy_csum_blocks", lambda: T._launch_copy_csum_blocks(x, out, partial, br),
         plain_ms, copy_bytes, m * n),
        ("fold_blocks", lambda: T._launch_fold_blocks(partial, None),
         cuda_ms(torch, plain_fold, iters=5), fold_bytes, nb * n),
        ("copy_csum_staged", lambda: T._launch_copy_csum_staged(x, out, partial, br, sr),
         plain_ms, copy_bytes, m * n),
        # a pure copy does no arithmetic: bound by its 2 x 64 MiB alone
        ("copy_blocks", lambda: T._launch_copy_blocks(x, out),
         cuda_ms(torch, lambda: T.device_copy_plain(x)), 2 * x.nbytes, 0),
    ]:
        ms = kernel_ms(torch, fn, f"{name}_kernel")
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_OPS_PER_S * 1e3
        row = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": totals[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
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
        print(f"[times] {name:17} {ms:.4f} ms (bound {max(t_bytes, t_ops):.4f} ms, "
              f"plain {plain:.4f} ms, x.clone() {clone_ms:.4f} ms)")
    # K1 at the width the PS path gives it: W, (6144, 6144) f32
    w = make_payload(torch, (PS_DIM, PS_DIM), torch.float32, SEED)
    w_out = torch.empty_like(w)
    w_br = T._fit_block_rows(PS_DIM)
    w_partial = torch.empty((PS_DIM // w_br, PS_DIM), dtype=torch.float32, device=w.device)
    w_ms = kernel_ms(torch, lambda: T._launch_copy_csum_blocks(w, w_out, w_partial, w_br),
                     "copy_csum_blocks_kernel")
    w_bound = max((2 * w.nbytes + 4 * PS_DIM) / HBM_BYTES_PER_S,
                  w.numel() / F32_OPS_PER_S) * 1e3
    rows[0].update(ps_w_ms=w_ms, ps_w_bound_ms=w_bound)
    print(f"[times] copy_csum_blocks on W {w.shape[0]}x{w.shape[1]} f32: {w_ms:.4f} ms "
          f"(bound {w_bound:.4f} ms, {w_ms / w_bound:.2f}x)")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from incubator_brpc_tpu_torch.ops import transfer as T

    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    smi = phase_build()
    errs, main_csum = phase_kernels(torch, T)
    echo_counts = phase_echo(torch, T, main_csum)
    ps_counts, products = phase_ps(torch, T)
    totals = {k: echo_counts[k] + ps_counts[k] for k in T.launches}
    print(f"[paths] launches: echo {echo_counts}; ps {ps_counts}")
    for k, v in totals.items():
        if k in OFF_PATH:  # no caller in either package: never on a path
            check(v == 0, f"kernel {k} launched {v} times on a main path")
        else:
            check(v > 0, f"kernel {k} never launched on the main paths")
    rows = phase_times(torch, T, errs, totals)
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
