"""The port's sanitizer lanes: its native code under a sanitizer.

    python -m incubator_brpc_tpu_torch.tools.sanitize              # asan
    python -m incubator_brpc_tpu_torch.tools.sanitize tsan -k mux  # extra args to pytest
    python -m incubator_brpc_tpu_torch.tools.sanitize cuda         # needs the card
    python -m incubator_brpc_tpu_torch.tools.sanitize --launch-cases [--device cpu] [--guarded]

``asan`` (ASan + UBSan, the default) and ``tsan`` build the native
engine (``native/engine.cpp``, ``fastcall.c``) and ``utils/murmur3.c``
instrumented (``BRPC_NATIVE_SANITIZE`` selects the flags and a target
name of their own) and run the port's engine tests on the CPU against
them, the sanitizer runtime preloaded because stock CPython is not
linked against it.  ASan's leak checking stays off: the interpreter's
arenas live as long as the process, and the lane is after memory
safety and undefined behaviour.  ``tsan`` fails on any report
(``exitcode=66``); ``tsan.supp`` beside this file carries the one
glibc-owned suppression.  A toolchain without the mode's runtimes exits
2.

``cuda`` runs ``compute-sanitizer`` (memcheck, racecheck, synccheck and
initcheck in turn) over ``--launch-cases``, the case launcher below,
with only the port's three kernels instrumented.  The kernels are built
first, outside the tool.  Without the tool it raises naming the path it
looked for; without a card it raises; a card the tool refuses
(``Device not supported``) raises :class:`SanitizerUnsupported` with
the tool's own words, before any case runs.

``--launch-cases`` launches each kernel on reduced versions of the
``kernels`` cases of ``chip_smoke.py`` (the same dtypes and row widths,
at most 2 MiB each): K1 whole with its fold, with a carry, chained
chunks and into an ``out=`` slot; K2 and K2 into a slot; K1 and K2 asked
for the frame's checksum, their in-tail scalars held to the plain
fold; ``copy_blocks`` fresh and into ``out=``.  It runs on the card unless ``--device cpu``
is given, and raises without one.  Every result is held bit-equal to
the plain version on the same device; it exits 0 only if every one is
and, on the card, every kernel launched.  On the CPU every wrapper runs
the plain version, so ``--device cpu`` checks the plain version's own
invariants (chunks chain to the whole frame, a slot equals a fresh
output, K2's path equals K1's) and launches nothing.  ``--guarded``
adds the checks that need no tool: each output lies between two
poisoned guard bands that must come back untouched, outputs start
poisoned and each K1/K2 launch is handed a scratch ``partial`` of NaNs
(an element a kernel does not write, or reads before writing, shows as
a mismatch), every launch plan's arrival counters (the frame's
included) must be back at zero after every launch, and on the card the cases run on two streams at once: both are
held behind one gate until the host has queued them (after a first run
on the current stream), and events on each must bracket intervals that
overlap.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = pathlib.Path(__file__).resolve().parents[2]
TSAN_SUPP = pathlib.Path(__file__).resolve().with_name("tsan.supp")

# the JAX lane's five files, in the port: the engine with its multi-
# protocol port and fast-path pool (test_torch_native.py holds all
# three), the rings, chaos with its native.* sites, and murmur3.
# test_torch_protocol_matrix.py has no case that runs the engine
LANE_TESTS = (
    "tests/test_torch_native.py",
    "tests/test_torch_ring.py",
    "tests/test_torch_chaos.py",
    "tests/test_torch_hashes.py",
)
# tsan only: the one lane case that runs an XLA computation (the JAX
# package's PsService Forward, held against the port's) on threads the
# JAX package's engine started; its port half, the batched Forwards
# through the port engine's burst collector, is a case of its own
# (test_forward_through_the_engine_batches) that the lane runs.  XLA's
# CPU runtime (libjax_common.so) is not instrumented, so TSan sees its
# new/delete and memcpy but not the atomics that order them, and reports
# races inside tsl::AsyncValue and xla::CpuAsyncExecutionTracker;
# ignoring that library's interceptors (called_from_lib) unpairs its
# mutexes instead.  The JAX package's own lane runs no XLA computation
# on engine threads and reports nothing
TSAN_DESELECT = (
    "tests/test_torch_native.py::"
    "test_forward_through_the_engine_batches_and_equals_the_jax_package",
)
ASAN_OPTIONS = "detect_leaks=0:abort_on_error=1"
UBSAN_OPTIONS = "print_stacktrace=1:halt_on_error=1"

CUDA_TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
COMPUTE_SANITIZER = pathlib.Path("/usr/local/cuda/bin/compute-sanitizer")
# transfer.cu's kernels, as substrings of their mangled names
KERNELS = ("copy_csum_blocks_kernel", "copy_csum_staged_kernel", "copy_blocks_kernel")
UNSUPPORTED = "Device not supported"
TOOL_TIMEOUT_S = 600

SEED = 1234
# chip_smoke.py's phase_kernels cases, each cut to at most 2 MiB by its
# rows (or, for the DMGET stack, its row width): (case, shape, dtype)
CASES = (
    ("echo frame (8192, 2048) f32", (256, 2048), "float32"),
    ("W (6144, 6144) f32", (64, 6144), "float32"),
    ("(320, 256) f32", (320, 256), "float32"),
    ("(1000, 128) f32", (1000, 128), "float32"),
    ("(1, 128) f32", (1, 128), "float32"),
    ("(4096, 1024) bf16", (512, 1024), "bfloat16"),
    ("ragged tile (1000, 384) u8", (1000, 384), "uint8"),
    ("(512, 256) i32", (512, 256), "int32"),
    ("(768, 512) f16", (768, 512), "float16"),
    ("1 MiB value (256, 4096) u8", (256, 4096), "uint8"),
    ("4 KB value (1, 4096) u8", (1, 4096), "uint8"),
    ("DMGET stack (32, 1048576) u8", (32, 65536), "uint8"),
    ("stream frame (256, 1024) f32", (256, 1024), "float32"),
)
GUARD_BYTES = 4096  # each guard band; keeps the output 16-byte aligned
# ~0.25 s of the card's clock: far longer than the host takes to queue
# both streams' launches of one case once its kernels are loaded (1-2 ms
# on an H100's host; a kernel's first launch held it 100 ms and more)
GATE_CYCLES = 500_000_000
POISON = 0xFF  # a NaN in every float type, -1 in the integers


class LaneError(RuntimeError):
    """A host lane cannot run: the toolchain lacks the mode's runtime."""


class SanitizerUnsupported(RuntimeError):
    """compute-sanitizer refuses this card; the message is the tool's."""


# ---------------------------------------------------------------------------
# asan / tsan: the engine and murmur3 on the CPU
# ---------------------------------------------------------------------------


def host_lane(mode: str, pytest_args: Sequence[str] = (),
              env: Optional[Dict[str, str]] = None) -> Tuple[List[str], Dict[str, str]]:
    """(argv, environment) of the ``mode`` lane's pytest run.  Raises
    LaneError when the mode's runtime libraries are missing."""
    from incubator_brpc_tpu_torch import native

    if mode not in ("asan", "tsan"):
        raise ValueError(f"host lane mode {mode!r}: expected asan or tsan")
    preload = native.sanitizer_preload(mode)
    if not preload:
        raise LaneError(f"sanitizer runtime(s) for {mode!r} not found in this toolchain")
    env = dict(os.environ if env is None else env)
    if mode == "asan":
        env["ASAN_OPTIONS"] = env.get("ASAN_OPTIONS") or ASAN_OPTIONS
        env["UBSAN_OPTIONS"] = env.get("UBSAN_OPTIONS") or UBSAN_OPTIONS
    else:
        env["TSAN_OPTIONS"] = env.get("TSAN_OPTIONS") or (
            f"halt_on_error=0:exitcode=66:suppressions={TSAN_SUPP}")
    env["BRPC_NATIVE_SANITIZE"] = mode
    env["LD_PRELOAD"] = preload
    env["JAX_PLATFORMS"] = "cpu"  # the lane's tests hold the port to the JAX package
    deselect = [arg for case in TSAN_DESELECT for arg in ("--deselect", case)] \
        if mode == "tsan" else []
    argv = [sys.executable, "-m", "pytest", *LANE_TESTS, "-q", "-m", "not slow",
            "-p", "no:cacheprovider", *deselect, *pytest_args]
    return argv, env


# ---------------------------------------------------------------------------
# cuda: compute-sanitizer over the case launcher
# ---------------------------------------------------------------------------


def compute_sanitizer() -> str:
    """The compute-sanitizer on PATH, else the toolkit's; raises
    FileNotFoundError naming where it looked."""
    found = shutil.which("compute-sanitizer")
    if found:
        return found
    if COMPUTE_SANITIZER.exists():
        return str(COMPUTE_SANITIZER)
    raise FileNotFoundError(
        f"compute-sanitizer not found on PATH or at {COMPUTE_SANITIZER}")


def kernel_filter(tool: str) -> List[str]:
    """The options that instrument only transfer.cu's kernels: ``--filter``
    where the toolkit has it, ``--kernel-name`` on an older one (each
    option adds its kernels to the checked set)."""
    shown = subprocess.run([tool, "--help"], capture_output=True, text=True,
                           timeout=60).stdout
    opt = "--filter" if "--filter " in shown else "--kernel-name"
    return [arg for k in KERNELS for arg in (opt, f"kns={k}")]


def cuda_commands(tool: str, filt: Sequence[str], device: str) -> List[Tuple[str, List[str]]]:
    """(tool name, argv) of each compute-sanitizer run over the cases."""
    launcher = [sys.executable, "-m", "incubator_brpc_tpu_torch.tools.sanitize",
              "--launch-cases", "--device", device]
    return [(t, [tool, "--tool", t, "--error-exitcode", "1", *filt, *launcher])
            for t in CUDA_TOOLS]


def _run(argv: Sequence[str]) -> Tuple[int, str, float]:
    t0 = time.perf_counter()
    proc = subprocess.run(list(argv), capture_output=True, text=True, cwd=ROOT,
                          timeout=TOOL_TIMEOUT_S)
    return proc.returncode, proc.stdout + proc.stderr, time.perf_counter() - t0


def cuda_lane(device: str = "cuda:0") -> List[dict]:
    """Each tool's run over the launch cases: {tool, rc, seconds,
    launches, report}.  Raises where no run can be made (no tool, no
    card, a card the tool refuses)."""
    tool = compute_sanitizer()
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the cuda lane needs a CUDA card; none is visible")
    from incubator_brpc_tpu_torch.ops import _build

    _build.build_all()  # outside the tool: nvcc is not what it checks
    rc, out, _ = _run([tool, "--tool", "memcheck", sys.executable, "-c",
                       f"import torch; torch.zeros(1, device={device!r}); "
                       f"torch.cuda.synchronize()"])
    if UNSUPPORTED in out:
        lines = [ln for ln in out.splitlines() if ln.startswith("=========")]
        raise SanitizerUnsupported("\n".join(lines[:4]))
    results = []
    for name, argv in cuda_commands(tool, kernel_filter(tool), device):
        rc, out, secs = _run(argv)
        summary = next((json.loads(ln[len("LAUNCH_CASES "):]) for ln in out.splitlines()
                        if ln.startswith("LAUNCH_CASES ")), {})
        results.append({
            "tool": name, "rc": rc, "seconds": secs,
            "launches": sum(summary.get("launches", {}).values()),
            "report": [ln for ln in out.splitlines() if ln.startswith("=========")],
        })
    return results


# ---------------------------------------------------------------------------
# the case launcher
# ---------------------------------------------------------------------------


def _payload(torch, shape, dtype, seed, device):
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        x = torch.randn(shape, generator=g).to(dtype)
    elif dtype == torch.uint8:
        x = torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)
    else:
        x = torch.randint(-(1 << 20), 1 << 20, shape, generator=g).to(dtype)
    return x.to(device)


class _Guarded:
    """Output buffers between poisoned guard bands, poisoned scratch, and
    the checks --guarded adds around each launch."""

    def __init__(self, torch, T, device):
        self.torch, self.T, self.device = torch, T, device
        self.bands: List[Tuple[str, object]] = []

    def empty(self, what, like):
        """A poisoned tensor shaped as ``like`` between two guard bands."""
        torch = self.torch
        nbytes = like.numel() * like.element_size()
        buf = torch.full((2 * GUARD_BYTES + nbytes,), POISON, dtype=torch.uint8,
                         device=self.device)
        self.bands.append((what, buf))
        view = buf[GUARD_BYTES:GUARD_BYTES + nbytes].view(like.dtype)
        return view.view(like.shape)

    def scratch(self, rows, n, block_rows):
        """A kernel's ``partial`` (one float32 row a row block), all NaN:
        an element read before the kernel wrote it reaches the
        accumulator as a NaN."""
        return self.torch.full((rows // block_rows, n), float("nan"), device=self.device)

    def problems(self) -> List[str]:
        torch = self.torch
        found = []
        for what, buf in self.bands:
            for band in (buf[:GUARD_BYTES], buf[-GUARD_BYTES:]):
                if not bool((band == POISON).all()):
                    found.append(f"{what}: a guard band was written")
        self.bands.clear()
        for key, plan in self.T.PLANS.items():
            if plan.counters is not None and int(torch.count_nonzero(plan.counters)):
                found.append(f"arrival counters of {key} not back at zero")
        return found


def launch_cases(device=None, guarded: bool = False) -> dict:
    """Run every case's launches on ``device`` (default: the card,
    through ``device_for_chip(0)``, which raises without one) against the
    plain version.  Returns {device, cases, launches, checks, overlaps,
    mismatches}; ``overlaps`` counts the guarded cases whose two streams
    were in flight at once."""
    import torch

    from incubator_brpc_tpu_torch.ops import transfer as T
    from incubator_brpc_tpu_torch.parallel.mesh import device_for_chip

    dev = device_for_chip(0, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    T.reset_launch_counts()
    mismatches: List[str] = []
    checks = overlaps = 0

    def hold(name, got, want):
        nonlocal checks
        checks += 1
        if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(
                got.reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8)):
            mismatches.append(name)

    # guarded on the card: each case runs first on the current stream
    # (a first launch of a kernel loads it, which holds the host), then
    # on two streams of its own, both held behind one gate (a sleep on
    # the current stream) until the host has queued both, so that they
    # run at once; events bracket each
    concurrent = guarded and dev.type == "cuda"
    side = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)] if concurrent else []
    main = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    for i, (case, shape, dtype_name) in enumerate(CASES):
        dtype = getattr(torch, dtype_name)
        x = _payload(torch, shape, dtype, SEED + i, dev)
        m, n = shape
        br = T._fit_block_rows(m)
        carry = torch.randn((1, n), generator=torch.Generator().manual_seed(i)).to(dev)
        zeros = torch.zeros((1, n), dtype=torch.float32, device=dev)
        _, acc_p = T.copy_csum_plain(x, None, br)
        _, acc_pc = T.copy_csum_plain(x, carry, br)
        sr = T.staged_plan(x, br).stage_rows
        _, _, chunks = T.chunk_plan_for(x, max(1, x.nbytes // 4))
        runs = []
        for s in [None, *side]:
            if s is not None and s is side[0]:
                gate = torch.cuda.Event(enable_timing=True)
                gate.record()
                torch.cuda._sleep(GATE_CYCLES)
            g = _Guarded(torch, T, dev) if guarded else None

            def out(what, g=g):
                return g.empty(what, x) if g else torch.empty_like(x)

            def scratch(rows=m, g=g):
                return g.scratch(rows, n, br) if g else None

            ctx = torch.cuda.stream(s) if s is not None else contextlib.nullcontext()
            with ctx:
                if s is not None:
                    s.wait_stream(main)
                    span = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
                    span[0].record(s)
                got = {}
                got["K1 whole"] = T._copy_csum(x, None, br, out("K1 whole"), scratch())
                got["K1 carry"] = T._copy_csum(x, carry, br, out("K1 carry"), scratch())
                acc_c, outs = zeros, []
                for off, rows in chunks:
                    o, acc_c = T._copy_csum(x[off:off + rows], acc_c, br, None, scratch(rows))
                    outs.append(o)
                got["K1 chained"] = (torch.cat(outs), acc_c)
                got["K1 slot"] = T._copy_csum(x, zeros, br, out("K1 slot"), scratch())
                got["K2"] = T._staged_copy_csum(x, br, sr, out("K2"), scratch())
                k2_slot, k2_acc = T._staged_copy_csum(x, br, sr, out("K2 slot"), scratch())
                k2_csum = T.fold_checksum(k2_acc)
                # launches that end a frame: its checksum folded in their tail
                tails = {"K1 tail": T._transmit_blocks(x, br, None, out("K1 tail")),
                         "K2 tail": T._transmit_staged(x, br, sr, out("K2 tail"))}
                _, k1_csum = T.device_copy_with_checksum(x)
                copy_fresh = T.device_copy(x)
                copy_into = T.device_copy(x, out=out("copy_blocks out="))
                if s is not None:
                    span[1].record(s)
            runs.append((s, got, tails, k2_slot, k2_csum, k1_csum, copy_fresh, copy_into, g,
                         span if s is not None else None))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if concurrent:
            (a0, b0), (a1, b1) = [[gate.elapsed_time(e) for e in r[-1]] for r in runs[1:]]
            if a1 < b0 and a0 < b1:
                overlaps += 1
            else:
                mismatches.append(f"{case}: the two streams did not run at once "
                                  f"({a0:.3f}-{b0:.3f} ms, {a1:.3f}-{b1:.3f} ms)")
        for j, (s, got, tails, k2_slot, k2_csum, k1_csum, copy_fresh, copy_into, g, _) in \
                enumerate(runs):
            tag = f"{case}" + (f" (stream {j})" if s is not None else "")
            for name, (o, acc) in got.items():
                hold(f"{name} copy, {tag}", o, x)
                hold(f"{name} accumulator, {tag}", acc, acc_pc if name == "K1 carry" else acc_p)
            hold(f"K2 slot copy, {tag}", k2_slot, x)
            csum_p = T.fold_checksum(acc_p)
            hold(f"K2 slot checksum, {tag}", k2_csum, csum_p)
            hold(f"K1 fold tail checksum, {tag}", k1_csum, csum_p)
            for name, (o, csum) in tails.items():
                hold(f"{name} copy, {tag}", o, x)
                hold(f"{name} checksum, {tag}", csum, csum_p)
            hold(f"copy_blocks, {tag}", copy_fresh, x)
            hold(f"copy_blocks out=, {tag}", copy_into, x)
            if g is not None:
                mismatches.extend(f"{p}, {tag}" for p in g.problems())
    return {"device": str(dev), "cases": len(CASES), "launches": dict(T.launches),
            "checks": checks, "overlaps": overlaps, "mismatches": mismatches}


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--launch-cases":
        ap = argparse.ArgumentParser(prog="sanitize --launch-cases")
        ap.add_argument("--device", default=None,
                        help="default: the card (raises without one); cpu checks the "
                             "plain versions' invariants")
        ap.add_argument("--guarded", action="store_true")
        args = ap.parse_args(argv[1:])
        summary = launch_cases(args.device, args.guarded)
        print("LAUNCH_CASES " + json.dumps(summary), flush=True)
        # on the card, a kernel that never launched checked nothing
        unlaunched = summary["device"].startswith("cuda") and not all(
            summary["launches"].values())
        return 1 if summary["mismatches"] or unlaunched else 0
    mode = argv.pop(0) if argv and not argv[0].startswith("-") else "asan"
    if mode == "cuda":
        results = cuda_lane()
        for r in results:
            print(f"{r['tool']}: rc {r['rc']}, {r['launches']} launches checked, "
                  f"{r['seconds']:.1f} s")
            for line in r["report"]:
                print(f"  {line}")
        return 1 if any(r["rc"] for r in results) else 0
    if mode not in ("asan", "tsan"):
        print(f"usage: sanitize [asan|tsan|cuda] [pytest args...] | --launch-cases "
              f"[--device DEV] [--guarded]", file=sys.stderr)
        return 2
    try:
        cmd, env = host_lane(mode, argv)
    except LaneError as e:
        print(e, file=sys.stderr)
        return 2
    return subprocess.call(cmd, env=env, cwd=ROOT)


if __name__ == "__main__":
    sys.exit(main())
