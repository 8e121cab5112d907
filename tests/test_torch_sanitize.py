"""The port's sanitizer lanes (incubator_brpc_tpu_torch/tools/sanitize.py).

The commands and environments each mode builds are checked here without
running them; the asan and tsan lanes themselves are marked slow, as the
JAX package's lane (tools/sanitize.sh) is not part of tier-1.  The cuda
lane needs the card and compute-sanitizer: here only its refusals and
its commands are checked, and its case launcher runs on the CPU, where
every wrapper is its plain version."""

import pathlib
import subprocess
import sys

import pytest

from incubator_brpc_tpu_torch import native
from incubator_brpc_tpu_torch.tools import sanitize as S
from incubator_brpc_tpu_torch.utils import hashes, sanitize_flags

ROOT = pathlib.Path(__file__).resolve().parents[1]
PRELOADS = {"asan": "/rt/libasan.so:/rt/libubsan.so", "tsan": "/rt/libtsan.so"}


@pytest.fixture
def runtimes(monkeypatch):
    monkeypatch.setattr(native, "sanitizer_preload", lambda mode=None: PRELOADS.get(mode))


@pytest.mark.parametrize("mode", ["asan", "tsan"])
def test_host_lane_builds_its_command_and_environment(runtimes, mode):
    argv, env = S.host_lane(mode, ["-k", "mux"], env={"PATH": "/bin"})
    assert argv[:3] == [sys.executable, "-m", "pytest"]
    assert argv[3:3 + len(S.LANE_TESTS)] == list(S.LANE_TESTS)
    assert argv[-2:] == ["-k", "mux"]
    assert ["-m", "not slow"] == argv[argv.index("-m", 3):argv.index("-m", 3) + 2]
    assert env["BRPC_NATIVE_SANITIZE"] == mode
    assert env["LD_PRELOAD"] == PRELOADS[mode]
    assert env["JAX_PLATFORMS"] == "cpu" and env["PATH"] == "/bin"
    deselected = [argv[i + 1] for i, a in enumerate(argv) if a == "--deselect"]
    assert deselected == (list(S.TSAN_DESELECT) if mode == "tsan" else [])
    if mode == "asan":
        assert env["ASAN_OPTIONS"] == "detect_leaks=0:abort_on_error=1"
        assert env["UBSAN_OPTIONS"] == "print_stacktrace=1:halt_on_error=1"
        assert "TSAN_OPTIONS" not in env
    else:
        assert env["TSAN_OPTIONS"] == (
            f"halt_on_error=0:exitcode=66:suppressions={S.TSAN_SUPP}")
        assert "ASAN_OPTIONS" not in env


def test_host_lane_keeps_options_the_caller_set(runtimes):
    _, env = S.host_lane("asan", env={"ASAN_OPTIONS": "detect_leaks=1"})
    assert env["ASAN_OPTIONS"] == "detect_leaks=1"
    _, env = S.host_lane("tsan", env={"TSAN_OPTIONS": "halt_on_error=1"})
    assert env["TSAN_OPTIONS"] == "halt_on_error=1"


def test_lane_tests_exist_and_cover_the_engine_and_murmur3():
    for path in S.LANE_TESTS:
        assert (ROOT / path).is_file(), path
    for case in S.TSAN_DESELECT:  # a deselected case must name a real test
        path, name = case.split("::")
        assert path in S.LANE_TESTS
        assert f"def {name}(" in (ROOT / path).read_text()
    assert "tests/test_torch_native.py" in S.LANE_TESTS
    assert "tests/test_torch_hashes.py" in S.LANE_TESTS


def test_tsan_suppressions_are_the_jax_lanes(runtimes):
    assert S.TSAN_SUPP.read_bytes() == (ROOT / "tools" / "tsan.supp").read_bytes()
    rules = [ln for ln in S.TSAN_SUPP.read_text().splitlines()
             if ln.strip() and not ln.startswith("#")]
    assert rules == ["race:_dl_deallocate_tls"]
    _, env = S.host_lane("tsan", env={})
    assert pathlib.Path(env["TSAN_OPTIONS"].split("suppressions=")[1]) == S.TSAN_SUPP


@pytest.mark.parametrize("mode", ["asan", "tsan"])
def test_a_missing_runtime_exits_2_and_runs_nothing(monkeypatch, capsys, mode):
    monkeypatch.setattr(native, "sanitizer_preload", lambda mode=None: None)
    monkeypatch.setattr(S.subprocess, "call",
                        lambda *a, **k: pytest.fail("the lane ran without its runtime"))
    assert S.main([mode]) == 2
    assert f"sanitizer runtime(s) for '{mode}' not found" in capsys.readouterr().err


def test_an_unknown_mode_exits_2(capsys):
    assert S.main(["msan"]) == 2
    assert "usage" in capsys.readouterr().err


def test_cuda_mode_raises_without_compute_sanitizer(monkeypatch, tmp_path):
    missing = tmp_path / "cuda" / "bin" / "compute-sanitizer"
    monkeypatch.setattr(S.shutil, "which", lambda name: None)
    monkeypatch.setattr(S, "COMPUTE_SANITIZER", missing)
    with pytest.raises(FileNotFoundError, match=str(missing)):
        S.cuda_lane()
    with pytest.raises(FileNotFoundError):
        S.main(["cuda"])


def test_cuda_mode_raises_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(S, "compute_sanitizer", lambda: "/bin/true")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(S, "_run", lambda argv: pytest.fail("ran without a card"))
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        S.cuda_lane()


def test_cuda_mode_raises_where_the_tool_refuses_the_card(monkeypatch):
    import torch

    from incubator_brpc_tpu_torch.ops import _build

    refused = ("========= COMPUTE-SANITIZER\n========= Error: Device not supported. "
               "Please refer to the \"Supported Devices\" section\nmalloc unknown error\n")
    ran = []
    monkeypatch.setattr(S, "compute_sanitizer", lambda: "/toolkit/compute-sanitizer")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_build, "build_all", lambda: ran.append("build"))
    monkeypatch.setattr(S, "_run", lambda argv: ran.append(argv) or (1, refused, 0.1))
    with pytest.raises(S.SanitizerUnsupported, match="Device not supported"):
        S.cuda_lane()
    # built first, then one probe that launches none of the port's kernels
    assert ran[0] == "build" and len(ran) == 2
    assert "--launch-cases" not in ran[1]


@pytest.mark.parametrize("spelling", ["--filter", "--kernel-name"])
def test_cuda_commands_run_four_tools_over_the_port_kernels_only(monkeypatch, spelling):
    shown = f"  {spelling} arg    key1=val1,...\n  --tool arg\n"
    monkeypatch.setattr(S.subprocess, "run", lambda *a, **k: subprocess.CompletedProcess(
        a[0], 0, stdout=shown, stderr=""))
    filt = S.kernel_filter("/toolkit/compute-sanitizer")
    assert filt == [spelling, "kns=copy_csum_blocks_kernel", spelling,
                    "kns=copy_csum_staged_kernel", spelling, "kns=copy_blocks_kernel"]
    cmds = S.cuda_commands("/toolkit/compute-sanitizer", filt, "cuda:0")
    assert [t for t, _ in cmds] == ["memcheck", "racecheck", "synccheck", "initcheck"]
    for tool, argv in cmds:
        assert argv[:5] == ["/toolkit/compute-sanitizer", "--tool", tool, "--error-exitcode", "1"]
        assert argv[5:11] == filt
        assert argv[11:] == [sys.executable, "-m", "incubator_brpc_tpu_torch.tools.sanitize",
                             "--launch-cases", "--device", "cuda:0"]


@pytest.mark.parametrize("guarded", [False, True])
def test_launch_cases_hold_every_plain_invariant_on_the_cpu(guarded):
    summary = S.launch_cases("cpu", guarded=guarded)
    assert summary["mismatches"] == []
    assert summary["cases"] == 13 == len(S.CASES)
    # 19 checks a case: 5 K1/K2 copies and accumulators, the K2 slot's
    # copy and checksum, the fold's checksum, the copies and in-tail
    # checksums of a K1 and a K2 launch that end a frame, two copy_blocks
    # outputs
    assert summary["checks"] == 19 * 13
    assert summary["launches"] == {"copy_csum_blocks": 0, "copy_csum_staged": 0,
                                   "copy_blocks": 0}


def test_launch_cases_are_the_smokes_shapes_cut_to_size():
    import torch

    dtypes = {"float32", "bfloat16", "uint8", "int32", "float16"}
    for _, (m, n), dtype in S.CASES:
        assert dtype in dtypes
        assert m * n * getattr(torch, dtype).itemsize <= 2 << 20
        assert n % 128 == 0
    shapes = [shape for _, shape, _ in S.CASES]
    assert (1000, 384) in shapes and (1, 4096) in shapes and (32, 65536) in shapes


def test_launch_cases_catch_a_kernel_that_disagrees(monkeypatch):
    import torch

    from incubator_brpc_tpu_torch.ops import transfer as T

    staged = T._staged_copy_csum

    def off_by_one_ulp(x, block_rows, stage_rows, out=None, partial=None):
        out, acc = staged(x, block_rows, stage_rows, out, partial)
        return out, acc.view(torch.int32).add(1).view(acc.dtype)

    monkeypatch.setattr(T, "_staged_copy_csum", off_by_one_ulp)
    summary = S.launch_cases("cpu")
    # every case's K2 accumulator, and the folded checksum of its slot
    # path wherever one ulp in a lane survives the fold
    k2 = [m for m in summary["mismatches"] if m.startswith("K2 accumulator")]
    assert len(k2) == 13
    assert all(m.startswith(("K2 accumulator", "K2 slot checksum"))
               for m in summary["mismatches"])
    assert S.main(["--launch-cases", "--device", "cpu"]) == 1


def test_launch_cases_run_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.launch_cases()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.main(["--launch-cases"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.main(["--launch-cases", "--guarded"])


@pytest.mark.parametrize("device,launched,rc", [
    ("cuda:0", 1, 0), ("cuda:0", 0, 1), ("cpu", 0, 0)])
def test_launch_cases_fail_on_the_card_when_a_kernel_never_launched(
        monkeypatch, capsys, device, launched, rc):
    counts = {"copy_csum_blocks": 3, "copy_csum_staged": 2, "copy_blocks": launched}
    monkeypatch.setattr(S, "launch_cases", lambda dev, guarded: {
        "device": device, "cases": 13, "launches": counts, "checks": 195, "overlaps": 0,
        "mismatches": []})
    assert S.main(["--launch-cases", "--device", device]) == rc


def test_guarded_launch_cases_hand_every_launch_a_poisoned_scratch(monkeypatch):
    import torch

    from incubator_brpc_tpu_torch.ops import transfer as T

    seen = []

    def recording(real):
        def call(x, *args):
            if len(args) == 4:  # the launcher's own calls (x, ..., out, partial)
                seen.append(args[3])
            return real(x, *args)
        return call

    monkeypatch.setattr(T, "_copy_csum", recording(T._copy_csum))
    monkeypatch.setattr(T, "_staged_copy_csum", recording(T._staged_copy_csum))
    assert S.launch_cases("cpu", guarded=True)["mismatches"] == []
    # per case: K1 whole, carry, slot, each chained chunk, K2 and its slot
    assert len(seen) > 5 * 13
    for partial in seen:
        assert partial is not None and partial.dtype == torch.float32
        assert bool(torch.isnan(partial).all())
    seen.clear()
    S.launch_cases("cpu")
    assert seen and all(partial is None for partial in seen)


def test_a_scratch_of_the_wrong_shape_is_refused():
    import torch

    from incubator_brpc_tpu_torch.ops import transfer as T

    x = torch.zeros((64, 256))
    assert T._scratch(x, 32, None).shape == (2, 256)
    good = torch.empty((2, 256))
    assert T._scratch(x, 32, good) is good
    for bad in (torch.empty((4, 256)), torch.empty((2, 256), dtype=torch.float16),
                torch.empty((256, 2)).t()):
        with pytest.raises(ValueError, match="partial must be"):
            T._scratch(x, 32, bad)


def test_launch_cases_command_line(capsys):
    assert S.main(["--launch-cases", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("LAUNCH_CASES ") and '"mismatches": []' in line


@pytest.mark.parametrize("mode", ["asan", "tsan"])
def test_murmur3_builds_instrumented_under_a_sanitizer(monkeypatch, tmp_path, mode):
    plain_flags, plain_target = hashes.murmur3_build("")
    flags, target = hashes.murmur3_build(mode)
    assert flags == [*hashes._CC_FLAGS, *sanitize_flags.SAN_FLAGS[mode]]
    assert flags[len(hashes._CC_FLAGS):] == native._SAN_FLAGS[mode]  # the engine's
    assert ("-fsanitize=address,undefined" if mode == "asan" else "-fsanitize=thread") in flags
    assert plain_flags == hashes._CC_FLAGS
    assert target.name.startswith(f"libmurmur3.{mode}-") and target != plain_target
    assert plain_target.name.startswith("libmurmur3-")
    # the compiler is handed exactly those flags, writing a temporary
    # beside the target (renamed onto it once built)
    ran = []

    def compiler(cmd, **kw):
        ran.append(cmd)
        raise subprocess.CalledProcessError(1, cmd)

    monkeypatch.setattr(sanitize_flags, "SANITIZE", mode)
    monkeypatch.setattr(hashes, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(hashes.subprocess, "run", compiler)
    with pytest.raises(subprocess.CalledProcessError):
        hashes._build_murmur3()
    _, target = hashes.murmur3_build(mode)
    (cmd,) = ran
    assert cmd[0] == "cc" and cmd[-1].endswith("utils/murmur3.c")
    assert cmd[1:cmd.index("-o")] == flags
    out = pathlib.Path(cmd[cmd.index("-o") + 1])
    assert out.parent == target.parent and out.name.startswith(target.stem + ".")


def test_murmur3_build_follows_the_engines_mode(monkeypatch):
    monkeypatch.setattr(sanitize_flags, "SANITIZE", "tsan")
    assert hashes.murmur3_build() == hashes.murmur3_build("tsan")
    monkeypatch.setattr(sanitize_flags, "SANITIZE", "")
    assert hashes.murmur3_build() == hashes.murmur3_build("")
    assert native._SAN_FLAGS is sanitize_flags.SAN_FLAGS
    with pytest.raises(ValueError, match="msan"):
        hashes.murmur3_build("msan")


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["asan", "tsan"])
def test_host_lane_runs_clean(mode):
    if native.sanitizer_preload(mode) is None:
        pytest.skip(f"no {mode} runtime in this toolchain")
    proc = subprocess.run([sys.executable, "-m", "incubator_brpc_tpu_torch.tools.sanitize",
                           mode], capture_output=True, text=True, cwd=ROOT, timeout=3600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]


@pytest.mark.cuda
def test_guarded_launch_cases_hold_on_the_card():
    """On the card: every kernel bit-equal to its plain version with its
    outputs between guard bands, its scratch poisoned, its arrival
    counters back at zero and two streams running the same cases at
    once."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    summary = S.launch_cases("cuda:0", guarded=True)
    assert summary["mismatches"] == []
    assert summary["checks"] == 3 * 15 * 13  # the current stream, then two at once
    assert summary["overlaps"] == 13
    assert all(summary["launches"].values())
