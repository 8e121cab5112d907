"""Whole runs on the CPU at a tiny size: each configuration sets up and
checks out with neither JAX nor the JAX package loaded, the result line
has the contract's keys, and the run command refuses to run without a
card."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness.cell import ROOT, cell_names, find_cell, load_spec
from benchmark.harness.runner import run_cell

from .conftest import CLOSED_32, SEED, run_tiny, tiny_cell

CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _one_cell_a_config():
    seen, out = set(), []
    for w in load_spec()["workloads"]:
        if w["config"] not in seen:
            seen.add(w["config"])
            out.append(w["name"])
    return out


@pytest.mark.parametrize("name", _one_cell_a_config())
def test_each_configuration_sets_up_without_jax_in_a_process_of_its_own(name):
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark.tests.conftest import run_tiny\n"
        "from benchmark.harness.guard import forbidden_loaded\n"
        f"r = run_tiny({name!r}, seconds=0.3)\n"
        "print(json.dumps({'correct': r.correct, 'loaded': forbidden_loaded(),"
        " 'jax_like': sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'incubator_brpc_tpu'))}))\n"
    )
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=240, cwd=ROOT, env=env)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out == {"correct": True, "loaded": [], "jax_like": []}


def test_the_run_command_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell_names(load_spec())[0],
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=240, cwd=ROOT, env=env)
    assert p.returncode == 3
    assert p.stdout.strip() == ""
    assert "card" in p.stderr


def test_an_untraced_line_has_the_contracts_keys_and_the_checks_last():
    r = run_tiny("echo.4kb", seconds=0.3)
    line = r.line()
    assert list(line) == CONTRACT_KEYS + ["checks"]
    assert r.correct and r.failed == 0 and r.attempted > 0
    assert set(line["metrics"]) == {"calls_per_s", "p50_ms", "setup_s"}  # no tail is gated
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(line)


def test_a_traced_line_carries_the_breakdown_and_the_windows_times():
    r = run_tiny("ps.forward.p1", seconds=0.3, trace=True, traffic=CLOSED_32)
    line = r.line()
    assert list(line) == CONTRACT_KEYS + ["breakdown", "checks"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0
    # the CPU has no device trace: what needs one is left out, never 0
    assert set(line["metrics"]) == {"server_wait_us", "rows_per_batch"}
    assert line["metrics"]["rows_per_batch"]["value"] >= 1
    assert r.correct


@pytest.mark.parametrize("name,generator,extra", [
    ("echo.4kb", "closed_loop", {"inflight": 4, "channels": 2}),
    ("ps.forward.p1", "serial", {}),
])
def test_each_loop_drives_each_configuration(name, generator, extra):
    """A later cell may pair any loop with either configuration by a traffic file alone."""
    cell = tiny_cell(name)
    cell.traffic.update(generator=generator, **extra)
    r = run_cell(cell, SEED, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert r.correct and r.attempted > 0, r.checks


def test_an_echo_keeps_a_seeded_sample_of_its_replies_and_frees_the_rest():
    """A reservoir of ``keep`` replies, the same for the same seed; every
    reply beyond it is let go, as a client lets its replies go."""
    from benchmark.harness.cell import load_module

    Deployment = load_module("deployments", "ici_echo").Deployment

    def sample(seed, n, keep=4):
        dep = Deployment.__new__(Deployment)
        dep._keep, dep._seed = keep, seed
        dep._lock = __import__("threading").Lock()
        dep._begin_sample()
        for k in range(n):
            dep._sample(k % 64, torch.full((2,), float(k)))
        return sorted(int(y[0]) for _, y in dep.kept.values())

    assert sample(SEED, 3) == [0, 1, 2]
    picks = sample(SEED, 10_000)
    assert len(picks) == 4 and len(set(picks)) == 4
    assert picks == sample(SEED, 10_000)
    assert picks != sample(SEED + 1, 10_000)
    assert max(picks) >= 4  # later replies take the place of earlier ones


def test_the_ps_shard_holds_every_layers_projections_and_serves_one():
    from benchmark.harness.cell import load_module

    mod = load_module("deployments", "ps_mixtral8x22b_attn")
    cell = find_cell("ps.forward.p1")
    keys = mod.keys_of(cell.config)
    assert len(keys) == 2 * 56 and len(set(keys)) == len(keys)
    assert keys[:2] == ["layers.0.q_proj", "layers.0.o_proj"]
    r = run_tiny("ps.forward.p1", seconds=0.3)
    assert r.correct, r.checks


def test_the_ps_shards_state_is_freed_before_the_reference_runs():
    """The stopped server stays reachable from the program, so the
    deployment deletes every key through the service first."""
    import gc
    import weakref

    from benchmark.harness.cell import load_module
    from benchmark.harness.ranges import Ranges

    cell = tiny_cell("ps.forward.p1")
    dep = load_module("deployments", cell.config_name).Deployment(
        cell.config, cell.traffic, torch.device("cpu"), SEED, Ranges(False))
    try:
        stored = [weakref.ref(v) for v in dep.service._store.values()]
        assert len(stored) == len(load_module("deployments", cell.config_name).keys_of(cell.config))
        dep.close_program()
        gc.collect()
        assert not any(r() is not None for r in stored)
    finally:
        dep.close()
