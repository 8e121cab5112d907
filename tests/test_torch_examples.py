"""The port's example programs (examples_torch/), run end to end on the
CPU as subprocesses, as tests/test_examples.py runs the JAX package's.

Each example that builds something on a device takes ``--device cpu``
here; without it and without a card it must raise, never carry on on
the CPU.  Every child runs its example through ``runpy`` (as
``python examples_torch/<name>.py`` would) and reports, at exit, which
modules of JAX or of the JAX package it had loaded: none may be."""

import json
import pathlib
import re
import socket
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples_torch"

# the examples that build something taking device= (a server port, a
# PsService, a cache store, a decode loop)
DEVICE_EXAMPLES = ("ici_echo.py", "batched_ps.py", "sharded_ps.py",
                   "replicated_ps.py", "streaming_generate.py",
                   "disagg_serving.py")

# tests/test_examples.py's strings, plus the two examples it does not run
EXPECT = [
    ("backup_request.py", "hedged away"),
    ("selective_echo.py", "8/8 succeeded"),
    ("partition_echo.py", "re-partitioned live: 2"),
    ("streaming_echo.py", "5 chunks echoed"),
    ("parallel_echo.py", None),
    ("async_echo.py", "64/64 async echoes"),
    ("cancel_echo.py", "done ran exactly once"),
    ("multi_threaded_echo.py", "800 echoes from 4 threads"),
    ("redis_client.py", "INCR -> 1"),
    ("memcache_client.py", "memcache set/get round trip"),
    ("dynamic_partition_echo.py", "20/20 echoes across coexisting"),
    ("batched_ps.py", "batched gets coalesced into"),
    ("sharded_ps.py", "sharded forward merged 4 partial results"),
    ("replicated_ps.py", "acknowledged writes still readable"),
    ("streaming_generate.py", "continuously-batched streams"),
    ("disagg_serving.py", "migrated live with prefill reused"),
    ("ici_echo.py", "attachment bytes: 4194304 | device-resident: True"),
    ("rtmp_relay.py", "subscriber got type=9"),
]

# runs argv[2] as __main__ with argv[2:] as its argv, the transmit entry
# points of package argv[1]'s ops/transfer.py wrapped in counters (the
# fabric imports them at call time, so the wrappers are what it calls);
# at exit prints the counts and the foreign modules the process loaded
LAUNCH = """
import atexit, collections, importlib, json, runpy, sys
T = importlib.import_module(sys.argv[1] + ".ops.transfer")
calls = collections.Counter()
def counted(name):
    fn = getattr(T, name)
    def wrapper(*a, **k):
        calls[name] += 1
        return fn(*a, **k)
    return wrapper
for name in ("transmit_array", "transmit_array_chunked", "device_copy",
             "device_copy_with_checksum_pallas", "device_copy_with_checksum_dma",
             "device_copy_with_checksum_dma_into"):
    setattr(T, name, counted(name))
def at_exit():
    print("TRANSMITS", json.dumps(dict(sorted(calls.items()))), flush=True)
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith("jax.") or m == "incubator_brpc_tpu"
                 or m.startswith("incubator_brpc_tpu."))
    print("FOREIGN AT EXIT", bad, flush=True)
atexit.register(at_exit)
sys.argv = sys.argv[2:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""

# the JAX examples' calls into the same entry points, counted the same
# way on the CPU: only the two whose device tensors cross an ici:// hop
# transmit (ici_echo's request hop; sharded_ps's four scatter Puts).
# The PS, cache and decode examples keep their values where they are or
# move host bytes over TCP, and the HTTP demo carries JSON
JAX_TRANSMITS = {
    "ici_echo.py": {"transmit_array": 1},
    "sharded_ps.py": {"transmit_array": 4},
    "batched_ps.py": {},
    "replicated_ps.py": {},
    "streaming_generate.py": {},
    "disagg_serving.py": {},
    "http_server.py": {},
}

_runs = {}


def run_example(script, *args, timeout=120):
    """(returncode, stdout, stderr) of one example's child, run once per
    (script, args) in this module."""
    key = (script, args)
    if key not in _runs:
        proc = subprocess.run(
            [sys.executable, "-c", LAUNCH, "incubator_brpc_tpu_torch",
             str(EXAMPLES / script), *args],
            capture_output=True, text=True, timeout=timeout, cwd=ROOT,
        )
        _runs[key] = (proc.returncode, proc.stdout, proc.stderr)
    return _runs[key]


def example_args(script):
    return ("--device", "cpu") if script in DEVICE_EXAMPLES else ()


def test_every_jax_example_has_a_port():
    ported = sorted(p.name for p in EXAMPLES.glob("*.py"))
    assert ported == sorted(p.name for p in (ROOT / "examples").glob("*.py"))
    assert len(ported) == 21
    # every entry program the tests run, bar the server/client pair
    assert sorted([s for s, _ in EXPECT] + ["echo_client.py", "echo_server.py",
                                            "http_server.py"]) == ported


@pytest.mark.parametrize("script,expect", EXPECT)
def test_example_runs(script, expect):
    rc, out, err = run_example(script, *example_args(script))
    assert rc == 0, err[-2000:]
    if expect:
        assert expect in out, out[-2000:]


def test_http_server_example_demo():
    rc, out, err = run_example("http_server.py", "--demo")
    assert rc == 0, err[-2000:]
    assert "'message': 'restful'" in out, out


@pytest.mark.parametrize("script", [s for s, _ in EXPECT] + ["http_server.py"])
def test_example_child_loads_neither_jax_nor_the_jax_package(script):
    args = ("--demo",) if script == "http_server.py" else example_args(script)
    rc, out, err = run_example(script, *args)
    assert rc == 0, err[-2000:]
    assert "FOREIGN AT EXIT []" in out, out[-2000:]


@pytest.mark.parametrize("script", sorted(JAX_TRANSMITS))
def test_device_example_transmits_as_the_jax_example_does(script):
    args = ("--demo",) if script == "http_server.py" else example_args(script)
    rc, out, err = run_example(script, *args)
    assert rc == 0, err[-2000:]
    line = next(ln for ln in out.splitlines() if ln.startswith("TRANSMITS "))
    assert json.loads(line[len("TRANSMITS "):]) == JAX_TRANSMITS[script]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_echo_server_and_client_pair():
    """echo_server.py serves on a free port (the native engine, builtin
    pages on port + 1); echo_client.py reaches it and prints the reply."""
    port = _free_port()
    while True:  # the builtin pages take port + 1: it must be free too
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", port + 1))
            break
        except OSError:
            port = _free_port()
    srv = subprocess.Popen(
        [sys.executable, str(EXAMPLES / "echo_server.py"), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
    )
    try:
        banner = srv.stdout.readline()
        assert f"echo server on :{port}" in banner, srv.stderr.read()[-2000:]
        client = subprocess.run(
            [sys.executable, str(EXAMPLES / "echo_client.py"),
             f"127.0.0.1:{port}", "pair"],
            capture_output=True, text=True, timeout=120, cwd=ROOT,
        )
        assert client.returncode == 0, client.stdout + client.stderr[-2000:]
        assert re.search(r"reply: 'pair'  \(\d+us\)", client.stdout), client.stdout
    finally:
        srv.send_signal(2)  # SIGINT: the server's KeyboardInterrupt stops it
        try:
            srv.wait(timeout=30)
        except subprocess.TimeoutExpired:
            srv.kill()
            srv.wait()
    assert srv.returncode == 0, srv.stderr.read()[-2000:]
