"""The port's bench (``incubator_brpc_tpu_torch/tools/bench.py``) held to
the JAX package's (``bench.py``) on the CPU.

Both modules define the same ``bench_*`` functions with the same
parameters, defaults and returned keys (the port's device benches add
``device=None``).  Each structure guard of ``tests/test_bench_smoke.py``
is ported here: it runs the JAX function and the port's with the same
small arguments (the port's on ``torch.device("cpu")``, its kernels'
plain versions) and asserts that the two return the same keys and the
same structural counts — dispatches per frame, merges per batch, legs
and crossings per fan-out, keys moved, evictions, the servable width —
where the count is fixed by the inputs; a count that timing decides (how
many rows one batch caught) is held to the JAX guard's bound on both
sides.  No timing threshold is ported: qps and overhead figures are
checked for presence and sign only.
"""

import importlib
import inspect
import pathlib
import statistics
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import bench as jax_bench
import incubator_brpc_tpu.native as jax_native
from incubator_brpc_tpu_torch import native as port_native
from incubator_brpc_tpu_torch.tools import bench as port_bench

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")

# every bench that places a tensor, starts an ici:// port or builds a
# store takes device=None in the port (the card; raises without one)
DEVICE_BENCHES = {
    "bench_transmit_op", "bench_ici_pipeline_curve", "bench_ici_rpc",
    "bench_dcn_bulk", "bench_profiler_overhead",
    "bench_device_witness_overhead", "bench_hbm_cache",
    "bench_batched_device_op", "bench_sharded_ps",
    "bench_batching_off_overhead", "bench_streaming_generate",
    "bench_disagg_serving", "bench_resharding",
    "bench_resharding_bulk_move", "bench_replicated_ps",
    "bench_shard_window",
}
# the helpers a bench calls, each with its JAX counterpart's signature
HELPERS = [
    "_drift_cancelled_overhead", "_bench_loop", "_bench_http",
    "_bench_redis", "_bench_native_http_redis",
    "_bench_ici_pipeline_curve_impl", "_bench_ici_rpc_impl",
    "_bench_sharded_ps_impl",
]


def _bench_names(mod):
    return {
        name for name, fn in inspect.getmembers(mod, inspect.isfunction)
        if name.startswith("bench_") and fn.__module__ == mod.__name__
    }


def _pkg(root: str, *names):
    """The modules ``root.<name>`` of one package, as attributes."""
    return types.SimpleNamespace(**{
        n.rsplit(".", 1)[-1]: importlib.import_module(f"{root}.{n}") for n in names
    })


def _keys(d, prefix=""):
    """Every key path of a nested dict (lists of dicts by their first
    item), so two results compare by structure, not by value."""
    out = set()
    for k, v in d.items():
        path = f"{prefix}{k}"
        out.add(path)
        if isinstance(v, dict):
            out |= _keys(v, path + ".")
        elif isinstance(v, list) and v and isinstance(v[0], dict):
            out |= _keys(v[0], path + "[].")
    return out


@pytest.fixture
def jax_engine():
    """The JAX package's engine, loaded in this process (reloaded when a
    test worker lost its build race, as tests/test_torch_native.py
    does): its native benches would otherwise measure another path."""
    if not jax_native.available():
        jax_native._lib_err = None
        jax_native._load()
    assert jax_native.available(), jax_native.unavailable_reason()
    return jax_native


@pytest.fixture
def fabrics():
    """Both packages' ICI fabrics, their chunk policy restored after."""
    from incubator_brpc_tpu.parallel.ici import get_fabric as jax_fabric
    from incubator_brpc_tpu_torch.parallel.ici import get_fabric as port_fabric

    fs = [jax_fabric(), port_fabric()]
    saved = [(f.chunk_mode, f.chunk_bytes) for f in fs]
    yield fs
    for f, (mode, cb) in zip(fs, saved):
        f.chunk_mode, f.chunk_bytes = mode, cb


def _echo_server(root):
    m = _pkg(root, "models.echo", "server.server")
    srv = m.server.Server(m.server.ServerOptions(native_engine=True))
    srv.add_service(m.echo.EchoService(attach_echo=False))
    assert srv.start(0) == 0
    return srv


@pytest.fixture
def echo_servers(jax_engine):
    """A native echo server of each package: {root: server}."""
    servers = {r: _echo_server(r) for r in ("incubator_brpc_tpu", "incubator_brpc_tpu_torch")}
    yield servers
    for srv in servers.values():
        srv.stop()


PACKAGES = ("incubator_brpc_tpu", "incubator_brpc_tpu_torch")


# ---------------------------------------------------------------------------
# the same functions, parameters and defaults
# ---------------------------------------------------------------------------


def test_the_two_benches_define_the_same_bench_functions():
    names = _bench_names(jax_bench)
    assert len(names) >= 25
    assert _bench_names(port_bench) == names


@pytest.mark.parametrize("name", sorted(_bench_names(jax_bench)) + HELPERS)
def test_each_bench_takes_the_jax_parameters_and_defaults(name):
    jp = inspect.signature(getattr(jax_bench, name)).parameters
    pp = dict(inspect.signature(getattr(port_bench, name)).parameters)
    device = pp.pop("device", None)
    assert [(p.name, p.default, p.kind) for p in pp.values()] == [
        (p.name, p.default, p.kind) for p in jp.values()
    ]
    takes_device = name in DEVICE_BENCHES or name in (
        "_bench_ici_pipeline_curve_impl", "_bench_ici_rpc_impl", "_bench_sharded_ps_impl")
    assert (device is not None) == takes_device, name
    if device is not None:
        assert device.default is None and device.kind == device.POSITIONAL_OR_KEYWORD


@pytest.mark.parametrize("name", sorted(DEVICE_BENCHES))
def test_a_device_bench_raises_without_a_card(name, monkeypatch):
    """No CPU fallback: device=None means the card, and with none the
    bench raises (at the guard's small arguments, so a bench that runs a
    host segment first stays short)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = {
        "bench_profiler_overhead": dict(seg_calls=20, pairs=1),
        "bench_shard_window": dict(n_keys=8, shards=2, value_bytes=64, reps=1),
    }.get(name, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(port_bench, name)(**small)


def test_the_port_bench_imports_neither_jax_nor_the_jax_package_nor_bench():
    guard = (
        "import sys\n"
        "import incubator_brpc_tpu_torch.tools.bench as b\n"
        "assert callable(b.main)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'bench', 'incubator_brpc_tpu')\n"
        "             or m.startswith(('jax.', 'incubator_brpc_tpu.')))\n"
        "print('FOREIGN', bad)\n"
    )
    res = subprocess.run([sys.executable, "-c", guard], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "FOREIGN []" in res.stdout, res.stdout
    src = (ROOT / "incubator_brpc_tpu_torch" / "tools" / "bench.py").read_text()
    assert "import bench" not in src and "from bench " not in src


# ---------------------------------------------------------------------------
# the JAX bench smoke's timing tests, as structure only
# ---------------------------------------------------------------------------


def test_echo_4kb_native_smoke(echo_servers):
    srv = echo_servers["incubator_brpc_tpu_torch"]
    r = port_native.bench_echo("127.0.0.1", srv.port, 4096, concurrency=1,
                               duration_ms=700, depth=32, conns=1)
    want = jax_native.bench_echo("127.0.0.1", echo_servers["incubator_brpc_tpu"].port,
                                 4096, concurrency=1, duration_ms=200, depth=32, conns=1)
    assert set(r) == set(want)
    assert r["failed"] == 0 and r["ok"] > 0 and r["qps"] > 0, r


def test_echo_size_curve_has_every_point(echo_servers):
    port = echo_servers["incubator_brpc_tpu_torch"].port
    for psize in (16384, 65536, 262144):
        for conc, depth, conns in [(2, 1, 1), (1, 16, 1)]:
            r = port_native.bench_echo("127.0.0.1", port, psize, concurrency=conc,
                                       duration_ms=300, depth=depth, conns=conns)
            assert r["failed"] == 0 and r["qps"] * psize / 1e9 > 0, (psize, r)


def test_chaos_disarmed_overhead_estimator(echo_servers):
    """The chaos-overhead estimator on the port's Python transport: it
    runs its OFF/ON/OFF segments, every call answers, and the deltas
    come out one per ON segment (no bound on them: timing)."""
    from incubator_brpc_tpu_torch.chaos import FaultPlan
    from incubator_brpc_tpu_torch.chaos import injector as chaos_injector
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import echo_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest

    ch = Channel(ChannelOptions(timeout_ms=10000))
    ch.init(f"127.0.0.1:{echo_servers['incubator_brpc_tpu_torch'].port}")
    stub = echo_stub(ch)
    req = EchoRequest(message="x" * 4096)

    def seg(calls=60):
        t0 = time.monotonic()
        for _ in range(calls):
            c = Controller()
            stub.Echo(c, req)
            assert not c.error_code, c.error_text()
        return calls / (time.monotonic() - t0)

    try:
        on, off, deltas = port_bench._drift_cancelled_overhead(
            seg, lambda: chaos_injector.arm(FaultPlan([], seed=1, name="empty")),
            chaos_injector.disarm, pairs=4)
    finally:
        chaos_injector.disarm()
        ch.close()
    assert len(on) == 4 and len(off) == 5 and len(deltas) == 4
    assert min(on + off) > 0
    assert not chaos_injector.armed


def test_echo_4kb_pyapi_smoke(echo_servers):
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import (
        acquire_controller,
        release_controller,
    )
    from incubator_brpc_tpu_torch.models.echo import echo_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.server.service import RAW_RESPONSE

    ch = Channel(ChannelOptions(timeout_ms=5000, connection_type="native"))
    ch.init(f"127.0.0.1:{echo_servers['incubator_brpc_tpu_torch'].port}")
    stub = echo_stub(ch)
    packed = EchoRequest(message="x" * 4096).SerializeToString()
    total, nthreads = 2000, 8
    ok, lock = [], threading.Lock()

    def worker():
        n = 0
        for _ in range(total // nthreads):
            c = acquire_controller()
            stub.Echo(c, packed, response=RAW_RESPONSE)
            n += not c.error_code
            release_controller(c)
        with lock:
            ok.append(n)

    try:
        t0 = time.monotonic()
        ts = [threading.Thread(target=worker) for _ in range(nthreads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        wall = time.monotonic() - t0
    finally:
        ch.close()
    assert sum(ok) == total and total / wall > 0


# ---------------------------------------------------------------------------
# the structure guards, each on both benches
# ---------------------------------------------------------------------------


def _ring_drive(root, server, window, nwin, payload):
    m = _pkg(root, "client.channel", "models.echo", "protos.echo_pb2")
    ch = m.channel.Channel(m.channel.ChannelOptions(timeout_ms=5000, connection_type="native"))
    assert ch.init(f"127.0.0.1:{server.port}") == 0
    stub = m.echo.echo_stub(ch)
    packed = m.echo_pb2.EchoRequest(message="x" * payload).SerializeToString()
    try:
        spec = stub.method_spec("Echo")
        ring = ch.submission_ring(depth=window)
        ok = 0
        for _ in range(nwin):
            ring.submit_all(spec, [packed] * window)
            ok += sum(isinstance(res, bytes) for _slot, res in ring.drain())
        return ok, ring.counters(), ch._native_mux().ring_stats()
    finally:
        ch.close()


def test_ring_bench_structure_guard(echo_servers):
    window, nwin = 32, 40
    calls = window * nwin
    got = {r: _ring_drive(r, echo_servers[r], window, nwin, 4096) for r in PACKAGES}
    (jok, jc, js), (pok, pc, ps) = got.values()
    assert set(pc) == set(jc) and set(ps) == set(js)
    assert pok == jok == calls
    for key in ("submissions", "fallback_calls", "double_resolves"):
        assert pc[key] == jc[key], (key, pc, jc)
    for c, stats in ((jc, js), (pc, ps)):
        assert c["submissions"] == calls and c["fallback_calls"] == 0, c
        assert c["harvest_batches"] >= 2 and c["boundary_crossings"] <= calls / 4, c
        assert stats["calls"] >= calls and stats["windows"] <= stats["calls"] / 4, stats


def test_ring_window_hits_micro_batcher_smoke(jax_engine):
    w = 16
    seen = {}
    for root in PACKAGES:
        m = _pkg(root, "batching.policy", "client.channel", "models.parameter_server",
                 "protos.echo_pb2", "server.server")
        srv = m.server.Server(m.server.ServerOptions(
            native_engine=True, enable_batching=True,
            batch_policies={"PsService.Get": m.policy.BatchPolicy(
                max_batch_size=32, max_wait_us=100_000)}))
        kw = {"device": CPU} if root.endswith("_torch") else {}
        svc = m.parameter_server.PsService(**kw)
        srv.add_service(svc)
        assert srv.start(0) == 0
        svc._store["k"] = b"v" * 64
        ch = m.channel.Channel(m.channel.ChannelOptions(timeout_ms=5000, connection_type="native"))
        try:
            assert ch.init(f"127.0.0.1:{srv.port}") == 0
            res = m.parameter_server.ps_stub(ch).call_many(
                "Get", [m.echo_pb2.EchoRequest(message="k").SerializeToString()] * w)
            assert len(res) == w and all(isinstance(r, bytes) for r in res), res
            b = srv.batcher("PsService.Get")
            seen[root] = (b.max_batch_seen, b.describe())
        finally:
            srv.stop()
            ch.close()
    (jmax, jdesc), (pmax, pdesc) = seen.values()
    assert set(pdesc) == set(jdesc)
    assert jmax >= w // 2 and pmax >= w // 2, seen


def test_shard_window_bench_structure_guard(jax_engine):
    n_keys, shards, reps = 24, 2, 1
    kw = dict(n_keys=n_keys, shards=shards, value_bytes=64, reps=reps)
    want = jax_bench.bench_shard_window(**kw)
    got = port_bench.bench_shard_window(**kw, device=CPU)
    assert "shard_window_error" not in want, want
    assert _keys(got) == _keys(want)
    for lane, counts in (("shard_window_ps", ("shards", "n_keys", "windows",
                                              "windowed_crossings", "fallback_calls",
                                              "keys_per_crossing")),
                         ("shard_window_cache", ("replicas", "n_keys", "set_many_crossings",
                                                 "get_many_crossings", "fallback_calls"))):
        for key in counts:
            assert got[lane][key] == want[lane][key], (lane, key, got[lane], want[lane])
    ps = got["shard_window_ps"]
    assert ps["windows"] == reps and ps["windowed_crossings"] == shards * reps, ps
    assert ps["keys_per_crossing"] == n_keys / shards and ps["fallback_calls"] == 0, ps
    cache = got["shard_window_cache"]
    assert 0 < cache["get_many_crossings"] <= cache["replicas"] * reps, cache
    assert 0 < cache["set_many_crossings"] <= cache["replicas"], cache


def test_server_ring_bench_structure_guard(echo_servers):
    window, nwin = 32, 4
    deltas = {}
    for root, srv in echo_servers.items():
        stats = lambda srv=srv: srv._engine_op(lambda eng: dict(eng.ring_stats()))  # noqa: E731
        before = stats()
        ok, _, _ = _ring_drive(root, srv, window, nwin, 1024)
        after = stats()
        assert ok == window * nwin
        deltas[root] = {k: after[k] - before[k] for k in before}
    jd, pd = deltas.values()
    assert set(pd) == set(jd)
    for d in (jd, pd):
        assert d["responses"] >= window * nwin * 3 // 4, d
        assert 1 <= d["windows"] <= max(2 * nwin, d["responses"] // 4), d
        assert d["flush_bursts"] >= d["windows"], d


# the keys bench_ici_rpc adds only when a marginal time resolved, and
# the diagnostic best only past the 200 us two-hop floor
_ICI_RESOLVED = {"ici_echo_e2e_us_per_echo_median", "ici_echo_e2e_us_per_echo_min",
                 "ici_echo_e2e_us_per_echo_max", "ici_64mb_echo_gbps"}


def _holds_the_benchs_rate(gbps, mb, us):
    """Whether ``gbps`` is the bench's figure for ``us``: both benches
    print round((2 * mb / 1024) / t, 1) for a time t that they print as
    ``us``, t in microseconds rounded to 0.1, so the figure lies between
    the figures of that rounding's two ends.  Exact at any load, where a
    bare ``gbps > 0`` reads 0.0 once t passes 2 * mb / 1024 / 0.05 s."""
    assert us > 0.05, us
    num = 2 * mb / 1024
    lo, hi = (us + 0.0500001) * 1e-6, (us - 0.0500001) * 1e-6
    return round(num / lo, 1) <= gbps <= round(num / hi, 1)


def test_ici_bench_structure_and_dispatch_guard(jax_engine, fabrics):
    kw = dict(mb=1, hi=4, lo=2, reps=2)
    want = jax_bench.bench_ici_rpc(**kw)
    got = port_bench.bench_ici_rpc(**kw, device=CPU)
    assert "ici_error" not in want, want
    for out in (want, got):
        resolved = bool(out["ici_echo_e2e_us_per_echo_all"])
        assert (_ICI_RESOLVED <= set(out)) == resolved, out
        assert set(out) - _ICI_RESOLVED - {"ici_64mb_echo_gbps_best"} == {
            "ici_echo_e2e_us_per_echo_all", "ici_rpc_dispatch_p50_us", "ici_rpc_ok"}
        assert 0 < out["ici_rpc_dispatch_p50_us"] < 200_000, out
        if resolved:
            all_us = out["ici_echo_e2e_us_per_echo_all"]
            assert out["ici_echo_e2e_us_per_echo_median"] == all_us[len(all_us) // 2], out
            assert out["ici_echo_e2e_us_per_echo_median"] > 0, out
            assert _holds_the_benchs_rate(out["ici_64mb_echo_gbps"], kw["mb"],
                                          out["ici_echo_e2e_us_per_echo_median"]), out
    # every echo of every chain completed: 2 warm + reps * (hi + lo)
    assert got["ici_rpc_ok"] == want["ici_rpc_ok"] == 2 + 2 * (4 + 2)


# the keys the JAX bench's bench_transmit_op returns when a marginal
# time resolved (bench.py:622-625); its chain raises on the CPU (Pallas
# there runs in interpret mode only), so the chain is held to the JAX
# package's device_copy_with_checksum in interpret mode instead
_TRANSMIT_RESOLVED = {"pallas_transmit_64mb_gbps", "pallas_transmit_64mb_us"}


def test_transmit_op_returns_the_jax_keys_and_runs_the_jax_chain():
    import jax.numpy as jnp

    from incubator_brpc_tpu.ops import transfer as jax_transfer

    # chains 20 transmits apart (a few ms each on the CPU), so a loaded
    # host's stall in a short chain cannot hide the marginal time in both
    # reps, as it hid 2 transmits' in a loaded run
    kw = dict(mb=1, hi=24, lo=4, reps=2)
    got = port_bench.bench_transmit_op(**kw, device=CPU)
    assert set(got) == _TRANSMIT_RESOLVED, got
    assert got["pallas_transmit_64mb_us"] > 0, got
    assert _holds_the_benchs_rate(got["pallas_transmit_64mb_gbps"], kw["mb"],
                                  got["pallas_transmit_64mb_us"]), got
    # the chain: each transmit copies the previous output and adds its
    # checksum to the sum; the JAX chain is bench.py:586-594's loop body
    rows = (kw["mb"] << 20) // (2048 * 4)
    x = np.random.RandomState(20).standard_normal((rows, 2048)).astype(np.float32)
    tol = 1e-5 * float(np.abs(x).sum())  # a checksum's limit, a transmit
    y, s = torch.from_numpy(x), torch.zeros((), dtype=torch.float32)
    jy, js = jnp.asarray(x), jnp.float32(0.0)
    iters = 4
    for k in range(1, iters + 1):
        y, s = port_bench.transmit_chain(y, s, 1)
        jy, csum = jax_transfer.device_copy_with_checksum(jy, interpret=True)
        js = js + csum
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
        assert abs(float(s) - float(js)) <= k * tol, (k, float(s), float(js))
    whole = port_bench.transmit_chain(torch.from_numpy(x), torch.zeros(()), iters)
    assert torch.equal(whole[0], y) and float(whole[1]) == float(s)
    fold = port_bench.transmit_fold(y, s)
    assert float(fold) == float(jy[0, 0] + jy[-1, -1] + 0.0 * js)


def test_batched_device_op_structure_guard(jax_engine):
    kw = dict(parallelism=(6,), batch_sizes=(6,), duration_s=0.5, dim=16)
    want = jax_bench.bench_batched_device_op(**kw)["batched_device_op"]
    got = port_bench.bench_batched_device_op(**kw, device=CPU)["batched_device_op"]
    assert _keys(got) == _keys(want)
    for d in (want, got):
        points = {p["config"]: p for p in d["points"]}
        assert set(points) == {"off", "on6"}, points
        assert points["off"]["ok"] > 0 and points["on6"]["ok"] > 0
        assert points["off"]["observed_max_batch"] == 1 and points["off"]["observed_batches"] == 0
        on = points["on6"]
        assert on["observed_batches"] > 0 and 2 <= on["observed_max_batch"] <= 6, on
        assert "speedup_vs_off" in on and "p99_vs_off_p50" in on
        assert "best_speedup_at_p6" in d


def test_ici_pipeline_curve_structure(jax_engine, fabrics):
    kw = dict(mb=2, hi=3, lo=1, reps=1)
    want = jax_bench.bench_ici_pipeline_curve(**kw)
    got = port_bench.bench_ici_pipeline_curve(**kw, device=CPU)
    assert "ici_pipeline_error" not in want, want
    assert set(got) == set(want)
    wc, gc_ = want["ici_pipeline_curve"], got["ici_pipeline_curve"]
    assert [(p["mode"], p["chunk_mb"]) for p in gc_] == [(p["mode"], p["chunk_mb"]) for p in wc]
    assert {p["mode"] for p in gc_} == {"off", "fused", "pipelined", "pallas"}
    for g, w in zip(gc_, wc):
        assert set(g) == set(w), (g, w)
        if g["mode"] == "pallas":
            # the 2 MB frame sits under the size gate in both packages:
            # no staged dispatch and no fallback, every transmit counted
            for key in ("pallas_dispatches", "pallas_fallbacks", "pallas_transmits"):
                assert g[key] == w[key], (key, g, w)
            assert g["pallas_transmits"] > 0
            assert g["pallas_dispatches"] + g["pallas_fallbacks"] in (0, g["pallas_transmits"])
    assert got["ici_pipeline_best"] in gc_ and want["ici_pipeline_best"] in wc


def test_ici_pallas_hit_path_structure_guard(monkeypatch):
    """The staged lane's hit path: a 512 KB frame at 64 KB chunks is ONE
    staged dispatch a transmit, no fallback, in both packages (the JAX
    package's DMA kernel through the Pallas interpreter, the port's K2
    through its plain version); the port's checksum equals its
    whole-frame transmit's bit for bit, and its armed transfer witness
    records no pull and no violation."""
    import functools

    import jax.numpy as jnp

    from incubator_brpc_tpu.ops import transfer as JT
    from incubator_brpc_tpu.parallel import ici as jici
    from incubator_brpc_tpu_torch.analysis import device_witness as dw
    from incubator_brpc_tpu_torch.ops import transfer as PT
    from incubator_brpc_tpu_torch.parallel import ici as pici

    orig_dma = JT.device_copy_with_checksum_dma
    monkeypatch.setattr(JT, "_on_tpu", lambda arr: True)
    monkeypatch.setattr(JT, "device_copy_with_checksum_dma",
                        functools.partial(orig_dma, interpret=True))
    monkeypatch.setattr(JT, "device_copy_with_checksum_dma_into",
                        lambda x, slot, br, sr: orig_dma(x, br, sr, interpret=True))
    host = np.random.RandomState(7).randn(1024, 128).astype(np.float32)
    transmits = 3
    counts = {}
    for ici, x, witness in ((jici, jnp.asarray(host), None),
                            (pici, torch.from_numpy(host), dw)):
        class _Shim:
            coords = (0, 0)
            device = None
            staging = ici.StagingRing(depth=2)

        fabric = ici.get_fabric()
        saved = (fabric.chunk_mode, fabric.chunk_bytes)
        frames0 = int(ici.ici_pallas_frames.get_value())
        falls0 = int(ici.ici_pallas_fallbacks.get_value())
        if witness is not None:
            was_armed = witness.enabled()
            witness.enable()
            rep0 = witness.cross_check()
        try:
            fabric.chunk_mode, fabric.chunk_bytes = "pallas", 64 << 10
            for _ in range(transmits):
                out, csum = fabric._transmit_segment(x, _Shim(), None)
                np.testing.assert_array_equal(np.asarray(out), host)
                if witness is not None:
                    assert float(csum) == float(PT.device_copy_with_checksum(x)[1])
        finally:
            fabric.chunk_mode, fabric.chunk_bytes = saved
            if witness is not None:
                rep = witness.cross_check()
                if not was_armed:
                    witness.disable()
        counts[ici.__name__] = (int(ici.ici_pallas_frames.get_value()) - frames0,
                                int(ici.ici_pallas_fallbacks.get_value()) - falls0)
    assert list(counts.values()) == [(transmits, 0), (transmits, 0)], counts
    assert rep["violations"] == rep0["violations"]
    assert rep["scope_uses"] == rep0["scope_uses"]


def test_resharding_bulk_move_bench_structure_guard():
    kw = dict(n_keys=16, value_bytes=512)
    want = jax_bench.bench_resharding_bulk_move(**kw)
    got = port_bench.bench_resharding_bulk_move(**kw, device=CPU)
    assert "resharding_bulk_move_error" not in want, want
    assert _keys(got) == _keys(want)
    for lane in ("bulk", "per_key"):
        for key in ("completed", "keys_moved", "collective_steps", "bulk_ranges",
                    "ranges_copied"):
            assert got["resharding_bulk_move"][lane][key] == \
                want["resharding_bulk_move"][lane][key], (lane, key, got, want)
    bulk, per_key = (got["resharding_bulk_move"][k] for k in ("bulk", "per_key"))
    assert bulk["completed"] and per_key["completed"]
    assert bulk["keys_moved"] == per_key["keys_moved"] > 0
    assert 0 < bulk["collective_steps"] <= 3 * bulk["bulk_ranges"]
    assert bulk["collective_steps"] < bulk["keys_moved"]
    assert per_key["collective_steps"] == 0


def test_streaming_generate_structure_guard():
    tokens = 24
    kw = dict(parallelism=(1, 4), tokens=tokens, dim=16, step_delay_s=0.005)
    want = jax_bench.bench_streaming_generate(**kw)["streaming_generate"]
    got = port_bench.bench_streaming_generate(**kw, device=CPU)["streaming_generate"]
    assert _keys(got) == _keys(want)
    for key in ("streamed_rows", "unary_rows"):
        assert got[key] == want[key], (key, got, want)
    assert got["unary_rows"] == 0 and got["streamed_rows"] == 1 + 1 + 4
    for d in (want, got):
        points = {p["parallelism"]: p for p in d["points"]}
        assert set(points) == {1, 4}
        for p, pt in points.items():
            assert pt["tokens"] == tokens * p and pt["progressive_streams"] == p, pt
        assert points[4]["max_fused"] >= 2 and points[4]["mid_stream_joins"] >= 1, points[4]
        assert "speedup_p4_vs_p1" in d


def test_disagg_serving_structure_guard():
    tokens = 12
    # a slower paced tier than the JAX guard's 0.01 s a step, for both
    # benches: the migration must land while session 0 still generates,
    # which a loaded test worker can otherwise miss
    kw = dict(parallelism=(1, 4), tokens=tokens, dim=12, n_layers=2, migrate_tokens=24,
              migrate_sessions=2, migrate_step_delay_s=0.02)
    want = jax_bench.bench_disagg_serving(**kw)["disagg_serving"]
    got = port_bench.bench_disagg_serving(**kw, device=CPU)["disagg_serving"]
    assert _keys(got) == _keys(want)
    for key in ("sessions", "completed", "prefill_executions_max"):
        assert got["migration"][key] == want["migration"][key], (key, got, want)
    assert got["rpc_front"] == want["rpc_front"] == {
        "frames": tokens, "streamed_rows": 1, "unary_fallback_rows": 0}
    for d in (want, got):
        assert {p["parallelism"] for p in d["points"]} == {1, 4}
        for pt in d["points"]:
            assert pt["disagg_tokens_per_s"] > 0 and pt["mono_tokens_per_s"] > 0, pt
            assert pt["disagg_ttft_ms_median"] > 0, pt
        mig = d["migration"]
        assert mig["completed"] == mig["sessions"] and mig["prefill_executions_max"] == 1
        assert mig["migrations_live"] >= 1 and d["prefill_reuse"] >= 1, d
        assert d["unary_fallback_rows"] == 0


def test_device_witness_bench_structure_guard():
    from incubator_brpc_tpu.analysis import device_witness as jdw
    from incubator_brpc_tpu_torch.analysis import device_witness as pdw

    kw = dict(rows=4, tokens=16, dim=16, pairs=2)
    armed = (jdw.enabled(), pdw.enabled())
    want = jax_bench.bench_device_witness_overhead(**kw)["device_witness_overhead"]
    got = port_bench.bench_device_witness_overhead(**kw, device=CPU)["device_witness_overhead"]
    assert (jdw.enabled(), pdw.enabled()) == armed, "a bench left a witness toggled"
    assert set(got) == set(want)
    assert got["armed_violations"] == want["armed_violations"] == 0
    for d in (want, got):
        assert d["decode_tok_s_witness_off"] > 0 and d["decode_tok_s_witness_armed"] > 0, d
        assert d["armed_manifested_pulls"] > 0, d
        assert len(d["armed_overhead_pct_segments"]) == 2
        assert d["disarmed_scope_ns"] > 0


def test_hbm_cache_bench_structure_guard():
    from incubator_brpc_tpu.analysis import device_witness as jdw
    from incubator_brpc_tpu_torch.analysis import device_witness as pdw

    kw = dict(sizes=(4096,), seg_calls=30, proof_calls=8, cluster_keys=6, cluster_calls=30,
              pairs=2, overhead_calls=40)
    armed = (jdw.enabled(), pdw.enabled())
    want = jax_bench.bench_hbm_cache(**kw)["hbm_cache"]
    got = port_bench.bench_hbm_cache(**kw, device=CPU)["hbm_cache"]
    assert (jdw.enabled(), pdw.enabled()) == armed, "a bench left a witness toggled"
    assert _keys(got) == _keys(want)
    for key in ("witness_armed", "hit_path_spill_pulls", "spill_manifested_pulls",
                "hit_path_violations"):
        assert got[key] == want[key], (key, got, want)
    assert got["hit_path_spill_pulls"] == 0 and got["spill_manifested_pulls"] > 0
    assert got["hit_path_violations"] == 0
    assert got["cluster"]["spill_hits"] == want["cluster"]["spill_hits"] == 30
    for d in (want, got):
        c = d["cluster"]
        assert c["locality_fraction"] >= 0.9 and c["picks_remote_after_kill"] > 0, c
        p = d["get_qps"]["4096"]
        assert p["device_hit_qps"] > 0 and p["host_hit_qps"] > 0
        assert d["device_miss_qps"] > 0 and d["host_miss_qps"] > 0
        assert len(d["cache_disabled_overhead"]["overhead_pct_segments"]) == 2


def _tiers(d):
    return {k for k in _keys(d) if ".sheds_by_tier." in k}


def test_overload_storm_bench_structure_guard():
    kw = dict(replicas=2, bulk_threads=3, interactive_threads=2, calls_per_thread=5,
              bulk_sleep_us=40_000, hedge_calls=10)
    want = jax_bench.bench_overload_storm(**kw)["overload_storm"]
    got = port_bench.bench_overload_storm(**kw)["overload_storm"]
    # sheds_by_tier holds the tiers that shed, which timing decides
    assert _keys(got) - _tiers(got) == _keys(want) - _tiers(want)
    for d in (want, got):
        for phase in ("storm_off", "storm_on"):
            for tier in ("interactive", "bulk"):
                assert {"completed", "qps", "p50_ms", "p99_ms"} <= set(d[phase][tier])
            assert d[phase]["interactive"]["completed"] > 0, d[phase]
        if sum(d["storm_on"]["sheds_by_tier"].values()):
            assert d["bulk_shed_fraction_storm_on"] >= 0.9, d["storm_on"]
        h = d["hedging"]
        # exactly-once completion of every hedged call
        assert h["hedged"]["completed"] == h["no_hedge"]["completed"] == 10, h
        assert h["slow_replica_rows_executed_hedged"] < h["slow_replica_rows_executed_no_hedge"], h


def test_sharded_ps_structure_guard():
    import jax

    assert len(jax.devices()) >= 4, "tests/conftest.py provides 8 virtual devices"
    kw = dict(shards=(1, 4), parallelism=(6,), duration_s=0.4, dim=256, overhead_pairs=2,
              overhead_calls=40)
    want = jax_bench._bench_sharded_ps_impl(**kw)
    got = port_bench._bench_sharded_ps_impl(**kw, device=CPU)
    assert _keys(got) == _keys(want)
    wpts = {p["shards"]: p for p in want["points"]}
    gpts = {p["shards"]: p for p in got["points"]}
    assert set(gpts) == set(wpts) == {1, 4}
    for k in (1, 4):
        assert gpts[k]["sharded"] == wpts[k]["sharded"] == (k > 1)
    for pts in (wpts, gpts):
        un, sh = pts[1], pts[4]
        assert un["ok"] > 0 and sh["ok"] > 0
        assert un["collective_merges"] == 0 and un["fused_executions"] == 0
        # one sharded execution and one merge per batch
        assert sh["batches"] >= 1
        assert sh["fused_executions"] == sh["collective_merges"] == sh["batches"], sh
        assert sh["observed_max_batch"] >= 2 and "speedup_vs_unsharded" in sh
    # the servable width and each chip's bytes, by placement
    assert got["max_servable"] == want["max_servable"]
    assert got["max_servable"]["ratio_vs_single_chip"] >= 2.0
    assert all(e["fits_budget"] and e["served"] for e in got["max_servable"]["sweep"])
    assert set(got["sharded_unsharded_overhead"]) == set(want["sharded_unsharded_overhead"])


def test_cluster_scrape_bench_structure_guard():
    want = jax_bench.bench_cluster_scrape_overhead(seg_calls=60, pairs=2)
    got = port_bench.bench_cluster_scrape_overhead(seg_calls=60, pairs=2)
    assert _keys(got) == _keys(want)
    for d in (want["cluster_scrape_overhead"], got["cluster_scrape_overhead"]):
        assert d["scrape_rounds"] > 0, "ON segments never scraped"
        assert len(d["overhead_pct_segments"]) == 2
        assert d["echo_1kb_qps_scrape_on"] > 0 and d["echo_1kb_qps_scrape_off"] > 0


def _stitch_and_merge(root):
    """The JAX guard's synthetic 2-leg fan-out and recorder merge, on
    one package: (stitched text, merged - pooled percentile errors)."""
    m = _pkg(root, "metrics.latency_recorder", "observability.cluster", "observability.span")
    cluster, lr = m.cluster, m.latency_recorder
    tid = 0x5117C4
    peers = ["10.0.0.1:8000", "10.0.0.2:8000"]

    def client_span(span_id, parent, remote, start, end):
        s = m.span.Span("client", "Ps", "Forward")
        s.trace_id, s.span_id, s.parent_span_id = tid, span_id, parent
        s.start_us, s.end_us, s.remote_side = start, end, remote
        return s

    local = [client_span(1, 0, "", 1_000, 50_000), client_span(2, 1, peers[0], 1_500, 21_500),
             client_span(3, 1, peers[1], 1_500, 31_500)]

    def fetch(ep, trace_id, timeout, retries, retry_delay_s):
        leg = 2 if ep == peers[0] else 3
        return [cluster.span_from_dict({
            "trace_id": f"{trace_id:x}", "span_id": f"{leg * 16:x}",
            "parent_span_id": f"{leg:x}", "kind": "server", "service": "Ps",
            "method": "Forward", "start_us": 2_000, "end_us": 7_000,
            "phases": {"received_us": 2_000, "sent_us": 7_000}}, ep)]

    text = cluster.render_stitched(tid, db=cluster._StitchDB(local), fetch=fetch)
    a, b, pooled = lr.LatencyRecorder(), lr.LatencyRecorder(), lr.LatencyRecorder()
    for i in range(150):
        v = 40 + 97 * i
        (a if i % 2 else b).update(v)
        pooled.update(v)
    merged = lr.merge_latency_snapshots([a.mergeable_snapshot(), b.mergeable_snapshot()])
    errs = [lr.percentile_from_buckets(merged["buckets"], q) - pooled.latency_percentile(q)
            for q in (0.5, 0.9, 0.99)]
    return text, errs


def test_cluster_stitch_and_merge_invariants():
    (jtext, jerrs), (ptext, perrs) = (_stitch_and_merge(r) for r in PACKAGES)
    assert ptext == jtext and ptext is not None
    lines = ptext.splitlines()
    assert sum(ln.startswith("+") for ln in lines) == 1
    assert sum(ln.startswith("    +") for ln in lines) == 2  # depth 3
    assert any("residual=15000us" in ln for ln in lines)
    assert any("residual=25000us" in ln for ln in lines)
    assert perrs == jerrs == [0, 0, 0]


def test_resharding_bench_structure_guard():
    from incubator_brpc_tpu_torch import errors as port_errors

    kw = dict(n_keys=24, dim=16, load_threads=2, phase_calls=20)
    want = jax_bench.bench_resharding(**kw)["resharding"]
    got = port_bench.bench_resharding(**kw, device=CPU)["resharding"]
    assert _keys(got) - {k for k in _keys(got) if k.startswith("errors_by_code.")} == \
        _keys(want) - {k for k in _keys(want) if k.startswith("errors_by_code.")}
    for key in ("completed", "phase", "epoch", "keys_total", "keys_moved",
                "planner_scheme_delta", "checksum_failures"):
        assert got["migration"][key] == want["migration"][key], (key, got, want)
    m = got["migration"]
    assert m["completed"] and m["epoch"] == 1 and m["checksum_failures"] == 0
    assert m["keys_moved"] == m["planner_scheme_delta"]
    erpc = {v for k, v in vars(port_errors).items()
            if k.isupper() and isinstance(v, int)} - {port_errors.EINTERNAL}
    for phase in ("pre", "during", "post"):
        assert got["phases"][phase]["calls"] > 0, got["phases"]
    for code in got["errors_by_code"]:
        assert int(code) in erpc, got["errors_by_code"]


def test_profiler_overhead_bench_structure_guard():
    from incubator_brpc_tpu.observability import profiling as jprof
    from incubator_brpc_tpu.utils.flags import get_flag as jget
    from incubator_brpc_tpu_torch.observability import profiling as pprof
    from incubator_brpc_tpu_torch.utils.flags import get_flag as pget

    kw = dict(payload=256, seg_calls=40, rows=2, tokens=8, dim=8, pairs=2)
    accts = (jprof.hbm_account("decode.rows"), pprof.hbm_account("decode.rows"))
    before = [a.live_bytes() for a in accts]
    want = jax_bench.bench_profiler_overhead(**kw)["profiler_overhead"]
    got = port_bench.bench_profiler_overhead(**kw, device=CPU)["profiler_overhead"]
    for get_flag in (jget, pget):
        for f in ("profiler_hbm_enabled", "profiler_device_enabled",
                  "profiler_occupancy_enabled"):
            assert get_flag(f) is True, f"bench left {f} disarmed"
    assert set(got) == set(want)
    assert [a.live_bytes() for a in accts] == before, "decode.rows ledger unbalanced"
    for d in (want, got):
        for key in ("echo_1kb_qps_profilers_on", "echo_1kb_qps_profilers_off",
                    "decode_tok_s_profilers_on", "decode_tok_s_profilers_off"):
            assert d[key] > 0, d
        assert len(d["echo_overhead_pct_segments"]) == len(d["decode_overhead_pct_segments"]) == 2


def test_replicated_ps_bench_structure_guard():
    kw = dict(n_keys=12, rf1_calls=40, rf3_calls=40, hedged_calls=24, slow_delay_us=50_000)
    want = jax_bench.bench_replicated_ps(**kw)
    got = port_bench.bench_replicated_ps(**kw, device=CPU)
    assert "replicated_ps" in want, want
    assert _keys(got) == _keys(want)
    want, got = want["replicated_ps"], got["replicated_ps"]
    assert got["puts"] == want["puts"] == 12 + 10
    for d in (want, got):
        trip = d["rf1_triplet"]
        for seg in ("off1", "on", "off2"):
            assert trip[seg]["calls"] > 0 and trip[seg]["errors"] == 0, trip
        assert d["rf3"]["calls"] > 0 and d["rf3"]["errors"] == 0, d["rf3"]
        assert d["quorum_writes"] >= d["puts"] > 0, d
        assert d["steady_leader_changes"] == 0, d
        assert d["hedged_tail"]["hedged_reads"] > 0, d["hedged_tail"]


def test_overhead_benches_return_the_jax_keys():
    """The host overhead benches without a guard of their own, at a few
    calls a segment: the same keys, one delta a pair, rates above 0."""
    for name, kw, dev in (
        ("bench_rpcz_overhead", dict(seg_calls=30, pairs=2), False),
        ("bench_chaos_overhead", dict(seg_calls=30, pairs=2), False),
        ("bench_admission_off_overhead", dict(seg_calls=30, pairs=2), False),
        ("bench_batching_off_overhead", dict(seg_calls=30, pairs=2), True),
    ):
        want = getattr(jax_bench, name)(**kw)
        got = getattr(port_bench, name)(**kw, **({"device": CPU} if dev else {}))
        assert _keys(got) == _keys(want), name
        (d,) = got.values()
        assert len(d["overhead_pct_segments"]) == 2, (name, d)
        assert statistics.median(v for k, v in d.items()
                                 if k.endswith("_qps") or "_qps_" in k) > 0, (name, d)
