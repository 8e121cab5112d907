"""The port's builtin pages, device profiler, rpc_dump and trackme held
against the JAX package's, on the CPU.

- Every page JAX ``register_builtin_services`` registers is registered
  on a port server and answers with the JAX package's status code
  (``chip_smoke.BUILTIN_STATUS``, which the card run also checks), and
  the pages of tests/test_http_builtin.py:146-200 carry the same content.
- The renderers of ``observability/profiling.py`` give the JAX package's
  text for the same snapshot.  Two lines may differ, and only where the
  port has more to say: the census line names the allocator's rounding
  when the census reports requested bytes, and a capture that ran the
  profiler lists its CUDA events per kernel below the counter table.
- ``device_capture`` runs ``torch.profiler`` (CPU activity here) under
  the JAX tests' rules (tests/test_profiling.py:313-410): one capture at
  a time, a chaos ``drop`` a 500 with no armed profiler left behind, a
  chaos ``delay_us`` a later start.
- rpc_dump files written by either package read back in the other.  The
  port records each sample's attachment size, so ``rpc_replay`` sends a
  Forward's x as the attachment it was; the JAX package's replay sends
  it inside the request message, where the method cannot find it.
- trackme pings a census service end to end (tests/test_trackme.py), and
  ``internal_port`` moves the pages off the public port.
"""

import importlib.util
import json
import os
import pathlib
import threading
import time
import tracemalloc
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from incubator_brpc_tpu.observability import profiling as j_prof
from incubator_brpc_tpu.observability import rpc_dump as j_dump
from incubator_brpc_tpu_torch.chaos import injector
from incubator_brpc_tpu_torch.chaos.plan import FaultPlan, FaultSpec
from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.models.parameter_server import PsService, ps_stub
from incubator_brpc_tpu_torch.observability import profiling
from incubator_brpc_tpu_torch.observability import rpc_dump
from incubator_brpc_tpu_torch.observability import trackme
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.protos.trackme_pb2 import TrackMeFatal, TrackMeOK, TrackMeWarning
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
from incubator_brpc_tpu_torch.utils.flags import set_flag

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_smoke)
BUILTIN_STATUS, BUILTIN_QUERY = _smoke.BUILTIN_STATUS, _smoke.BUILTIN_QUERY


def http_get(port, path, method="GET"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read().decode("utf-8", "replace")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8", "replace")


@pytest.fixture
def server():
    srv = Server()
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def warm_profiler():
    """torch.profiler's first start initializes it (seconds); the timed
    captures below start after that."""
    profiling.device_capture(0.0)


# ---------------------------------------------------------------------------
# every page, with the JAX package's status code
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_every_page_answers_with_the_golden_status(pkg):
    if pkg == "jax":
        from incubator_brpc_tpu.models.echo import EchoService as Echo
        from incubator_brpc_tpu.server.server import Server as Srv
    else:
        Echo, Srv = EchoService, Server
    srv = Srv()
    srv.add_service(Echo())
    assert srv.start(0) == 0
    tracing = tracemalloc.is_tracing()
    try:
        assert set(srv._builtin_handlers) == set(BUILTIN_STATUS)
        got = {page: http_get(srv.port, page + BUILTIN_QUERY.get(page, ""))[0]
               for page in BUILTIN_STATUS}
    finally:
        if not tracing:  # the heap pages start tracemalloc
            tracemalloc.stop()
        srv.stop()
    assert got == BUILTIN_STATUS


def test_builtin_services_need_builtin():
    srv = Server(ServerOptions(has_builtin_services=False))
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    try:
        assert srv._builtin_handlers == {}
        assert http_get(srv.port, "/status")[0] == 404
    finally:
        srv.stop()


@pytest.mark.parametrize("page,needle", [
    ("status", "EchoService.Echo"),
    ("vars", "process_uptime"),
    ("health", "OK"),
    ("version", "incubator-brpc_tpu"),
    ("list", "EchoService"),
    ("threads", "runtime_workers"),
    ("ids", "call_id_slots"),
    ("sockets", "socket_slots"),
    ("connections", "total_connections"),
    ("index", "/status"),
    ("hotspots/runtime", "--- runtime occupancy"),
    ("hotspots/device", "--- device"),
    ("hotspots/hbm", "--- hbm"),
    ("rpc_dump", '"enabled": false'),
])
def test_builtin_page_content(server, page, needle):
    ch = Channel(ChannelOptions(timeout_ms=3000))
    assert ch.init(f"127.0.0.1:{server.port}") == 0
    for _ in range(3):
        c = Controller()
        echo_stub(ch).Echo(c, EchoRequest(message="t"))
        assert not c.failed(), c.error_text()
    ch.close()
    st, body = http_get(server.port, "/" + page)
    assert st == 200 and needle in body, f"/{page}: {body[:200]!r}"


def test_metrics_prometheus_format(server):
    body = http_get(server.port, "/metrics")[1]
    assert "# TYPE" in body and "process_memory_resident" in body
    assert "rpc_worker_count" in body and "rpc_profiler_captures_total" in body


def test_vars_wildcard_filter(server):
    body = http_get(server.port, "/vars?filter=process_*")[1]
    assert "process_pid" in body and "rpc_server" not in body


def test_flags_page_and_reload(server):
    from incubator_brpc_tpu_torch.utils.flags import get_flag

    assert "rpcz_enabled" in http_get(server.port, "/flags")[1]
    body = http_get(server.port, "/flags?flag=health_check_interval_s&setvalue=2.5")[1]
    try:
        assert "set to 2.5" in body and get_flag("health_check_interval_s") == 2.5
    finally:
        set_flag("health_check_interval_s", 1.0)
    assert "not reloadable" in http_get(server.port, "/flags?flag=nope&setvalue=1")[1]


def test_internal_port_serves_the_pages_and_no_methods():
    srv = Server(ServerOptions(internal_port=0))
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    try:
        assert srv.internal_port > 0 and srv.internal_port != srv.port
        for page in ("/status", "/vars", "/hotspots/runtime"):
            assert http_get(srv.internal_port, page)[0] == 200
            assert http_get(srv.port, page)[0] == 403
        ch = Channel(ChannelOptions(timeout_ms=3000))
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        c = Controller()
        assert echo_stub(ch).Echo(c, EchoRequest(message="pub")).message == "pub"
        ch.close()
        assert http_get(srv.internal_port, "/EchoService/Echo", "POST")[0] == 404
    finally:
        srv.stop()
    assert srv._internal_acceptor is None


def test_cluster_scrapes_reach_port_peers(server):
    """observability/cluster.py's remote fetches read a port peer's
    /cluster/export: the port's and the JAX package's scrapers get the
    same methods, and the /cluster pages merge over the peer."""
    from incubator_brpc_tpu.observability import cluster as j_cluster
    from incubator_brpc_tpu_torch.observability import cluster

    ch = Channel(ChannelOptions(timeout_ms=3000))
    assert ch.init(f"127.0.0.1:{server.port}") == 0
    for _ in range(4):
        echo_stub(ch).Echo(Controller(), EchoRequest(message="scrape"))
    ch.close()
    ep = f"127.0.0.1:{server.port}"
    payloads, errors = cluster.scrape_exports([ep])
    j_payloads, j_errors = j_cluster.scrape_exports([ep])
    assert not errors and not j_errors
    assert "EchoService.Echo" in payloads[0]["methods"]
    assert payloads[0]["methods"].keys() == j_payloads[0]["methods"].keys()
    st, body = http_get(server.port, f"/cluster/metrics?replicas={ep}")
    assert st == 200 and "EchoService.Echo" in body
    st, body = http_get(server.port, f"/cluster/latency_breakdown?replicas={ep}")
    assert st == 200 and "merged over 1 replicas" in body


# ---------------------------------------------------------------------------
# the renderers, held to the JAX package's text
# ---------------------------------------------------------------------------

HBM = {
    "tags": {"cache.values": {"bytes": 3 << 20, "allocs": 3},
             "ici.inflight": {"bytes": 1 << 26, "allocs": 1}},
    "accounted_bytes": (3 << 20) + (1 << 26),
    "census": {"available": True, "source": "memory_stats", "bytes": 80 << 20},
    "census_baseline": 4096,
    "dark_bytes": (80 << 20) - 4096 - (3 << 20) - (1 << 26),
}
DEVICE = {
    "ici.pallas": {"executions": 12, "total_us": 812.5, "ema_us": 66.1, "last_us": 64.0},
    "ps.forward": {"executions": 3, "total_us": 9130.25, "ema_us": 3001.2, "last_us": 2987.7},
}
CAPTURE = {
    "seconds": 2.004,
    "families": {"ici.pallas": {"executions": 40, "device_us": 2650.1, "ema_us": 66.2},
                 "decode.step": {"executions": 7, "device_us": 910.0, "ema_us": 130.0}},
    "trace_dir": "/tmp/device-trace-x",
    "trace_error": None,
}
RUNTIME = {
    "workers": 8, "blocked": 1, "parked": 5, "parks_total": 120, "steals_total": 9,
    "remote_q": 2,
    "per_worker": [{"worker_id": i, "rq_depth": i % 3, "steals": i, "runs": 100 * i}
                   for i in range(8)],
    "queue_wait": {"count": 512, "total_us": 40960, "ema_us": 80.5},
}


@pytest.mark.parametrize("name,args", [
    ("render_hbm", (HBM,)),
    ("render_hbm", (dict(HBM, census={"available": False, "source": None, "bytes": 0,
                                      "reason": "not loaded"}, dark_bytes=None),)),
    ("render_device", (DEVICE,)),
    ("render_device", ({},)),
    ("render_capture", (CAPTURE,)),
    ("render_capture", (dict(CAPTURE, families={}, trace_dir=None,
                             trace_error="RuntimeError('x')"),)),
    ("render_runtime", (RUNTIME,)),
    ("render_runtime", (dict(RUNTIME, per_worker=[]),)),
])
def test_renderers_give_the_jax_packages_text(name, args):
    assert getattr(profiling, name)(*args) == getattr(j_prof, name)(*args)


def test_port_only_lines_of_the_renderers():
    """The census line names the allocator's rounding when the census
    reports requested bytes (the only hbm line that differs); a capture
    with the profiler's kernels lists them after the JAX text."""
    cen = dict(HBM["census"], requested_bytes=(80 << 20) - 1536)
    port = profiling.render_hbm(dict(HBM, census=cen)).splitlines()
    jax = j_prof.render_hbm(HBM).splitlines()
    differ = [i for i, (a, b) in enumerate(zip(port, jax)) if a != b]
    assert len(port) == len(jax) and differ == [2]
    assert port[2] == jax[2] + (" rounding=1536 (allocated - requested: the caching "
                                "allocator rounds each block up, to 512 B at least)")
    kernels = {"copy_csum_blocks_kernel<float>": {"count": 4, "cuda_us": 160.5}}
    port = profiling.render_capture(dict(CAPTURE, kernels=kernels))
    jax = j_prof.render_capture(CAPTURE)
    assert port.startswith(jax + "\n")
    tail = port[len(jax) + 1:].splitlines()
    assert tail[1].startswith("device_us above: host dispatch windows")
    assert tail[-1].split() == ["4", "160.5", "copy_csum_blocks_kernel<float>"]


def test_hbm_census_rebase_and_growth_on_the_cpu():
    """No CUDA context on the CPU: the census is unavailable and <dark>
    unknown; the ledger's tags still render, and growth diffs them."""
    acct = profiling.hbm_account("test.builtin")
    text = profiling.render_hbm_growth()
    n = acct.adopt(torch.zeros(1024))
    try:
        assert "census: unavailable" in profiling.render_hbm()
        assert profiling.rebase_census()["available"] is False
        assert "test.builtin" in profiling.render_hbm()
        grown = profiling.render_hbm_growth()
        assert text == "hbm baseline captured; re-fetch for growth" or "---" in text
        assert f"{n:>+14}" in grown and "test.builtin" in grown
    finally:
        acct.release(n)


# ---------------------------------------------------------------------------
# device_capture on torch.profiler (tests/test_profiling.py:313-410)
# ---------------------------------------------------------------------------


def test_capture_exports_a_trace_and_counts_the_window(warm_profiler):
    before = profiling.rpc_profiler_captures_total.get_value()
    with profiling.kernel_section("test.before"):
        pass
    box = {}
    t = threading.Thread(target=lambda: box.setdefault("r", profiling.device_capture(0.3)))
    t.start()
    time.sleep(0.1)
    with profiling.kernel_section("test.in-window"):
        torch.ones(8).sum()
    t.join(10)
    r = box["r"]
    assert r["trace_error"] is None and r["seconds"] >= 0.3
    assert "test.in-window" in r["families"] and "test.before" not in r["families"]
    assert r["kernels"] == {}  # no CUDA context: no device events
    assert json.loads((pathlib.Path(r["trace_dir"]) / profiling.TRACE_FILE).read_text())
    assert profiling.rpc_profiler_captures_total.get_value() == before + 1
    assert not profiling.capture_active()


def test_concurrent_capture_is_refused_while_serving(server, warm_profiler):
    ch = Channel(ChannelOptions(timeout_ms=5000))
    assert ch.init(f"127.0.0.1:{server.port}") == 0
    box = {}

    def capture():
        try:
            box["result"] = profiling.device_capture(0.5)
        except profiling.CaptureError as e:
            box["error"] = e

    t = threading.Thread(target=capture)
    t.start()
    time.sleep(0.05)
    with pytest.raises(profiling.CaptureError, match="already in progress"):
        profiling.device_capture(0.2)
    ok = 0
    while t.is_alive():
        c = Controller()
        assert echo_stub(ch).Echo(c, EchoRequest(message="mid")).message == "mid"
        ok += 1
        with profiling.kernel_section("test.mid-capture"):
            pass
    t.join(5)
    ch.close()
    assert ok > 0 and "result" in box, box.get("error")
    assert box["result"]["families"]["test.mid-capture"]["executions"] >= 1
    assert not profiling.capture_active()


def test_chaos_drop_gives_a_500_and_leaves_the_profiler_disarmed(server, warm_profiler):
    injector.arm(FaultPlan(
        [FaultSpec("profile.capture", "drop", probability=1.0, max_hits=1)], seed=41))
    try:
        st, body = http_get(server.port, "/hotspots/device?seconds=0.05")
        assert st == 500 and "device capture failed" in body and "dropped" in body
        assert not profiling.capture_active()
        st, body = http_get(server.port, "/hotspots/device?seconds=0.05")
        assert st == 200 and "--- device capture" in body
    finally:
        injector.disarm()
    assert not profiling.capture_active()
    assert http_get(server.port, "/hotspots/device?seconds=x")[0] == 400


def test_chaos_delay_stretches_the_capture_start(warm_profiler):
    injector.arm(FaultPlan(
        [FaultSpec("profile.capture", "delay_us", arg=200_000, probability=1.0,
                   max_hits=1)], seed=43))
    try:
        t0 = time.monotonic()
        result = profiling.device_capture(0.05)
        wall = time.monotonic() - t0
    finally:
        injector.disarm()
    assert wall >= 0.2 and result["seconds"] < 0.2
    assert not profiling.capture_active()


def test_occupancy_sampler_counts_queue_waits(server):
    before = profiling.occupancy_snapshot()["queue_wait"]["count"]
    ch = Channel(ChannelOptions(timeout_ms=3000))
    assert ch.init(f"127.0.0.1:{server.port}") == 0
    for _ in range(5):
        echo_stub(ch).Echo(Controller(), EchoRequest(message="q"))
    ch.close()
    snap = profiling.occupancy_snapshot()
    assert snap["workers"] > 0 and snap["queue_wait"]["count"] > before
    assert f"workers: {snap['workers']}" in profiling.render_runtime(snap)


# ---------------------------------------------------------------------------
# rpc_dump and rpc_replay (tests/test_http_builtin.py:220-250)
# ---------------------------------------------------------------------------


class _Meta:
    def __init__(self, service, method, log_id):
        self.service_name, self.method_name, self.log_id = service, method, log_id


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_dump_files_read_back_in_the_other_package(tmp_path, writer):
    from incubator_brpc_tpu.utils.iobuf import IOBuf as JIOBuf
    from incubator_brpc_tpu_torch.utils.iobuf import IOBuf

    bodies = [bytes([i]) * (100 + i) for i in range(5)]
    if writer == "port":
        ctx = rpc_dump.RpcDumpContext(str(tmp_path), sample_ratio=1.0)
        for i, b in enumerate(bodies):
            ctx.sample_request(_Meta("PsService", "Forward", i), IOBuf(b), 40)
        read, files = j_dump.read_samples, j_dump.list_dump_files(str(tmp_path))
    else:
        ctx = j_dump.RpcDumpContext(str(tmp_path), sample_ratio=1.0)
        for i, b in enumerate(bodies):
            ctx.sample_request(_Meta("PsService", "Forward", i), JIOBuf(b))
        read, files = rpc_dump.read_samples, rpc_dump.list_dump_files(str(tmp_path))
    ctx._cur.flush()
    assert files == [os.path.join(str(tmp_path), "requests.0000")]
    samples = list(read(files[0]))
    assert [b for _, b in samples] == bodies
    assert [(m["service"], m["method"], m["log_id"]) for m, _ in samples] == [
        ("PsService", "Forward", i) for i in range(5)]
    assert all(m.get("attachment_size", 0) == (40 if writer == "port" else 0)
               for m, _ in samples)


def test_rpc_dump_and_replay(tmp_path):
    """tests/test_http_builtin.py's dump-and-replay of Echo, then a PS
    Forward whose x rides the attachment: the replayed call on a fresh
    server computes the same y."""
    from incubator_brpc_tpu_torch.tools.rpc_replay import replay

    dump_dir = str(tmp_path / "dump")
    w = np.random.default_rng(3).standard_normal((8, 8)).astype(np.float32)
    srv = Server(ServerOptions(rpc_dump_dir=dump_dir))
    srv.add_service(EchoService())
    ps = PsService(device=CPU)
    ps.put_param("w", w)
    srv.add_service(ps)
    assert srv.start(0) == 0
    srv._rpc_dump_ctx.sample_ratio = 1.0  # sample everything for the test
    dst_ps = PsService(device=CPU)
    dst_ps.put_param("w", w)
    seen = []
    forward = dst_ps.Forward

    def recorded(controller, request, response, done):
        forward(controller, request, response, lambda: (
            seen.append((controller.failed(), controller.response_attachment.to_bytes())),
            done()))

    dst_ps.Forward = recorded
    dst = Server()
    dst.add_service(EchoService())
    dst.add_service(dst_ps)
    assert dst.start(0) == 0
    try:
        ch = Channel(ChannelOptions(timeout_ms=3000))
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        for i in range(5):
            c = Controller()
            echo_stub(ch).Echo(c, EchoRequest(message=f"dump{i}"))
        xs = np.random.default_rng(4).standard_normal((3, 8)).astype(np.float32)
        for x in xs:
            c = Controller()
            c.request_attachment.append_user_data(x.tobytes())
            ps_stub(ch).Forward(c, EchoRequest(message="w"))
            assert not c.failed(), c.error_text()
        ch.close()
        files = rpc_dump.list_dump_files(dump_dir)
        samples = [s for f in files for s in rpc_dump.read_samples(f)]
        assert len(samples) == 8 and samples[0][0]["service"] == "EchoService"
        assert [m["attachment_size"] for m, _ in samples] == [0] * 5 + [32] * 3
        assert http_get(srv.port, "/rpc_dump")[1].count("requests.0000") == 1
        n = replay(f"127.0.0.1:{dst.port}", dump_dir, qps=500, report=lambda *_: None)
        assert n == 8
        deadline = time.monotonic() + 10
        while len(seen) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert [failed for failed, _ in seen] == [False] * 3
        ys = np.stack([np.frombuffer(y, np.float32) for _, y in seen])
        # the replayed frames run on scheduler workers and may finish in
        # another order than they were sent: each y must equal its own
        # x's row, every x answered once
        ref = xs @ w
        owners = [[i for i in range(len(ref)) if np.allclose(y, ref[i], rtol=1e-5, atol=1e-6)]
                  for y in ys]
        assert sorted(o[0] for o in owners if len(o) == 1) == [0, 1, 2], owners
    finally:
        srv.stop()
        dst.stop()


def test_rpc_dump_page_arms_and_disarms(tmp_path, server):
    st, body = http_get(server.port, f"/rpc_dump?dir={tmp_path}&ratio=0.5", "POST")
    assert st == 200 and json.loads(body) == {"enabled": True, "dir": str(tmp_path),
                                              "ratio": 0.5}
    assert json.loads(http_get(server.port, "/rpc_dump")[1])["ratio"] == 0.5
    assert http_get(server.port, "/rpc_dump?dir=x&ratio=2", "POST")[0] == 400
    st, body = http_get(server.port, "/rpc_dump?disable=1", "POST")
    assert st == 200 and server._rpc_dump_ctx is None


# ---------------------------------------------------------------------------
# trackme (tests/test_trackme.py)
# ---------------------------------------------------------------------------


class _CensusService(trackme.TrackMeService):
    def __init__(self):
        super().__init__()
        self.verdicts, self.seen = [], []

    def check(self, version, server_addr):
        self.seen.append((version, server_addr))
        return self.verdicts.pop(0) if self.verdicts else (TrackMeOK, "", 0)


def test_trackme_ping_round_trip_and_interval_retune(monkeypatch):
    svc = _CensusService()
    svc.verdicts = [(TrackMeOK, "", 0), (TrackMeWarning, "1.x has a known wobble", 0),
                    (TrackMeFatal, "1.0 corrupts data, upgrade NOW", 45)]
    srv = Server()
    srv.add_service(svc)
    assert srv.start(0) == 0
    logged = []
    monkeypatch.setattr(trackme, "log_error", lambda fmt, *a: logged.append(fmt % a))
    pinger = trackme._TrackMePinger()
    try:
        set_flag("trackme_server", "")
        assert pinger.ping_now() is None and pinger.pings == 0
        set_flag("trackme_server", f"127.0.0.1:{srv.port}")
        resp = pinger.ping_now(server_addr="10.0.0.7:8000")
        assert resp.severity == TrackMeOK and pinger.pings == 1 and not logged
        assert svc.seen[-1] == (trackme.rpc_version(), "10.0.0.7:8000")
        assert pinger.ping_now().severity == TrackMeWarning
        assert any("wobble" in ln and "warning" in ln for ln in logged)
        assert pinger.ping_now().severity == TrackMeFatal
        assert any("FATAL" in ln and "upgrade NOW" in ln for ln in logged)
        assert pinger._interval == 45 and pinger.pings == 3
    finally:
        set_flag("trackme_server", "")
        srv.stop()


def test_trackme_background_loop_pings():
    svc = _CensusService()
    srv = Server()
    srv.add_service(svc)
    assert srv.start(0) == 0
    pinger = trackme._TrackMePinger()
    try:
        set_flag("trackme_server", "")
        pinger.start_once()
        assert pinger._thread is None  # opt-in
        set_flag("trackme_server", f"127.0.0.1:{srv.port}")
        pinger.start_once()
        assert pinger._thread is not None
        deadline = time.monotonic() + 10
        while pinger.pings == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert pinger.pings >= 1 and pinger.last_response.severity == TrackMeOK
    finally:
        pinger.stop()
        set_flag("trackme_server", "")
        srv.stop()
    assert pinger._thread is None
