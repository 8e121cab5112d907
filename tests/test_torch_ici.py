"""The port's ICI echo held against the JAX package's, plus the fabric
scenarios of tests/test_ici.py and tests/test_ici_pipeline.py rerun
against ``incubator_brpc_tpu_torch``.

Everything runs on the CPU: the port's server and channel are given
``torch.device("cpu")``, so each transmit runs the plain version of its
kernel (and still computes the checksum).  The port's registries (the
fabric, the chaos injector, the metrics) are separate from the JAX
package's: these tests arm and read the port's.
"""

import ast
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.parallel import ici as port_ici
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
from incubator_brpc_tpu_torch.utils.iobuf import IOBuf

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_PKG = ROOT / "incubator_brpc_tpu_torch"
CPU = torch.device("cpu")
MODES = ["off", "fused", "pipelined", "pallas"]

_coords_counter = [500]


def fresh_coords():
    _coords_counter[0] += 1
    return (11, _coords_counter[0])


@pytest.fixture
def fabric():
    """The port's fabric with 64KB chunks: a 1MB payload chunks here
    (tests/test_ici_pipeline.py:142)."""
    fab = port_ici.get_fabric()
    saved = (fab.chunk_mode, fab.chunk_bytes)
    fab.chunk_bytes = 64 * 1024
    yield fab
    fab.chunk_mode, fab.chunk_bytes = saved


@pytest.fixture
def echo_server():
    srv = Server()
    srv.add_service(EchoService())
    s, c = fresh_coords()
    assert srv.start_ici(s, c, device=CPU) == 0
    srv._test_addr = f"ici://slice{s}/chip{c}"
    yield srv
    srv.stop()


def _stub(addr):
    ch = Channel(ChannelOptions(timeout_ms=30000, ici_device=CPU))
    assert ch.init(addr) == 0
    return echo_stub(ch)


def _echo(stub, t):
    c = Controller()
    c.request_attachment.append_device(t)
    stub.Echo(c, EchoRequest(message="bulk"))
    assert not c.failed(), c.error_text()
    segs = c.response_attachment.device_segments()
    assert len(segs) == 1 and segs[0].whole_array() is not None
    return segs[0]


def _jax_echo(x_np, mode, chunk_bytes):
    """The same echo through the JAX package's own fabric."""
    import jax

    from incubator_brpc_tpu.client.channel import Channel as JChannel
    from incubator_brpc_tpu.client.channel import ChannelOptions as JOptions
    from incubator_brpc_tpu.client.controller import Controller as JController
    from incubator_brpc_tpu.models.echo import EchoService as JEcho
    from incubator_brpc_tpu.models.echo import echo_stub as jecho_stub
    from incubator_brpc_tpu.parallel.ici import get_fabric as jget_fabric
    from incubator_brpc_tpu.protos.echo_pb2 import EchoRequest as JRequest
    from incubator_brpc_tpu.server.server import Server as JServer

    fab = jget_fabric()
    saved = (fab.chunk_mode, fab.chunk_bytes)
    fab.chunk_mode, fab.chunk_bytes = mode, chunk_bytes
    dev = jax.devices()[0]
    srv = JServer()
    srv.add_service(JEcho())
    s, c = fresh_coords()
    assert srv.start_ici(s, c, device=dev) == 0
    try:
        ch = JChannel(JOptions(timeout_ms=30000, ici_device=dev))
        assert ch.init(f"ici://slice{s}/chip{c}") == 0
        ctrl = JController()
        ctrl.request_attachment.append_device(jax.numpy.asarray(x_np))
        jecho_stub(ch).Echo(ctrl, JRequest(message="bulk"))
        assert not ctrl.failed(), ctrl.error_text()
        return np.asarray(ctrl.response_attachment.device_arrays()[0])
    finally:
        srv.stop()
        fab.chunk_mode, fab.chunk_bytes = saved


# ---- the echo, per chunk mode, against the JAX package ----------------------


@pytest.mark.parametrize("mode", MODES)
def test_echo_matches_jax_fabric(fabric, echo_server, mode):
    from incubator_brpc_tpu_torch.analysis.device_witness import transfer_counts
    from incubator_brpc_tpu_torch.ops import transfer as TT

    fabric.chunk_mode = mode
    x_np = np.random.RandomState(21).randn(1024, 256).astype(np.float32)
    x = torch.from_numpy(x_np)
    views0 = transfer_counts().get("iobuf.host-view", 0)
    frames0 = int(port_ici.ici_pallas_frames.get_value())
    TT.reset_launch_counts()
    ref = _echo(_stub(echo_server._test_addr), x)
    out = ref.array
    assert out.data_ptr() != x.data_ptr(), "transmit must produce a fresh buffer"
    assert out.device == CPU and torch.equal(out, x)
    np.testing.assert_array_equal(out.numpy(), _jax_echo(x_np, mode, fabric.chunk_bytes))
    # the frame checksum rides the response, bit-equal to the whole frame's
    assert torch.equal(ref.csum, TT.device_copy_with_checksum(x)[1])
    # no payload byte went through the host, and no kernel ran on the CPU
    assert transfer_counts().get("iobuf.host-view", 0) == views0
    assert all(v == 0 for v in TT.launches.values())
    frames = int(port_ici.ici_pallas_frames.get_value()) - frames0
    assert frames == (2 if mode == "pallas" else 0)


def test_one_byte_wire_tail_survives_pallas_mode(fabric, echo_server):
    fabric.chunk_mode = "pallas"
    payload = bytes(range(256)) * 1024 + b"\x7f"
    assert len(payload) == 4 * fabric.chunk_bytes + 1
    c = Controller()
    c.request_attachment.append(payload)
    _stub(echo_server._test_addr).Echo(c, EchoRequest(message="tail"))
    assert not c.failed(), c.error_text()
    assert c.response_attachment.to_bytes() == payload


@pytest.mark.parametrize("mode", ["fused", "pipelined", "pallas"])
def test_chunk_fault_surfaces_one_einternal(fabric, echo_server, mode):
    from incubator_brpc_tpu_torch.chaos import FaultPlan
    from incubator_brpc_tpu_torch.chaos import injector as chaos_injector
    from incubator_brpc_tpu_torch.chaos.plan import FaultSpec

    fabric.chunk_mode = mode
    stub = _stub(echo_server._test_addr)
    x = torch.ones((1024, 256), dtype=torch.float32)  # 1MB → 4 chunks
    _echo(stub, x)
    chaos_injector.arm(FaultPlan(
        [FaultSpec("ici.chunk", "reset", probability=1.0, max_hits=1)],
        seed=1234, name=f"{mode}-chunk-fault",
    ))
    try:
        c = Controller()
        c.max_retry = 0
        c.request_attachment.append_device(x)
        stub.Echo(c, EchoRequest(message="bulk"))
        assert c.failed() and c.error_code == errors.EINTERNAL, (
            c.error_code, c.error_text(),
        )
        hits = chaos_injector.site_hits().get("ici.chunk", {})
        assert sum(hits.values()) == 1, hits
    finally:
        chaos_injector.disarm()
    # the faulted frame reserved no window credit, and the connection lives
    assert echo_server._ici_port._queued_bytes == 0
    assert torch.equal(_echo(stub, x).array, x)


def test_unknown_coords_fail_fast():
    stub = _stub("ici://slice9/chip999")
    c = Controller()
    c.max_retry = 1
    stub.Echo(c, EchoRequest(message="x"))
    assert c.failed()
    assert c.error_code in (errors.EFAILEDSOCKET, errors.ERPCTIMEDOUT)


def test_small_message_echo_and_zero_copy_mode(echo_server):
    stub = _stub(echo_server._test_addr)
    c = Controller()
    r = stub.Echo(c, EchoRequest(message="ici-ping"))
    assert not c.failed() and r.message == "ici-ping"
    assert c.remote_side.is_ici()
    fab = port_ici.get_fabric()
    fab.zero_copy = True
    try:
        x = torch.ones((256, 128))
        assert _echo(stub, x).array is x, "zero_copy moves the tensor by reference"
    finally:
        fab.zero_copy = False


# ---- staging ring: allocation-free steady state ------------------------------


class _Shim:
    coords = (0, 0)
    device = CPU

    def __init__(self, depth):
        self.staging = port_ici.StagingRing(depth=depth)


def test_pipelined_ring_reaches_zero_alloc_steady_state(fabric):
    from incubator_brpc_tpu_torch.ops import transfer as TT

    fabric.chunk_mode = "pipelined"
    shim = _Shim(depth=4)
    # 512KB at 64KB chunks, block rows 256 → 4 chunks of 256 rows
    x = torch.from_numpy(np.random.RandomState(3).randn(1024, 128).astype(np.float32))
    whole = TT.device_copy_with_checksum(x)[1]
    out, csum = fabric._transmit_pipelined(x, shim, None)
    assert torch.equal(out, x) and torch.equal(csum, whole)
    assert shim.staging.misses == 4 and shim.staging.hits == 0
    out2, csum2 = fabric._transmit_pipelined(x, shim, None)
    assert torch.equal(out2, x) and torch.equal(csum2, whole)
    assert shim.staging.hits == 4, "steady state must recycle every slot"
    assert shim.staging.misses == 4, "steady state must not allocate"


def test_pallas_ring_slot_recycles(fabric):
    from incubator_brpc_tpu_torch.ops import transfer as TT

    fabric.chunk_mode = "pallas"
    shim = _Shim(depth=2)
    x = torch.from_numpy(np.random.RandomState(11).randn(1024, 128).astype(np.float32))
    whole = TT.device_copy_with_checksum(x)[1]
    out1, csum1 = fabric._transmit_pallas(x, shim, None)
    assert shim.staging.misses == 1 and shim.staging.hits == 0
    assert torch.equal(csum1, whole)
    shim.staging.release(out1)  # the receiver hands the buffer back
    out2, csum2 = fabric._transmit_pallas(x, shim, None)
    assert shim.staging.hits == 1, "steady state must recycle the slot"
    assert out2.data_ptr() == out1.data_ptr(), "the slot path writes the slot"
    assert torch.equal(out2, x) and torch.equal(csum2, whole)


def test_staging_ring_bookkeeping():
    ring = port_ici.StagingRing(depth=2, max_keys=2)
    assert ring.acquire((4, 4), torch.float32) is None
    a = torch.zeros((4, 4))
    ring.release(a)
    assert ring.acquire((4, 4), torch.float32) is a
    b, c, d = (torch.zeros((4, 4)) for _ in range(3))
    for t in (b, c, d):
        ring.release(t)
    assert ring.acquire((4, 4), torch.float32) is b
    assert ring.acquire((4, 4), torch.float32) is c
    assert ring.acquire((4, 4), torch.float32) is None


def test_stacked_transmit_makes_one_dispatch(fabric):
    fabric.chunk_mode = "pallas"

    class _Ref:
        array = None
        csum = "sentinel"

    rng = np.random.RandomState(5)
    same = [torch.from_numpy(rng.randn(64, 128).astype(np.float32)) for _ in range(4)]
    odd = torch.from_numpy(rng.randn(32, 128).astype(np.float32))
    pairs = [(_Ref(), t) for t in same] + [(_Ref(), odd)]
    frames0 = int(port_ici.ici_pallas_stacked_frames.get_value())
    segs0 = int(port_ici.ici_pallas_stacked_segments.get_value())
    rest = fabric._transmit_stacked(pairs, _Shim(depth=2), None)
    assert [t is odd for _, t in rest] == [True]
    assert int(port_ici.ici_pallas_stacked_frames.get_value()) - frames0 == 1
    assert int(port_ici.ici_pallas_stacked_segments.get_value()) - segs0 == 4
    for ref, t in pairs[:4]:
        assert ref.csum is None, "integrity rides the stack checksum"
        assert torch.equal(ref.array, t)


# ---- receive window -----------------------------------------------------------


def test_receive_window_backpressure():
    fab = port_ici.get_fabric()
    coords = fresh_coords()
    port = fab.register(coords, server=object())
    gate = threading.Event()
    released = threading.Event()

    def blocker(batch):
        for frame, _ in batch:
            released.set()
            gate.wait(10)
            with port._qb_lock:
                port._queued_bytes -= len(frame)

    port._cq._consumer = blocker
    port.overcrowded_bytes = 4 << 20
    try:
        src = fresh_coords()
        assert fab.send(IOBuf(b"x" * (1 << 20)), coords, src) == 0
        assert released.wait(5)
        rcs = [fab.send(IOBuf(b"x" * (1 << 20)), coords, src) for _ in range(8)]
        assert errors.EOVERCROWDED in rcs, rcs
        assert port._queued_bytes <= port.overcrowded_bytes
        gate.set()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if fab.send(IOBuf(b"y"), coords, src) == 0:
                break
            time.sleep(0.02)
        else:
            raise AssertionError("window never reopened after drain")
    finally:
        gate.set()
        fab.unregister(coords)


def test_closed_port_releases_the_whole_batchs_window():
    """A batch drained after its port closed releases the window bytes
    of every frame in it, the undelivered rest included.  The queue
    hands the drain an iterable, not a list: the JAX package's drain
    slices it (``batch[i + 1:]``) and raises TypeError there instead."""
    from incubator_brpc_tpu_torch.runtime.execution_queue import TaskIterator

    fab = port_ici.get_fabric()
    coords = fresh_coords()
    port = fab.register(coords, server=object())
    try:
        frames = [(IOBuf(b"a" * 100), (0, 1)), (IOBuf(b"b" * 28), (0, 1))]
        with port._qb_lock:
            port._queued_bytes += 128
        port.closed = True
        port._drain_completions(TaskIterator(frames, False))
        assert port._queued_bytes == 0
    finally:
        port.closed = False
        fab.unregister(coords)


# ---- device selection and what is not ported --------------------------------


def test_start_ici_without_cuda_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    srv = Server()
    srv.add_service(EchoService())
    with pytest.raises(RuntimeError):
        srv.start_ici(*fresh_coords())
    assert not srv.is_running()


def test_unported_branches_raise_not_implemented(tmp_path):
    """Every branch this test pinned as unported is ported now; it holds
    what each does instead.  No branch of the port raises
    NotImplementedError for a missing item any more."""
    from incubator_brpc_tpu_torch import native
    from incubator_brpc_tpu_torch.client.ring import SubmissionRing

    # cluster channels: a naming URL with a balancer inits
    ch = Channel()
    assert ch.init("list://127.0.0.1:1,127.0.0.1:2", "rr") == 0
    # call_many and submission_ring run; on a channel that is not
    # native, call_many degrades to one call_method per request
    assert ch.call_many(None, []) == []
    assert isinstance(ch.submission_ring(), SubmissionRing)
    ch.close()
    from incubator_brpc_tpu_torch.transport.ssl_helper import ChannelSSLOptions

    tls = Channel(ChannelOptions(ssl_options=ChannelSSLOptions()))
    assert tls.init("127.0.0.1:1") == 0
    tls.close()
    # connection_type="native" runs over the port's own engine, built in
    # the port's package; TLS on a native channel degrades to pooled
    nat = Channel(ChannelOptions(connection_type="native"))
    assert nat.init("127.0.0.1:1") == 0 and nat.options.connection_type == "native"
    nat.close()
    assert PORT_PKG in native.engine_path().parents
    nat_tls = Channel(ChannelOptions(connection_type="native", ssl_options=ChannelSSLOptions()))
    assert nat_tls.init("127.0.0.1:1") == 0
    assert nat_tls.options.connection_type == "pooled"
    nat_tls.close()
    # the combo channels and the authenticator are ported and exported
    # as the JAX package exports them
    import incubator_brpc_tpu_torch as port
    from incubator_brpc_tpu_torch.client import auth, combo

    assert port.ParallelChannel is combo.ParallelChannel
    assert port.SelectiveChannel is combo.SelectiveChannel
    assert port.PartitionChannel is combo.PartitionChannel
    assert port.Authenticator is auth.Authenticator
    assert port.AuthContext is auth.AuthContext
    # the native engine serves; with TLS it yields to the Python
    # transport as the JAX package's does
    srv = Server(ServerOptions(native_engine=True))
    srv.add_service(EchoService())
    try:
        assert srv.start(0) == 0 and srv._native_engine is not None
    finally:
        srv.stop()
    assert srv._native_engine is None
    # rpc_dump sampling and internal_port are ported: both start
    srv = Server(ServerOptions(rpc_dump_dir=str(tmp_path / "dump"), internal_port=0))
    srv.add_service(EchoService())
    try:
        assert srv.start(0) == 0 and srv.is_running()
        assert srv._rpc_dump_ctx is not None and srv.internal_port > 0
    finally:
        srv.stop()
    assert not (PORT_PKG / "unported.py").exists()


def test_hbm_ledger_and_census_on_cpu(fabric, echo_server):
    from incubator_brpc_tpu_torch.observability import profiling

    acct = profiling.hbm_account("test.torch")
    n = acct.adopt(torch.zeros((16, 128)))
    assert n == 16 * 128 * 4 and acct.live_bytes() == n
    acct.release(n)
    assert acct.live_bytes() == 0
    prof = profiling.hbm_profile()
    if not torch.cuda.is_available():
        assert prof["census"]["available"] is False and prof["dark_bytes"] is None
    before = profiling.kernel_snapshot().get("ici.chunk", {}).get("executions", 0)
    fabric.chunk_mode = "pipelined"
    _echo(_stub(echo_server._test_addr), torch.ones((1024, 256)))
    after = profiling.kernel_snapshot()["ici.chunk"]["executions"]
    # one dispatch window per chunk per hop: 64KB chunks of 1KB rows
    # clamp up to the 256-row block, so 4 chunks per hop
    assert after - before == 2 * 4


# ---- the port stands alone ----------------------------------------------------

_GUARD = """
import sys, time, torch
import incubator_brpc_tpu_torch
from incubator_brpc_tpu_torch import Channel, ChannelOptions, Controller, Server
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
cpu = torch.device("cpu")
srv = Server(); srv.add_service(EchoService())
assert srv.start_ici(3, 77, device=cpu) == 0
ch = Channel(ChannelOptions(timeout_ms=30000, ici_device=cpu))
assert ch.init("ici://slice3/chip77") == 0
c = Controller(); x = torch.arange(64 * 128, dtype=torch.float32).reshape(64, 128)
c.request_attachment.append_device(x)
echo_stub(ch).Echo(c, EchoRequest(message="guard"))
assert not c.failed(), c.error_text()
assert torch.equal(c.response_attachment.device_arrays()[0], x)
srv.stop()
# the cache, streaming and serving tiers, each driven once
from incubator_brpc_tpu_torch.cache import HBMCacheService, HBMCacheStore
from incubator_brpc_tpu_torch.protocols import redis as R
from incubator_brpc_tpu_torch.server.server import ServerOptions
from incubator_brpc_tpu_torch.serving.decode import DecodeService
from incubator_brpc_tpu_torch.serving.prefill import PrefillService
from incubator_brpc_tpu_torch.serving.router import SessionChannel
from incubator_brpc_tpu_torch.streaming.generate import DecodeLoop
import incubator_brpc_tpu_torch.models.streaming_echo, incubator_brpc_tpu_torch.serving.metrics
srv = Server(ServerOptions(redis_service=HBMCacheService(device=cpu)))
assert srv.start_ici(3, 78, device=cpu) == 0
ch = Channel(ChannelOptions(protocol="redis", timeout_ms=30000, ici_device=cpu))
assert ch.init("ici://slice3/chip78") == 0
req = R.RedisRequest(); req.add_command("SET", b"k", b"v" * 256); req.add_command("GET", b"k")
resp = R.RedisResponse(); c = Controller()
ch.call_method(R.redis_method_spec(), c, req, resp)
assert not c.failed(), c.error_text()
assert resp.reply(1).bytes_value() == b"v" * 256
srv.stop()
store = HBMCacheStore(1 << 20, device=cpu)
reps = [DecodeService(store, DecodeLoop(dim=8, device=cpu), name="g")]
res = SessionChannel(PrefillService(store, dim=8, n_layers=2, device=cpu), reps).generate(
    "guard", "guard prompt", 3)
assert len(res.tokens) == 3 and res.prefill_executions == 1
reps[0].close()
# the DCN bridge and the cluster tier: a cache cluster over list://, a
# replicated group, a resharding plan, with the bridge listening
from incubator_brpc_tpu_torch.cache import CacheChannel
from incubator_brpc_tpu_torch.client.lb_with_naming import LoadBalancerWithNaming
from incubator_brpc_tpu_torch.parallel.dcn import get_bridge, listen_dcn
from incubator_brpc_tpu_torch.replication import replicated_cache_group
from incubator_brpc_tpu_torch.resharding import moved_keys
assert listen_dcn(0, host="127.0.0.1") > 0
srv = Server(ServerOptions(redis_service=HBMCacheService(device=cpu)))
assert srv.start_ici(3, 79, device=cpu) == 0
cc = CacheChannel("list://ici://slice3/chip79", lb="rr",
                  options=ChannelOptions(timeout_ms=30000, ici_device=cpu))
g = replicated_cache_group("guard", [cc], register=False)
g.put("k", b"v" * 64)
assert cc.get_host("k") == b"v" * 64 and moved_keys(["k"], 1, 2) is not None
cc.close(); srv.stop(); get_bridge().close()
# the combo channels: a sharded PS fan-out, its replicated and
# live-resharded forms, the cluster observability plane, the native hash
import numpy as np
from incubator_brpc_tpu_torch.client.combo import DynamicShardChannel
from incubator_brpc_tpu_torch.models.parameter_server import (
    PsService, ps_stub, scatter_param, sharded_ps_channel)
from incubator_brpc_tpu_torch.observability import cluster, trace
from incubator_brpc_tpu_torch.replication import replicated_ps_channel
from incubator_brpc_tpu_torch.resharding import MigrationView
from incubator_brpc_tpu_torch.tools import rpc_view
from incubator_brpc_tpu_torch.utils.hashes import murmur3_32
eps, servers = [], []
for chip in (80, 81):
    srv = Server(); srv.add_service(PsService(device=cpu))
    assert srv.start_ici(3, chip, device=cpu) == 0
    servers.append(srv); eps.append(f"ici://slice3/chip{chip}")
opts = ChannelOptions(timeout_ms=30000, ici_device=cpu)
sh = sharded_ps_channel(endpoints=eps, timeout_ms=30000, channel_options=opts)
w = np.arange(16 * 16, dtype=np.float32).reshape(16, 16)
scatter_param(sh, "w", w)
c = Controller(); c.request_attachment.append_user_data(np.ones(16, np.float32).tobytes())
ps_stub(sh).Forward(c, EchoRequest(message="w"))
assert not c.failed(), c.error_text()
assert np.array_equal(np.frombuffer(c.response_attachment.to_bytes(), np.float32), w.sum(0))
dyn = DynamicShardChannel(sharded_ps_channel(endpoints=eps[:1], channel_options=opts), sh, MigrationView())
rep = replicated_ps_channel([[e] for e in eps], register=False, channel_options=opts)
assert rep.rf1 and murmur3_32(b"guard") == 2201486462
for srv in servers: srv.stop()
# the HTTP front: builtin pages, SSE, rpc_dump, trackme, the profiler
import json, tempfile, urllib.request
from incubator_brpc_tpu_torch.observability import profiling, trackme
from incubator_brpc_tpu_torch.streaming.generate import GenerateService, generate_stub
from incubator_brpc_tpu_torch.tools.rpc_replay import replay
import incubator_brpc_tpu_torch.client.naming_remote, incubator_brpc_tpu_torch.serialization
gen = GenerateService(DecodeLoop(dim=8, device=cpu))
srv = Server(ServerOptions(rpc_dump_dir=tempfile.mkdtemp()))
srv.add_service(gen); srv.add_service(EchoService())
assert srv.start(0) == 0
srv._rpc_dump_ctx.sample_ratio = 1.0
for page in ("status", "vars", "metrics", "hotspots/hbm", "hotspots/runtime",
             "hotspots/device?seconds=0.01", "cache", "serving", "replication", "resharding"):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/{page}", timeout=30) as r:
        assert r.status == 200, page
ch = Channel(ChannelOptions(protocol="http", timeout_ms=30000))
assert ch.init(f"127.0.0.1:{srv.port}") == 0
c = Controller(); c.response_will_be_read_progressively()
generate_stub(ch).GenerateSSE(c, EchoRequest(message="guard", code=3))
parts = []; c.read_progressive_attachment(lambda p: parts.append(p))
while not parts or parts[-1] is not None: time.sleep(0.01)
assert b"".join(parts[:-1]).count(b"data: ") == 4
tcp = Channel(ChannelOptions(timeout_ms=30000)); assert tcp.init(f"127.0.0.1:{srv.port}") == 0
c = Controller(); echo_stub(tcp).Echo(c, EchoRequest(message="dumped")); assert not c.failed()
assert replay(f"127.0.0.1:{srv.port}", srv._rpc_dump_ctx.dump_dir, report=lambda *_: None) >= 1
assert trackme.pinger().ping_now() is None
ch.close(); tcp.close(); srv.stop(); gen.close()
# the mesh: a collective, the in-mesh sharded PS over ici://, the
# sharded prefill and the dp x tp training step
from incubator_brpc_tpu_torch import convert
from incubator_brpc_tpu_torch.batching.sharded import ShardedFusedKernel
from incubator_brpc_tpu_torch.models.parameter_server import make_training_step
from incubator_brpc_tpu_torch.parallel import collectives as coll
from incubator_brpc_tpu_torch.parallel import create_mesh
mesh = create_mesh((1, 4), devices=[cpu] * 4)
x = torch.arange(32, dtype=torch.float32).reshape(8, 4)
assert torch.equal(coll.parallel_merge(mesh)(x).full(), x.reshape(4, 2, 4).sum(0))
svc = PsService(mesh=mesh); srv = Server(); srv.add_service(svc)
assert srv.start_ici(3, 82, device=cpu) == 0
ch = Channel(opts); assert ch.init("ici://slice3/chip82") == 0
c = Controller(); c.request_attachment.append_device(torch.from_numpy(w))
ps_stub(ch).Put(c, EchoRequest(message="w")); assert not c.failed(), c.error_text()
c = Controller(); c.request_attachment.append_user_data(np.ones(16, np.float32).tobytes())
ps_stub(ch).Forward(c, EchoRequest(message="w")); assert not c.failed(), c.error_text()
assert np.array_equal(np.frombuffer(c.response_attachment.to_bytes(), np.float32), w.sum(0))
assert svc.shard_kernel.executions == 1 and svc.remesh(create_mesh((1, 2), devices=[cpu] * 2)) == 1
ch.close(); srv.stop()
pf = PrefillService(HBMCacheStore(1 << 20, device=cpu), dim=8, n_layers=2, mesh=mesh)
assert pf.prefill_sessions([("m", "mesh")])["m"]["prefill_executions"] == 1
step, params, xx = make_training_step(create_mesh((2, 2), devices=[cpu] * 4), dim=8, batch=4)
params, loss = step(params, xx)
params, xx = convert.training_state_from_reference(
    {k: v.full().numpy() for k, v in params.items()}, xx.full().numpy(), mesh)
from incubator_brpc_tpu_torch.analysis import device_witness, pytest_plugin, witness
from incubator_brpc_tpu_torch.client.auth import Authenticator, AuthContext
from incubator_brpc_tpu_torch.runtime import fd
from incubator_brpc_tpu_torch.serialization import mcpack
from incubator_brpc_tpu_torch.tools import check
from incubator_brpc_tpu_torch.utils import timeio
assert not check.run_check(invariants=False)["violations"]
device_witness.enable(); device_witness.disable()
assert mcpack.loads(mcpack.dumps({"k": [1, "v"]})) == {"k": [1, "v"]}
# the native engine: a native server and channel, a call_many window,
# rpc_press --native and parallel_http against the same port
from incubator_brpc_tpu_torch import native
from incubator_brpc_tpu_torch.tools.parallel_http import fetch_all
from incubator_brpc_tpu_torch.tools.rpc_press import press_native
srv = Server(ServerOptions(native_engine=True)); srv.add_service(EchoService())
assert srv.start(0) == 0 and srv._native_engine is not None
ch = Channel(ChannelOptions(timeout_ms=30000, connection_type="native"))
assert ch.init(f"127.0.0.1:{srv.port}") == 0
assert len(echo_stub(ch).call_many("Echo", [EchoRequest(message="n")] * 4)) == 4
assert press_native(f"127.0.0.1:{srv.port}", duration_s=0.1, report=lambda *_: None)["ok"] > 0
assert fetch_all([f"127.0.0.1:{srv.port}/status"], 1, report=lambda *_: None)[1].ok == 1
ch.close(); srv.stop()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "incubator_brpc_tpu"
             or m.startswith("incubator_brpc_tpu."))
print("FOREIGN", bad)
"""


def test_port_runs_without_jax_or_the_jax_package():
    res = subprocess.run(
        [sys.executable, "-c", _GUARD], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "FOREIGN []" in res.stdout, res.stdout


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_sources_import_neither_jax_nor_the_jax_package():
    paths = sorted(PORT_PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(paths) > 40
    # the native engine's bindings are scanned like every module, and its
    # C sources include nothing of either package
    assert PORT_PKG / "native" / "__init__.py" in paths
    for src in ("engine.cpp", "fastcall.c"):
        includes = [ln for ln in (PORT_PKG / "native" / src).read_text().splitlines()
                    if ln.startswith("#include")]
        assert includes and not [ln for ln in includes
                                 if "jax" in ln or "incubator_brpc_tpu" in ln]
    foreign = [
        (str(p.relative_to(ROOT)), mod)
        for p in paths
        for mod in _imported_modules(p)
        if mod.split(".")[0] in ("jax", "jaxlib", "incubator_brpc_tpu")
    ]
    assert foreign == []
