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


# ---- device selection and what is not ported --------------------------------


def test_start_ici_without_cuda_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    srv = Server()
    srv.add_service(EchoService())
    with pytest.raises(RuntimeError):
        srv.start_ici(*fresh_coords())
    assert not srv.is_running()


def test_unported_branches_raise_not_implemented():
    ch = Channel()
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 12"):
        ch.init("list://127.0.0.1:1,127.0.0.1:2", "rr")
    with pytest.raises(NotImplementedError):
        Channel(ChannelOptions(connection_type="native")).init("127.0.0.1:1")
    with pytest.raises(NotImplementedError, match="item 12"):
        Server(ServerOptions(native_engine=True)).start(0)
    srv = Server(ServerOptions(enable_batching=True))
    with pytest.raises(NotImplementedError, match="item 4"):
        srv.start_ici(*fresh_coords(), device=CPU)
    assert not srv.is_running()


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
import sys, torch
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
    foreign = [
        (str(p.relative_to(ROOT)), mod)
        for p in paths
        for mod in _imported_modules(p)
        if mod.split(".")[0] in ("jax", "jaxlib", "incubator_brpc_tpu")
    ]
    assert foreign == []
