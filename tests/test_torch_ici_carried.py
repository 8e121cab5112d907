"""ICI fabric transport tests, carried by hand from ``tests/test_ici.py``.

RPC over ici:// with device payloads.  Each server port and channel is
given the device the case runs on (the CPU, where the port's wrappers run
their plain versions, or the card): the port has no default device to
fall back on.  Payloads are made from a seed with numpy; where a case
checks a device value, the JAX package's function runs on the same input.
"""

import threading

import numpy as np
import pytest
import torch

from torch_carry import torch_device  # noqa: F401  (fixture)

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest

_coords_counter = [100]


def fresh_coords():
    _coords_counter[0] += 1
    return (7, _coords_counter[0])


@pytest.fixture
def ici_server(torch_device):
    from incubator_brpc_tpu_torch.server.server import Server

    srv = Server()
    srv.add_service(EchoService())
    s, c = fresh_coords()
    assert srv.start_ici(s, c, device=torch_device) == 0
    srv._test_addr = f"ici://slice{s}/chip{c}"
    srv._test_device = torch_device
    yield srv
    srv.stop()


def make_channel(addr, device=None):
    # generous, as the JAX file's: a loaded box can stall the first call
    ch = Channel(ChannelOptions(timeout_ms=30000, ici_device=device))
    assert ch.init(addr) == 0
    return ch


def test_ici_echo(ici_server):
    stub = echo_stub(make_channel(ici_server._test_addr, ici_server._test_device))
    c = Controller()
    r = stub.Echo(c, EchoRequest(message="ici-ping"))
    assert not c.failed(), c.error_text()
    assert r.message == "ici-ping"
    assert c.remote_side.is_ici()


def test_ici_device_payload_zero_copy(ici_server):
    stub = echo_stub(make_channel(ici_server._test_addr, ici_server._test_device))
    x = torch.arange(1024 * 256, dtype=torch.float32).reshape(1024, 256)  # 1MB
    x = x.to(ici_server._test_device)
    c = Controller()
    c.request_attachment.append_device(x)
    r = stub.Echo(c, EchoRequest(message="bulk"))
    assert not c.failed(), c.error_text()
    assert len(c.response_attachment) == x.nbytes
    arrs = c.response_attachment.device_arrays()
    assert len(arrs) == 1, "device payload was materialized to host bytes"
    assert arrs[0].shape == (1024, 256)


def test_ici_concurrent_calls(ici_server):
    stub = echo_stub(make_channel(ici_server._test_addr, ici_server._test_device))
    n = 40
    results = [None] * n
    barrier = threading.Barrier(n + 1, timeout=20)

    def call(i):
        c = Controller()
        r = stub.Echo(c, EchoRequest(message=f"m{i}"))
        results[i] = (c.failed(), r.message)
        barrier.wait()

    for i in range(n):
        threading.Thread(target=call, args=(i,), daemon=True).start()
    barrier.wait()
    assert all(not f and m == f"m{i}" for i, (f, m) in enumerate(results))


def test_ici_fault_injection(ici_server):
    stub = echo_stub(make_channel(ici_server._test_addr, ici_server._test_device))
    c = Controller()
    stub.Echo(c, EchoRequest(message="x", server_fail=errors.EINTERNAL))
    assert c.failed() and c.error_code == errors.EINTERNAL


def test_ici_server_stop_fails_calls(ici_server):
    stub = echo_stub(make_channel(ici_server._test_addr, ici_server._test_device))
    c = Controller()
    stub.Echo(c, EchoRequest(message="warm"))
    assert not c.failed()
    ici_server.stop()
    c2 = Controller()
    c2.max_retry = 0
    stub.Echo(c2, EchoRequest(message="after"))
    assert c2.failed()


def test_ici_unknown_coords_fails_fast(torch_device):
    ch = make_channel("ici://slice9/chip999", torch_device)
    stub = echo_stub(ch)
    c = Controller()
    c.max_retry = 1
    stub.Echo(c, EchoRequest(message="x"))
    assert c.failed()
    assert c.error_code in (errors.EFAILEDSOCKET, errors.ERPCTIMEDOUT)


def test_ici_transmit_copies_buffer(ici_server):
    """Default (non-zero-copy) delivery must hand the receiver a FRESH
    buffer with identical contents — the payload demonstrably traversed
    HBM per hop instead of moving by reference."""
    stub = echo_stub(make_channel(ici_server._test_addr, ici_server._test_device))
    x = torch.arange(512 * 128, dtype=torch.float32).reshape(512, 128)
    x = x.to(ici_server._test_device)
    c = Controller()
    c.request_attachment.append_device(x)
    stub.Echo(c, EchoRequest(message="bulk"))
    assert not c.failed(), c.error_text()
    out = c.response_attachment.device_arrays()[0]
    assert out is not x, "payload moved by reference in copy mode"
    assert out.data_ptr() != x.data_ptr()
    np.testing.assert_array_equal(out.cpu().numpy(), x.cpu().numpy())


def test_ici_zero_copy_mode_moves_reference(ici_server):
    from incubator_brpc_tpu_torch.parallel.ici import get_fabric

    fabric = get_fabric()
    fabric.zero_copy = True
    try:
        stub = echo_stub(make_channel(ici_server._test_addr, ici_server._test_device))
        x = torch.ones((256, 128), dtype=torch.float32)
        if ici_server._ici_port.device is not None:
            # reference identity only survives when no placement hop runs
            x = x.to(ici_server._ici_port.device)
        c = Controller()
        c.request_attachment.append_device(x)
        stub.Echo(c, EchoRequest(message="bulk"))
        assert not c.failed(), c.error_text()
        out = c.response_attachment.device_arrays()[0]
        assert out is x, "zero_copy mode must move the array by reference"
    finally:
        fabric.zero_copy = False


def test_transmit_array_shapes_and_content(torch_device):
    """transmit_array handles lane-aligned 2D, reshapeable, and awkward
    shapes; contents always survive; a fresh buffer is always produced.
    On the CPU the bytes are held to the JAX package's transmit_array and
    the checksum to its kernel in interpret mode, on the same values
    (1e-5 of the sum of |x|, ROADMAP's standing rule)."""
    from incubator_brpc_tpu_torch.ops.transfer import transmit_array

    for shape in [(16, 256), (4, 8, 128), (1000,), (3, 7)]:
        values = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
        x = torch.from_numpy(values).to(torch_device)
        out, csum = transmit_array(x)
        assert out is not x
        assert out.shape == x.shape
        np.testing.assert_array_equal(out.cpu().numpy(), values)
        if csum is not None:
            np.testing.assert_allclose(
                float(csum), float(values.sum()), rtol=1e-5
            )
        if torch_device.type == "cpu":
            import jax.numpy as jnp

            from incubator_brpc_tpu.ops import transfer as jax_transfer

            ref_out, _ = jax_transfer.transmit_array(jnp.asarray(values))
            assert out.numpy().tobytes() == np.asarray(ref_out).tobytes()
            view = jax_transfer.lanes_view(jnp.asarray(values))
            # off the TPU the JAX transmit skips its kernel: hold the
            # port's checksum to that kernel in interpret mode
            assert (csum is None) == (view is None)
            if csum is not None:
                _, ref_csum = jax_transfer.device_copy_with_checksum(view, interpret=True)
                assert abs(float(csum) - float(ref_csum)) <= 1e-5 * float(np.abs(values).sum())


def test_ici_receive_window_backpressure():
    """A stalled consumer port pushes senders into EOVERCROWDED instead
    of queueing frames without bound (the RDMA sq
    window analog, rdma_endpoint.h:83-137)."""
    import threading
    import time as _t

    from incubator_brpc_tpu_torch import errors
    from incubator_brpc_tpu_torch.parallel.ici import get_fabric
    from incubator_brpc_tpu_torch.utils.iobuf import IOBuf

    fabric = get_fabric()
    # a SERVER port: server-port delivery always rides the completion
    # queue (client ports may consume inline, which cannot congest)
    port = fabric.register((0, 91), server=object())
    # stall the consumer: park the execution queue on a blocking item
    gate = threading.Event()
    released = threading.Event()

    def blocker(batch):
        # stand-in consumer: stalls like a slow handler, then releases
        # window bytes the way _drain_completions does
        for frame, _ in batch:
            released.set()
            gate.wait(10)
            with port._qb_lock:
                port._queued_bytes -= len(frame)

    port._cq._consumer = blocker
    port.overcrowded_bytes = 4 << 20  # small window for the test
    try:
        src = (0, 92)
        # first frame occupies the consumer; window starts filling
        assert fabric.send(IOBuf(b"x" * (1 << 20)), (0, 91), src) == 0
        assert released.wait(5)
        rcs = []
        for _ in range(8):
            rcs.append(fabric.send(IOBuf(b"x" * (1 << 20)), (0, 91), src))
        assert errors.EOVERCROWDED in rcs, rcs
        # bounded: queued bytes never exceeded the window
        assert port._queued_bytes <= port.overcrowded_bytes
        # release the consumer: the window drains and sends work again
        gate.set()
        deadline = _t.monotonic() + 5
        while _t.monotonic() < deadline:
            if fabric.send(IOBuf(b"y"), (0, 91), src) == 0:
                break
            _t.sleep(0.02)
        else:
            raise AssertionError("window never reopened after drain")
    finally:
        gate.set()
        fabric.unregister(port.coords)


def test_receive_window_released_when_port_closes_mid_batch():
    """Regression: _drain_completions returning early on a
    closed port must release window bytes for the UNDRAINED rest of
    the batch too — leaking them would wedge senders at EOVERCROWDED
    if a port is later reopened at the same coords."""
    from incubator_brpc_tpu_torch.parallel.ici import get_fabric
    from incubator_brpc_tpu_torch.utils.iobuf import IOBuf

    fabric = get_fabric()
    port = fabric.register((0, 93), server=object())
    try:
        frames = [(IOBuf(b"a" * 128), (0, 94)) for _ in range(5)]
        with port._qb_lock:
            port._queued_bytes += sum(len(f) for f, _ in frames)
        port.closed = True
        port._drain_completions(frames)
        assert port._queued_bytes == 0
    finally:
        fabric.unregister(port.coords)
