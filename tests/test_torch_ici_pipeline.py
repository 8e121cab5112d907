"""Pipelined ICI data plane, carried by hand from ``tests/test_ici_pipeline.py``:
chunked transfers, chunk-accumulating checksums, coalesced delivery, and
the credit-flow invariants under partial pipeline failure
(docs/ici_pipeline.md).

The device cases run on the CPU, where the port's wrappers run their
plain versions, and on the card, where they launch K1 and K2.  Inputs are
made from a seed with numpy.  Each checksum case holds the port's bytes
and checksum to the JAX package's kernel in Pallas interpret mode (as the
JAX file runs it) on the same input: bytes equal, the checksum within
1e-5 of the sum of |x|.  Between the port's own modes the checksums stay
bit-equal, as the JAX file requires of its modes.
"""

import threading
import time as _time

import numpy as np
import pytest
import torch

from torch_carry import torch_device  # noqa: F401  (fixture)

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.utils.iobuf import IOBuf
from incubator_brpc_tpu_torch.utils.segmentation import (
    chunk_views,
    plan_chunks,
    plan_row_chunks,
)

_coords_counter = [300]


def fresh_coords():
    _coords_counter[0] += 1
    return (9, _coords_counter[0])


def _hold_to_jax(values, out, csum):
    """On the CPU: the port's copy equals the JAX package's whole-frame
    kernel's (interpret mode) byte for byte, and its checksum agrees within
    1e-5 of the sum of |x| (ROADMAP's standing rule)."""
    if out.device.type != "cpu":
        return
    import jax.numpy as jnp

    from incubator_brpc_tpu.ops.transfer import device_copy_with_checksum

    ref_out, ref_csum = device_copy_with_checksum(jnp.asarray(values), interpret=True)
    assert out.numpy().tobytes() == np.asarray(ref_out).tobytes()
    assert abs(float(csum) - float(ref_csum)) <= 1e-5 * float(np.abs(values).sum())


# ---- chunk planner ---------------------------------------------------------


def test_plan_chunks_one_byte_tail():
    chunks = plan_chunks(4 * 1024 + 1, chunk_bytes=1024)
    assert chunks == [(0, 1024), (1024, 1024), (2048, 1024),
                      (3072, 1024), (4096, 1)]
    assert plan_chunks(0, 1024) == []
    with pytest.raises(ValueError):
        plan_chunks(10, 0)


def test_chunk_views_one_byte_tail_reassembles():
    payload = bytes(range(256)) * 17  # 4352 = 4 * 1024 + 256
    views = [memoryview(payload[:4096]), memoryview(payload[4096:4351]),
             memoryview(payload[4351:])]  # last view is ONE byte
    out = b"".join(
        bytes(c) for c in chunk_views(views, 1024)
    )
    assert out == payload


def test_plan_row_chunks_alignment():
    # chunk boundaries stay multiples of align_rows; tail may be short
    chunks = plan_row_chunks(320, row_bytes=1024, chunk_bytes=128 * 1024,
                             align_rows=64)
    assert chunks == [(0, 128), (128, 128), (256, 64)]
    assert all(off % 64 == 0 for off, _ in chunks)
    # chunk_bytes below one aligned row-group clamps UP to align_rows
    chunks = plan_row_chunks(256, row_bytes=1024, chunk_bytes=1024,
                             align_rows=64)
    assert chunks[0][1] == 64
    with pytest.raises(ValueError):
        plan_row_chunks(100, 1024, 1 << 20, align_rows=64)


# ---- chunk-accumulating checksum (interpret mode = real kernels) -----------


@pytest.mark.parametrize(
    "m,n,chunk_bytes",
    [
        (512, 256, 128 * 256 * 4),   # exact chunk multiples
        (320, 256, 100 * 256 * 4),   # m not a chunk multiple (short tail)
        (1000, 128, 4096 * 128),     # odd m: block rows fall to 8
        (1, 128, 64),                # single-row frame, one chunk
    ],
)
def test_chunked_checksum_equals_whole_frame_interpret(m, n, chunk_bytes, torch_device):
    """Chunked and whole-frame copy+checksum must agree BIT-FOR-BIT:
    the chained accumulator performs the same f32 additions in the same
    order (the property the receiver's one-value-per-frame verification
    rests on)."""
    from incubator_brpc_tpu_torch.ops.transfer import (
        device_copy_with_checksum,
        device_copy_with_checksum_chunked,
    )

    values = np.random.RandomState(m).randn(m, n).astype(np.float32)
    x = torch.from_numpy(values).to(torch_device)
    whole_out, whole_csum = device_copy_with_checksum(x)
    chunk_out, chunk_csum = device_copy_with_checksum_chunked(
        x, chunk_bytes=chunk_bytes
    )
    assert chunk_out.shape == x.shape
    np.testing.assert_array_equal(whole_out.cpu().numpy(), chunk_out.cpu().numpy())
    assert float(whole_csum) == float(chunk_csum)
    _hold_to_jax(values, chunk_out, chunk_csum)


def test_per_chunk_kernel_chain_matches_whole_frame(torch_device):
    """The launch-per-chunk flavor (what the pipelined send issues)
    chained by hand produces the identical checksum and payload."""
    from incubator_brpc_tpu_torch.ops.transfer import (
        _fit_block_rows,
        device_copy_with_checksum,
        device_copy_with_checksum_chunk,
        fold_checksum,
    )

    m, n = 384, 128
    values = np.random.RandomState(0).randn(m, n).astype(np.float32)
    x = torch.from_numpy(values).to(torch_device)
    block_rows = _fit_block_rows(m)
    acc = torch.zeros((1, n), dtype=torch.float32, device=torch_device)
    outs = []
    for off in range(0, m, 128):
        oc, acc = device_copy_with_checksum_chunk(
            x[off : off + 128], acc, block_rows
        )
        outs.append(oc.cpu().numpy())
    whole_out, whole_csum = device_copy_with_checksum(x)
    assert float(fold_checksum(acc)) == float(whole_csum)
    np.testing.assert_array_equal(
        np.concatenate(outs), whole_out.cpu().numpy()
    )
    _hold_to_jax(values, whole_out, fold_checksum(acc))


# ---- pipelined transmit through a real RPC ---------------------------------


@pytest.fixture
def pipelined_fabric(torch_device):
    from incubator_brpc_tpu_torch.parallel.ici import get_fabric

    fabric = get_fabric()
    saved = (fabric.chunk_mode, fabric.chunk_bytes)
    fabric.chunk_mode = "pipelined"
    fabric.chunk_bytes = 64 * 1024  # small: a 1MB payload chunks even here
    fabric._test_device = torch_device
    yield fabric
    fabric.chunk_mode, fabric.chunk_bytes = saved


def _ici_echo_server(device):
    from incubator_brpc_tpu_torch.models.echo import EchoService
    from incubator_brpc_tpu_torch.server.server import Server

    srv = Server()
    srv.add_service(EchoService())
    s, c = fresh_coords()
    assert srv.start_ici(s, c, device=device) == 0
    return srv, f"ici://slice{s}/chip{c}"


def test_pipelined_chunked_echo_content_and_fresh_buffer(pipelined_fabric):
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import echo_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest

    srv, addr = _ici_echo_server(pipelined_fabric._test_device)
    try:
        ch = Channel(
            ChannelOptions(timeout_ms=30000, ici_device=pipelined_fabric._test_device)
        )
        assert ch.init(addr) == 0
        stub = echo_stub(ch)
        x = torch.arange(1024 * 256, dtype=torch.float32).reshape(1024, 256)
        x = x.to(pipelined_fabric._test_device)
        c = Controller()
        c.request_attachment.append_device(x)
        stub.Echo(c, EchoRequest(message="bulk"))
        assert not c.failed(), c.error_text()
        arrs = c.response_attachment.device_arrays()
        assert len(arrs) == 1 and arrs[0].shape == (1024, 256)
        assert arrs[0] is not x, "chunked transmit must produce a fresh buffer"
        assert arrs[0].data_ptr() != x.data_ptr()
        np.testing.assert_array_equal(arrs[0].cpu().numpy(), x.cpu().numpy())
    finally:
        srv.stop()


def test_fused_chunked_echo_content(pipelined_fabric):
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import echo_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest

    pipelined_fabric.chunk_mode = "fused"
    srv, addr = _ici_echo_server(pipelined_fabric._test_device)
    try:
        ch = Channel(
            ChannelOptions(timeout_ms=30000, ici_device=pipelined_fabric._test_device)
        )
        assert ch.init(addr) == 0
        stub = echo_stub(ch)
        x = torch.ones((512, 512), dtype=torch.float32).to(pipelined_fabric._test_device)
        c = Controller()
        c.request_attachment.append_device(x)
        stub.Echo(c, EchoRequest(message="bulk"))
        assert not c.failed(), c.error_text()
        out = c.response_attachment.device_arrays()[0]
        assert out is not x
        np.testing.assert_array_equal(out.cpu().numpy(), x.cpu().numpy())
    finally:
        srv.stop()


# ---- partial pipeline failure: credits must not leak (satellite) -----------


def test_chunk_fault_releases_window_and_surfaces_one_error(pipelined_fabric):
    """Seeded FaultPlan fires an ici.chunk reset mid-frame: the sender
    gets ONE ERPC error (EINTERNAL — the fabric connection stays up),
    the receive window shows zero queued bytes afterwards, and the very
    next call on the same socket succeeds."""
    from incubator_brpc_tpu_torch.chaos import FaultPlan
    from incubator_brpc_tpu_torch.chaos import injector as chaos_injector
    from incubator_brpc_tpu_torch.chaos.plan import FaultSpec
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import echo_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest

    srv, addr = _ici_echo_server(pipelined_fabric._test_device)
    try:
        ch = Channel(
            ChannelOptions(timeout_ms=30000, ici_device=pipelined_fabric._test_device)
        )
        assert ch.init(addr) == 0
        stub = echo_stub(ch)
        x = torch.ones((1024, 256), dtype=torch.float32)  # 1MB → 16 chunks of 64KB
        x = x.to(pipelined_fabric._test_device)
        warm = Controller()
        warm.request_attachment.append_device(x)
        stub.Echo(warm, EchoRequest(message="warm"))
        assert not warm.failed(), warm.error_text()

        plan = FaultPlan(
            [FaultSpec("ici.chunk", "reset", probability=1.0, max_hits=1)],
            seed=1234,
            name="chunk-fault",
        )
        chaos_injector.arm(plan)
        try:
            c = Controller()
            c.max_retry = 0
            c.request_attachment.append_device(x)
            stub.Echo(c, EchoRequest(message="bulk"))
            assert c.failed()
            assert c.error_code == errors.EINTERNAL, (
                c.error_code, c.error_text(),
            )
        finally:
            chaos_injector.disarm()
        # the faulted frame reserved no window credit — nothing leaks
        assert srv._ici_port._queued_bytes == 0
        # and the fabric connection survived: same socket, next call ok
        c2 = Controller()
        c2.request_attachment.append_device(x)
        stub.Echo(c2, EchoRequest(message="after"))
        assert not c2.failed(), c2.error_text()
    finally:
        srv.stop()


def test_chunk_fault_fires_under_fused_mode_too(pipelined_fabric):
    """The ici.chunk site must cover the DEFAULT chunk mode: fused
    sends walk the same chunk plan through the site before dispatch,
    so a plan targeting chunk k faults the frame under either mode."""
    from incubator_brpc_tpu_torch.chaos import FaultPlan
    from incubator_brpc_tpu_torch.chaos import injector as chaos_injector
    from incubator_brpc_tpu_torch.chaos.plan import FaultSpec
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import echo_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest

    pipelined_fabric.chunk_mode = "fused"
    srv, addr = _ici_echo_server(pipelined_fabric._test_device)
    try:
        ch = Channel(
            ChannelOptions(timeout_ms=30000, ici_device=pipelined_fabric._test_device)
        )
        assert ch.init(addr) == 0
        stub = echo_stub(ch)
        x = torch.ones((1024, 256), dtype=torch.float32).to(pipelined_fabric._test_device)
        chaos_injector.arm(FaultPlan(
            [FaultSpec("ici.chunk", "reset", probability=1.0, max_hits=1)],
            seed=77, name="fused-chunk-fault",
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
        assert srv._ici_port._queued_bytes == 0
    finally:
        srv.stop()


# ---- coalesced delivery: send_batch / delivery_burst / execute_batch -------


def _stub_port(fabric, window_bytes=None):
    """Server port whose completion queue records drained frames and
    releases window credits like _drain_completions does."""
    coords = fresh_coords()
    port = fabric.register(coords, server=object())
    drained = []
    calls = []

    def consumer(batch):
        calls.append(len(batch))
        for frame, src in batch:
            drained.append(bytes(frame.to_bytes()))
            with port._qb_lock:
                port._queued_bytes -= len(frame)

    port._cq._consumer = consumer
    if window_bytes is not None:
        port.overcrowded_bytes = window_bytes
    return port, coords, drained, calls


def _wait_for(pred, timeout=5.0):
    deadline = _time.monotonic() + timeout
    while _time.monotonic() < deadline:
        if pred():
            return True
        _time.sleep(0.01)
    return pred()


def test_send_batch_single_wake_in_order():
    from incubator_brpc_tpu_torch.parallel.ici import get_fabric

    fabric = get_fabric()
    port, coords, drained, calls = _stub_port(fabric)
    try:
        frames = [IOBuf(bytes([65 + i]) * (i + 1)) for i in range(5)]
        rcs = fabric.send_batch(frames, coords, fresh_coords())
        assert rcs == [0] * 5
        assert _wait_for(lambda: len(drained) == 5)
        assert drained == [bytes([65 + i]) * (i + 1) for i in range(5)]
        # ONE consumer wake drained the whole burst
        assert calls == [5], calls
        assert port._queued_bytes == 0
    finally:
        fabric.unregister(coords)


def test_send_batch_window_overflow_fails_frames_individually():
    from incubator_brpc_tpu_torch.parallel.ici import get_fabric

    fabric = get_fabric()
    port, coords, drained, calls = _stub_port(fabric, window_bytes=300)
    try:
        frames = [IOBuf(b"x" * 120) for _ in range(4)]
        rcs = fabric.send_batch(frames, coords, fresh_coords())
        # first two fit the 300B window; the rest bounce at admission
        assert rcs[:2] == [0, 0]
        assert all(rc == errors.EOVERCROWDED for rc in rcs[2:]), rcs
        assert _wait_for(lambda: len(drained) == 2)
        assert port._queued_bytes == 0  # admitted credits fully returned
    finally:
        fabric.unregister(coords)


def test_delivery_burst_defers_consumer_wake():
    from incubator_brpc_tpu_torch.parallel.ici import get_fabric

    fabric = get_fabric()
    port, coords, drained, calls = _stub_port(fabric)
    try:
        src = fresh_coords()
        with fabric.delivery_burst():
            assert fabric.send(IOBuf(b"one"), coords, src) == 0
            assert fabric.send(IOBuf(b"two"), coords, src) == 0
            # window credits reserved immediately...
            assert port._queued_bytes == 6
            # ...but no consumer ran yet: frames wait for the flush
            _time.sleep(0.05)
            assert drained == []
        assert _wait_for(lambda: len(drained) == 2)
        assert drained == [b"one", b"two"]
        assert calls == [2]
        assert port._queued_bytes == 0
    finally:
        fabric.unregister(coords)


def test_delivery_burst_bulk_frame_bypasses_capture():
    """Frames ≥ BURST_BYPASS_BYTES dispatch immediately inside a burst:
    coalescing amortizes microsecond-scale wakes for small RPCs, and
    must not hold a bulk frame's receive work hostage to burst close."""
    from incubator_brpc_tpu_torch.parallel.ici import (
        BURST_BYPASS_BYTES,
        get_fabric,
    )

    fabric = get_fabric()
    port, coords, drained, calls = _stub_port(fabric)
    try:
        src = fresh_coords()
        with fabric.delivery_burst():
            assert fabric.send(IOBuf(b"small"), coords, src) == 0
            bulk = IOBuf(b"\xa5" * BURST_BYPASS_BYTES)
            assert fabric.send(bulk, coords, src) == 0
            # the bulk frame dispatched without waiting for burst close…
            assert _wait_for(lambda: len(drained) == 1)
            assert len(drained[0]) == BURST_BYPASS_BYTES
            # …while the small frame stays captured until the flush
            assert b"small" not in drained
        assert _wait_for(lambda: len(drained) == 2)
        assert drained[1] == b"small"
        assert port._queued_bytes == 0
    finally:
        fabric.unregister(coords)


def test_execute_batch_refused_after_stop_and_credits_released():
    from incubator_brpc_tpu_torch.parallel.ici import get_fabric
    from incubator_brpc_tpu_torch.runtime.execution_queue import ExecutionQueue

    q = ExecutionQueue(lambda batch: None)
    q.stop()
    assert q.execute_batch([1, 2, 3]) is False
    assert q.execute_batch([]) is True  # empty batch is a no-op

    # a port whose queue stopped must refuse delivery AND give the
    # window credits back (the leak the close/send race would cause)
    fabric = get_fabric()
    coords = fresh_coords()
    port = fabric.register(coords, server=object())
    try:
        port._cq.stop()
        port._cq.join(2)
        assert port.deliver(IOBuf(b"x" * 64), fresh_coords()) is False
        assert port._queued_bytes == 0
        # a burst flush hitting a stopped queue must return the credits
        # its deliveries reserved
        with port._qb_lock:
            port._queued_bytes += 32
        port._flush_burst([(IOBuf(b"y" * 32), fresh_coords())])
        assert port._queued_bytes == 0
    finally:
        fabric.unregister(coords)


def test_close_racing_send_reports_connection_failure_not_backpressure(
    monkeypatch,
):
    """A port that closes between the fabric's lookup and delivery must
    surface EFAILEDSOCKET (dead destination), not EOVERCROWDED —
    retry/circuit-breaker accounting keys on the difference, and no
    window credit may stick to the refused frame."""
    from incubator_brpc_tpu_torch.parallel.ici import get_fabric

    fabric = get_fabric()
    port, coords, _, _ = _stub_port(fabric)
    try:
        port.closed = True  # close "wins" the race...
        port._cq.stop()
        # ...but the sender already resolved the port object
        monkeypatch.setattr(
            fabric, "port", lambda c: port if c == coords else None
        )
        rc = fabric.send(IOBuf(b"x" * 64), coords, fresh_coords())
        assert rc == errors.EFAILEDSOCKET, rc
        assert port._queued_bytes == 0
    finally:
        monkeypatch.undo()
        fabric.unregister(coords)


def test_execution_queue_execute_batch_orders_and_drains():
    from incubator_brpc_tpu_torch.runtime.execution_queue import ExecutionQueue

    seen = []
    done = threading.Event()

    def consume(batch):
        seen.extend(batch)
        if len(seen) >= 10:
            done.set()

    q = ExecutionQueue(consume)
    assert q.execute_batch(range(10)) is True
    assert done.wait(5)
    assert seen == list(range(10))


# ---- pallas DMA lane (interpret mode = REAL kernels, DMA included) ---------


@pytest.mark.parametrize(
    "m,n,chunk_bytes",
    [
        (512, 256, 128 * 256 * 4),   # exact chunk multiples
        (320, 256, 100 * 256 * 4),   # m not a chunk multiple (short tail)
        (1000, 128, 4096 * 128),     # odd m: block rows fall to 8
        (1, 128, 64),                # single-row frame, one stage
    ],
)
def test_pallas_dma_checksum_equals_pr4_kernels_interpret(m, n, chunk_bytes, torch_device):
    """The double-buffered DMA kernel must agree BIT-FOR-BIT with BOTH
    earlier kernels (whole-frame and fused-chunked): the DMA stage is an
    aligned multiple of the checksum block rows, so splitting the frame
    into semaphored stages cannot reorder the chained f32 additions.
    Interpret mode runs the SAME kernel — DMA semaphores included —
    through the Pallas TPU interpreter.  In the port the
    staged kernel is K2 on the card and its plain version on the CPU;
    the JAX kernel runs in interpret mode for the comparison."""
    from incubator_brpc_tpu_torch.ops.transfer import (
        device_copy_with_checksum,
        device_copy_with_checksum_chunked,
        device_copy_with_checksum_pallas,
    )

    values = np.random.RandomState(m).randn(m, n).astype(np.float32)
    x = torch.from_numpy(values).to(torch_device)
    whole_out, whole_csum = device_copy_with_checksum(x)
    _, chunk_csum = device_copy_with_checksum_chunked(
        x, chunk_bytes=chunk_bytes
    )
    dma_out, dma_csum = device_copy_with_checksum_pallas(
        x, chunk_bytes=chunk_bytes
    )
    assert dma_out.shape == x.shape
    np.testing.assert_array_equal(dma_out.cpu().numpy(), whole_out.cpu().numpy())
    assert float(dma_csum) == float(whole_csum) == float(chunk_csum)
    _hold_to_jax(values, dma_out, dma_csum)


def test_pallas_one_byte_wire_tail_survives_pallas_mode(pipelined_fabric):
    """A host-bytes attachment whose size leaves a ONE-byte wire tail
    must reassemble byte-exact while the fabric runs in pallas mode —
    the device lane swap must not disturb the byte-plane chunker."""
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import echo_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest

    pipelined_fabric.chunk_mode = "pallas"
    srv, addr = _ici_echo_server(pipelined_fabric._test_device)
    try:
        ch = Channel(
            ChannelOptions(timeout_ms=30000, ici_device=pipelined_fabric._test_device)
        )
        assert ch.init(addr) == 0
        stub = echo_stub(ch)
        # 4 full 64KB wire chunks + a one-byte tail
        payload = bytes(range(256)) * 1024 + b"\x7f"
        assert len(payload) == 4 * pipelined_fabric.chunk_bytes + 1
        c = Controller()
        c.request_attachment.append(payload)
        stub.Echo(c, EchoRequest(message="tail"))
        assert not c.failed(), c.error_text()
        assert c.response_attachment.to_bytes() == payload
    finally:
        srv.stop()


def test_pallas_mode_echo_content_and_fresh_buffer(
    pipelined_fabric, monkeypatch
):
    """End-to-end pallas-mode echo on the HIT path: content round-trips
    through a REAL RPC, the receiver gets a fresh buffer, and the frame
    rode exactly one fused dispatch per direction.  The JAX file forces
    its TPU check true and runs the DMA kernel through the interpreter;
    the port's staged transmit runs wherever the tensor lies (K2 on the
    card, its plain version on the CPU), so nothing is patched."""
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import echo_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.parallel.ici import (
        ici_pallas_fallbacks,
        ici_pallas_frames,
    )

    pipelined_fabric.chunk_mode = "pallas"
    frames0 = int(ici_pallas_frames.get_value())
    falls0 = int(ici_pallas_fallbacks.get_value())
    srv, addr = _ici_echo_server(pipelined_fabric._test_device)
    try:
        ch = Channel(
            ChannelOptions(timeout_ms=30000, ici_device=pipelined_fabric._test_device)
        )
        assert ch.init(addr) == 0
        stub = echo_stub(ch)
        x = torch.arange(1024 * 256, dtype=torch.float32).reshape(1024, 256)
        x = x.to(pipelined_fabric._test_device)
        c = Controller()
        c.request_attachment.append_device(x)
        stub.Echo(c, EchoRequest(message="bulk"))
        assert not c.failed(), c.error_text()
        arrs = c.response_attachment.device_arrays()
        assert len(arrs) == 1 and arrs[0].shape == (1024, 256)
        assert arrs[0] is not x, "pallas transmit must produce a fresh buffer"
        assert arrs[0].data_ptr() != x.data_ptr()
        np.testing.assert_array_equal(arrs[0].cpu().numpy(), x.cpu().numpy())
    finally:
        srv.stop()
    # one fused dispatch per direction (request + response), no
    # silent fallback to the legacy pipeline
    assert int(ici_pallas_frames.get_value()) - frames0 == 2
    assert int(ici_pallas_fallbacks.get_value()) - falls0 == 0


def test_chunk_fault_fires_under_pallas_mode_too(pipelined_fabric):
    """Satellite regression: the ici.chunk site covers the pallas lane.
    A seeded FaultPlan reset walks the SAME chunk plan pre-dispatch
    (before the platform gate, so the off-TPU fallback frame is covered
    too): ONE ERPC EINTERNAL, no socket teardown, zero queued bytes
    left in the receive window, and the next call on the same fabric
    connection succeeds."""
    from incubator_brpc_tpu_torch.chaos import FaultPlan
    from incubator_brpc_tpu_torch.chaos import injector as chaos_injector
    from incubator_brpc_tpu_torch.chaos.plan import FaultSpec
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import echo_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest

    pipelined_fabric.chunk_mode = "pallas"
    srv, addr = _ici_echo_server(pipelined_fabric._test_device)
    try:
        ch = Channel(
            ChannelOptions(timeout_ms=30000, ici_device=pipelined_fabric._test_device)
        )
        assert ch.init(addr) == 0
        stub = echo_stub(ch)
        x = torch.ones((1024, 256), dtype=torch.float32)  # 1MB → 16 chunks of 64KB
        x = x.to(pipelined_fabric._test_device)
        warm = Controller()
        warm.request_attachment.append_device(x)
        stub.Echo(warm, EchoRequest(message="warm"))
        assert not warm.failed(), warm.error_text()

        chaos_injector.arm(FaultPlan(
            [FaultSpec("ici.chunk", "reset", probability=1.0, max_hits=1)],
            seed=4321, name="pallas-chunk-fault",
        ))
        try:
            c = Controller()
            c.max_retry = 0
            c.request_attachment.append_device(x)
            stub.Echo(c, EchoRequest(message="bulk"))
            assert c.failed()
            assert c.error_code == errors.EINTERNAL, (
                c.error_code, c.error_text(),
            )
            hits = chaos_injector.site_hits().get("ici.chunk", {})
            assert sum(hits.values()) == 1, hits
        finally:
            chaos_injector.disarm()
        # the faulted frame reserved no window credit — nothing leaks
        assert srv._ici_port._queued_bytes == 0
        # and the fabric connection survived: same socket, next call ok
        c2 = Controller()
        c2.request_attachment.append_device(x)
        stub.Echo(c2, EchoRequest(message="after"))
        assert not c2.failed(), c2.error_text()
    finally:
        srv.stop()


def test_pallas_ring_slot_recycles_to_allocation_free_steady_state(
    pipelined_fabric, monkeypatch
):
    """The pallas lane's StagingRing contract: a released frame-shaped
    slot is re-acquired by the next transmit of that shape (ring hit,
    no new allocation) and the donated-slot kernel runs — with the
    checksum still bit-equal to the whole-frame kernel's.  The JAX file
    forces its TPU check and runs the kernels through the interpreter;
    the port's run wherever the tensor lies, so only the donated-slot
    entry is wrapped, to record its calls."""
    from incubator_brpc_tpu_torch.ops import transfer as T
    from incubator_brpc_tpu_torch.parallel.ici import StagingRing

    orig_into = T.device_copy_with_checksum_dma_into
    into_calls = []

    def _into(x, slot, br, sr):
        into_calls.append(tuple(slot.shape))
        return orig_into(x, slot, br, sr)

    monkeypatch.setattr(T, "device_copy_with_checksum_dma_into", _into)

    class _Shim:
        coords = (0, 0)
        device = pipelined_fabric._test_device
        staging = StagingRing(depth=2)

    shim = _Shim()
    pipelined_fabric.chunk_mode = "pallas"
    values = np.random.RandomState(11).randn(1024, 128).astype(np.float32)
    x = torch.from_numpy(values).to(pipelined_fabric._test_device)
    whole_csum = float(T.device_copy_with_checksum(x)[1])

    # frame 1: cold ring — miss, allocating kernel
    out1, csum1 = pipelined_fabric._transmit_pallas(x, shim, None)
    assert shim.staging.misses == 1 and shim.staging.hits == 0
    assert into_calls == []
    assert float(csum1) == whole_csum
    # the receiver hands the delivered buffer back (response recycled)
    shim.staging.release(out1)
    # frame 2: ring hit — the donated-slot kernel runs on the slot
    out2, csum2 = pipelined_fabric._transmit_pallas(x, shim, None)
    assert shim.staging.hits == 1, "steady state must recycle the slot"
    assert into_calls == [tuple(x.shape)]
    assert float(csum2) == whole_csum
    np.testing.assert_array_equal(out2.cpu().numpy(), values)
    _hold_to_jax(values, out2, csum2)


def test_pallas_stacked_transmit_coalesces_same_shape_segments(
    pipelined_fabric, monkeypatch
):
    """The bulk-move collective lowering at the segment level: 4
    same-shape refs of one frame coalesce into ONE stacked kernel
    dispatch (per-ref csum None — integrity rides the stack checksum),
    while odd shapes return for the per-segment path.  (The JAX file
    forces its TPU check and the interpreter; the port's staged transmit
    runs wherever the tensors lie.)"""
    from incubator_brpc_tpu_torch.parallel.ici import (
        StagingRing,
        ici_pallas_stacked_frames,
        ici_pallas_stacked_segments,
    )

    class _Ref:
        array = None
        csum = "sentinel"

    class _Shim:
        coords = (0, 0)
        device = pipelined_fabric._test_device
        staging = StagingRing(depth=2)

    dev = pipelined_fabric._test_device
    rng = np.random.RandomState(5)
    same = [torch.from_numpy(rng.randn(64, 128).astype(np.float32)).to(dev)
            for _ in range(4)]
    odd = torch.from_numpy(rng.randn(32, 128).astype(np.float32)).to(dev)
    pairs = [(_Ref(), a) for a in same] + [(_Ref(), odd)]

    frames0 = int(ici_pallas_stacked_frames.get_value())
    segs0 = int(ici_pallas_stacked_segments.get_value())
    pipelined_fabric.chunk_mode = "pallas"
    rest = pipelined_fabric._transmit_stacked(pairs, _Shim(), None)

    # the singleton shape came back for the per-segment path
    assert [a is odd for _, a in rest] == [True]
    assert int(ici_pallas_stacked_frames.get_value()) - frames0 == 1
    assert int(ici_pallas_stacked_segments.get_value()) - segs0 == 4
    for (ref, a) in pairs[:4]:
        assert ref.csum is None, "integrity rides the stack checksum"
        np.testing.assert_array_equal(ref.array.cpu().numpy(), a.cpu().numpy())
