"""The port's hand-written kernels on the card.

Every test here needs a CUDA card: the kernels have no CPU mode.  Each
is marked ``cuda`` and skips where ``torch.cuda.is_available()`` is
false.  The file imports neither jax nor the JAX package, so it runs on
a machine with the card and without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: copies byte-equal; every mode's accumulator and checksum
bit-equal to the whole-frame kernel's and to the plain version's, which
adds in the kernels' order (the checksum K1 and K2 fold in their tail
bit-equal to ``fold_checksum`` of the accumulator); a batched Forward row within 2e-6 x
(|x| @ |W|) of the float64 product (float32 with TF32 off; a TF32
product would fail it).
"""

import numpy as np
import pytest
import torch

from incubator_brpc_tpu_torch.ops import transfer as TT

SHAPES = [  # tests/test_ici_pipeline.py:70-77
    (512, 256, 128 * 256 * 4),
    (320, 256, 100 * 256 * 4),
    (1000, 128, 4096 * 128),
    (1, 128, 64),
]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _all_modes_bit_equal(x, chunk_bytes):
    """Runs every kernel path on x; asserts copies equal x and every
    accumulator/checksum equals the whole-frame K1's, and that one the
    plain version's.  Returns its acc."""
    m, n = x.shape
    br = TT._fit_block_rows(m)
    _, _, chunks = TT.chunk_plan_for(x, chunk_bytes)
    zeros = torch.zeros((1, n), dtype=torch.float32, device=x.device)
    out, acc = TT._copy_csum(x, None, br)
    assert torch.equal(out, x)
    assert torch.equal(acc, TT.copy_csum_plain(x, None, br)[1])
    carry, outs = zeros, []
    for off, rows in chunks:
        oc, carry = TT.device_copy_with_checksum_chunk(x[off:off + rows], carry, br)
        outs.append(oc)
    assert torch.equal(torch.cat(outs), x) and torch.equal(carry, acc)
    slot = torch.empty_like(x)
    out_s, acc_s = TT.device_copy_with_checksum_chunk_into(x, zeros, slot, br)
    assert out_s.data_ptr() == slot.data_ptr()
    assert torch.equal(out_s, x) and torch.equal(acc_s, acc)
    out_k2, acc_k2 = TT._staged_copy_csum(x, br, TT.staged_plan(x, br).stage_rows)
    assert torch.equal(out_k2, x) and torch.equal(acc_k2, acc)
    csum = TT.fold_checksum(acc)
    slot2 = torch.empty_like(x)
    for out_c, csum_c in [
        TT.device_copy_with_checksum_chunked(x, chunk_bytes),
        TT.device_copy_with_checksum_pallas(x, chunk_bytes),
        TT.device_copy_with_checksum_pallas(x, chunk_bytes, slot=slot2),
    ]:
        assert torch.equal(out_c, x) and torch.equal(csum_c, csum)
    return acc


# the staged kernel's u8 shapes: the 32-value DMGET/DMSET stack (one
# 32-row block of 2048 tiles), a ragged 384-byte row (one tile, clipped),
# a single-row 4 KB value
U8_SHAPES = [
    (32, 1 << 20, 8 << 20),
    (1000, 384, 384 * 1000 // 3),
    (1, 4096, 1024),
]


@pytest.mark.parametrize("m,n,chunk_bytes,dtype",
                         [(*s, torch.float32) for s in SHAPES]
                         + [(*s, torch.uint8) for s in U8_SHAPES])
def test_kernels_match_plain(cuda_device, m, n, chunk_bytes, dtype):
    if dtype == torch.uint8:
        x_np = np.random.RandomState(m + 5).randint(0, 256, size=(m, n)).astype(np.uint8)
    else:
        x_np = np.random.RandomState(m + 5).randn(m, n).astype(np.float32)
    x = torch.from_numpy(x_np).to(cuda_device)
    TT.reset_launch_counts()
    acc = _all_modes_bit_equal(x, chunk_bytes)
    assert all(TT.launches[k] > 0 for k in
               ("copy_csum_blocks", "copy_csum_staged")), TT.launches
    _, plain_acc = TT.copy_csum_plain(x, None, TT._fit_block_rows(m))
    assert torch.equal(acc, plain_acc)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.uint8,
                                   torch.int8, torch.int16, torch.int32,
                                   torch.int64, torch.float64])
def test_kernels_take_every_numeric_dtype(cuda_device, dtype):
    g = torch.Generator().manual_seed(3)
    x = torch.randint(0, 100, (1000, 384), generator=g).to(dtype).to(cuda_device)
    acc = _all_modes_bit_equal(x, x.nbytes // 3)
    _, plain_acc = TT.copy_csum_plain(x, None, TT._fit_block_rows(1000))
    assert torch.equal(acc, plain_acc)  # integer-valued: every sum exact


def test_kernels_refuse_what_they_do_not_take(cuda_device):
    x = torch.zeros((64, 256), device=cuda_device)
    with pytest.raises(ValueError):  # not contiguous
        TT._copy_csum(x.t().contiguous().t(), None, 64)
    with pytest.raises(ValueError):  # slot of another dtype
        TT.device_copy_with_checksum_chunk_into(
            x, torch.zeros((1, 256), device=cuda_device),
            torch.empty((64, 256), dtype=torch.float16, device=cuda_device), 64,
        )
    with pytest.raises(TypeError):  # no kernel element type
        TT._copy_csum(x.to(torch.complex64), None, 64)
    with pytest.raises(ValueError):  # block rows must divide m
        TT._copy_csum(x, None, 48)
    # a view 4 bytes past an aligned base: the bulk-copy engine cannot
    # describe it, and no wrapper launches on it
    bad = torch.zeros(64 * 256 + 1, device=cuda_device)[1:].view(64, 256)
    assert bad.data_ptr() % 16
    TT.reset_launch_counts()
    for call in (lambda: TT._staged_copy_csum(bad, 64, 64),
                 lambda: TT.device_copy_with_checksum_pallas(bad),
                 lambda: TT._copy_csum(bad, None, 64),
                 lambda: TT.device_copy(bad)):
        with pytest.raises(ValueError):
            call()
    with pytest.raises(ValueError):  # a stage that is not whole row groups
        TT._staged_copy_csum(x, 64, 12)
    assert all(v == 0 for v in TT.launches.values()), TT.launches


def test_staged_kernel_launches_on_every_card(cuda_device):
    """K2 asks for more than 48 KB of dynamic shared memory, an opt-in
    that holds per device: a launch on a second card after one on the
    first must still get it."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    x0 = torch.randn((1024, 256), generator=torch.Generator().manual_seed(2))
    csums = []
    for i in range(torch.cuda.device_count()):
        x = x0.to(torch.device("cuda", i))
        out, csum = TT.device_copy_with_checksum_pallas(x, x.nbytes // 4)
        assert out.device == x.device and torch.equal(out, x)
        assert torch.equal(csum, TT.device_copy_with_checksum(x)[1])
        csums.append(csum.cpu())
    assert all(torch.equal(c, csums[0]) for c in csums)


@pytest.mark.parametrize("mode,per_hop", [
    ("off", {"copy_csum_blocks": 1, "copy_csum_staged": 0, "copy_blocks": 0}),
    ("fused", {"copy_csum_blocks": 1, "copy_csum_staged": 0, "copy_blocks": 0}),
    ("pipelined", {"copy_csum_blocks": 4, "copy_csum_staged": 0, "copy_blocks": 0}),
    ("pallas", {"copy_csum_blocks": 0, "copy_csum_staged": 1, "copy_blocks": 0}),
])
def test_echo_on_card_runs_the_kernels(cuda_device, mode, per_hop):
    from incubator_brpc_tpu_torch import Channel, ChannelOptions, Controller, Server
    from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
    from incubator_brpc_tpu_torch.parallel.ici import get_fabric
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest

    fab = get_fabric()
    saved = (fab.chunk_mode, fab.chunk_bytes)
    fab.chunk_mode, fab.chunk_bytes = mode, 64 * 1024
    srv = Server()
    srv.add_service(EchoService())
    assert srv.start_ici(12, 40 + len(mode)) == 0  # device defaults to cuda
    try:
        ch = Channel(ChannelOptions(timeout_ms=30000, ici_device=cuda_device))
        assert ch.init(f"ici://slice12/chip{40 + len(mode)}") == 0
        x = torch.randn((1024, 256), generator=torch.Generator().manual_seed(1))
        x = x.to(cuda_device)
        TT.reset_launch_counts()
        c = Controller()
        c.request_attachment.append_device(x)
        echo_stub(ch).Echo(c, EchoRequest(message="bulk"))
        assert not c.failed(), c.error_text()
        assert TT.launches == {k: 2 * v for k, v in per_hop.items()}
        seg = c.response_attachment.device_segments()[0]
        assert seg.array.is_cuda and seg.array.data_ptr() != x.data_ptr()
        assert torch.equal(seg.array, x)
        assert torch.equal(seg.csum, TT.device_copy_with_checksum(x)[1])
    finally:
        srv.stop()
        fab.chunk_mode, fab.chunk_bytes = saved


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8,
                                   torch.float64, torch.bool])
@pytest.mark.parametrize("shape", [(8192, 2048), (1000, 128), (1, 384), (3, 640),
                                   (32, 1 << 20), (1000, 384), (1, 4096)])
def test_copy_blocks_matches_plain(cuda_device, shape, dtype):
    g = torch.Generator().manual_seed(shape[0])
    x = torch.randint(0, 256, shape, generator=g).to(dtype).to(cuda_device)
    TT.reset_launch_counts()
    out = TT.device_copy(x)
    slot = torch.empty_like(x)
    into = TT.device_copy(x, out=slot)
    torch.cuda.synchronize()
    assert TT.launches["copy_blocks"] == 2
    assert out.data_ptr() != x.data_ptr() and into.data_ptr() == slot.data_ptr()
    plain = TT.device_copy_plain(x)
    for o in (out, into):
        assert torch.equal(o.view(torch.uint8), plain.view(torch.uint8))


def test_k1_at_the_full_width_w(cuda_device):
    """The PS path's W: (6144, 6144) float32, 96 column tiles x 24 row
    blocks = 2304 CTAs of K1, and a (24, 6144) partial for the fold."""
    g = torch.Generator(device=cuda_device).manual_seed(6144)
    w = torch.randn((6144, 6144), generator=g, device=cuda_device)
    TT.reset_launch_counts()
    acc = _all_modes_bit_equal(w, 8 << 20)
    _, plain_acc = TT.copy_csum_plain(w, None, TT._fit_block_rows(6144))
    assert torch.equal(acc, plain_acc)


def _seeded(shape, dtype, seed, device):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).to(device)


def test_k1_and_k2_back_to_back_leave_no_counter_dirty(cuda_device):
    """K1 (with and without a carry) and K2 over shapes of
    different column-tile and row-block counts, repeated and
    interleaved, each also asked for the frame's checksum: a counter
    left nonzero (a tile's, a slice's or the frame's) or a stale partial
    or lane read by a last arrival would break a later accumulator or
    scalar, and every plan's counters end at zero."""
    cases = []
    for i, (shape, dtype) in enumerate([
        ((8192, 2048), torch.float32),   # 64 MB frame: 32 tiles x 32 blocks
        ((1024, 2048), torch.float32),   # one 8 MB chunk: 32 tiles x 4 blocks
        ((6144, 6144), torch.float32),   # W: 96 tiles x 24 blocks
        ((12, 256), torch.float32),      # br = 12: ragged groups
        ((1, 128), torch.float32),       # br = 1
        ((300, 384), torch.bfloat16),    # br = 4: half the groups empty
        ((32, 1 << 20), torch.uint8),    # the DMSET stack: one block, no counter
        ((1000, 384), torch.uint8),      # a ragged tile: 125 blocks
    ]):
        x = _seeded(shape, dtype, i, cuda_device)
        br = TT._fit_block_rows(shape[0])
        carry = _seeded((1, shape[1]), torch.float32, 100 + i, cuda_device)
        cases.append((x, br, TT.staged_plan(x, br).stage_rows, carry,
                      TT.copy_csum_plain(x, None, br)[1],
                      TT.copy_csum_plain(x, carry, br)[1]))
    got = []
    for rep in range(4):
        for x, br, sr, carry, plain, plain_c in (cases if rep % 2 else cases[::-1]):
            got.append((TT._copy_csum(x, None, br)[1], plain))
            got.append((TT._staged_copy_csum(x, br, sr)[1], plain))
            got.append((TT._copy_csum(x, carry, br)[1], plain_c))
            got.append((TT._transmit_blocks(x, br)[1], TT.fold_checksum(plain)))
            got.append((TT._transmit_staged(x, br, sr)[1], TT.fold_checksum(plain)))
            got.append((TT._transmit_blocks(x, br, carry)[1], TT.fold_checksum(plain_c)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, p) for a, p in got)
    for key, plan in TT.PLANS.items():
        if plan.counters is not None:
            assert int(torch.count_nonzero(plan.counters)) == 0, key


def test_two_streams_at_once_give_the_same_bits(cuda_device):
    """The same payloads transmitted on two CUDA streams concurrently:
    each stream has launch plans of its own (arrival counters, scratch,
    the lane accumulator a frame's checksum folds through), so the
    accumulators and the in-tail checksums stay bit-equal to the plain
    version's."""
    xs = [_seeded(shape, torch.float32, 7, cuda_device) for shape in ((8192, 2048), (1024, 2048))]
    plains = [TT.copy_csum_plain(x, None, TT._fit_block_rows(x.shape[0]))[1] for x in xs]
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    torch.cuda.synchronize()
    got = []
    for _ in range(8):
        for s in streams:
            with torch.cuda.stream(s):
                for x, plain in zip(xs, plains):
                    br = TT._fit_block_rows(x.shape[0])
                    sr = TT.staged_plan(x, br).stage_rows
                    got.append((TT._copy_csum(x, None, br)[1], plain))
                    got.append((TT._staged_copy_csum(x, br, sr)[1], plain))
                    got.append((TT.device_copy_with_checksum(x)[1], TT.fold_checksum(plain)))
                    got.append((TT.device_copy_with_checksum_dma(x, br, sr)[1],
                                TT.fold_checksum(plain)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, p) for a, p in got)
    assert {(cuda_device.index, s.cuda_stream) for s in streams} <= {
        key[:2] for key, _ in TT.PLANS.items()}


# chip_smoke.py's [kernels] cases: every main path's lane view
KERNEL_CASES = [
    ((8192, 2048), torch.float32), ((6144, 6144), torch.float32),
    ((320, 256), torch.float32), ((1000, 128), torch.float32), ((1, 128), torch.float32),
    ((4096, 1024), torch.bfloat16), ((1000, 384), torch.uint8), ((512, 256), torch.int32),
    ((768, 512), torch.float16), ((256, 4096), torch.uint8), ((1, 4096), torch.uint8),
    ((32, 1 << 20), torch.uint8), ((256, 1024), torch.float32),
]


@pytest.mark.parametrize("shape,dtype", KERNEL_CASES)
def test_in_tail_scalar_equals_the_plain_fold(cuda_device, shape, dtype):
    """The frame checksum K1 and K2 fold in their tail, bit-equal to
    ``fold_checksum`` of the same launch's accumulator and of the plain
    version's, whole frame and from a carry."""
    g = torch.Generator().manual_seed(shape[1])
    x = (torch.randn(shape, generator=g) if dtype.is_floating_point
         else torch.randint(0, 128, shape, generator=g)).to(dtype).to(cuda_device)
    br = TT._fit_block_rows(shape[0])
    sr = TT.staged_plan(x, br).stage_rows
    carry = _seeded((1, shape[1]), torch.float32, 10, cuda_device)
    tails = [torch.empty((), dtype=torch.float32, device=cuda_device) for _ in range(3)]
    _, acc1 = TT._copy_csum(x, None, br, csum=tails[0])
    _, acc2 = TT._staged_copy_csum(x, br, sr, csum=tails[1])
    _, acc3 = TT._copy_csum(x, carry, br, csum=tails[2])
    torch.cuda.synchronize()
    plain = TT.copy_csum_plain(x, None, br)[1]
    plain_c = TT.copy_csum_plain(x, carry, br)[1]
    for tail, acc, want in ((tails[0], acc1, plain), (tails[1], acc2, plain),
                            (tails[2], acc3, plain_c)):
        assert torch.equal(acc, want)
        assert torch.equal(tail, TT.fold_checksum(acc))
        assert torch.equal(tail, TT.fold_checksum(want))


@pytest.mark.parametrize("shape", [(8192, 2048), (6144, 6144), (1024, 256)])
def test_last_chunk_and_k2_scalars_equal_the_whole_frame(cuda_device, shape):
    """A chunked frame's last chunk folds the frame's checksum in its
    tail, and so does K2's launch: both bit-equal to the whole-frame
    K1's, which the chunked and staged entries are held to as well."""
    x = _seeded(shape, torch.float32, 11, cuda_device)
    _, whole = TT.device_copy_with_checksum(x)
    v, br, chunks = TT.chunk_plan_for(x, x.nbytes // 5)
    carry = None
    for off, rows in chunks[:-1]:
        _, carry = TT.device_copy_with_checksum_chunk(
            x[off:off + rows],
            carry if carry is not None else torch.zeros((1, shape[1]), device=cuda_device), br)
    off, rows = chunks[-1]
    out_last, last = TT.device_copy_with_checksum_last_chunk(x[off:], carry, br)
    _, staged = TT.device_copy_with_checksum_dma(x, br, TT.staged_plan(x, br).stage_rows)
    _, chunked = TT.device_copy_with_checksum_chunked(x, x.nbytes // 5)
    _, pallas = TT.device_copy_with_checksum_pallas(x, x.nbytes // 5)
    torch.cuda.synchronize()
    assert len(chunks) > 1 and torch.equal(out_last, x[off:])
    for csum in (last, staged, chunked, pallas):
        assert torch.equal(csum, whole)
    assert torch.equal(whole, TT.fold_checksum(TT.copy_csum_plain(x, None, br)[1]))


def test_one_launch_a_transmit_and_no_reduce_in_an_echo(cuda_device, tmp_path):
    """A 64 MB echo over ici:// in the fused mode, in a profiler trace:
    one K1 a hop, two in all, and no reduce kernel (the checksum is
    folded in K1's tail); the reply carries the whole frame's checksum.
    The plan cache hits on the second echo."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from incubator_brpc_tpu_torch import Channel, ChannelOptions, Controller, Server
    from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
    from incubator_brpc_tpu_torch.parallel.ici import get_fabric
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest

    fab = get_fabric()
    saved = (fab.chunk_mode, fab.chunk_bytes)
    fab.chunk_mode = "fused"
    srv = Server()
    srv.add_service(EchoService())
    assert srv.start_ici(12, 70, device=cuda_device) == 0
    try:
        ch = Channel(ChannelOptions(timeout_ms=30000, ici_device=cuda_device))
        assert ch.init("ici://slice12/chip70") == 0
        x = _seeded((8192, 2048), torch.float32, 12, cuda_device)

        def echo():
            c = Controller()
            c.request_attachment.append_device(x)
            echo_stub(ch).Echo(c, EchoRequest(message="bulk"))
            assert not c.failed(), c.error_text()
            return c.response_attachment.device_segments()[0]

        first = echo()  # builds both hops' plans
        torch.cuda.synchronize()
        hits = TT.PLANS.hits.get_value()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            seg = echo()
            torch.cuda.synchronize()
        assert TT.PLANS.hits.get_value() - hits == 2
        prof.export_chrome_trace(str(tmp_path / "echo.json"))
        events = json.loads((tmp_path / "echo.json").read_text())["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        assert sum("copy_csum_blocks_kernel" in k for k in kernels) == 2, kernels
        assert not [k for k in kernels if "reduce" in k.lower()], kernels
        assert torch.equal(seg.array, x) and torch.equal(seg.csum, first.csum)
        assert torch.equal(seg.csum, TT.device_copy_with_checksum(x)[1])
        assert seg.array.data_ptr() != first.array.data_ptr()
        assert seg.csum.data_ptr() != first.csum.data_ptr()
    finally:
        srv.stop()
        fab.chunk_mode, fab.chunk_bytes = saved


def test_batched_forward_on_the_card(cuda_device):
    import threading

    from incubator_brpc_tpu_torch import Channel, ChannelOptions, Controller, Server, ServerOptions
    from incubator_brpc_tpu_torch.models.parameter_server import PsService, ps_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest

    assert torch.backends.cuda.matmul.allow_tf32 is False
    d, rows = 1024, 8
    g = torch.Generator().manual_seed(11)
    w = (torch.randn((d, d), generator=g) / d ** 0.5).numpy()
    xs = torch.randn((rows, d), generator=g).numpy()
    svc = PsService()  # the card by default
    svc.put_param("w", w)
    assert svc._store["w"].device.type == "cuda"
    srv = Server(ServerOptions(enable_batching=True))
    srv.add_service(svc)
    assert srv.start(0) == 0
    ys = [None] * rows
    barrier = threading.Barrier(rows, timeout=20)
    try:
        def worker(i):
            ch = Channel(ChannelOptions(timeout_ms=20000))
            assert ch.init(f"127.0.0.1:{srv.port}") == 0
            barrier.wait()
            c = Controller()
            c.request_attachment.append_user_data(xs[i].tobytes())
            ps_stub(ch).Forward(c, EchoRequest(message="w"))
            assert not c.failed(), c.error_text()
            ys[i] = np.frombuffer(c.response_attachment.to_bytes(), np.float32)
            ch.close()

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(rows)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert srv.batcher("PsService.Forward").rows == rows
    finally:
        srv.stop()
    ref = xs.astype(np.float64) @ w.astype(np.float64)
    scale = np.abs(xs).astype(np.float64) @ np.abs(w).astype(np.float64)
    assert np.all(np.abs(np.stack(ys) - ref) <= 2e-6 * scale)


def test_sharded_scatter_and_fanout_forward_on_the_card(cuda_device):
    """scatter_param places each shard's rows on the card with one K1
    per Put hop; a fan-out Forward issues one leg per shard and its y
    is within 2e-6 x (|x| @ |W|) of the float64 product."""
    from incubator_brpc_tpu_torch import ChannelOptions, Controller, Server
    from incubator_brpc_tpu_torch.models.parameter_server import (
        PsService,
        ps_stub,
        scatter_param,
        sharded_ps_channel,
    )
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest

    d, n = 1024, 4
    g = torch.Generator(device=cuda_device).manual_seed(12)
    w = torch.randn((d, d), generator=g, device=cuda_device) / d ** 0.5
    svcs, servers = [PsService() for _ in range(n)], []
    try:
        for chip, svc in enumerate(svcs):
            srv = Server()
            srv.add_service(svc)
            assert srv.start_ici(40, chip) == 0
            servers.append(srv)
        ch = sharded_ps_channel(
            endpoints=[f"ici://slice40/chip{k}" for k in range(n)],
            channel_options=ChannelOptions(timeout_ms=30000, ici_device=cuda_device))
        TT.reset_launch_counts()
        scatter_param(ch, "w", w)
        assert TT.launches["copy_csum_blocks"] == n
        rows = d // n
        for i, svc in enumerate(svcs):
            got = svc._store["w"]
            assert got.device == cuda_device and torch.equal(got, w[i * rows:(i + 1) * rows])
        x = torch.randn((d,), generator=g, device=cuda_device).cpu().numpy()
        c = Controller()
        c.request_attachment.append_user_data(x.tobytes())
        ps_stub(ch).Forward(c, EchoRequest(message="w"))
        assert not c.failed(), c.error_text()
        y = np.frombuffer(c.response_attachment.to_bytes(), np.float32)
    finally:
        for srv in servers:
            srv.stop()
    w64 = w.double().cpu().numpy()
    ref = x.astype(np.float64) @ w64
    scale = np.abs(x).astype(np.float64) @ np.abs(w64)
    assert np.all(np.abs(y - ref) <= 2e-6 * scale)


def _chip_devices(n):
    """n chips over the cards as the port places them: chip j on
    cuda:(j % count), so one card holds n virtual chips and four cards
    one chip each."""
    from incubator_brpc_tpu_torch.parallel.mesh import device_for_chip

    return [device_for_chip(j) for j in range(n)]


def test_mesh_collectives_on_the_cards(cuda_device):
    """Each lowering over a (1, 4) mesh of chips on the cards, held to a
    plain version on cuda:0: gather, all_to_all, the ring and the hedged
    pick byte-equal, the psum bit-equal to the chip-order sum; every
    chip's result lies on its own chip's device."""
    from incubator_brpc_tpu_torch.parallel import collectives as C
    from incubator_brpc_tpu_torch.parallel.mesh import create_mesh

    devs = _chip_devices(4)
    mesh = create_mesh((1, 4), devices=devs)
    x = torch.randn((4 * 64, 32), generator=torch.Generator().manual_seed(21)).to(cuda_device)
    blocks = list(x.split(64))
    psum = blocks[0].clone()
    for b in blocks[1:]:
        psum += b
    ring = []
    for k in range(4):
        acc = blocks[k]
        for hop in range(1, 4):
            acc = acc + blocks[(k - hop) % 4]
        ring.append(acc)
    flags = torch.tensor([0.0, 1.0, 0.0, 1.0], device=cuda_device)
    a2a = [torch.cat([b[:, 8 * i:8 * (i + 1)] for b in blocks]) for i in range(4)]
    cases = [
        (C.parallel_merge(mesh, "chip", "sum")(x), [psum] * 4),
        (C.parallel_broadcast_gather(mesh, "chip")(x), [x] * 4),
        (C.partition_reshard(mesh, "chip")(x), a2a),
        (C.ring_stream(mesh, "chip")(x), ring),
        (C.hedged_first_valid(mesh, "chip")(x, flags), [blocks[1] + 0] * 4),
    ]
    for out, plain in cases:
        for k, (shard, want) in enumerate(zip(out.shards, plain)):
            assert shard.device == devs[k]
            assert torch.equal(shard.cpu().view(torch.int32), want.cpu().view(torch.int32))


def test_mesh_ps_and_training_step_on_the_cards(cuda_device):
    """PsService(mesh=) over 4 chips on the cards: W's rows on each
    chip's device, a batch of Forwards within 2e-6 x (|x| @ |W|) of the
    float64 product with one execution and one merge; the dp x tp step
    on a (2, 2) mesh equal to the plain unsharded step within 2e-6 of
    |w| + lr |grad| and its loss falling."""
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.parameter_server import PsService, make_training_step
    from incubator_brpc_tpu_torch.parallel.mesh import create_mesh
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest, EchoResponse

    devs = _chip_devices(4)
    d = 1024
    g = torch.Generator().manual_seed(22)
    w = torch.randn((d, d), generator=g) / d ** 0.5
    xs = torch.randn((8, d), generator=g)
    svc = PsService(mesh=create_mesh((1, 4), devices=devs))
    assert svc.put_param("w", w.numpy()) is True
    assert [s.device for s in svc._store["w"].shards] == devs
    ctrls = []
    for x in xs:
        c = Controller()
        c.request_attachment.append_user_data(x.numpy().tobytes())
        ctrls.append(c)
    PsService.Forward.__batch_fn__(svc, ctrls, [EchoRequest(message="w")] * 8,
                                   [EchoResponse() for _ in ctrls], lambda: None)
    assert svc.shard_kernel.executions == svc.shard_kernel.collective_merges == 1
    y = np.stack([np.frombuffer(c.response_attachment.to_bytes(), np.float32) for c in ctrls])
    ref = xs.double().numpy() @ w.double().numpy()
    scale = np.abs(xs.double().numpy()) @ np.abs(w.double().numpy())
    assert np.all(np.abs(y - ref) <= 2e-6 * scale)

    lr = 0.01
    step, params, xx = make_training_step(create_mesh((2, 2), devices=devs), dim=256,
                                          batch=16, lr=lr)
    w1, w2 = (params[k].full().double().requires_grad_() for k in ("w1", "w2"))
    loss64 = torch.mean((torch.relu(xx.full().double() @ w1) @ w2) ** 2)
    loss64.backward()
    new, loss = step(params, xx)
    for name, w64 in (("w1", w1), ("w2", w2)):
        want = (w64 - lr * w64.grad).detach()
        got = new[name].full().double()
        assert torch.all((got - want).abs() <= 2e-6 * (w64.abs() + lr * w64.grad.abs()) + 1e-12)
        assert [s.device for s in new[name].shards] == devs
    _, loss2 = step(new, xx)
    assert float(loss2) < float(loss) and abs(float(loss) - float(loss64.detach())) <= 2e-6 * float(loss64.detach())


def test_device_capture_trace_names_k1(cuda_device):
    """/hotspots/device?seconds=N while echoes run on the card: no
    trace_error, the exported torch.profiler trace names K1 with its
    CUDA time, and the page prints the profiler's kernel rows beside the
    dispatch counters."""
    import json
    import pathlib
    import threading

    from incubator_brpc_tpu_torch import Channel, ChannelOptions, Controller, Server
    from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
    from incubator_brpc_tpu_torch.observability import profiling
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
    from incubator_brpc_tpu_torch.tools.rpc_view import fetch_page

    srv = Server()
    srv.add_service(EchoService())
    assert srv.start(0) == 0 and srv.start_ici(12, 60) == 0
    stop = threading.Event()
    try:
        ch = Channel(ChannelOptions(timeout_ms=30000, ici_device=cuda_device))
        assert ch.init("ici://slice12/chip60") == 0
        x = torch.randn((2048, 1024), device=cuda_device)

        def load():
            while not stop.is_set():
                c = Controller()
                c.request_attachment.append_device(x)
                echo_stub(ch).Echo(c, EchoRequest(message="capture"))
                assert not c.failed(), c.error_text()

        profiling.device_capture(0.05)  # the profiler's first start
        t = threading.Thread(target=load)
        t.start()
        try:
            text = fetch_page(f"127.0.0.1:{srv.port}", "hotspots/device?seconds=0.5")
        finally:
            stop.set()
            t.join(30)
        assert "trace: unavailable" not in text, text
        assert "copy_csum_blocks_kernel" in text  # the profiler's kernel rows
        trace_dir = next(ln.split(": ", 1)[1] for ln in text.splitlines()
                         if ln.startswith("trace_dir: "))
        events = json.loads((pathlib.Path(trace_dir) / profiling.TRACE_FILE).read_text())
        k1 = [e for e in events["traceEvents"]
              if e.get("cat") == "kernel" and "copy_csum_blocks_kernel" in e["name"]]
        assert k1 and all(float(e["dur"]) > 0 for e in k1)
        assert not profiling.capture_active()
    finally:
        stop.set()
        srv.stop()


def test_transfer_guard_refuses_a_seeded_pull_of_a_cuda_tensor(cuda_device, tmp_path):
    """The guard's teeth on the card, in a child interpreter: a seeded
    module under an extra scope calls .item() on a CUDA tensor outside
    any allow scope and gets TransferWitnessError; the same pull inside
    a manifested scope passes.  A hidden sync (``bool`` of a CUDA
    tensor, which no wrapper sees) is caught by the sync hook, on the
    main thread and on another thread."""
    import json
    import pathlib
    import subprocess
    import sys
    import textwrap

    root = str(pathlib.Path(__file__).resolve().parents[1])
    (tmp_path / "seeded_cuda.py").write_text(textwrap.dedent("""\
        from incubator_brpc_tpu_torch.analysis.device_witness import allowed_transfer


        def pull(x):
            return x.item()


        def hidden(x):
            return bool(x > 0)


        def pull_scoped(x):
            with allowed_transfer("decode.token-sums"):
                return x.item()
    """))
    code = textwrap.dedent(f"""\
        import json, sys, threading
        sys.path.insert(0, {root!r})
        from incubator_brpc_tpu_torch.analysis import device_witness as dw
        dw.enable(extra_scopes=[{str(tmp_path)!r}])
        sys.path.insert(0, {str(tmp_path)!r})
        import torch
        import seeded_cuda as sc
        x = torch.ones(1, device="cuda:0")
        out = {{}}
        for name in ("pull", "hidden"):
            try:
                getattr(sc, name)(x)
                out[name] = False
            except dw.TransferWitnessError:
                out[name] = True
        def on_thread():
            try:
                sc.hidden(x)
                out["hidden_thread"] = False
            except dw.TransferWitnessError:
                out["hidden_thread"] = True
        t = threading.Thread(target=on_thread)
        t.start()
        t.join()
        out["scoped"] = sc.pull_scoped(x)
        out["report"] = dw.cross_check()
        print("REPORT " + json.dumps(out, default=repr))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads([ln for ln in proc.stdout.splitlines()
                      if ln.startswith("REPORT ")][-1][len("REPORT "):])
    assert out["pull"] is True and out["scoped"] == 1.0
    assert out["report"]["sync_hook"] is True
    kinds = [v["kind"] for v in out["report"]["violations"]]
    assert "transfer" in kinds
    # the sync hook: a bool() of a CUDA tensor syncs inside torch's C++
    assert out["hidden"] is True and "sync" in kinds, out
    assert out["hidden_thread"] is True, out
    assert sum(k == "sync" for k in kinds) >= 2, out


def test_queued_window_times_a_transmit_chain_on_the_card(cuda_device):
    """tools/_device_time.queued_ms on a short chain of bench_transmit_op's
    transmits: the window's device time is at least the transmits' HBM
    bound (a window that closed early would read under it), the chain's
    output and sum are the plain chain's, and a window the host cannot
    fill (a sleep of a cycle or two) is refused once its tries are out."""
    from incubator_brpc_tpu_torch.tools import _device_time
    from incubator_brpc_tpu_torch.tools import bench

    x = torch.randn((8192, 2048), generator=torch.Generator(device=cuda_device).manual_seed(3),
                    device=cuda_device)
    s0 = torch.zeros((), dtype=torch.float32, device=cuda_device)
    ms, (y, s), cycles = _device_time.queued_ms(lambda: bench.transmit_chain(x, s0, 8))
    assert cycles >= _device_time.SLEEP_CYCLES
    assert ms >= 8 * 2 * x.nbytes / 3.35e12 * 1e3, ms
    assert torch.equal(y, x)
    plain = 8 * x.double().sum().item()
    assert abs(s.item() - plain) <= 8 * 1e-5 * x.abs().double().sum().item()
    with pytest.raises(RuntimeError, match="slower than the card slept"):
        _device_time.queued_ms(lambda: bench.transmit_chain(x, s0, 8), cycles=1, tries=2)


def test_transmit_op_reads_the_cards_time(cuda_device):
    """bench_transmit_op at its 64 MB frame with short chains: the JAX
    bench's keys, and a time a transmit at or above the HBM bound of one
    64 MB read and write (0.0401 ms)."""
    from incubator_brpc_tpu_torch.tools import bench

    got = bench.bench_transmit_op(hi=24, lo=8, reps=2)
    assert set(got) == {"pallas_transmit_64mb_gbps", "pallas_transmit_64mb_us"}, got
    assert got["pallas_transmit_64mb_us"] >= 2 * (64 << 20) / 3.35e12 * 1e6, got
