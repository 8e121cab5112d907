"""The port's hand-written kernels on the card.

Every test here needs a CUDA card: the kernels have no CPU mode.  Each
is marked ``cuda`` and skips where ``torch.cuda.is_available()`` is
false.  The file imports neither jax nor the JAX package, so it runs on
a machine with the card and without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances: copies byte-equal; every mode's accumulator and checksum
bit-equal to the whole-frame kernel's; the kernels against the plain
version within 1e-5 relative to sum|x| per lane (exact for
integer-valued payloads).
"""

import numpy as np
import pytest
import torch

from incubator_brpc_tpu_torch.ops import transfer as TT

RTOL = 1e-5
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
    accumulator/checksum equals the whole-frame K1's.  Returns its acc."""
    m, n = x.shape
    br = TT._fit_block_rows(m)
    _, _, chunks = TT.chunk_plan_for(x, chunk_bytes)
    zeros = torch.zeros((1, n), dtype=torch.float32, device=x.device)
    out, acc = TT._copy_csum(x, None, br)
    assert torch.equal(out, x)
    carry, outs = zeros, []
    for off, rows in chunks:
        oc, carry = TT.device_copy_with_checksum_chunk(x[off:off + rows], carry, br)
        outs.append(oc)
    assert torch.equal(torch.cat(outs), x) and torch.equal(carry, acc)
    slot = torch.empty_like(x)
    out_s, acc_s = TT.device_copy_with_checksum_chunk_into(x, zeros, slot, br)
    assert out_s.data_ptr() == slot.data_ptr()
    assert torch.equal(out_s, x) and torch.equal(acc_s, acc)
    out_k2, acc_k2 = TT._staged_copy_csum(x, br, TT.pallas_stage_rows(x, br))
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


@pytest.mark.parametrize("m,n,chunk_bytes", SHAPES)
def test_kernels_match_plain(cuda_device, m, n, chunk_bytes):
    x_np = np.random.RandomState(m + 5).randn(m, n).astype(np.float32)
    x = torch.from_numpy(x_np).to(cuda_device)
    TT.reset_launch_counts()
    acc = _all_modes_bit_equal(x, chunk_bytes)
    assert all(v > 0 for v in TT.launches.values()), TT.launches
    _, plain_acc = TT.copy_csum_plain(x, None, TT._fit_block_rows(m))
    scale = x.abs().sum(0, keepdim=True)
    assert torch.all((acc - plain_acc).abs() <= RTOL * scale)


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
    ("off", {"copy_csum_blocks": 1, "fold_blocks": 1, "copy_csum_staged": 0}),
    ("fused", {"copy_csum_blocks": 1, "fold_blocks": 1, "copy_csum_staged": 0}),
    ("pipelined", {"copy_csum_blocks": 4, "fold_blocks": 4, "copy_csum_staged": 0}),
    ("pallas", {"copy_csum_blocks": 0, "fold_blocks": 1, "copy_csum_staged": 1}),
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
