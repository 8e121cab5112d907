"""The port's copy+checksum ops held against the JAX package's kernels.

The same numpy inputs, made from a seed, go through the JAX function
(Pallas interpret mode, as tests/test_ici_pipeline.py runs it on the
CPU) and through its counterpart in ``incubator_brpc_tpu_torch``.  On
the CPU the port runs its plain PyTorch versions; the hand-written
kernels are held against them on the card by tests/test_torch_cuda.py.

Tolerances:
- copies: byte-identical;
- integer-valued float32 payloads: every partial sum is exact, so the
  lane accumulator and the checksum are bit-equal to JAX's;
- randn payloads: within 1e-5 relative to sum|x| per lane (JAX sums
  inside a block in XLA's order, the port in the kernels' order);
- within the port: whole frame, chained chunks, slot and staged paths
  are bit-equal (torch.equal), and the plain version is bit-equal to a
  float32 scalar loop in the kernels' order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from incubator_brpc_tpu.ops import transfer as JT
from incubator_brpc_tpu_torch.ops import transfer as TT

RTOL = 1e-5

# tests/test_ici_pipeline.py:70-77
SHAPES = [
    (512, 256, 128 * 256 * 4),   # exact chunk multiples
    (320, 256, 100 * 256 * 4),   # m not a chunk multiple (short tail)
    (1000, 128, 4096 * 128),     # odd m: block rows fall to 8
    (1, 128, 64),                # single-row frame, one chunk
]


def _payload(m, n, seed, integer_valued):
    rng = np.random.RandomState(seed)
    if integer_valued:
        return rng.randint(-64, 64, size=(m, n)).astype(np.float32)
    return rng.randn(m, n).astype(np.float32)


def _jax_acc(x_np):
    """JAX's lane accumulator: the carry kernel over the whole frame
    from a zero carry (the same block sequence as the whole-frame
    kernel)."""
    m, n = x_np.shape
    out, acc = JT.device_copy_with_checksum_chunk(
        jnp.asarray(x_np), jnp.zeros((1, n), jnp.float32),
        JT._fit_block_rows(m), True,
    )
    return np.asarray(out), np.asarray(acc)


def _jax_csums(x_np, chunk_bytes):
    x = jnp.asarray(x_np)
    whole_out, whole = JT.device_copy_with_checksum(x, interpret=True)
    chunk_out, chunked = JT.device_copy_with_checksum_chunked(
        x, chunk_bytes=chunk_bytes, interpret=True
    )
    v, br, _ = JT.chunk_plan_for(x, chunk_bytes)
    dma_out, dma = JT.device_copy_with_checksum_dma(
        v, br, JT.pallas_stage_rows(v, br), interpret=True
    )
    for o in (whole_out, chunk_out, dma_out):
        np.testing.assert_array_equal(np.asarray(o), x_np)
    return float(whole), float(chunked), float(dma)


def _port_all_modes(x, chunk_bytes):
    """(out, acc) per port path; every path's csum is fold_checksum(acc)
    or returned directly."""
    m, n = x.shape
    br = TT._fit_block_rows(m)
    _, _, chunks = TT.chunk_plan_for(x, chunk_bytes)
    res = {}
    res["whole"] = TT._copy_csum(x, None, br)
    acc, outs = torch.zeros((1, n), dtype=torch.float32, device=x.device), []
    for off, rows in chunks:
        oc, acc = TT.device_copy_with_checksum_chunk(x[off:off + rows], acc, br)
        outs.append(oc)
    res["chained"] = (torch.cat(outs), acc)
    slot = torch.empty_like(x)
    res["into"] = TT.device_copy_with_checksum_chunk_into(
        x, torch.zeros((1, n), dtype=torch.float32, device=x.device), slot, br
    )
    assert res["into"][0].data_ptr() == slot.data_ptr()
    res["staged"] = TT._staged_copy_csum(x, br, TT.staged_plan(x, br).stage_rows)
    return res


def _assert_port_modes_bit_equal(x, chunk_bytes):
    res = _port_all_modes(x, chunk_bytes)
    whole_out, whole_acc = res["whole"]
    for name, (out, acc) in res.items():
        assert torch.equal(out, x), name
        assert torch.equal(acc, whole_acc), name
    csum = TT.fold_checksum(whole_acc)
    _, csum_chunked = TT.device_copy_with_checksum_chunked(x, chunk_bytes)
    _, csum_pallas = TT.device_copy_with_checksum_pallas(x, chunk_bytes)
    slot = torch.empty_like(x)
    out_p, csum_into = TT.device_copy_with_checksum_pallas(
        x, chunk_bytes, slot=slot
    )
    assert out_p.data_ptr() == slot.data_ptr()
    _, csum_whole = TT.device_copy_with_checksum(x)
    for c in (csum_chunked, csum_pallas, csum_into, csum_whole):
        assert torch.equal(c, csum)
    return whole_acc, csum


@pytest.mark.parametrize("m,n,chunk_bytes", SHAPES)
def test_integer_valued_payload_bit_equal_to_jax(m, n, chunk_bytes):
    x_np = _payload(m, n, m, integer_valued=True)
    jax_out, jax_acc = _jax_acc(x_np)
    whole, chunked, dma = _jax_csums(x_np, chunk_bytes)
    acc, csum = _assert_port_modes_bit_equal(torch.from_numpy(x_np), chunk_bytes)
    np.testing.assert_array_equal(acc.numpy(), jax_acc)
    assert float(csum) == whole == chunked == dma


@pytest.mark.parametrize("m,n,chunk_bytes", SHAPES)
def test_randn_payload_within_tolerance_of_jax(m, n, chunk_bytes):
    x_np = _payload(m, n, m + 1, integer_valued=False)
    _, jax_acc = _jax_acc(x_np)
    whole, chunked, dma = _jax_csums(x_np, chunk_bytes)
    assert whole == chunked == dma  # the reference's own contract
    acc, csum = _assert_port_modes_bit_equal(torch.from_numpy(x_np), chunk_bytes)
    lane_scale = np.abs(x_np).sum(0, keepdims=True)
    assert np.all(np.abs(acc.numpy() - jax_acc) <= RTOL * lane_scale)
    assert abs(float(csum) - whole) <= RTOL * float(lane_scale.sum())


@pytest.mark.parametrize("m,n,chunk_bytes", SHAPES)
def test_copied_bytes_identical_to_jax(m, n, chunk_bytes):
    x_np = _payload(m, n, m + 2, integer_valued=False)
    jax_out = np.asarray(
        JT.device_copy_with_checksum_chunked(
            jnp.asarray(x_np), chunk_bytes=chunk_bytes, interpret=True
        )[0]
    )
    out, _ = TT.device_copy_with_checksum_chunked(
        torch.from_numpy(x_np), chunk_bytes
    )
    assert out.numpy().tobytes() == jax_out.tobytes()


@pytest.mark.parametrize(
    "np_dtype,torch_dtype",
    [("bfloat16", torch.bfloat16), (np.uint8, torch.uint8)],
)
def test_bf16_and_uint8_accepted_and_match_jax(np_dtype, torch_dtype):
    from incubator_brpc_tpu_torch.convert import tensor_from_reference

    rng = np.random.RandomState(7)
    raw = rng.randint(0, 100, size=(64, 256))
    xj = jnp.asarray(raw).astype(jnp.bfloat16 if np_dtype == "bfloat16" else jnp.uint8)
    jax_out, jax_acc = JT.device_copy_with_checksum_chunk(
        xj, jnp.zeros((1, 256), jnp.float32), JT._fit_block_rows(64), True
    )
    x = tensor_from_reference(np.asarray(xj), "cpu")
    assert x.dtype == torch_dtype and x.shape == (64, 256)
    out, csum = TT.transmit_array(x)
    assert csum is not None and torch.equal(out, x)
    acc, port_csum = _assert_port_modes_bit_equal(x, 64 * 256 // 4)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jax_acc))
    assert torch.equal(csum, port_csum)
    view = out.view(torch.uint8).numpy().tobytes()
    assert view == np.asarray(jax_out).view(np.uint8).tobytes()


@pytest.mark.parametrize("shape", [(3, 7), (1000,), (5, 3, 9)])
def test_untileable_takes_clone_route_without_checksum(shape):
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    out, csum = TT.transmit_array(x)
    assert csum is None
    assert out.data_ptr() != x.data_ptr() and torch.equal(out, x)
    jax_out, jax_csum = JT.transmit_array(jnp.asarray(x.numpy()))
    assert jax_csum is None
    np.testing.assert_array_equal(np.asarray(jax_out), out.numpy())


def test_non_numeric_takes_clone_route():
    x = torch.tensor([True, False] * 128)
    out, csum = TT.transmit_array(x)
    assert csum is None and torch.equal(out, x)


def test_reshaped_transmit_matches_whole_frame():
    x_np = _payload(8, 8 * 128, 3, integer_valued=True).reshape(4, 2, 1024)
    out, csum = TT.transmit_array(torch.from_numpy(x_np))
    assert out.shape == (4, 2, 1024)
    _, jax_csum = JT.device_copy_with_checksum(
        JT.lanes_view(jnp.asarray(x_np)), interpret=True
    )
    assert float(csum) == float(jax_csum)


# block rows 256, 64, 12, 8, 4 and 1 (_fit_block_rows of m)
BLOCK_ROW_SHAPES = [(512, 256), (320, 256), (12, 256), (1000, 128), (300, 384), (1, 128)]


def _ordered_acc(x_np, carry_np, br):
    """The kernels' order, one float32 scalar addition at a time: per
    block, group g sums rows g, g+8, ... from 0, the first min(8, br)
    groups are added in order, then the blocks onto the carry."""
    m, n = x_np.shape
    acc = (np.zeros(n, np.float32) if carry_np is None
           else carry_np.reshape(n).astype(np.float32))
    for b in range(m // br):
        blk = x_np[b * br:(b + 1) * br].astype(np.float32)
        for c in range(n):
            sums = []
            for g in range(min(8, br)):
                s = np.float32(0)
                for r in range(g, br, 8):
                    s = np.float32(s + blk[r, c])
                sums.append(s)
            t = sums[0]
            for v in sums[1:]:
                t = np.float32(t + v)
            acc[c] = np.float32(acc[c] + t)
    return acc.reshape(1, n)


@pytest.mark.parametrize("m,n", [(64, 128), (12, 128), (40, 128), (300, 128), (1, 128),
                                 (257, 128)])
@pytest.mark.parametrize("with_carry", [False, True])
def test_plain_version_adds_in_the_kernels_order(m, n, with_carry):
    rng = np.random.RandomState(m + n)
    x_np = (rng.randn(m, n) * 100).astype(np.float32)
    carry_np = rng.randn(1, n).astype(np.float32) if with_carry else None
    br = TT._fit_block_rows(m)
    _, acc = TT.copy_csum_plain(
        torch.from_numpy(x_np), None if carry_np is None else torch.from_numpy(carry_np), br
    )
    want = _ordered_acc(x_np, carry_np, br)
    assert acc.numpy().view(np.uint32).tobytes() == want.view(np.uint32).tobytes()


@pytest.mark.parametrize("m,n", BLOCK_ROW_SHAPES)
@pytest.mark.parametrize("integer_valued", [True, False])
def test_plain_version_against_jax_at_every_block_row_count(m, n, integer_valued):
    x_np = _payload(m, n, m + 3, integer_valued)
    _, jax_acc = _jax_acc(x_np)
    _, jax_csum = JT.device_copy_with_checksum(jnp.asarray(x_np), interpret=True)
    out, acc = TT.copy_csum_plain(torch.from_numpy(x_np), None, TT._fit_block_rows(m))
    assert out.numpy().tobytes() == x_np.tobytes()
    csum = float(TT.fold_checksum(acc))
    if integer_valued:  # every partial sum exact: any order gives the same bits
        np.testing.assert_array_equal(acc.numpy(), jax_acc)
        assert csum == float(jax_csum)
    else:
        lane_scale = np.abs(x_np).sum(0, keepdims=True)
        assert np.all(np.abs(acc.numpy() - jax_acc) <= RTOL * lane_scale)
        assert abs(csum - float(jax_csum)) <= RTOL * float(lane_scale.sum())


@pytest.mark.parametrize("m,n", BLOCK_ROW_SHAPES)
def test_chained_plain_chunks_bit_equal_to_the_plain_frame(m, n):
    x = torch.from_numpy(_payload(m, n, m + 4, integer_valued=False))
    br = TT._fit_block_rows(m)
    carry = torch.from_numpy(np.random.RandomState(m).randn(1, n).astype(np.float32))
    _, whole = TT.copy_csum_plain(x, carry, br)
    acc = carry
    for off in range(0, m, br * 2):  # chunks of two blocks (the last may be one)
        _, acc = TT.copy_csum_plain(x[off:off + 2 * br], acc, br)
    assert torch.equal(acc, whole)


def test_plan_helpers_match_jax():
    for shape, dtype in [((8192, 2048), np.float32), ((1000, 384), np.uint8),
                         ((4, 3, 128), np.float32), ((77,), np.float32)]:
        x_np = np.zeros(shape, dtype)
        jv, jbr, jchunks = JT.chunk_plan_for(jnp.asarray(x_np), 8 << 20)
        tv, tbr, tchunks = TT.chunk_plan_for(torch.from_numpy(x_np), 8 << 20)
        assert (jv is None) == (tv is None)
        if tv is not None:
            assert tuple(jv.shape) == tuple(tv.shape)
            assert (jbr, list(jchunks)) == (tbr, list(tchunks))
    for m in (1, 3, 8, 320, 1000, 8192):
        assert TT._fit_block_rows(m) == JT._fit_block_rows(m)


# lane views the staged kernel is planned for: the echo frame in four
# dtypes, the DMGET/DMSET stack, a 1 MiB and a 4 KB cache value, a ragged
# u8 row (384 bytes: one 512-byte tile, clipped), and blocks of 1, 4, 12,
# 40 and 200 rows
PLAN_CASES = [
    ((8192, 2048), torch.float32), ((8192, 2048), torch.bfloat16),
    ((8192, 2048), torch.uint8), ((8192, 2048), torch.float64),
    ((32, 1048576), torch.uint8), ((256, 4096), torch.uint8),
    ((1, 4096), torch.uint8), ((1000, 384), torch.uint8),
    ((1, 128), torch.float32), ((300, 384), torch.bfloat16),
    ((12, 256), torch.float32), ((40, 640), torch.int16),
    ((200, 512), torch.float64), ((1000, 384), torch.int64),
]


@pytest.mark.parametrize("shape,dtype", PLAN_CASES)
def test_stage_rows_fit_the_staged_kernel(shape, dtype):
    m, n = shape
    v = torch.empty(shape, dtype=dtype)
    br = TT._fit_block_rows(m)
    plan = TT.staged_plan(v, br)
    # the tile is the same number of bytes whatever the dtype
    assert plan.tile_cols * v.element_size() == TT._TILE_BYTES == 512
    # every column lies in exactly one tile: tile t holds [t * w, (t + 1) * w) ∩ [0, n)
    cover = torch.zeros(n, dtype=torch.int32)
    for t in range(plan.ntiles):
        cover[t * plan.tile_cols:(t + 1) * plan.tile_cols] += 1
    assert torch.equal(cover, torch.ones(n, dtype=torch.int32))
    assert plan.items == (m // br) * plan.ntiles
    # a stage is whole row groups (or the whole block of fewer than 8 rows),
    # no more than the block needs, and the stages of an item cover its block
    sr = plan.stage_rows
    assert sr % 8 == 0 or sr == br < 8
    assert sr < br + 8 and -(-br // sr) * sr >= br
    # a stage, the ring and the kernels' CTAs fit the shared memory
    assert sr * TT._TILE_BYTES <= TT._STAGE_BYTES
    assert TT._STAGED_CTAS_PER_SM * TT._STAGED_SMEM <= TT._SMEM_PER_SM
    assert TT._COPY_CTAS_PER_SM * TT._COPY_SMEM <= TT._SMEM_PER_SM
    # transfer.cu's tensor-map box, one tile's 8-byte words x the stage's
    # rows x one block: the engine takes at most 256 elements a dimension
    assert max(TT._TILE_BYTES // 8, sr, 1) <= 256
    assert plan.grid(132) == min(plan.items, 132 * TT._STAGED_CTAS_PER_SM)
    TT._check_stage_rows(br, sr)  # what the wrapper (and transfer.cu) takes


# the staged kernel's u8 shapes: the stack of a 32-value DMSET at a small
# width (one 32-row block, 8 tiles), and the ragged 384-byte row
STAGED_U8 = [(32, 4096), (1000, 384)]


@pytest.mark.parametrize("m,n", STAGED_U8)
def test_staged_plain_matches_the_jax_dma_kernel_on_u8(m, n):
    """The port's staged path on the CPU (its plain version) against the
    JAX package's DMA kernel in interpret mode.  Every lane sum of u8
    values here is below 2**24, so the accumulators are exact and
    bit-equal; the frame checksum is a float32 sum past 2**24, held
    within RTOL of sum|x|."""
    x_np = np.random.RandomState(m + n).randint(0, 256, size=(m, n)).astype(np.uint8)
    v = jnp.asarray(x_np)
    br = JT._fit_block_rows(m)
    dma_out, dma = JT.device_copy_with_checksum_dma(
        v, br, JT.pallas_stage_rows(v, br), interpret=True
    )
    _, jax_acc = _jax_acc(x_np)
    x = torch.from_numpy(x_np)
    assert TT._fit_block_rows(m) == br
    sr = TT.staged_plan(x, br).stage_rows
    out, acc = TT._staged_copy_csum(x, br, sr)
    out_d, csum = TT.device_copy_with_checksum_dma(x, br, sr)
    assert out.numpy().tobytes() == out_d.numpy().tobytes() == np.asarray(dma_out).tobytes()
    np.testing.assert_array_equal(acc.numpy(), jax_acc)
    assert torch.equal(csum, TT.fold_checksum(acc))
    assert abs(float(csum) - float(dma)) <= RTOL * float(x_np.astype(np.float64).sum())


def test_unaligned_view_is_refused_before_any_launch():
    """The bulk-copy engine needs a 16-byte aligned base: a view at an
    odd offset is refused by the planner and by the wrappers' checks on
    the CPU as on the card, and nothing launches."""
    flat = torch.zeros(64 * 256 + 4, dtype=torch.uint8)
    v = flat[4:].view(64, 256)
    assert v.data_ptr() % 16 and v.is_contiguous()
    TT.reset_launch_counts()
    with pytest.raises(ValueError):
        TT.staged_plan(v, 64)
    with pytest.raises(ValueError):
        TT.device_copy_with_checksum_dma(v, 64, 64)
    with pytest.raises(ValueError):
        TT.device_copy_with_checksum_pallas(v)
    with pytest.raises(ValueError):  # what the K1, K2 and copy_blocks launchers check
        TT._check_operand(v, "payload", v)
    with pytest.raises(ValueError):  # a stage that is not whole row groups
        TT._staged_copy_csum(flat[:64 * 256].view(64, 256), 64, 12)
    assert all(c == 0 for c in TT.launches.values())


def test_cpu_path_launches_no_kernel():
    TT.reset_launch_counts()
    x = torch.from_numpy(_payload(512, 256, 9, integer_valued=False))
    TT.device_copy_with_checksum(x)
    TT.device_copy_with_checksum_chunked(x, 128 * 256 * 4)
    TT.device_copy_with_checksum_pallas(x, 128 * 256 * 4)
    assert all(v == 0 for v in TT.launches.values())


def test_other_devices_raise():
    x = torch.empty((8, 128), device="meta")
    with pytest.raises(ValueError):
        TT.device_copy_with_checksum(x)
    with pytest.raises(ValueError):
        TT.device_copy_with_checksum_pallas(x)


def test_tensor_from_reference_keeps_bytes():
    from incubator_brpc_tpu_torch.convert import tensor_from_reference

    rng = np.random.RandomState(11)
    for xj in [jnp.asarray(rng.randn(16, 128).astype(np.float32)),
               jnp.asarray(rng.randn(16, 128)).astype(jnp.bfloat16),
               jnp.asarray(rng.randint(0, 255, (3, 5)).astype(np.uint8))]:
        ref = np.asarray(xj)
        t = tensor_from_reference(ref, torch.device("cpu"))
        assert tuple(t.shape) == ref.shape
        assert t.contiguous().view(torch.uint8).numpy().tobytes() == \
            ref.view(np.uint8).tobytes()


def test_tensor_from_reference_needs_a_device_without_cuda(monkeypatch):
    from incubator_brpc_tpu_torch.convert import tensor_from_reference

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tensor_from_reference(np.zeros((2, 128), np.float32))


def test_slot_must_match_the_payload():
    x = torch.zeros((64, 256))
    carry = torch.zeros((1, 256))
    for bad in (torch.empty((64, 256), dtype=torch.float16), torch.empty((32, 256))):
        with pytest.raises(ValueError):
            TT.device_copy_with_checksum_chunk_into(x, carry, bad, 64)
        with pytest.raises(ValueError):
            TT.device_copy_with_checksum_pallas(x, slot=bad)


# ---- TPU kernel #1: device_copy ----------------------------------------------


def _jax_copy_interpret(x_np, chunk_rows=256):
    """The JAX package's ``_copy_kernel`` over the grid ``device_copy``
    builds, in Pallas interpret mode (``device_copy`` itself refuses the
    CPU)."""
    import jax
    from jax.experimental import pallas as pl

    m, n = x_np.shape
    rows = JT._fit_block_rows(m, chunk_rows)
    return np.asarray(pl.pallas_call(
        JT._copy_kernel,
        out_shape=jax.ShapeDtypeStruct(x_np.shape, x_np.dtype),
        grid=(m // rows,),
        in_specs=[pl.BlockSpec((rows, n), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((rows, n), lambda i: (i, 0)),
        interpret=True,
    )(jnp.asarray(x_np)))


@pytest.mark.parametrize("shape,chunk_rows", [
    ((512, 256), 256),   # two full blocks
    ((1000, 128), 256),  # rows fall to 8
    ((7, 384), 256),     # rows fall to 1
    ((96, 128), 32),     # a smaller chunk_rows
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint8"])
def test_device_copy_byte_equal_to_jax_copy_kernel(shape, chunk_rows, dtype):
    from incubator_brpc_tpu_torch.convert import tensor_from_reference

    rng = np.random.RandomState(shape[0] + chunk_rows)
    if dtype == "uint8":
        x_np = rng.randint(0, 256, size=shape).astype(np.uint8)
    else:
        x_np = np.asarray(jnp.asarray(rng.randn(*shape).astype(np.float32)).astype(dtype))
    want = _jax_copy_interpret(x_np, chunk_rows)
    x = tensor_from_reference(x_np, "cpu")
    TT.reset_launch_counts()
    out = TT.device_copy(x)
    assert out.data_ptr() != x.data_ptr() and out.dtype == x.dtype
    assert out.view(torch.uint8).numpy().tobytes() == want.view(np.uint8).tobytes()
    slot = torch.empty_like(x)
    assert TT.device_copy(x, out=slot).data_ptr() == slot.data_ptr()
    assert torch.equal(slot.view(torch.uint8), out.view(torch.uint8))
    assert TT.launches["copy_blocks"] == 0  # the CPU runs the plain version


def test_device_copy_refuses_what_the_tpu_kernel_refuses():
    for bad in (torch.zeros((4, 100)), torch.zeros((512,)), torch.zeros((0, 128))):
        with pytest.raises(ValueError):
            TT.device_copy(bad)
    with pytest.raises(ValueError):  # out of another shape
        TT.device_copy(torch.zeros((8, 128)), out=torch.empty((4, 128)))
    with pytest.raises(ValueError):  # neither the CPU nor a card
        TT.device_copy(torch.empty((8, 128), device="meta"))
