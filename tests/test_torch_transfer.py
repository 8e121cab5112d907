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
- randn payloads: within 1e-5 relative to sum|x| per lane (JAX and
  torch sum inside a block in different orders);
- within the port: whole frame, chained chunks, slot and staged paths
  are bit-equal (torch.equal).
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
    res["staged"] = TT._staged_copy_csum(x, br, TT.pallas_stage_rows(x, br))
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


def test_stage_rows_fit_the_staged_kernel():
    for dtype, fit in [(torch.float32, 64), (torch.bfloat16, 128),
                       (torch.uint8, 256), (torch.float64, 32)]:
        v = torch.zeros((8192, 2048), dtype=dtype)
        sr = TT.pallas_stage_rows(v, 256)
        assert sr == fit and sr % 8 == 0
        assert sr * 128 * v.element_size() <= 32768
    assert TT.pallas_stage_rows(torch.zeros((1, 128)), 1) == 8


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
