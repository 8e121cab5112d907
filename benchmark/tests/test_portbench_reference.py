"""The references against small hand-worked cases, and their refusal of a
corrupted byte and of a result taken one precision lower."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness.cell import find_cell, load_module

echo = load_module("reference", "ici_echo")
ps = load_module("reference", "ps_mixtral8x22b_attn")


def test_echo_reference_counts_a_reply_with_one_byte_changed():
    pool = torch.arange(2 * 1 * 8, dtype=torch.float32).reshape(2, 1, 8)
    good = [(0, pool[0].clone()), (1, pool[1].clone())]
    assert echo.replies_wrong(good, pool) == 0
    bad = pool[1].clone()
    bad.view(torch.uint8)[0, 5] ^= 1  # one bit of one byte
    assert echo.replies_wrong([(0, pool[0].clone()), (1, bad)], pool) == 1
    assert echo.replies_wrong([(1, pool[0].clone())], pool) == 1  # another request's bytes
    assert echo.replies_wrong([(0, pool[0].reshape(8, 1).clone())], pool) == 1  # its shape


def test_echo_reference_checksum_is_the_exact_sum():
    pool = torch.tensor([[[1.0, 2.0, -0.5]], [[1e8, 1.0, -1e8]]])
    assert echo.checksum(pool).tolist() == [2.5, 1.0]
    assert echo.magnitude(pool).tolist() == [3.5, 2e8 + 1.0]
    sums = [(0, torch.tensor(2.5)), (1, torch.tensor(0.0))]  # float32 loses the 1 here
    gap = echo.checksum_gap(sums, echo.checksum(pool), echo.magnitude(pool))
    assert gap == pytest.approx(1.0 / (2e8 + 1.0))


def test_echo_reference_refuses_its_bfloat16_control():
    g = torch.Generator().manual_seed(5)
    pool = torch.randn((16, 1, 1024), generator=g)
    limits = find_cell("echo.4kb").limits
    sound = [(i, pool[i].sum()) for i in range(16)]  # float32, in torch's order
    assert echo.checksum_gap(sound, echo.checksum(pool), echo.magnitude(pool)) <= limits["csum_gap"]
    ctrl = [echo.control_reply(pool[i]) for i in range(16)]
    assert echo.replies_wrong([(i, y) for i, (y, _) in enumerate(ctrl)], pool) == 16
    gap = echo.checksum_gap([(i, s) for i, (_, s) in enumerate(ctrl)],
                            echo.checksum(pool), echo.magnitude(pool))
    assert gap > limits["csum_gap"]


def test_tf32_rounding_keeps_ten_mantissa_bits_nearest_even():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-10, -(1.0 + 2**-12)])
    assert ps.round_tf32(x).tolist() == [1.0, 1.0 + 2**-9, 1.0 + 2**-10, -1.0]


def test_ps_reference_is_the_float64_product_and_refuses_lower_precisions():
    d = 256
    g = torch.Generator().manual_seed(9)
    W = torch.randn((d, d), generator=g) / d ** 0.5
    rows = torch.randn((8, d), generator=g)
    ref, scale = ps.forward(rows, W)
    assert torch.allclose(ref, rows.double() @ W.double())
    assert bool((scale >= ref.abs()).all())
    limit = find_cell("ps.forward.p1").limits["y_gap"]

    def gap(y):
        return ps.forward_gap([(i, y[i].numpy().tobytes()) for i in range(8)], rows, W)

    assert gap(rows @ W) <= limit  # float32 passes
    assert gap(ps.control_forward(rows, W)) > limit  # TF32 is refused
    assert gap((rows.bfloat16() @ W.bfloat16()).float()) > limit  # and bfloat16
    y = rows @ W
    y[3, 17] += 1e-3 * float(scale[3, 17])  # one entry off
    assert gap(y) > limit
    swapped = (rows @ W)[[1, 0, 2, 3, 4, 5, 6, 7]]  # another row's answer
    assert gap(swapped) > limit
