"""The frame fold in the kernels' tail, and the transmit's launch plans.

On the CPU the port's wrappers run the plain versions: ``fold_checksum``
is the fold K1's and K2's tails run on the card, so here it is held bit
for bit to a float32 loop written out in that order, and within
1e-5 x sum|carry| to the JAX package's fold (``jnp.sum``, another order).
Every chunk mode of the fabric gives the whole frame's scalar, bit for
bit, as the card's must (tests/test_torch_cuda.py holds the kernels).

The plan cache (``ops/transfer.PLANS``): a repeated (device, stream,
shape, dtype, block rows) hits, a new one misses, as the fabric's two
``/vars`` counters show; no two transmits share a reply or a checksum;
the cache keeps at most its bound of plans.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from incubator_brpc_tpu.ops import transfer as JT
from incubator_brpc_tpu_torch.metrics.variable import describe_exposed
from incubator_brpc_tpu_torch.ops import transfer as TT

RTOL = 1e-5
FOLD_WIDTHS = [128, 1024, 2048, 6144, 65664]


def _ordered_fold(lanes):
    """The stated order, one float32 add at a time: 128 lanes, lane j
    adding lanes[j], lanes[j + 128], ... from 0.0, then the tree, lane
    j < s adding lane j + s for s = 64, 32, ..., 1."""
    v = [np.float32(0.0)] * 128
    for k in range(len(lanes) // 128):
        for j in range(128):
            v[j] = np.float32(v[j] + lanes[k * 128 + j])
    s = 64
    while s:
        for j in range(s):
            v[j] = np.float32(v[j] + v[j + s])
        s //= 2
    return v[0]


def _lanes(n, offset, seed):
    """A (1, n) float32 accumulator cut at ``offset`` out of a wider row
    whose magnitudes span six decades, so that any other order of the
    adds rounds differently."""
    rng = np.random.RandomState(seed)
    row = (rng.randn(1, n + offset) * 10.0 ** rng.randint(-3, 4, size=(1, n + offset)))
    return torch.from_numpy(row.astype(np.float32))[:, offset:offset + n]


@pytest.mark.parametrize("offset", [0, 384])
@pytest.mark.parametrize("n", FOLD_WIDTHS)
def test_fold_adds_in_the_stated_order(n, offset):
    carry = _lanes(n, offset, n + offset)
    got = TT.fold_checksum(carry)
    assert got.dtype == torch.float32 and got.shape == ()
    want = _ordered_fold(carry.numpy().reshape(-1))
    assert np.float32(got.item()).view(np.uint32) == want.view(np.uint32)


@pytest.mark.parametrize("n", FOLD_WIDTHS)
def test_fold_within_tolerance_of_the_jax_fold(n):
    carry = _lanes(n, 0, 7 * n)
    jax_csum = float(JT.fold_checksum(jnp.asarray(carry.numpy())))
    scale = float(np.abs(carry.numpy()).astype(np.float64).sum())
    assert abs(TT.fold_checksum(carry).item() - jax_csum) <= RTOL * scale


def test_fold_refuses_lanes_that_do_not_tile():
    with pytest.raises(ValueError, match="not a multiple of 128"):
        TT.fold_checksum(torch.zeros((1, 192)))


class _Port:
    """What ``IciFabric._transmit_segment`` reads of a destination port."""

    def __init__(self):
        from incubator_brpc_tpu_torch.parallel.ici import StagingRing

        self.coords = (0, 0)
        self.device = torch.device("cpu")
        self.staging = StagingRing(depth=2)


@pytest.fixture
def fabric():
    from incubator_brpc_tpu_torch.parallel.ici import get_fabric

    fab = get_fabric()
    saved = (fab.chunk_mode, fab.chunk_bytes)
    fab.chunk_bytes = 64 * 1024
    yield fab
    fab.chunk_mode, fab.chunk_bytes = saved


@pytest.mark.parametrize("shape", [(1024, 256), (320, 768), (4096, 128)])
@pytest.mark.parametrize("mode", ["off", "fused", "pipelined", "pallas"])
def test_every_chunk_mode_gives_the_whole_frame_scalar(fabric, mode, shape):
    """Each mode's checksum bit-equal to the whole frame's and to the
    plain fold of the plain accumulator (the pipelined mode's is its last
    chunk's, folded by that launch)."""
    fabric.chunk_mode = mode
    x = torch.from_numpy(np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32))
    out, csum = fabric._transmit_segment(x, _Port(), None)
    assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
    _, acc = TT.copy_csum_plain(x, None, TT._fit_block_rows(shape[0]))
    assert torch.equal(csum, TT.fold_checksum(acc))
    assert torch.equal(csum, TT.device_copy_with_checksum(x)[1])


def test_the_last_chunk_ends_the_frame_with_its_scalar():
    x = _lanes(1024 * 256, 0, 5).reshape(1024, 256)
    br = TT._fit_block_rows(1024)
    carry = None
    for off in range(0, 768, br):
        _, carry = TT.device_copy_with_checksum_chunk(
            x[off:off + br], carry if carry is not None else torch.zeros((1, 256)), br)
    out, csum = TT.device_copy_with_checksum_last_chunk(x[768:], carry, br)
    assert torch.equal(out, x[768:])
    assert torch.equal(csum, TT.device_copy_with_checksum(x)[1])


def _plan_counts():
    return (int(describe_exposed("rpc_ici_transmit_plan_hits")),
            int(describe_exposed("rpc_ici_transmit_plan_misses")))


def test_plan_cache_hits_a_repeated_shape_and_misses_a_new_one(fabric):
    fabric.chunk_mode = "off"
    port = _Port()
    x = torch.randn((3, 640), generator=torch.Generator().manual_seed(3))
    TT.PLANS.clear()
    hits, misses = _plan_counts()
    first = fabric._transmit_segment(x, port, None)
    assert _plan_counts() == (hits, misses + 1)
    second = fabric._transmit_segment(x, port, None)
    assert _plan_counts() == (hits + 1, misses + 1)
    fabric._transmit_segment(x.to(torch.float64), port, None)  # another dtype
    fabric._transmit_segment(torch.zeros((6, 640)), port, None)  # another shape
    assert _plan_counts() == (hits + 1, misses + 3)
    # every transmit a reply and a checksum of its own
    (out1, csum1), (out2, csum2) = first, second
    assert out1.data_ptr() not in (x.data_ptr(), out2.data_ptr())
    assert csum1.data_ptr() != csum2.data_ptr()
    assert torch.equal(out1, out2) and torch.equal(csum1, csum2)
    keys = [key for key, _ in TT.PLANS.items()]
    assert (-1, 0, x.shape, torch.float32, TT._fit_block_rows(3)) in keys


def test_plan_cache_stays_within_its_bound(fabric):
    fabric.chunk_mode = "off"
    port = _Port()
    TT.PLANS.clear()
    for rows in range(1, 2 * TT.PLAN_KEYS + 2):
        fabric._transmit_segment(torch.ones((rows, 128)), port, None)
    assert len(TT.PLANS.items()) == TT.PLAN_KEYS
    kept = [key[2][0] for key, _ in TT.PLANS.items()]
    assert kept == list(range(TT.PLAN_KEYS + 2, 2 * TT.PLAN_KEYS + 2))


def test_plan_cache_drops_the_least_recently_used():
    cache = TT.PlanCache(bound=3)
    xs = [torch.zeros((r, 128)) for r in range(1, 6)]
    keys = [(-1, 0, x.shape, x.dtype, 1) for x in xs]
    for key, x in zip(keys[:3], xs):
        cache.get(key, x, 1)
    cache.get(keys[0], xs[0], 1)  # a hit: now the most recent
    cache.get(keys[3], xs[3], 1)  # drops keys[1]
    assert [k for k, _ in cache.items()] == [keys[2], keys[0], keys[3]]
    assert (cache.hits.get_value(), cache.misses.get_value()) == (1, 4)


def test_launch_plan_refuses_other_devices():
    with pytest.raises(ValueError, match="no copy\\+checksum kernel"):
        TT.launch_plan(torch.empty((8, 128), device="meta"), 8)
