"""The port's mesh, collective lowerings and dp x tp training step held
against the JAX package's, on the CPU.

The scenarios are those of tests/test_parallel.py:12-99: a (2, 4) mesh
and its ici:// topology, each lowering of ``parallel/collectives.py``
and ``make_training_step``.  The JAX side runs on the conftest's eight
virtual CPU devices; the port's mesh lists ``torch.device("cpu")``
eight times (virtual chips, as on one card).  Inputs are numpy arrays
from a seed.

Tolerances.  all_gather, all_to_all, the ppermute ring and the hedged
pick move or add values in the same order in both packages: byte-equal.
The psum, pmean and pmax agree within 1e-6·Σ|x| per element (JAX's
psum order is its own); the port's psum is bit-equal to the plain loop
that adds the chips' partials in chip order.  The training step agrees
within rtol 1e-5, atol 1e-6 on the loss and every parameter.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from incubator_brpc_tpu.parallel import collectives as JC
from incubator_brpc_tpu.parallel import mesh as jmesh
from incubator_brpc_tpu_torch import convert
from incubator_brpc_tpu_torch.parallel import collectives as C
from incubator_brpc_tpu_torch.parallel import mesh as pmesh

CPU = torch.device("cpu")
STEP_RTOL, STEP_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def meshes():
    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("need 8 virtual cpu devices (xla_force_host_platform_device_count)")
    return (jmesh.create_mesh((2, 4), devices=devs[:8]),
            pmesh.create_mesh((2, 4), devices=[CPU] * 8))


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def logical(out) -> np.ndarray:
    return out.full().numpy()


def assert_bytes_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def test_mesh_and_topology(meshes):
    jm, pm = meshes
    assert pm.axis_names == jm.axis_names == ("slice", "chip")
    assert list(pm.shape.items()) == list(jm.shape.items())
    assert pm.devices.shape == jm.devices.shape and pm.size == 8
    eps = pmesh.ici_endpoints(pm)
    assert [str(e) for e in eps] == [str(e) for e in jmesh.ici_endpoints(jm)]
    assert str(eps[0]) == "ici://slice0/chip0"
    assert pmesh.device_of(pm, eps[5]) is pm.devices[1][1]


def test_create_mesh_refuses_a_shape_that_is_not_the_device_count():
    for create, devs in ((jmesh.create_mesh, jax.devices("cpu")[:8]),
                         (pmesh.create_mesh, [CPU] * 8)):
        with pytest.raises(ValueError, match="mesh shape"):
            create((3, 3), devices=devs)
    m = pmesh.create_mesh(devices=[CPU] * 3)
    assert dict(m.shape) == {"slice": 1, "chip": 3}
    named = pmesh.create_mesh((1, 2), axis_names=("dp", "tp"), devices=[CPU] * 2)
    assert named.axis_names == ("dp", "tp") and named.shape["tp"] == 2


def test_create_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.create_mesh()


def test_shards_are_placed_as_jax_places_them(meshes):
    """Each chip's block under each spec equals the JAX array's
    addressable shard on the same mesh position, and is a contiguous
    copy of its own (never a view of the whole tensor)."""
    jm, pm = meshes
    from jax.sharding import NamedSharding, PartitionSpec as JP

    x = rand((8, 12), 3)
    xt = torch.from_numpy(x)
    for spec in [("chip", None), (None, "chip"), ("slice", None), ("slice", "chip"),
                 (("slice", "chip"), None), ()]:
        ja = jax.device_put(x, NamedSharding(jm, JP(*spec)))
        by_dev = {s.device: np.asarray(s.data) for s in ja.addressable_shards}
        st = C.shard_tensor(xt, pm, C.P(*spec))
        assert len(st.shards) == 8
        for k, shard in enumerate(st.shards):
            jdev = jm.devices.flat[k]
            assert_bytes_equal(shard.numpy(), by_dev[jdev])
            assert shard.is_contiguous()
            assert shard.untyped_storage().nbytes() == shard.numel() * 4
            assert shard.data_ptr() != xt.data_ptr()
        assert_bytes_equal(st.full().numpy(), x)
    with pytest.raises(ValueError, match="does not split"):
        C.shard_tensor(torch.zeros(6, 4), pm, C.P("chip"))


# ---------------------------------------------------------------------------
# the lowerings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
@pytest.mark.parametrize("seed", [0, 1])
def test_parallel_merge_within_tolerance_of_jax(meshes, op, seed):
    jm, pm = meshes
    x = rand((8 * 16, 24), seed)
    got = C.parallel_merge(pm, "chip", op)(torch.from_numpy(x))
    want = np.asarray(JC.parallel_merge(jm, "chip", op)(jnp.asarray(x)))
    assert got.replicated and len(got.shards) == 8
    assert all(torch.equal(s, got.shards[0]) for s in got.shards)
    bound = 1e-6 * np.abs(x).reshape(4, -1, 24).sum(axis=0)
    assert got.shape == want.shape
    assert np.all(np.abs(logical(got) - want) <= bound)


def test_psum_is_bit_equal_to_the_chip_order_sum(meshes):
    """The port's psum adds chip 0's block, then each chip's in order:
    equal bit for bit to that plain loop (and not to the reduction's
    own order in general)."""
    _, pm = meshes
    x = torch.from_numpy(rand((4 * 64, 33), 5))
    got = logical(C.parallel_merge(pm, "chip", "sum")(x))
    blocks = x.reshape(4, 64, 33)
    plain = blocks[0].clone()
    for b in blocks[1:]:
        plain = plain + b
    assert_bytes_equal(got, plain.numpy())
    mean = logical(C.parallel_merge(pm, "chip", "mean")(x))
    assert_bytes_equal(mean, (plain / 4).numpy())


def test_parallel_merge_refuses_an_unknown_op(meshes):
    _, pm = meshes
    with pytest.raises(ValueError, match="min"):
        C.parallel_merge(pm, "chip", "min")(torch.zeros(8, 2))


@pytest.mark.parametrize("shape", [(8, 4), (32, 16)])
def test_all_gather_byte_equal_to_jax(meshes, shape):
    jm, pm = meshes
    x = rand(shape, 7)
    got = C.parallel_broadcast_gather(pm, "chip")(torch.from_numpy(x))
    want = JC.parallel_broadcast_gather(jm, "chip")(jnp.asarray(x))
    assert_bytes_equal(logical(got), want)
    assert_bytes_equal(logical(got), x)


@pytest.mark.parametrize("shape", [(16, 8), (32, 12)])
def test_partition_reshard_byte_equal_to_jax(meshes, shape):
    jm, pm = meshes
    x = rand(shape, 11)
    got = C.partition_reshard(pm, "chip")(torch.from_numpy(x))
    want = JC.partition_reshard(jm, "chip")(jnp.asarray(x))
    assert tuple(got.shape) == want.shape == (4 * shape[0], shape[1] // 4)
    assert_bytes_equal(logical(got), want)
    # the sharded output: chip c holds the JAX shard of its position
    by_dev = {s.device: np.asarray(s.data) for s in want.addressable_shards}
    for k, shard in enumerate(got.shards):
        assert_bytes_equal(shard.numpy(), by_dev[jm.devices.flat[k]])


@pytest.mark.parametrize("hops", [None, 1, 2])
def test_ring_stream_byte_equal_to_jax(meshes, hops):
    jm, pm = meshes
    x = rand((8, 6), 13)
    got = C.ring_stream(pm, "chip", hops)(torch.from_numpy(x))
    want = JC.ring_stream(jm, "chip", hops)(jnp.asarray(x))
    assert_bytes_equal(logical(got), want)
    if hops is None:  # every chip has folded every shard
        full = np.asarray(want).reshape(4, 2, 6)
        assert np.allclose(full, x.reshape(4, 2, 6).sum(axis=0), atol=1e-5)


@pytest.mark.parametrize("flags", [[0, 0, 1, 1], [1, 0, 0, 0], [0, 0, 0, 1], [0, 1, 0, 1]])
def test_hedged_first_valid_byte_equal_to_jax(meshes, flags):
    jm, pm = meshes
    x = rand((8, 4), 17)
    valid = np.repeat(np.array(flags, np.float32), 2)
    got = C.hedged_first_valid(pm, "chip")(torch.from_numpy(x), torch.from_numpy(valid))
    want = JC.hedged_first_valid(jm, "chip")(jnp.asarray(x), jnp.asarray(valid))
    assert_bytes_equal(logical(got), want)
    first = flags.index(1)
    assert_bytes_equal(logical(got), x[2 * first:2 * first + 2])


def test_a_sharded_input_is_not_written(meshes):
    """A ShardedTensor already split by the lowering's spec goes in as
    is, and the psum leaves its shards untouched."""
    _, pm = meshes
    x = torch.from_numpy(rand((8, 4), 19))
    st = C.shard_tensor(x, pm, C.P("chip"))
    before = [s.clone() for s in st.shards]
    out = C.parallel_merge(pm, "chip", "sum")(st)
    assert all(torch.equal(a, b) for a, b in zip(before, st.shards))
    assert_bytes_equal(logical(out), logical(C.parallel_merge(pm, "chip", "sum")(x)))


def test_collective_leaves_a_subspan_only_inside_an_rpc(meshes):
    from incubator_brpc_tpu_torch.observability.span import Span, span_db, swap_current_span
    from incubator_brpc_tpu_torch.utils.flags import set_flag

    _, pm = meshes
    merge = C.parallel_merge(pm, "chip", "sum")
    set_flag("rpcz_max_spans_per_second", 1_000_000)
    try:
        merge(torch.ones(8, 2))  # outside any RPC: no span
        root = Span.create_client("test", "collective-leg")
        prev = swap_current_span(root)
        try:
            merge(torch.ones(8, 2))
        finally:
            swap_current_span(prev)
            root.end(0)
        import time

        deadline = time.monotonic() + 8
        legs = []
        while time.monotonic() < deadline and not legs:
            legs = [s for s in span_db().recent(500)
                    if s.trace_id == root.trace_id and s.kind == "collective"]
            time.sleep(0.05)
        assert len(legs) == 1 and legs[0].method == "psum_sum@chip"
        assert legs[0].parent_span_id == root.span_id
        # the call outside any RPC left no parentless leg
        assert not [s for s in span_db().recent(500)
                    if s.method == "psum_sum@chip" and s.parent_span_id == 0]
    finally:
        set_flag("rpcz_max_spans_per_second", 500)


# ---------------------------------------------------------------------------
# the dp x tp training step
# ---------------------------------------------------------------------------


def test_training_state_carried_across_is_placed_as_jax_places_it(meshes):
    from incubator_brpc_tpu.models.parameter_server import make_training_step as j_make

    jm, pm = meshes
    _, jparams, jx = j_make(jm, dim=64, batch=8)
    params, x = convert.training_state_from_reference(
        {k: np.asarray(v) for k, v in jparams.items()}, np.asarray(jx), pm)
    for name, jarr in [("w1", jparams["w1"]), ("w2", jparams["w2"]), ("x", jx)]:
        st = x if name == "x" else params[name]
        by_dev = {s.device: np.asarray(s.data) for s in jarr.addressable_shards}
        for k, shard in enumerate(st.shards):
            assert_bytes_equal(shard.numpy(), by_dev[jm.devices.flat[k]])


def test_training_step_matches_jax_from_the_carried_state(meshes):
    """Two steps from the JAX initial state: the losses and every
    parameter agree within rtol 1e-5, atol 1e-6, and the loss falls."""
    from incubator_brpc_tpu.models.parameter_server import make_training_step as j_make
    from incubator_brpc_tpu_torch.models.parameter_server import make_training_step

    jm, pm = meshes
    jstep, jparams, jx = j_make(jm, dim=64, batch=8)
    step, _, _ = make_training_step(pm, dim=64, batch=8)
    params, x = convert.training_state_from_reference(
        {k: np.asarray(v) for k, v in jparams.items()}, np.asarray(jx), pm)
    losses = []
    for _ in range(2):
        jparams, jloss = jstep(jparams, jx)
        params, loss = step(params, x)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=STEP_RTOL, atol=STEP_ATOL)
        for name in ("w1", "w2"):
            np.testing.assert_allclose(params[name].full().numpy(), np.asarray(jparams[name]),
                                       rtol=STEP_RTOL, atol=STEP_ATOL)
        losses.append(float(loss))
    assert losses[1] < losses[0]


def test_training_step_keeps_its_shardings_and_learns(meshes):
    from incubator_brpc_tpu_torch.models.parameter_server import make_training_step

    _, pm = meshes
    step, params, x = make_training_step(pm, dim=32, batch=8, lr=0.05)
    assert params["w1"].spec == C.P(None, "chip") and params["w2"].spec == C.P("chip", None)
    assert x.spec == C.P("slice", None)
    assert [tuple(s.shape) for s in params["w1"].shards] == [(32, 8)] * 8
    assert [tuple(s.shape) for s in x.shards] == [(4, 32)] * 8
    losses = []
    for _ in range(4):
        params, loss = step(params, x)
        losses.append(float(loss))
        assert params["w2"].spec == C.P("chip", None) and len(params["w2"].shards) == 8
    assert all(b < a for a, b in zip(losses, losses[1:]))


def test_training_step_equals_the_plain_unsharded_step(meshes):
    """The sharded step's gradient reduction (autograd's sum over the
    slices' replicas) and psum give the unsharded step's numbers."""
    from incubator_brpc_tpu_torch.models.parameter_server import make_training_step

    _, pm = meshes
    step, params, x = make_training_step(pm, dim=16, batch=4, lr=0.1)
    w1 = params["w1"].full().double().requires_grad_()
    w2 = params["w2"].full().double().requires_grad_()
    xf = x.full().double()
    loss64 = torch.mean((torch.relu(xf @ w1) @ w2) ** 2)
    loss64.backward()
    new, loss = step(params, x)
    np.testing.assert_allclose(float(loss), float(loss64.detach()), rtol=1e-6)
    for name, w in (("w1", w1), ("w2", w2)):
        ref = (w - 0.1 * w.grad).detach().numpy()
        np.testing.assert_allclose(new[name].full().numpy(), ref, rtol=1e-5, atol=1e-6)
