"""The port's HBM cache tier held against the JAX package's, on the CPU.

Each test runs the same inputs, made from a seed with numpy, through
``incubator_brpc_tpu.cache`` and ``incubator_brpc_tpu_torch.cache`` and
compares what comes out:

- the store under one op sequence (SET/GET/DELETE/FLUSH/multi-GET):
  hits, misses, evictions, ``hbm_used``, LRU order and the fused
  gather's bytes are equal, and the gather's traces stay within its
  padding buckets;
- the redis front over ``ici://`` (tests/test_hbm_cache.py:450-599):
  GET stays device-resident, SET over budget is an error reply, the
  DMGET/DMSET wire formats, the TCP host spill and the admission shed;
  the memcache and redis fronts sharing one store
  (tests/test_memcache.py:352);
- a stream over ``ici://`` (tests/test_streaming_subsystem.py:562).

Cache values are bytes, so everything is compared for equality.  The
port runs with ``device=torch.device("cpu")``: its fabric then moves
device segments with the copy kernels' plain versions.  It also holds
the rule the JAX package never needed: a stored value pins no more
memory than the budget charges for it (tensor indexing makes views).
"""

import threading
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_brpc_tpu import errors as j_errors
from incubator_brpc_tpu.cache import store as j_store_mod
from incubator_brpc_tpu.cache.service import (
    HBMCacheMemcacheService as JMemcacheFront,
)
from incubator_brpc_tpu.cache.service import HBMCacheService as JCacheService
from incubator_brpc_tpu.cache.store import HBMCacheStore as JStore
from incubator_brpc_tpu.chaos import injector as j_injector
from incubator_brpc_tpu.chaos.storm import admission_pressure_plan as j_pressure
from incubator_brpc_tpu.client.channel import Channel as JChannel
from incubator_brpc_tpu.client.channel import ChannelOptions as JChannelOptions
from incubator_brpc_tpu.client.controller import Controller as JController
from incubator_brpc_tpu.models.streaming_echo import StreamingEchoService as JStreamEcho
from incubator_brpc_tpu.protocols import memcache as JM
from incubator_brpc_tpu.protocols import redis as JR
from incubator_brpc_tpu.protos.echo_pb2 import EchoRequest as JEchoRequest
from incubator_brpc_tpu.server.server import Server as JServer
from incubator_brpc_tpu.server.server import ServerOptions as JServerOptions
from incubator_brpc_tpu.server.service import ServiceStub as JServiceStub
from incubator_brpc_tpu.streaming.stream import Stream as JStream
from incubator_brpc_tpu.streaming.stream import StreamHandler as JStreamHandler
from incubator_brpc_tpu.utils.iobuf import DeviceRef as JDeviceRef
from incubator_brpc_tpu_torch import convert
from incubator_brpc_tpu_torch import errors as p_errors
from incubator_brpc_tpu_torch.cache import CacheChannel
from incubator_brpc_tpu_torch.cache import store as p_store_mod
from incubator_brpc_tpu_torch.cache.service import (
    HBMCacheMemcacheService as PMemcacheFront,
)
from incubator_brpc_tpu_torch.cache.service import HBMCacheService as PCacheService
from incubator_brpc_tpu_torch.cache.store import HBMCacheStore as PStore
from incubator_brpc_tpu_torch.chaos import injector as p_injector
from incubator_brpc_tpu_torch.chaos.storm import admission_pressure_plan as p_pressure
from incubator_brpc_tpu_torch.client.channel import Channel as PChannel
from incubator_brpc_tpu_torch.client.channel import ChannelOptions as PChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller as PController
from incubator_brpc_tpu_torch.models.streaming_echo import StreamingEchoService as PStreamEcho
from incubator_brpc_tpu_torch.observability.profiling import hbm_account
from incubator_brpc_tpu_torch.protocols import memcache as PM
from incubator_brpc_tpu_torch.protocols import redis as PR
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest as PEchoRequest
from incubator_brpc_tpu_torch.server.server import Server as PServer
from incubator_brpc_tpu_torch.server.server import ServerOptions as PServerOptions
from incubator_brpc_tpu_torch.server.service import ServiceStub as PServiceStub
from incubator_brpc_tpu_torch.streaming.stream import Stream as PStream
from incubator_brpc_tpu_torch.streaming.stream import StreamHandler as PStreamHandler
from incubator_brpc_tpu_torch.utils.flags import get_flag, set_flag
from incubator_brpc_tpu_torch.utils.iobuf import DeviceRef as PDeviceRef
from incubator_brpc_tpu_torch.utils.iobuf import IOBuf as PIOBuf

CPU = torch.device("cpu")

# one namespace per package, so each scenario is written once and run
# through both; ``srv_kw``/``ch_kw``/``store_kw`` carry the port's
# explicit device (the JAX package picks its default device itself)
JAX = types.SimpleNamespace(
    errors=j_errors, store_mod=j_store_mod, Store=JStore,
    CacheService=JCacheService, MemcacheFront=JMemcacheFront,
    injector=j_injector, pressure=j_pressure, Channel=JChannel,
    ChannelOptions=JChannelOptions, Controller=JController, R=JR, M=JM,
    Server=JServer, ServerOptions=JServerOptions, DeviceRef=JDeviceRef,
    StreamEcho=JStreamEcho, EchoRequest=JEchoRequest, ServiceStub=JServiceStub,
    Stream=JStream, StreamHandler=JStreamHandler,
    srv_kw={}, ch_kw={}, store_kw={},
)
PORT = types.SimpleNamespace(
    errors=p_errors, store_mod=p_store_mod, Store=PStore,
    CacheService=PCacheService, MemcacheFront=PMemcacheFront,
    injector=p_injector, pressure=p_pressure, Channel=PChannel,
    ChannelOptions=PChannelOptions, Controller=PController, R=PR, M=PM,
    Server=PServer, ServerOptions=PServerOptions, DeviceRef=PDeviceRef,
    StreamEcho=PStreamEcho, EchoRequest=PEchoRequest, ServiceStub=PServiceStub,
    Stream=PStream, StreamHandler=PStreamHandler,
    srv_kw={"device": CPU}, ch_kw={"ici_device": CPU}, store_kw={"device": CPU},
)

# ICI coords are per package registry; this file owns slices 140+ in both
_slice_counter = [140]


def fresh_slice():
    _slice_counter[0] += 1
    return _slice_counter[0]


@pytest.fixture(autouse=True)
def _isolation():
    # the port's rpcz flag is process-wide: whatever a test did to it,
    # the next test starts from the value this one found
    rpcz = get_flag("rpcz_enabled")
    yield
    set_flag("rpcz_enabled", rpcz)
    j_injector.disarm()
    p_injector.disarm()


def host_bytes(pkg, v):
    if v is None or isinstance(v, bytes):
        return v
    return bytes(pkg.DeviceRef(v).view())


def metrics(pkg):
    m = pkg.store_mod
    return (m.cache_hits.get_value(), m.cache_misses.get_value(),
            m.cache_evictions.get_value(), m.cache_hbm_bytes.get_value())


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


def _op_sequence(seed, n_ops=160):
    rng = np.random.default_rng(seed)
    keys = [b"k%02d" % i for i in range(12)]
    lengths = (256, 1024, 4096, 16384, 65536)
    ops = []
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.5:
            n = int(rng.choice(lengths))
            ops.append(("set", keys[rng.integers(len(keys))],
                        rng.integers(0, 256, n, dtype=np.uint8).tobytes()))
        elif r < 0.72:
            ops.append(("get", keys[rng.integers(len(keys))]))
        elif r < 0.77:
            ops.append(("get_host", keys[rng.integers(len(keys))]))
        elif r < 0.85:
            ops.append(("delete", keys[rng.integers(len(keys))]))
        elif r < 0.98:
            k = int(rng.integers(2, 7))
            ops.append(("get_many", [keys[i] for i in rng.choice(len(keys), k)]))
        else:
            ops.append(("flush",))
    return ops


def _apply(pkg, store, op):
    kind = op[0]
    if kind == "set":
        return store.set(op[1], op[2])
    if kind == "get":
        return host_bytes(pkg, store.get(op[1]))
    if kind == "get_host":
        return store.get_host(op[1])
    if kind == "delete":
        return store.delete(op[1])
    if kind == "get_many":
        values, stacked = store.get_many(op[1])
        return ([host_bytes(pkg, v) for v in values],
                None if stacked is None
                else (tuple(stacked.shape), host_bytes(pkg, stacked)))
    return store.flush()


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_store_op_sequence_matches_jax(seed):
    """One seeded SET/GET/DELETE/FLUSH/multi-GET sequence through both
    stores over a 200 KB budget: every result, hit, miss, eviction and
    hbm_used is equal, the LRU order too, and the fused gather's stacks
    are byte-equal with pad rows repeating row 0."""
    budget = 200_000
    jstore, pstore = JStore(hbm_budget_bytes=budget), PStore(budget, device=CPU)
    traces0 = p_store_mod._mget_gather.trace_count()
    stacked_lengths = set()
    for op in _op_sequence(seed):
        j0, p0 = metrics(JAX), metrics(PORT)
        jr, pr = _apply(JAX, jstore, op), _apply(PORT, pstore, op)
        assert pr == jr, op[:2]
        jd = tuple(a - b for a, b in zip(metrics(JAX), j0))
        pd = tuple(a - b for a, b in zip(metrics(PORT), p0))
        assert pd == jd, (op[:2], pd, jd)  # hits, misses, evictions, bytes
        assert pstore.hbm_used == jstore.hbm_used <= budget
        assert pstore.keys() == jstore.keys()
        if op[0] == "get_many" and pr[1] is not None:
            stacked_lengths.add(pr[1][0][1])
    stats_j, stats_p = jstore.stats(), pstore.stats()
    for k in ("enabled", "entries", "hbm_used", "hbm_budget"):
        assert stats_p[k] == stats_j[k]
    traces = p_store_mod._mget_gather.trace_count() - traces0
    assert traces <= len(p_store_mod.MGET_BUCKETS) * max(1, len(stacked_lengths))


def test_fused_gather_bytes_equal_and_traces_bounded_by_buckets():
    """Hit counts 2..40 of one length: both gathers pad to the same
    bucket with the same bytes, and the port traces at most once per
    bucket (first-seen signatures, the JAX jit cache's count)."""
    rng = np.random.default_rng(5)
    L = 1536
    vals = [rng.integers(0, 256, L, dtype=np.uint8).tobytes() for _ in range(40)]
    jstore, pstore = JStore(1 << 22), PStore(1 << 22, device=CPU)
    keys = [b"g%02d" % i for i in range(40)]
    for k, v in zip(keys, vals):
        jstore.set(k, v)
        pstore.set(k, v)
    t0 = p_store_mod._mget_gather.trace_count()
    for n in range(2, 41):
        _, js = jstore.get_many(keys[:n])
        _, ps = pstore.get_many(keys[:n])
        assert tuple(ps.shape) == tuple(js.shape) == (p_store_mod._pad_bucket(n), L)
        assert ps.dtype == torch.uint8
        assert ps.numpy().tobytes() == np.asarray(js).tobytes()
    buckets_used = {p_store_mod._pad_bucket(n) for n in range(2, 41)}
    assert p_store_mod._mget_gather.trace_count() - t0 <= len(buckets_used)


def test_store_values_pin_no_more_than_they_are_charged():
    """A row view (a prefill layer, a DMGET row, a decode state) is
    stored as a compact copy: its storage is exactly its bytes, the
    budget and the cache.values ledger charge those bytes, and the
    (bucket, ...) base is not kept alive.  A whole tensor, bare or in a
    DeviceRef, is adopted by identity."""
    acct = hbm_account("cache.values")
    base0 = acct.live_bytes()
    store = PStore(1 << 20, device=CPU)
    big = torch.arange(32 * 256, dtype=torch.float32).reshape(32, 256)
    store.set(b"row", big[3])
    row = store.get(b"row")
    assert torch.equal(row, big[3])
    assert row.untyped_storage().nbytes() == row.nbytes == 1024
    assert row.untyped_storage().data_ptr() != big.untyped_storage().data_ptr()
    store.set(b"col", big[:, 5])  # not contiguous either
    col = store.get(b"col")
    assert col.is_contiguous() and col.untyped_storage().nbytes() == 32 * 4
    assert torch.equal(col, big[:, 5])
    whole = torch.ones(256)
    store.set(b"whole", whole)
    assert store.get(b"whole") is whole
    ref = PDeviceRef(torch.full((64,), 7, dtype=torch.uint8))
    store.set(b"ref", ref)
    assert store.get(b"ref") is ref.array
    _, stacked = store.get_many([b"row", b"whole"])
    assert tuple(stacked.shape) == (2, 256)
    store.set(b"again", stacked[1])
    again = store.get(b"again")
    assert again.untyped_storage().nbytes() == 1024 and torch.equal(again, whole)
    stored = [store.get(k) for k in store.keys()]
    assert store.hbm_used == sum(v.nbytes for v in stored)
    assert sum(v.untyped_storage().nbytes() for v in stored) == store.hbm_used
    assert acct.live_bytes() - base0 == store.hbm_used
    store.flush()
    assert acct.live_bytes() == base0


def test_jax_cache_values_carry_into_the_port():
    """convert.tensor_from_reference carries a JAX cache value — uint8
    bytes or a float32 KV layer — into a port store with equal bytes."""
    rng = np.random.default_rng(8)
    jstore = JStore(1 << 20)
    jstore.set(b"u8", rng.integers(0, 256, 4096, dtype=np.uint8).tobytes())
    jstore.set(b"f32", jnp.asarray(rng.standard_normal(32).astype(np.float32)))
    pstore = PStore(1 << 20, device=CPU)
    for k in (b"u8", b"f32"):
        t = convert.tensor_from_reference(np.asarray(jstore.get(k)), CPU)
        assert t.dtype == (torch.uint8 if k == b"u8" else torch.float32)
        assert pstore.set(k, t)
        assert pstore.get_host(k) == jstore.get_host(k)


def test_store_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PStore()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PCacheService()


def test_cache_channel_is_not_ported_yet():
    """CacheChannel is ported (tests/test_torch_cluster.py), and so is
    Channel TLS now: a CacheChannel with ssl_options builds as the JAX
    package's does, its nodes' channels keyed apart from plaintext ones
    (tests/test_torch_secure.py runs TLS calls)."""
    from incubator_brpc_tpu_torch.transport.ssl_helper import ChannelSSLOptions

    cc = CacheChannel("list://127.0.0.1:1", options=PChannelOptions(
        ssl_options=ChannelSSLOptions(), ici_device=torch.device("cpu")))
    try:
        plain = CacheChannel("list://127.0.0.1:1",
                             options=PChannelOptions(ici_device=torch.device("cpu")))
        assert ":ssl:" in cc._channel._signature()
        assert cc._channel._signature() != plain._channel._signature()
        plain.close()
    finally:
        cc.close()


def test_protocol_device_checks_accept_tensors_unedited():
    """redis and memcache are the JAX package's modules with only their
    imports rewritten: their duck-typed device-value checks take a
    torch.Tensor (nbytes + dtype), so a tensor bulk reply or SET value
    rides the IOBuf as a DeviceRef segment, not as host bytes."""
    for t in (torch.arange(16, dtype=torch.uint8), torch.zeros(4, 8)):
        assert PR._is_device_value(t) and PM._is_device_value(t)
        reply = PR.RedisReply(PR.REPLY_STRING, t)
        assert reply.is_device() and reply.device_array() is t
        out = PIOBuf()
        PR.pack_reply_into(reply, out)
        assert out.device_arrays() == [t]
        assert reply.bytes_value() == t.numpy().tobytes()
    for host in (b"abc", bytearray(b"abc"), memoryview(b"abc")):
        assert not PR._is_device_value(host) and not PM._is_device_value(host)
    req = PR.RedisRequest()
    req.add_command("SET", b"k", torch.ones(8, dtype=torch.uint8))
    buf = req.serialize_iobuf()
    assert len(buf.device_arrays()) == 1


# ---------------------------------------------------------------------------
# the redis front over ici:// and TCP (tests/test_hbm_cache.py:450-599)
# ---------------------------------------------------------------------------


def _cache_server(pkg, s, **store_kwargs):
    svc = pkg.CacheService(**store_kwargs, **pkg.store_kw)
    srv = pkg.Server(pkg.ServerOptions(redis_service=svc))
    assert srv.start_ici(s, 1, **pkg.srv_kw) == 0
    return srv, svc


def _redis_channel(pkg, addr, ici=True):
    kw = dict(pkg.ch_kw) if ici else {}
    ch = pkg.Channel(pkg.ChannelOptions(protocol="redis", timeout_ms=30000, **kw))
    assert ch.init(addr) == 0
    return ch


def call(pkg, ch, *commands):
    req = pkg.R.RedisRequest()
    for cmd in commands:
        req.add_command(*cmd)
    resp = pkg.R.RedisResponse()
    ctrl = pkg.Controller()
    ch.call_method(pkg.R.redis_method_spec(), ctrl, req, resp)
    return ctrl, resp


def _get_stays_device_resident(pkg):
    s = fresh_slice()
    srv, svc = _cache_server(pkg, s)
    try:
        ch = _redis_channel(pkg, f"ici://slice{s}/chip1")
        ctrl, resp = call(pkg, ch, ("SET", b"hot", b"\x01\x02" * 32))
        assert not ctrl.failed(), ctrl.error_text()
        assert resp.reply(0).value == "OK"
        ctrl, resp = call(pkg, ch, ("GET", b"hot"))
        assert not ctrl.failed(), ctrl.error_text()
        arr = resp.reply(0).device_array()
        assert arr is not None, "ICI GET materialized to host bytes"
        got = (int(arr.nbytes), host_bytes(pkg, arr), type(arr).__name__)
        ctrl, resp = call(pkg, ch, ("GET", b"nope"), ("EXISTS", b"hot"),
                          ("STRLEN", b"hot"), ("DBSIZE",))
        assert not ctrl.failed(), ctrl.error_text()
        info = (resp.reply(0).is_nil(), resp.reply(1).value,
                resp.reply(2).value, resp.reply(3).value)
        ctrl, resp = call(pkg, ch, ("DEL", b"hot"), ("FLUSHALL",))
        assert not ctrl.failed()
        return got, info, resp.reply(0).value, len(svc.store)
    finally:
        srv.stop()


def test_redis_get_over_ici_stays_device_resident():
    jr, pr = _get_stays_device_resident(JAX), _get_stays_device_resident(PORT)
    assert pr[0][2] == "Tensor"  # the port's GET hands back a tensor
    assert pr[0][:2] == jr[0][:2] == (64, b"\x01\x02" * 32)
    assert pr[1:] == jr[1:] == ((True, 1, 64, 1), 1, 0)


def _set_over_budget(pkg):
    s = fresh_slice()
    srv, _ = _cache_server(pkg, s, hbm_budget_bytes=128)
    try:
        ch = _redis_channel(pkg, f"ici://slice{s}/chip1")
        ctrl, _ = call(pkg, ch, ("SET", b"big", b"z" * 256))
        return (ctrl.failed(), ctrl.error_code == pkg.errors.ERESPONSE,
                "budget" in ctrl.error_text())
    finally:
        srv.stop()


def test_redis_set_over_budget_is_an_error_reply():
    assert _set_over_budget(PORT) == _set_over_budget(JAX) == (True, True, True)


def _dmget_wire(pkg):
    s = fresh_slice()
    srv, _ = _cache_server(pkg, s)
    try:
        ch = _redis_channel(pkg, f"ici://slice{s}/chip1")
        ctrl, _ = call(pkg, ch, *[("SET", b"d%d" % i, bytes([i]) * 64) for i in range(3)])
        assert not ctrl.failed(), ctrl.error_text()
        ctrl, resp = call(pkg, ch, ("DMGET", b"d0", b"miss", b"d1", b"d2"))
        assert not ctrl.failed(), ctrl.error_text()
        fused, lengths_r, payload = resp.reply(0).value
        stacked = payload.device_array()
        assert stacked is not None, "fused DMGET payload was pulled to host"
        fused_out = (fused.value, [x.value for x in lengths_r.value],
                     tuple(stacked.shape), host_bytes(pkg, stacked)[:192])
        ctrl, _ = call(pkg, ch, ("SET", b"odd", b"q" * 10))
        assert not ctrl.failed()
        ctrl, resp = call(pkg, ch, ("DMGET", b"d0", b"odd"))
        assert not ctrl.failed(), ctrl.error_text()
        fused, lengths_r, payload = resp.reply(0).value
        items = [host_bytes(pkg, it.device_array()) for it in payload.value]
        return fused_out, (fused.value, [x.value for x in lengths_r.value], items)
    finally:
        srv.stop()


def test_redis_dmget_fused_wire_format_over_ici():
    """Hit i is row i in hit order (the miss takes no row); 3 hits pad
    to the 4-bucket; mixed lengths leave unfused per-key bulks."""
    jr, pr = _dmget_wire(JAX), _dmget_wire(PORT)
    assert pr == jr
    assert pr[0][:3] == (1, [64, -1, 64, 64], (4, 64))
    assert pr[0][3] == b"\x00" * 64 + b"\x01" * 64 + b"\x02" * 64
    assert pr[1] == (0, [64, 10], [b"\x00" * 64, b"q" * 10])


def _dmset_wire(pkg):
    s = fresh_slice()
    srv, _ = _cache_server(pkg, s)
    try:
        ch = _redis_channel(pkg, f"ici://slice{s}/chip1")
        pairs = []
        for i in range(4):
            pairs.extend((b"bw%d" % i, bytes([i + 1]) * 64))
        ctrl, resp = call(pkg, ch, ("DMSET", *pairs))
        assert not ctrl.failed(), ctrl.error_text()
        stored = resp.reply(0).value
        ctrl, resp = call(pkg, ch, ("DMGET", b"bw0", b"bw1", b"bw2", b"bw3"))
        assert not ctrl.failed(), ctrl.error_text()
        fused, lengths_r, payload = resp.reply(0).value
        got = (fused.value, [x.value for x in lengths_r.value],
               host_bytes(pkg, payload.device_array()))
        ctrl, _ = call(pkg, ch, ("DMSET", b"lonely"))
        odd = (ctrl.failed(), "wrong number of arguments" in ctrl.error_text())
        ctrl, resp = call(pkg, ch, ("DMGET", b"lonely"))
        return stored, got, odd, [x.value for x in resp.reply(0).value[1].value]
    finally:
        srv.stop()


def test_redis_dmset_bulk_write_wire_format_over_ici():
    jr, pr = _dmset_wire(JAX), _dmset_wire(PORT)
    assert pr == jr
    assert pr[0] == 4 and pr[1][:2] == (1, [64] * 4)
    assert pr[1][2] == b"".join(bytes([i + 1]) * 64 for i in range(4))
    assert pr[2] == (True, True) and pr[3] == [-1]


def test_dmset_of_device_values_adopts_the_delivered_tensors():
    """DMSET values sent as tensors ride the request as DeviceRef
    segments; the store adopts each delivered tensor (a fresh copy made
    by the fabric's transmit, not the client's) with its exact bytes."""
    s = fresh_slice()
    srv, svc = _cache_server(PORT, s)
    try:
        ch = _redis_channel(PORT, f"ici://slice{s}/chip1")
        vals = [torch.full((4096,), i, dtype=torch.uint8) for i in range(4)]
        pairs = []
        for i, v in enumerate(vals):
            pairs.extend((b"dv%d" % i, v))
        ctrl, resp = call(PORT, ch, ("DMSET", *pairs))
        assert not ctrl.failed(), ctrl.error_text()
        assert resp.reply(0).value == 4
        for i, v in enumerate(vals):
            got = svc.store.get(b"dv%d" % i)
            assert torch.equal(got, v) and got.data_ptr() != v.data_ptr()
            assert got.untyped_storage().nbytes() == 4096
    finally:
        srv.stop()


def _tcp_spill(pkg):
    svc = pkg.CacheService(**pkg.store_kw)
    srv = pkg.Server(pkg.ServerOptions(redis_service=svc))
    assert srv.start(0) == 0
    try:
        ch = _redis_channel(pkg, f"127.0.0.1:{srv.port}", ici=False)
        big = bytes(range(256)) * 16  # a 4 KB value
        ctrl, resp = call(pkg, ch, ("SET", b"k", b"host-client"), ("GET", b"k"),
                          ("SET", b"v4k", big), ("GET", b"v4k"))
        assert not ctrl.failed(), ctrl.error_text()
        return [(resp.reply(i).device_array() is None, resp.reply(i).bytes_value())
                for i in (1, 3)]
    finally:
        srv.stop()


def test_redis_get_over_tcp_spills_to_host_bytes():
    jr, pr = _tcp_spill(JAX), _tcp_spill(PORT)
    assert pr == jr == [(True, b"host-client"), (True, bytes(range(256)) * 16)]


def _admission_shed(pkg):
    s = fresh_slice()
    srv, _ = _cache_server(pkg, s)
    try:
        ch = _redis_channel(pkg, f"ici://slice{s}/chip1")
        ctrl, _ = call(pkg, ch, ("SET", b"k", b"v"))
        assert not ctrl.failed(), ctrl.error_text()
        pkg.injector.arm(pkg.pressure(seed=3, reject_pct=1.0,
                                      method="redis.GET", max_hits=1))
        ctrl, _ = call(pkg, ch, ("GET", b"k"))
        shed = (ctrl.failed(), ctrl.error_code == pkg.errors.EOVERCROWDED)
        pkg.injector.disarm()
        ctrl, resp = call(pkg, ch, ("GET", b"k"))
        assert not ctrl.failed(), ctrl.error_text()
        return shed, resp.reply(0).device_array() is not None
    finally:
        srv.stop()


def test_redis_admission_shed_maps_to_eovercrowded():
    assert _admission_shed(PORT) == _admission_shed(JAX) == ((True, True), True)


def _mc_call(pkg, ch, req):
    resp = pkg.M.MemcacheResponse()
    ctrl = pkg.Controller()
    ch.call_method(pkg.M.memcache_method_spec(), ctrl, req, resp)
    assert not ctrl.failed(), ctrl.error_text()
    return resp


def _two_fronts(pkg):
    s = fresh_slice()
    store = pkg.Store(**pkg.store_kw)
    srv = pkg.Server(pkg.ServerOptions(
        redis_service=pkg.CacheService(store=store),
        memcache_service=pkg.MemcacheFront(store=store),
    ))
    assert srv.start_ici(s, 1, **pkg.srv_kw) == 0
    try:
        rch = _redis_channel(pkg, f"ici://slice{s}/chip1")
        ctrl, _ = call(pkg, rch, ("SET", b"shared", b"one-store" * 7))
        assert not ctrl.failed(), ctrl.error_text()
        mch = pkg.Channel(pkg.ChannelOptions(protocol="memcache", timeout_ms=30000,
                                             **pkg.ch_kw))
        assert mch.init(f"ici://slice{s}/chip1") == 0
        req = pkg.M.MemcacheRequest()
        req.get("shared")
        req.set("back", b"memcache-wrote-this")
        op = _mc_call(pkg, mch, req).op(0)
        mc = (op.device_array() is not None, op.bytes_value())
        ctrl, resp = call(pkg, rch, ("GET", b"back"))
        assert not ctrl.failed(), ctrl.error_text()
        return mc, host_bytes(pkg, resp.reply(0).device_array())
    finally:
        srv.stop()


def test_memcache_and_redis_fronts_share_one_store_over_ici():
    jr, pr = _two_fronts(JAX), _two_fronts(PORT)
    assert pr == jr == ((True, b"one-store" * 7), b"memcache-wrote-this")


# ---------------------------------------------------------------------------
# a stream over ici:// (tests/test_streaming_subsystem.py:562)
# ---------------------------------------------------------------------------


def _stream_over_ici(pkg, x):
    class Collect(pkg.StreamHandler):
        def __init__(self):
            self.chunks, self.cv = [], threading.Condition()
            self.closed = threading.Event()

        def on_received_messages(self, stream, messages):
            with self.cv:
                self.chunks.extend(m.to_bytes() for m in messages)
                self.cv.notify_all()

        def on_closed(self, stream):
            self.closed.set()

    s = fresh_slice()
    srv = pkg.Server()
    srv.add_service(pkg.StreamEcho())
    assert srv.start_ici(s, 201, **pkg.srv_kw) == 0
    try:
        ch = pkg.Channel(pkg.ChannelOptions(timeout_ms=30000, **pkg.ch_kw))
        assert ch.init(f"ici://slice{s}/chip201") == 0
        stub = pkg.ServiceStub(ch, pkg.StreamEcho)
        ctrl, collect = pkg.Controller(), Collect()
        stream = pkg.Stream.create(ctrl, collect)
        r = stub.StartStream(ctrl, pkg.EchoRequest(message="ici-stream"))
        assert not ctrl.failed(), ctrl.error_text()
        assert stream.wait_established(10)
        assert stream.write_device(x, timeout=30) == 0
        assert stream.write(b"host-bytes-too") == 0
        with collect.cv:
            assert collect.cv.wait_for(lambda: len(collect.chunks) >= 2, 30)
        frames = stream.frames_sent
        stream.close()
        assert collect.closed.wait(10)
        ch.close()
        return r.message, collect.chunks[:2], frames >= 2
    finally:
        srv.stop()


def test_stream_over_ici_device_payload():
    """A stream negotiated over an ici:// connection moves a device
    tensor as ONE frame through the fabric and the frames round-trip
    bit-exact, in both packages on the same input."""
    xs = np.arange(64 * 256, dtype=np.float32).reshape(64, 256)
    jr = _stream_over_ici(JAX, jnp.asarray(xs))
    pr = _stream_over_ici(PORT, torch.from_numpy(xs))
    assert pr == jr == ("stream-accepted", [xs.tobytes(), b"host-bytes-too"], True)
