"""The port's device paths, driven on the CPU for the armed witness lane.

Not collected by the tier-1 run (the name does not start with
``test_``): ``tests/test_torch_analysis.py`` runs this file in a child
pytest with both witnesses armed through the plugin,

    BRPC_TORCH_LOCK_WITNESS=1 BRPC_TORCH_TRANSFER_WITNESS=1 \\
        python -m pytest tests/torch_witness_paths.py \\
        -p incubator_brpc_tpu_torch.analysis.pytest_plugin

and reads the two reports.  Each test holds its own path's manifested
pulls to the counts the device plane promises: no host view on an ICI
hop, no spill on an ICI cache hit, one Forward pull per batch (over
ici:// and through the native engine), one
token-sums pull per decode step, and one host view per frame on a TLS
hop.
"""

import subprocess
import threading

import numpy as np
import pytest
import torch

from incubator_brpc_tpu_torch.analysis import device_witness as dw
from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

CPU = torch.device("cpu")
SLICE = 41
D = 64


def pulls(key):
    return dw.transfer_counts().get(key, 0)


def test_witness_is_armed():
    assert dw.enabled(), "run through the plugin with BRPC_TORCH_TRANSFER_WITNESS=1"


@pytest.mark.parametrize("mode", ["fused", "pallas"])
def test_ici_echo_takes_no_host_view(mode):
    from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
    from incubator_brpc_tpu_torch.ops import transfer as T
    from incubator_brpc_tpu_torch.parallel.ici import get_fabric

    fab = get_fabric()
    saved = fab.chunk_mode
    fab.chunk_mode = mode
    srv = Server()
    srv.add_service(EchoService())
    chip = 1 if mode == "fused" else 2
    assert srv.start_ici(SLICE, chip, device=CPU) == 0
    ch = Channel(ChannelOptions(timeout_ms=30000, ici_device=CPU))
    try:
        assert ch.init(f"ici://slice{SLICE}/chip{chip}") == 0
        x = torch.randn((256, 1024), generator=torch.Generator().manual_seed(7))
        views0 = pulls("iobuf.host-view")
        for _ in range(4):
            c = Controller()
            c.request_attachment.append_device(x)
            echo_stub(ch).Echo(c, EchoRequest(message="bulk"))
            assert not c.failed(), c.error_text()
            (seg,) = c.response_attachment.device_segments()
            assert torch.equal(seg.whole_array(), x)
            assert seg.csum is not None
            want = T.fold_checksum(T.copy_csum_plain(x.reshape(-1, 1024), None, 256)[1])
            assert torch.equal(seg.csum, want)
        assert pulls("iobuf.host-view") == views0
    finally:
        ch.close()
        srv.stop()
        fab.chunk_mode = saved


def _forwards(addr, x_rows):
    from incubator_brpc_tpu_torch.models.parameter_server import ps_stub

    out = [None] * len(x_rows)
    barrier = threading.Barrier(len(x_rows), timeout=20)

    def one(i):
        ch = Channel(ChannelOptions(timeout_ms=30000, ici_device=CPU))
        assert ch.init(addr) == 0
        barrier.wait()
        c = Controller()
        c.request_attachment.append_user_data(x_rows[i].tobytes())
        ps_stub(ch).Forward(c, EchoRequest(message="w"))
        assert not c.failed(), c.error_text()
        out[i] = np.frombuffer(c.response_attachment.to_bytes(), np.float32)
        ch.close()

    ts = [threading.Thread(target=one, args=(i,)) for i in range(len(x_rows))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    return out


def test_ps_put_get_forward_pull_once_per_batch():
    from incubator_brpc_tpu_torch.models.parameter_server import PsService, ps_stub

    svc = PsService(device=CPU)
    srv = Server(ServerOptions(enable_batching=True))
    srv.add_service(svc)
    assert srv.start_ici(SLICE, 3, device=CPU) == 0
    addr = f"ici://slice{SLICE}/chip3"
    ch = Channel(ChannelOptions(timeout_ms=30000, ici_device=CPU))
    try:
        assert ch.init(addr) == 0
        w = torch.randn((D, D), generator=torch.Generator().manual_seed(3))
        views0 = pulls("iobuf.host-view")
        c = Controller()
        c.request_attachment.append_device(w)
        ps_stub(ch).Put(c, EchoRequest(message="w"))
        assert not c.failed(), c.error_text()
        c = Controller()
        ps_stub(ch).Get(c, EchoRequest(message="w"))
        assert not c.failed(), c.error_text()
        assert torch.equal(c.response_attachment.device_arrays()[0], w)
        assert pulls("iobuf.host-view") == views0
        rng = np.random.default_rng(5)
        xs = [rng.standard_normal(D).astype(np.float32) for _ in range(8)]
        b = srv.batcher("PsService.Forward")
        batches0, fwd0 = b.batches, pulls("ps.forward-pull")
        ys = _forwards(addr, xs)
        for x, y in zip(xs, ys):
            np.testing.assert_allclose(y, x @ w.numpy(), rtol=1e-5, atol=1e-5)
        assert pulls("ps.forward-pull") - fwd0 == b.batches - batches0 > 0
    finally:
        ch.close()
        srv.stop()


def test_native_forward_pull_once_per_batch():
    """The native engine's path (chip_smoke.py's [witness] runs it on
    the card): 8 concurrent async Forwards over one native channel with
    batching on, each read burst's rows one submit_many; one
    ps.forward-pull a batch, no other pull."""
    from incubator_brpc_tpu_torch.models.parameter_server import PsService, ps_stub

    svc = PsService(device=CPU)
    w = torch.randn((D, D), generator=torch.Generator().manual_seed(4))
    svc.put_param("w", w)
    srv = Server(ServerOptions(native_engine=True, enable_batching=True))
    srv.add_service(svc)
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=30000, connection_type="native"))
    try:
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        rng = np.random.default_rng(6)
        xs = [rng.standard_normal(D).astype(np.float32) for _ in range(8)]
        b = srv.batcher("PsService.Forward")
        batches0, fwd0 = b.batches, pulls("ps.forward-pull")
        done = [threading.Event() for _ in xs]
        ctrls = []
        for i, x in enumerate(xs):
            c = Controller()
            c.request_attachment.append_user_data(x.tobytes())
            ps_stub(ch).Forward(c, EchoRequest(message="w"), done=done[i].set)
            ctrls.append(c)
        assert all(e.wait(30) for e in done)
        for x, c in zip(xs, ctrls):
            assert not c.failed(), c.error_text()
            y = np.frombuffer(c.response_attachment.to_bytes(), np.float32)
            np.testing.assert_allclose(y, x @ w.numpy(), rtol=1e-5, atol=1e-5)
        assert pulls("ps.forward-pull") - fwd0 == b.batches - batches0 > 0
    finally:
        ch.close()
        srv.stop()


def test_cache_ici_hits_never_spill():
    from incubator_brpc_tpu_torch.cache import HBMCacheService
    from incubator_brpc_tpu_torch.protocols import redis as R

    srv = Server(ServerOptions(redis_service=HBMCacheService(hbm_budget_bytes=1 << 22, device=CPU)))
    assert srv.start_ici(SLICE, 4, device=CPU) == 0
    ch = Channel(ChannelOptions(protocol="redis", timeout_ms=30000, ici_device=CPU))
    try:
        assert ch.init(f"ici://slice{SLICE}/chip4") == 0

        def call(*cmd):
            req, resp, c = R.RedisRequest(), R.RedisResponse(), Controller()
            req.add_command(*cmd)
            ch.call_method(R.redis_method_spec(), c, req, resp)
            assert not c.failed(), c.error_text()
            return resp.reply(0)

        vals = {f"k{i}".encode(): torch.arange(4096, dtype=torch.uint8) + i
                for i in range(8)}
        for k, v in vals.items():
            req, resp, c = R.RedisRequest(), R.RedisResponse(), Controller()
            req.add_command(b"SET", k, v)
            ch.call_method(R.redis_method_spec(), c, req, resp)
            assert not c.failed(), c.error_text()
        spills0, views0 = pulls("cache.host-spill"), pulls("iobuf.host-view")
        for k, v in vals.items():
            got = call(b"GET", k).device_array()
            assert got is not None and torch.equal(got, v)
        assert pulls("cache.host-spill") == spills0
        assert pulls("iobuf.host-view") == views0
    finally:
        ch.close()
        srv.stop()


def test_decode_pulls_token_sums_once_per_step():
    from incubator_brpc_tpu_torch.streaming.generate import DecodeLoop

    loop = DecodeLoop(dim=8, device=CPU)
    try:
        sums0 = pulls("decode.token-sums")
        steps0 = loop.steps
        done = threading.Event()
        toks = []
        loop.admit("witness", 8, lambda t, r: toks.append(t), lambda r, ok: done.set())
        assert done.wait(30)
        assert len(toks) == 8
        assert pulls("decode.token-sums") - sums0 == loop.steps - steps0 == 8
    finally:
        loop.stop()


@pytest.fixture(scope="module")
def tls_certs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tls")
    cert, key = str(d / "cert.pem"), str(d / "key.pem")
    proc = subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", key, "-out", cert, "-days", "2", "-subj", "/CN=localhost",
         "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        pytest.skip(f"openssl unavailable: {proc.stderr[-200:]}")
    return {"cert": cert, "key": key}


def test_tls_ps_get_one_host_view_per_frame(tls_certs):
    from incubator_brpc_tpu_torch.client.auth import Authenticator
    from incubator_brpc_tpu_torch.models.parameter_server import PsService, ps_stub
    from incubator_brpc_tpu_torch.transport.ssl_helper import (
        CertInfo,
        ChannelSSLOptions,
        ServerSSLOptions,
    )

    class Token(Authenticator):
        def generate_credential(self):
            return "witness-token"

        def verify_credential(self, auth_str, peer, context=None):
            return 0 if auth_str == "witness-token" else 1

    svc = PsService(device=CPU)
    w = torch.randn((D, D), generator=torch.Generator().manual_seed(9))
    svc.put_param("w", w)
    srv = Server(ServerOptions(auth=Token(), ssl_options=ServerSSLOptions(
        default_cert=CertInfo(certificate=tls_certs["cert"],
                              private_key=tls_certs["key"]))))
    srv.add_service(svc)
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=10000, auth=Token(),
                                ssl_options=ChannelSSLOptions(ca_file=tls_certs["cert"])))
    try:
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        views0 = pulls("iobuf.host-view")
        for n in range(1, 4):
            c = Controller()
            ps_stub(ch).Get(c, EchoRequest(message="w"))
            assert not c.failed(), c.error_text()
            got = np.frombuffer(c.response_attachment.to_bytes(), np.float32)
            assert np.array_equal(got.reshape(D, D), w.numpy())
            assert pulls("iobuf.host-view") - views0 == n
    finally:
        ch.close()
        srv.stop()
