"""TLS on the port's Channel and Server, and the rest of item 20
(``client/auth.py``, ``serialization/mcpack.py``, ``runtime/fd.py``,
``utils/timeio.py``), each held against the JAX package on the same
inputs (tests/test_ssl.py, test_auth.py, test_mcpack_trackme.py and
test_runtime.py:300-330 of the reference's suite).

Certificates are self-signed and made per module with the ``openssl``
CLI, as tests/test_ssl.py makes them; the TLS cases skip without it.
"""

import os
import subprocess
import threading
import time

import numpy as np
import pytest
import torch

from incubator_brpc_tpu.client.auth import Authenticator as JAuthenticator
from incubator_brpc_tpu.client.channel import Channel as JChannel
from incubator_brpc_tpu.client.channel import ChannelOptions as JChannelOptions
from incubator_brpc_tpu.client.controller import Controller as JController
from incubator_brpc_tpu.models.echo import EchoService as JEchoService
from incubator_brpc_tpu.models.echo import echo_stub as j_echo_stub
from incubator_brpc_tpu.protos.echo_pb2 import EchoRequest as JEchoRequest
from incubator_brpc_tpu.serialization import mcpack as j_mcpack
from incubator_brpc_tpu.server.server import Server as JServer
from incubator_brpc_tpu.server.server import ServerOptions as JServerOptions
from incubator_brpc_tpu.transport import ssl_helper as j_ssl
from incubator_brpc_tpu_torch.client.auth import AuthContext, Authenticator
from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.serialization import mcpack
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
from incubator_brpc_tpu_torch.transport import ssl_helper

CPU = torch.device("cpu")
D = 64


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


def _server_ssl(helper, certs):
    return helper.ServerSSLOptions(default_cert=helper.CertInfo(
        certificate=certs["cert"], private_key=certs["key"]))


def _make_auth(base):
    class Token(base):
        MAGIC = "torch-secret-7"

        def __init__(self, credential=MAGIC):
            self.credential = credential
            self.verified = []

        def generate_credential(self):
            return self.credential

        def verify_credential(self, auth_str, peer, context=None):
            self.verified.append(auth_str)
            if context is not None:
                context.user = "torch"
            return 0 if auth_str == self.MAGIC else -1

    return Token


PAuth, JAuth = _make_auth(Authenticator), _make_auth(JAuthenticator)


# ---------------------------------------------------------------------------
# TLS
# ---------------------------------------------------------------------------

def test_tls_echo_equals_the_jax_tls_echo(tls_certs):
    """tpu_std echo over TLS with server-cert verification, sync and
    async, on both packages: the same replies."""
    got = {}
    for pkg in ("port", "jax"):
        if pkg == "port":
            srv = Server(ServerOptions(ssl_options=_server_ssl(ssl_helper, tls_certs)))
            srv.add_service(EchoService())
            ch_cls, opts, ssl_opts, stub_fn, ctrl, req = (
                Channel, ChannelOptions, ssl_helper.ChannelSSLOptions, echo_stub,
                Controller, EchoRequest)
        else:
            srv = JServer(JServerOptions(ssl_options=_server_ssl(j_ssl, tls_certs)))
            srv.add_service(JEchoService())
            ch_cls, opts, ssl_opts, stub_fn, ctrl, req = (
                JChannel, JChannelOptions, j_ssl.ChannelSSLOptions, j_echo_stub,
                JController, JEchoRequest)
        assert srv.start(0) == 0
        ch = ch_cls(opts(timeout_ms=5000, ssl_options=ssl_opts(ca_file=tls_certs["cert"])))
        try:
            assert ch.init(f"127.0.0.1:{srv.port}") == 0
            out = []
            for i in range(3):
                c = ctrl()
                r = stub_fn(ch).Echo(c, req(message=f"tls{i}"))
                assert not c.failed(), (pkg, c.error_text())
                out.append(r.message)
            done = threading.Event()
            c = ctrl()
            resp = stub_fn(ch).Echo(c, req(message="async"), done=done.set)
            assert done.wait(5) and not c.failed(), c.error_text()
            out.append(resp.message)
            got[pkg] = out
        finally:
            ch.close()
            srv.stop()
    assert got["port"] == got["jax"] == ["tls0", "tls1", "tls2", "async"]


def _jax_tls_get(w_np, certs):
    from incubator_brpc_tpu.models.parameter_server import PsService as JPs
    from incubator_brpc_tpu.models.parameter_server import ps_stub as j_ps_stub

    svc = JPs()
    svc.put_param("w", w_np)
    srv = JServer(JServerOptions(ssl_options=_server_ssl(j_ssl, certs), auth=JAuth()))
    srv.add_service(svc)
    assert srv.start(0) == 0
    ch = JChannel(JChannelOptions(timeout_ms=30000, auth=JAuth(),
                                  ssl_options=j_ssl.ChannelSSLOptions(ca_file=certs["cert"])))
    try:
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        c = JController()
        j_ps_stub(ch).Get(c, JEchoRequest(message="w"))
        assert not c.failed(), c.error_text()
        return c.response_attachment.to_bytes()
    finally:
        ch.close()
        srv.stop()


def test_tls_ps_get_is_byte_equal_to_the_jax_package(tls_certs):
    """A PS Get of a CPU-device W over TLS/TCP with an Authenticator: the
    reply bytes equal the JAX package's TLS path on the same seeded W."""
    from incubator_brpc_tpu_torch.models.parameter_server import PsService, ps_stub

    w_np = np.random.default_rng(17).standard_normal((D, D)).astype(np.float32)
    svc = PsService(device=CPU)
    svc.put_param("w", torch.from_numpy(w_np.copy()))
    server_auth = PAuth()
    srv = Server(ServerOptions(ssl_options=_server_ssl(ssl_helper, tls_certs),
                               auth=server_auth))
    srv.add_service(svc)
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=30000, auth=PAuth(),
                                ssl_options=ssl_helper.ChannelSSLOptions(
                                    ca_file=tls_certs["cert"])))
    try:
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        c = Controller()
        ps_stub(ch).Get(c, EchoRequest(message="w"))
        assert not c.failed(), c.error_text()
        port_bytes = c.response_attachment.to_bytes()
    finally:
        ch.close()
        srv.stop()
    assert server_auth.verified == [PAuth.MAGIC]
    assert port_bytes == w_np.tobytes()
    assert port_bytes == _jax_tls_get(w_np, tls_certs)


def test_plaintext_and_tls_channels_get_distinct_socket_map_keys():
    plain = Channel(ChannelOptions())
    tls = Channel(ChannelOptions(ssl_options=ssl_helper.ChannelSSLOptions()))
    strict = Channel(ChannelOptions(ssl_options=ssl_helper.ChannelSSLOptions(
        verify_hostname=True)))
    sigs = {plain._signature(), tls._signature(), strict._signature()}
    assert len(sigs) == 3
    assert ":ssl:" in tls._signature() and ":ssl:" not in plain._signature()
    # the same keys the JAX package derives for the same options
    j_tls = JChannel(JChannelOptions(ssl_options=j_ssl.ChannelSSLOptions()))
    assert j_tls._signature() == tls._signature()
    assert plain._ssl_params() is None
    ctx, sni = tls._ssl_params()
    assert ctx is tls._ssl_params()[0]  # built once


def test_native_engine_with_tls_still_raises_item_22(tls_certs):
    """The engine is ported (item 22) and plaintext: with ssl_options a
    native_engine server serves TLS on the Python transport, as the JAX
    package's does, and a TLS echo answers."""
    srv = Server(ServerOptions(native_engine=True,
                               ssl_options=_server_ssl(ssl_helper, tls_certs)))
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=5000, ssl_options=ssl_helper.ChannelSSLOptions(
        ca_file=tls_certs["cert"])))
    try:
        assert srv._native_engine is None and srv._ssl_server_ctx is not None
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        c = Controller()
        r = echo_stub(ch).Echo(c, EchoRequest(message="tls"))
        assert not c.failed(), c.error_text()
        assert r.message == "tls"
    finally:
        ch.close()
        srv.stop()


def test_bad_server_certificate_fails_start(tmp_path):
    missing = str(tmp_path / "nope.pem")
    srv = Server(ServerOptions(ssl_options=ssl_helper.ServerSSLOptions(
        default_cert=ssl_helper.CertInfo(certificate=missing, private_key=missing))))
    assert srv.start(0) == -1
    assert not srv.is_running()


# ---------------------------------------------------------------------------
# Authenticator / AuthContext (item 20)
# ---------------------------------------------------------------------------

def _auth_outcomes(pkg, credential, protocol):
    if pkg == "port":
        srv_cls, opts, ch_cls, ch_opts, stub_fn, ctrl, req, auth = (
            Server, ServerOptions, Channel, ChannelOptions, echo_stub, Controller,
            EchoRequest, PAuth)
        svc = EchoService()
    else:
        srv_cls, opts, ch_cls, ch_opts, stub_fn, ctrl, req, auth = (
            JServer, JServerOptions, JChannel, JChannelOptions, j_echo_stub, JController,
            JEchoRequest, JAuth)
        svc = JEchoService()
    server_auth = auth()
    srv = srv_cls(opts(auth=server_auth))
    srv.add_service(svc)
    assert srv.start(0) == 0
    client_auth = auth(credential) if credential is not None else None
    ch = ch_cls(ch_opts(timeout_ms=2000, protocol=protocol, auth=client_auth, max_retry=1))
    try:
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        failed = []
        for i in range(2):
            c = ctrl()
            stub_fn(ch).Echo(c, req(message=f"a{i}"))
            failed.append(c.failed())
        return failed, sorted(set(server_auth.verified))
    finally:
        ch.close()
        srv.stop()


@pytest.mark.parametrize("protocol", ["tpu_std", "http"])
@pytest.mark.parametrize("credential", ["torch-secret-7", "wrong", None])
def test_authenticator_accepts_or_refuses_as_the_jax_package(credential, protocol):
    port = _auth_outcomes("port", credential, protocol)
    ref = _auth_outcomes("jax", credential, protocol)
    assert port == ref
    assert port[0] == ([False, False] if credential == PAuth.MAGIC else [True, True])


def test_auth_context_is_the_jax_shape():
    ctx = AuthContext(user="u", group="g", roles="r", starter="s", is_service=True)
    assert (ctx.user, ctx.group, ctx.roles, ctx.starter, ctx.is_service) == (
        "u", "g", "r", "s", True)
    assert AuthContext.__slots__ == ("user", "group", "roles", "starter", "is_service")
    with pytest.raises(NotImplementedError):
        Authenticator().generate_credential()


# ---------------------------------------------------------------------------
# mcpack, fd, timeio (item 20)
# ---------------------------------------------------------------------------

MCPACK_DOCS = [
    {"s": "hello", "i8": 5, "neg": -12000, "big": 1 << 40, "f": 1.25, "yes": True,
     "no": False, "nil": None, "bin": b"\x01\x02", "obj": {"a": 1, "b": "two"},
     "arr": [1, "x", {"k": 2}]},
    {"long": "y" * 300, "ints": [1, 2, 3], "nested": {"deeper": {"z": -1.5}}},
    {},
]


@pytest.mark.parametrize("doc", MCPACK_DOCS, ids=["mixed", "long", "empty"])
def test_mcpack_round_trips_to_the_jax_bytes(doc):
    blob = mcpack.dumps(doc)
    assert blob == j_mcpack.dumps(doc)
    assert mcpack.loads(blob) == j_mcpack.loads(blob) == doc


def test_mcpack_proto_bridge_equals_the_jax_bytes():
    msg = EchoRequest(message="mc", code=9)
    blob = mcpack.proto_to_mcpack(msg)
    assert blob == j_mcpack.proto_to_mcpack(JEchoRequest(message="mc", code=9))
    out = EchoRequest()
    ok, err = mcpack.mcpack_to_proto(blob, out)
    assert ok, err
    assert out.message == "mc" and out.code == 9


def test_fd_wait_readable_and_timeout():
    from incubator_brpc_tpu_torch.runtime.fd import EVENT_IN, fd_wait

    r, w = os.pipe()
    os.set_blocking(r, False)
    try:
        t0 = time.monotonic()
        assert fd_wait(r, EVENT_IN, timeout=0.2) == 0
        assert time.monotonic() - t0 >= 0.15
        threading.Timer(0.1, lambda: os.write(w, b"x")).start()
        assert fd_wait(r, EVENT_IN, timeout=3.0) == 1
        assert os.read(r, 1) == b"x"
    finally:
        os.close(r)
        os.close(w)


def test_task_connect():
    import socket as pysock

    from incubator_brpc_tpu_torch.runtime.fd import task_connect

    ls = pysock.socket()
    ls.bind(("127.0.0.1", 0))
    ls.listen(1)
    port = ls.getsockname()[1]
    s = task_connect(("127.0.0.1", port), timeout=3.0)
    assert s is not None
    s.close()
    ls.close()
    assert task_connect(("127.0.0.1", port), timeout=1.0) is None


def test_timeio_matches_the_jax_package():
    from incubator_brpc_tpu.utils import timeio as j_timeio
    from incubator_brpc_tpu_torch.utils import timeio

    names = sorted(n for n in vars(j_timeio) if not n.startswith("_") and callable(
        getattr(j_timeio, n)) and getattr(getattr(j_timeio, n), "__module__", "") ==
        j_timeio.__name__)
    assert names and names == sorted(
        n for n in vars(timeio) if not n.startswith("_") and callable(getattr(timeio, n))
        and getattr(getattr(timeio, n), "__module__", "") == timeio.__name__)
