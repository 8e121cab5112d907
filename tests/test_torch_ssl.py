"""TLS transport: Channel/Server ssl_options + encrypted DCN bridge.

Analog of the reference's SSL support (details/ssl_helper.cpp, SSL
states on Socket socket.h:205 region, ChannelSSLOptions /
ServerSSLOptions in ssl_options.h).  Certs are generated per-session
with the openssl CLI (self-signed, CN=localhost + SAN 127.0.0.1).

Carried by hand from ``tests/test_ssl.py``.  The gRPC-over-TLS cases are
held by ``tests/test_torch_h2.py`` and the encrypted DCN bridge by
``tests/test_torch_dcn.py``; the rest run with the port's package name and
nothing else changed.
"""

import json
import os
import ssl
import subprocess
import sys
import threading
import urllib.request

import pytest

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
from incubator_brpc_tpu_torch.transport.ssl_helper import (
    CertInfo,
    ChannelSSLOptions,
    ServerSSLOptions,
)


@pytest.fixture(scope="module")
def tls_certs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tls")
    cert, key = str(d / "cert.pem"), str(d / "key.pem")
    proc = subprocess.run(
        [
            "openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
            "-keyout", key, "-out", cert, "-days", "2",
            "-subj", "/CN=localhost",
            "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1",
        ],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        pytest.skip(f"openssl unavailable: {proc.stderr[-200:]}")
    return {"cert": cert, "key": key}


def _tls_server(tls_certs, **opt_kw):
    srv = Server(
        ServerOptions(
            ssl_options=ServerSSLOptions(
                default_cert=CertInfo(
                    certificate=tls_certs["cert"], private_key=tls_certs["key"]
                ),
                **opt_kw,
            )
        )
    )
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    return srv


def _tls_channel(port, tls_certs, protocol="tpu_std", **ssl_kw):
    ch = Channel(
        ChannelOptions(
            protocol=protocol,
            timeout_ms=5000,
            ssl_options=ChannelSSLOptions(ca_file=tls_certs["cert"], **ssl_kw),
        )
    )
    assert ch.init(f"127.0.0.1:{port}") == 0
    return ch


def test_tls_echo_rpc(tls_certs):
    """tpu_std echo over TLS with server-cert verification, sync+async."""
    srv = _tls_server(tls_certs)
    try:
        ch = _tls_channel(srv.port, tls_certs)
        stub = echo_stub(ch)
        for i in range(5):
            c = Controller()
            r = stub.Echo(c, EchoRequest(message=f"tls-{i}", code=i))
            assert not c.failed(), c.error_text()
            assert r.message == f"tls-{i}" and r.code == i
        ev = threading.Event()
        c = Controller()
        r = stub.Echo(c, EchoRequest(message="tls-async"), done=ev.set)
        assert ev.wait(5) and not c.failed(), c.error_text()
        assert r.message == "tls-async"
        ch.close()
    finally:
        srv.stop()


def test_tls_attachment_roundtrip(tls_certs):
    """Large attachment (multi-TLS-record) over the encrypted link."""
    srv = _tls_server(tls_certs)
    try:
        ch = _tls_channel(srv.port, tls_certs)
        stub = echo_stub(ch)
        c = Controller()
        blob = os.urandom(300_000)
        c.request_attachment.append(blob)
        r = stub.Echo(c, EchoRequest(message="big"))
        assert not c.failed(), c.error_text()
        assert c.response_attachment.to_bytes() == blob
        ch.close()
    finally:
        srv.stop()


def test_tls_https_builtin_page(tls_certs):
    """The builtin pages answer over https on the main port (protocol
    sniffing runs beneath TLS, so http+tpu_std share the TLS port just
    like the plaintext port)."""
    srv = _tls_server(tls_certs)
    try:
        ctx = ssl.create_default_context(cafile=tls_certs["cert"])
        ctx.check_hostname = False
        body = (
            urllib.request.urlopen(
                f"https://127.0.0.1:{srv.port}/health", timeout=5, context=ctx
            )
            .read()
            .decode()
        )
        assert "OK" in body or "ok" in body, body
    finally:
        srv.stop()


def test_tls_rejects_plaintext_client(tls_certs):
    """A plaintext channel against the TLS port must fail, not hang or
    get garbage through."""
    srv = _tls_server(tls_certs)
    try:
        ch = Channel(ChannelOptions(timeout_ms=1000))
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        stub = echo_stub(ch)
        c = Controller()
        stub.Echo(c, EchoRequest(message="plain"))
        assert c.failed()
        assert c.error_code in (
            errors.ERPCTIMEDOUT,
            errors.EFAILEDSOCKET,
        ), c.error_text()
        ch.close()
    finally:
        srv.stop()


def test_tls_hostname_verification_failure(tls_certs):
    """verify_hostname with a non-matching SNI name must fail the
    handshake (EFAILEDSOCKET), proving verification is real."""
    srv = _tls_server(tls_certs)
    try:
        ch = _tls_channel(
            srv.port, tls_certs, sni_name="wrong.example", verify_hostname=True
        )
        stub = echo_stub(ch)
        c = Controller()
        stub.Echo(c, EchoRequest(message="x"))
        assert c.failed()
        assert c.error_code == errors.EFAILEDSOCKET, c.error_text()
        ch.close()
        # and the matching name succeeds
        ch2 = _tls_channel(
            srv.port, tls_certs, sni_name="localhost", verify_hostname=True
        )
        c2 = Controller()
        r2 = echo_stub(ch2).Echo(c2, EchoRequest(message="named"))
        assert not c2.failed(), c2.error_text()
        assert r2.message == "named"
        ch2.close()
    finally:
        srv.stop()


def test_tls_mutual_auth(tls_certs):
    """Server requiring client certs: a bare client fails the handshake,
    one presenting the cert passes (reference verify_client_certificate)."""
    srv = _tls_server(tls_certs, verify_client_ca_file=tls_certs["cert"])
    try:
        ch = _tls_channel(srv.port, tls_certs)  # no client cert
        c = Controller()
        echo_stub(ch).Echo(c, EchoRequest(message="x"))
        assert c.failed(), "handshake without client cert must fail"
        ch.close()
        ch2 = _tls_channel(
            srv.port,
            tls_certs,
            client_cert=CertInfo(
                certificate=tls_certs["cert"], private_key=tls_certs["key"]
            ),
        )
        c2 = Controller()
        r2 = echo_stub(ch2).Echo(c2, EchoRequest(message="mutual"))
        assert not c2.failed(), c2.error_text()
        assert r2.message == "mutual"
        ch2.close()
    finally:
        srv.stop()


_TLS_DCN_SERVER = r"""
import json, os, sys
sys.path.insert(0, os.environ["REPO_ROOT"])
from incubator_brpc_tpu_torch.parallel.dcn import listen_dcn
from incubator_brpc_tpu_torch.models.echo import EchoService
from incubator_brpc_tpu_torch.server.server import Server
from incubator_brpc_tpu_torch.transport.ssl_helper import (
    CertInfo, ServerSSLOptions, make_server_context,
)

srv = Server()
srv.add_service(EchoService())
assert srv.start_ici(0, 9) == 0
ctx = make_server_context(ServerSSLOptions(default_cert=CertInfo(
    certificate=os.environ["TLS_CERT"], private_key=os.environ["TLS_KEY"])))
port = listen_dcn(0, host="127.0.0.1", ssl_context=ctx)
print(json.dumps({"dcn_port": port}), flush=True)
sys.stdin.read()
"""


def test_ssl_config_not_shared_across_channels(tls_certs):
    """Channels with different TLS configs must not share a SocketMap
    entry: the full ssl_options hashes into the channel signature
    (review finding: on/off marker alone let an unverified connection
    serve a verifying channel)."""
    a = Channel(ChannelOptions(ssl_options=ChannelSSLOptions()))
    b = Channel(
        ChannelOptions(
            ssl_options=ChannelSSLOptions(
                ca_file=tls_certs["cert"], verify_hostname=True,
                sni_name="localhost",
            )
        )
    )
    plain = Channel(ChannelOptions())
    assert a._signature() != b._signature()
    assert a._signature() != plain._signature()


def test_alpns_comma_string_form(tls_certs):
    """The reference's comma-list alpns string must not be exploded
    per-character (review finding): prove it with a REAL handshake —
    a client offering only "h2" must see "h2" negotiated, which a
    per-character explosion ('h','2',',',...) cannot produce."""
    import socket

    from incubator_brpc_tpu_torch.models.echo import EchoService
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    srv = Server(
        ServerOptions(
            ssl_options=ServerSSLOptions(
                default_cert=CertInfo(
                    certificate=tls_certs["cert"],
                    private_key=tls_certs["key"],
                ),
                alpns="h2, http/1.1",
            )
        )
    )
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    try:
        ctx = ssl.create_default_context(cafile=tls_certs["cert"])
        ctx.set_alpn_protocols(["h2"])
        with socket.create_connection(("127.0.0.1", srv.port), timeout=5) as raw:
            with ctx.wrap_socket(raw, server_hostname="localhost") as tls:
                assert tls.selected_alpn_protocol() == "h2"
    finally:
        srv.stop()
