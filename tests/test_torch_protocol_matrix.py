"""The port's cross-protocol conformance matrix, against the JAX
package's (``tests/test_protocol_matrix.py``, mirrored case for case),
and the JAX package as the oracle on the wire: the same request with the
same correlation id packs to the same bytes through both packages, and a
port client against a JAX server (and the reverse) gets the reply the
same-package pair gets, for every protocol of the matrix plus thrift and
mongo.  Both packages keep their own protocol registries; each server
starts on port 0 and stops at the end of its module.
"""

import threading

import pytest

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

# every pb-RPC-capable protocol the framework registers (thrift/mongo/
# redis/memcache/rtmp have their own non-pb surfaces, tested elsewhere)
PROTOCOLS = [
    "tpu_std",
    "http",
    "h2",
    "hulu_pbrpc",
    "sofa_pbrpc",
    "nova_pbrpc",
    "public_pbrpc",
    "ubrpc",
    "nshead_mcpack",
]


@pytest.fixture(scope="module")
def matrix_server():
    srv = Server(ServerOptions(nova_service=EchoService()))
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def mcpack_server():
    """A configured NsheadService owns ALL of a server's nshead traffic
    (one adaptor per server, same constraint as the reference), so the
    ubrpc and nshead_mcpack adaptors each get their own server."""
    from incubator_brpc_tpu_torch.protocols.legacy import (
        NsheadMcpackAdaptor,
        UbrpcAdaptor,
    )

    mc = Server(ServerOptions(nshead_service=NsheadMcpackAdaptor()))
    mc.add_service(EchoService())
    assert mc.start(0) == 0
    ub = Server(ServerOptions(nshead_service=UbrpcAdaptor()))
    ub.add_service(EchoService())
    assert ub.start(0) == 0
    yield {"nshead_mcpack": mc, "ubrpc": ub}
    mc.stop()
    ub.stop()


def _server_for(proto, matrix_server, mcpack_server):
    return mcpack_server.get(proto, matrix_server)


@pytest.mark.parametrize("proto", PROTOCOLS)
def test_sync_echo(proto, matrix_server, mcpack_server):
    srv = _server_for(proto, matrix_server, mcpack_server)
    ch = Channel(ChannelOptions(protocol=proto, timeout_ms=5000))
    assert ch.init(f"127.0.0.1:{srv.port}") == 0
    stub = echo_stub(ch)
    c = Controller()
    r = stub.Echo(c, EchoRequest(message=f"sync-{proto}"))
    assert not c.failed(), (proto, c.error_text())
    assert r.message == f"sync-{proto}"
    assert c.latency_us > 0
    ch.close()


@pytest.mark.parametrize("proto", PROTOCOLS)
def test_async_echo(proto, matrix_server, mcpack_server):
    srv = _server_for(proto, matrix_server, mcpack_server)
    ch = Channel(ChannelOptions(protocol=proto, timeout_ms=5000))
    assert ch.init(f"127.0.0.1:{srv.port}") == 0
    stub = echo_stub(ch)
    evs = []
    for i in range(4):
        ev = threading.Event()
        c = Controller()
        r = stub.Echo(c, EchoRequest(message=f"async-{proto}-{i}"), done=ev.set)
        evs.append((ev, c, r, f"async-{proto}-{i}"))
    for ev, c, r, want in evs:
        assert ev.wait(8), (proto, "done never ran")
        assert not c.failed(), (proto, c.error_text())
        assert r.message == want
    ch.close()


@pytest.mark.parametrize("proto", PROTOCOLS)
def test_timeout(proto, matrix_server, mcpack_server):
    srv = _server_for(proto, matrix_server, mcpack_server)
    ch = Channel(ChannelOptions(protocol=proto, timeout_ms=5000, max_retry=0))
    assert ch.init(f"127.0.0.1:{srv.port}") == 0
    stub = echo_stub(ch)
    c = Controller()
    c.timeout_ms = 150
    stub.Echo(c, EchoRequest(message="slow", sleep_us=900_000))
    assert c.failed(), proto
    assert c.error_code == errors.ERPCTIMEDOUT, (proto, c.error_code)
    ch.close()


# ubrpc/nshead_mcpack adaptors run the handler through _run_method whose
# error path is the mcpack envelope / empty reply — covered in
# test_legacy_protocols; server_fail here exercises the pb-native paths.
@pytest.mark.parametrize(
    "proto",
    ["tpu_std", "http", "h2", "hulu_pbrpc", "sofa_pbrpc", "public_pbrpc"],
)
def test_server_fail_propagates(proto, matrix_server, mcpack_server):
    srv = _server_for(proto, matrix_server, mcpack_server)
    ch = Channel(ChannelOptions(protocol=proto, timeout_ms=5000, max_retry=0))
    assert ch.init(f"127.0.0.1:{srv.port}") == 0
    stub = echo_stub(ch)
    c = Controller()
    stub.Echo(c, EchoRequest(message="x", server_fail=errors.EINTERNAL))
    assert c.failed(), proto
    ch.close()


@pytest.mark.parametrize("proto", ["public_pbrpc", "nova_pbrpc", "nshead_mcpack", "thrift"])
def test_late_response_never_binds_to_new_rpc(proto, matrix_server, mcpack_server):
    """A response arriving AFTER its RPC timed out must not complete a
    newer RPC that recycled the same call-id slot (regression: the
    32-bit wire correlation forms now fold the slot generation in)."""
    import time

    if proto == "thrift":
        from incubator_brpc_tpu_torch.protocols.thrift import (
            T_STRING,
            ThriftService,
            ThriftStub,
        )

        svc = ThriftService()

        def slow_echo(ctrl, fields, done):
            import time as _t

            _t.sleep(fields.get(2, (0, 0))[1] / 1e6)
            done({0: (T_STRING, fields.get(1, (T_STRING, b""))[1])})

        svc.add_method("Echo", slow_echo)
        srv = Server(ServerOptions(thrift_service=svc))
        srv.add_service(EchoService())
        assert srv.start(0) == 0
        try:
            ch = Channel(ChannelOptions(protocol="thrift", timeout_ms=5000,
                                        max_retry=0))
            assert ch.init(f"127.0.0.1:{srv.port}") == 0
            stub = ThriftStub(ch)
            from incubator_brpc_tpu_torch.protocols.thrift import T_I64

            c = Controller()
            c.timeout_ms = 150
            stub.call(c, "Echo", {1: (T_STRING, b"slow"), 2: (T_I64, 900_000)})
            assert c.failed() and c.error_code == errors.ERPCTIMEDOUT
            c2 = Controller()
            out = stub.call(c2, "Echo", {1: (T_STRING, b"fresh")})
            assert not c2.failed(), c2.error_text()
            assert out[0][1] == b"fresh", "late response bound to new RPC"
        finally:
            srv.stop()
            ch.close()
        return
    srv = _server_for(proto, matrix_server, mcpack_server)
    ch = Channel(ChannelOptions(protocol=proto, timeout_ms=5000, max_retry=0))
    assert ch.init(f"127.0.0.1:{srv.port}") == 0
    stub = echo_stub(ch)
    c = Controller()
    c.timeout_ms = 150
    stub.Echo(c, EchoRequest(message="slow", sleep_us=900_000))
    assert c.failed() and c.error_code == errors.ERPCTIMEDOUT, proto
    c2 = Controller()
    r2 = stub.Echo(c2, EchoRequest(message="fresh"))
    assert not c2.failed(), (proto, c2.error_text())
    assert r2.message == "fresh", (proto, "late response bound to new RPC")
    # and the connection still works after the late reply drains
    time.sleep(1.0)
    c3 = Controller()
    r3 = stub.Echo(c3, EchoRequest(message="again"))
    assert not c3.failed() and r3.message == "again"
    ch.close()


# ---------------------------------------------------------------------------
# the JAX package as the oracle: wire bytes and cross-package interop
# ---------------------------------------------------------------------------
import importlib  # noqa: E402

import numpy as np  # noqa: E402

PKGS = ("incubator_brpc_tpu_torch", "incubator_brpc_tpu")
# the 8 pb protocols of the legacy family, then thrift and mongo (h2's
# request bytes are held in tests/test_torch_h2.py, through h2.issue)
WIRE_PROTOCOLS = ["hulu_pbrpc", "sofa_pbrpc", "nshead", "nova_pbrpc", "public_pbrpc",
                  "ubrpc", "nshead_mcpack", "esp", "thrift", "mongo"]
# a 64-bit call id: the 32-bit wire forms fold its slot generation in
WIRE_CID = (0x3A5 << 32) | 0x1234


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _seeded_request(pkg, seed):
    rng = np.random.RandomState(seed)
    text = "".join(chr(c) for c in rng.randint(0x20, 0x7F, size=int(rng.randint(1, 300))))
    return _mod(pkg, "protos.echo_pb2").EchoRequest(message=text, code=int(rng.randint(0, 1 << 30)))


def _packed(pkg, proto, seed):
    """One request packed for the wire by one package, as its channel
    packs it: serialize once, then pack with the call id."""
    _mod(pkg, "global_init").global_init()
    ctl = _mod(pkg, "client.controller").Controller()
    ctl.log_id = 4242
    ctl.timeout_ms = 900
    if proto == "mongo":
        mongo = _mod(pkg, "protocols.mongo")
        doc = {"echo": {"s": _seeded_request(pkg, seed).message, "n": seed, "f": 0.5}, "$db": "admin"}
        return (mongo.pack_op_msg(7, doc, request_id=WIRE_CID & 0x7FFFFFFF)
                + mongo.pack_op_reply(9, [doc, {"ok": 1.0}], request_id=3))
    if proto == "thrift":
        th = _mod(pkg, "protocols.thrift")
        req = _seeded_request(pkg, seed)
        request = {1: (th.T_STRING, req.message.encode()), 2: (th.T_I64, req.code),
                   3: (th.T_STRUCT, {1: (th.T_I32, seed)})}
    elif proto == "esp":
        legacy = _mod(pkg, "protocols.legacy")
        request = legacy.EspMessage(to=9, msg=1, body=_seeded_request(pkg, seed).SerializeToString())
    else:
        request = _seeded_request(pkg, seed)
    spec = _mod(pkg, "server.service").MethodSpec(
        "EchoService", "Echo", type(_seeded_request(pkg, 0)),
        _mod(pkg, "protos.echo_pb2").EchoResponse)
    p = _mod(pkg, "protocols").find_protocol(proto)
    buf = p.serialize_request(request, ctl)
    return p.pack_request(buf, WIRE_CID, spec, ctl).to_bytes()


@pytest.mark.parametrize("proto", WIRE_PROTOCOLS)
def test_request_wire_bytes_equal_the_jax_packages(proto):
    for seed in range(4):
        port, ref = (_packed(pkg, proto, seed) for pkg in PKGS)
        assert port == ref, (proto, seed)
        assert len(port) > 16


def _thrift_service(pkg):
    th = _mod(pkg, "protocols.thrift")
    svc = th.ThriftService()

    def echo(ctrl, fields, done):
        msg = fields.get(1, (th.T_STRING, b""))[1]
        done({0: (th.T_STRUCT, {1: (th.T_STRING, msg), 2: (th.T_I32, len(msg))})})

    svc.add_method("Echo", echo)
    return svc


def _mongo_adaptor(pkg):
    mongo = _mod(pkg, "protocols.mongo")

    class Adaptor(mongo.MongoServiceAdaptor):
        def handle(self, controller, doc):
            if "echo" in doc:
                return {"ok": 1.0, "you_sent": doc["echo"]}
            return {"ok": 0.0, "errmsg": "unknown command", "code": 59}

    return Adaptor()


@pytest.fixture(scope="module")
def pkg_servers():
    """Per package: one server with nova, thrift and mongo beside
    tpu_std, and one each for the mcpack and ubrpc nshead adaptors."""
    made = {}
    try:
        for pkg in PKGS:
            srv_mod = _mod(pkg, "server.server")
            echo = _mod(pkg, "models.echo").EchoService
            legacy = _mod(pkg, "protocols.legacy")
            opts = [
                ("main", srv_mod.ServerOptions(nova_service=echo(), thrift_service=_thrift_service(pkg),
                                               mongo_service_adaptor=_mongo_adaptor(pkg))),
                ("nshead_mcpack", srv_mod.ServerOptions(nshead_service=legacy.NsheadMcpackAdaptor())),
                ("ubrpc", srv_mod.ServerOptions(nshead_service=legacy.UbrpcAdaptor())),
            ]
            made[pkg] = {}
            for key, opt in opts:
                srv = srv_mod.Server(opt)
                srv.add_service(echo())
                assert srv.start(0) == 0
                made[pkg][key] = srv
        yield made
    finally:
        for servers in made.values():
            for srv in servers.values():
                srv.stop()


def _replies(client, server, proto, servers):
    """Echo replies of `client`'s channel of `proto` against `server`'s
    servers, as bytes: seeded requests, sync and async."""
    srv = servers[server].get(proto, servers[server]["main"])
    if proto == "mongo":
        import socket
        import struct

        mongo = _mod(client, "protocols.mongo")
        out = []
        for seed in range(3):
            doc = {"echo": {"s": _seeded_request(client, seed).message, "n": seed}}
            with socket.create_connection(("127.0.0.1", srv.port), timeout=5) as s:
                s.sendall(mongo.pack_op_msg(0, doc, request_id=seed + 1))
                data = b""
                while len(data) < 4 or len(data) < struct.unpack_from("<i", data)[0]:
                    chunk = s.recv(65536)
                    assert chunk, "mongo server closed early"
                    data += chunk
            out.append(data)
        return out
    ch_mod = _mod(client, "client.channel")
    ctl = _mod(client, "client.controller")
    ch = ch_mod.Channel(ch_mod.ChannelOptions(protocol=proto, timeout_ms=5000))
    assert ch.init(f"127.0.0.1:{srv.port}") == 0
    out = []
    try:
        if proto == "thrift":
            th = _mod(client, "protocols.thrift")
            stub = th.ThriftStub(ch)
            for seed in range(3):
                c = ctl.Controller()
                res = stub.call(c, "Echo", {1: (th.T_STRING, _seeded_request(client, seed).message.encode())})
                assert not c.failed(), c.error_text()
                out.append(repr(res))
            return out
        stub = _mod(client, "models.echo").echo_stub(ch)
        for seed in range(3):
            c = ctl.Controller()
            r = stub.Echo(c, _seeded_request(client, seed))
            assert not c.failed(), (proto, client, server, c.error_text())
            out.append(r.SerializeToString())
        evs = []
        for seed in range(3, 6):
            ev, c = threading.Event(), ctl.Controller()
            evs.append((ev, c, stub.Echo(c, _seeded_request(client, seed), done=ev.set)))
        for ev, c, r in evs:
            assert ev.wait(8) and not c.failed(), (proto, c.error_text())
            out.append(r.SerializeToString())
        return out
    finally:
        ch.close()


@pytest.mark.parametrize("direction", ["port->jax", "jax->port"])
@pytest.mark.parametrize("proto", PROTOCOLS + ["thrift", "mongo"])
def test_client_and_server_interoperate_across_packages(proto, direction, pkg_servers):
    """A port client against a JAX server, and a JAX client against a
    port server: the replies equal the same-package pair's, which carry
    the request back."""
    client, server = PKGS if direction == "port->jax" else PKGS[::-1]
    cross = _replies(client, server, proto, pkg_servers)
    same = _replies(server, server, proto, pkg_servers)
    assert cross == same
    if proto not in ("thrift", "mongo"):
        want = [_seeded_request(client, s).message for s in range(6)]
        got = []
        for raw in cross:
            r = _mod(client, "protos.echo_pb2").EchoResponse()
            r.ParseFromString(raw)
            got.append(r.message)
        assert got == want
