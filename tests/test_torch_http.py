"""The port's HTTP front held against the JAX package's, on the CPU.

The wire cases are tests/test_http_builtin.py:63-110 (a request parsed
whole and in pieces, a non-HTTP head) and the request and response
builders: both packages' ``http.parse``, ``build_request`` and
``build_response`` get the same bytes and must give equal fields and
equal bytes.  ``json2pb`` must give equal JSON and equal messages.  The
port's own server then answers a restful JSON call and a
``Channel(protocol="http")`` call, and the remote naming services of
tests/test_naming_remote.py resolve the same nodes in both packages
from a port server's pages.

One fault of the JAX package is fixed in the port: a progressive (SSE)
response finished its RPC at the headers and handed its pooled
connection back while the body still streamed on it, so the next call
wrote into a connection the server closes (``Connection: close``).
The port's body closes the connection at its end
(``test_concurrent_sse_calls_on_one_channel_all_finish``).
"""

import json
import socket
import threading
import time

import pytest
import torch

from incubator_brpc_tpu.protocols import http as j_http
from incubator_brpc_tpu.protos import echo_pb2 as j_echo
from incubator_brpc_tpu.protos import json_test_pb2 as j_json_test
from incubator_brpc_tpu.protos import rpc_meta_pb2 as j_meta
from incubator_brpc_tpu.protos import trackme_pb2 as j_trackme
from incubator_brpc_tpu.serialization import json2pb as j_json2pb
from incubator_brpc_tpu.utils.iobuf import IOBuf as JIOBuf
from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.protocols import ParseError
from incubator_brpc_tpu_torch.protocols import http as p_http
from incubator_brpc_tpu_torch.protos import echo_pb2 as p_echo
from incubator_brpc_tpu_torch.protos import json_test_pb2 as p_json_test
from incubator_brpc_tpu_torch.protos import rpc_meta_pb2 as p_meta
from incubator_brpc_tpu_torch.protos import trackme_pb2 as p_trackme
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.serialization import json2pb as p_json2pb
from incubator_brpc_tpu_torch.server.server import Server
from incubator_brpc_tpu_torch.streaming.generate import (
    DecodeLoop,
    GenerateService,
    generate_stub,
)
from incubator_brpc_tpu_torch.utils.iobuf import IOBuf

CPU = torch.device("cpu")


class _ServerSock:
    is_server_side = True


# ---------------------------------------------------------------------------
# the wire: parse and the builders, byte for byte
# ---------------------------------------------------------------------------

REQUESTS = [
    b"POST /EchoService/Echo?x=1 HTTP/1.1\r\n"
    b"Content-Type: application/json\r\nContent-Length: 16\r\n\r\n"
    b'{"message": "m"}',
    b"GET /vars HTTP/1.1\r\nHost: x\r\n\r\n",
    b"GET /flags?flag=a&setvalue=2.5 HTTP/1.1\r\nHost: x\r\nX-Trace-Id: 00ab\r\n\r\n",
    b"POST /rpc_dump HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n"
    b"4\r\n{\"di\r\n9\r\nr\": \"d\"}\n\r\n0\r\n\r\n",
    b"HTTP/1.1 404 Not Found\r\nContent-Length: 3\r\n\r\nnop",
]


def _fields(pkg_http, iobuf_cls, raw, cut=None):
    """Parse raw (first its first ``cut`` bytes, then the rest) and
    return everything the parser decided."""
    buf = iobuf_cls(raw[:cut] if cut else raw)
    out = []
    if cut:
        r = pkg_http.parse(buf, _ServerSock(), False)
        out.append(r.error.name)
        buf.append(raw[cut:])
    r = pkg_http.parse(buf, _ServerSock(), False)
    out.append(r.error.name)
    m = r.message
    if m is not None:
        out += [m.is_request, m.method, m.path, m.query, m.version, m.status,
                dict(m.headers), m.body.to_bytes()]
    out.append(len(buf))
    return out


@pytest.mark.parametrize("cut", [None, 10, 25])
@pytest.mark.parametrize("raw", REQUESTS, ids=range(len(REQUESTS)))
def test_parse_gives_the_jax_packages_fields(raw, cut):
    port = _fields(p_http, IOBuf, raw, cut)
    assert port == _fields(j_http, JIOBuf, raw, cut)
    assert port[-1] == 0  # every byte consumed


def test_non_http_heads_try_the_other_protocols():
    for head in (b"TRPC\x00\x00\x00\x01", b"\x00\x01\x02\x03PRPC"):
        j = j_http.parse(JIOBuf(head), _ServerSock(), False).error
        p = p_http.parse(IOBuf(head), _ServerSock(), False).error
        assert p.name == j.name == ParseError.TRY_OTHERS.name


BUILDS = [
    ("POST", "/EchoService/Echo", b'{"message": "m"}', "application/json", "h:1", None),
    ("GET", "/status", b"", "text/plain", "", {"x-trace-id": "1f"}),
    ("POST", "/GenerateService/GenerateSSE", b"{}", "application/json", "", {"A": "b"}),
]


@pytest.mark.parametrize("case", BUILDS, ids=range(len(BUILDS)))
def test_build_request_bytes_equal(case):
    assert p_http.build_request(*case).to_bytes() == j_http.build_request(*case).to_bytes()


@pytest.mark.parametrize("status,body,ctype,headers", [
    (200, "OK", "text/plain", None),
    (404, b"no such page", "text/plain", {"Connection": "close"}),
    (500, "device capture failed", "text/plain", None),
    (200, json.dumps({"a": [1, 2]}), "application/json", {"x-span-id": "2"}),
])
def test_build_response_bytes_equal(status, body, ctype, headers):
    j = j_http.build_response(status, body, ctype, headers).to_bytes()
    assert p_http.build_response(status, body, ctype, headers).to_bytes() == j


# ---------------------------------------------------------------------------
# json2pb
# ---------------------------------------------------------------------------


def _messages(echo, meta, trackme):
    rm = meta.RpcMeta(correlation_id=7, attachment_size=16)
    rm.request.service_name, rm.request.method_name = "PsService", "Forward"
    rm.request.log_id = 1 << 40
    return [
        echo.EchoRequest(message="via-http", code=5),
        echo.EchoResponse(message="éé unicode", code=-3),
        rm,
        trackme.TrackMeResponse(severity=trackme.TrackMeWarning, error_text="w",
                                new_interval=45),
        trackme.TrackMeRequest(rpc_version=3, server_addr="10.0.0.7:8000"),
    ]


@pytest.mark.parametrize("i", range(5))
@pytest.mark.parametrize("pretty", [False, True])
def test_json2pb_gives_the_jax_packages_json_and_messages(i, pretty):
    jm = _messages(j_echo, j_meta, j_trackme)[i]
    pm = _messages(p_echo, p_meta, p_trackme)[i]
    text = p_json2pb.proto_to_json(pm, pretty)
    assert text == j_json2pb.proto_to_json(jm, pretty)
    back_p, back_j = type(pm)(), type(jm)()
    assert p_json2pb.json_to_proto(text, back_p) == j_json2pb.json_to_proto(text, back_j)
    assert back_p.SerializeToString() == back_j.SerializeToString() == pm.SerializeToString()


@pytest.mark.parametrize("doc", ['{"message": 5}', '{"nope": 1}', "not json", '{"code": "x"}'])
def test_json2pb_refuses_what_the_jax_package_refuses(doc):
    pj, jj = p_echo.EchoRequest(), j_echo.EchoRequest()
    assert p_json2pb.json_to_proto(doc, pj) == j_json2pb.json_to_proto(doc, jj)


def _json_probes(pb):
    """The json2pb test proto (``protos/json_test_pb2``): every scalar
    kind, an enum, a sub-message, repeated and map fields, an optional,
    and the single-repeated-field ``OnlyList``."""
    m = pb.JsonProbe(i32=-5, i64=1 << 40, d=2.5, flag=True, text="héllo",
                     blob=b"\x00\x01\xfe", color=pb.Color.BLUE, nums=[1, 2, 3])
    m.sub.name, m.sub.value = "n", 7
    m.subs.add(name="a", value=1)
    m.counts["x"] = 9
    m.items[3].name = "three"
    return [m, pb.JsonProbe(), pb.JsonProbe(opt_i32=0, color=pb.Color.GREEN, d=float("inf")),
            pb.OnlyList(names=["a"]), pb.OnlyList(names=["a", "b"]), pb.OnlyList()]


# (Pb2JsonOptions, Json2PbOptions) fields, each pair one reader's settings
JSON_OPTIONS = [
    ({}, {}),
    ({"pretty_json": True, "enum_option": p_json2pb.OUTPUT_ENUM_BY_NUMBER}, {}),
    ({"bytes_to_base64": False, "always_print_primitive_fields": True}, {"base64_to_bytes": False}),
    ({"single_repeated_to_array": True, "jsonify_empty_array": True}, {"array_to_single_repeated": True}),
    ({"enable_protobuf_map": False}, {"allow_unknown_fields": False}),
]


@pytest.mark.parametrize("opts", range(len(JSON_OPTIONS)))
@pytest.mark.parametrize("i", range(6))
def test_json2pb_options_give_the_jax_packages_json_on_the_test_proto(i, opts):
    """JsonProbe, Color and OnlyList through both packages' json2pb under
    each option set: the same JSON text, the same parse verdict, error
    and offset, and the same message back."""
    pb_opts, json_opts = JSON_OPTIONS[opts]
    pm, jm = _json_probes(p_json_test)[i], _json_probes(j_json_test)[i]
    p_out = p_json2pb.proto_to_json_with_options(pm, p_json2pb.Pb2JsonOptions(**pb_opts))
    j_out = j_json2pb.proto_to_json_with_options(jm, j_json2pb.Pb2JsonOptions(**pb_opts))
    assert p_out == j_out
    text = p_out[0]
    assert text is not None, p_out
    back_p, back_j = type(pm)(), type(jm)()
    p_res = p_json2pb.json_to_proto_with_options(text, back_p, p_json2pb.Json2PbOptions(**json_opts))
    j_res = j_json2pb.json_to_proto_with_options(text, back_j, j_json2pb.Json2PbOptions(**json_opts))
    assert p_res == j_res
    assert back_p.SerializeToString() == back_j.SerializeToString()


# ---------------------------------------------------------------------------
# restful calls and the http channel on a port server
# ---------------------------------------------------------------------------


@pytest.fixture
def server():
    srv = Server()
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    yield srv
    srv.stop()


def raw_http(port, request: bytes) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        s.sendall(request)
        s.settimeout(5)
        data = b""
        while True:
            head, _, body = data.partition(b"\r\n\r\n")
            if _:
                lens = [int(ln.split(b":")[1]) for ln in head.split(b"\r\n")
                        if ln.lower().startswith(b"content-length:")]
                if lens and len(body) >= lens[0]:
                    return data
            chunk = s.recv(65536)
            if not chunk:
                return data
            data += chunk


def test_restful_json_call(server):
    body = raw_http(server.port,
                    b"POST /EchoService/Echo HTTP/1.1\r\nContent-Type: application/json\r\n"
                    b'Content-Length: 24\r\n\r\n{"message": "via-http"}\n')
    assert b"200 OK" in body.split(b"\r\n")[0]
    assert json.loads(body.partition(b"\r\n\r\n")[2])["message"] == "via-http"


def test_restful_unknown_method_404(server):
    body = raw_http(server.port, b"GET /NoService/NoMethod HTTP/1.1\r\nHost: x\r\n\r\n")
    assert b"404" in body.split(b"\r\n")[0]


def test_http_client_channel(server):
    ch = Channel(ChannelOptions(protocol="http", timeout_ms=3000))
    assert ch.init(f"127.0.0.1:{server.port}") == 0
    c = Controller()
    r = echo_stub(ch).Echo(c, EchoRequest(message="http-client", code=5))
    assert not c.failed(), c.error_text()
    assert r.message == "http-client" and r.code == 5
    ch.close()


def test_global_init_registers_http_and_the_balancers():
    """global_init imports what the port has carried over without a
    guard: the http protocol resolves, and so do the load balancers and
    the remote naming services, whatever else was imported first."""
    from incubator_brpc_tpu_torch.client import load_balancer
    from incubator_brpc_tpu_torch.client.naming_service import find_naming_service
    from incubator_brpc_tpu_torch.global_init import global_init
    from incubator_brpc_tpu_torch.protocols import find_protocol

    global_init()
    assert find_protocol("http") is p_http.PROTOCOL
    for name in ("rr", "random", "wrr", "wr", "la", "c_murmurhash", "mesh_locality"):
        assert load_balancer.create_load_balancer(name) is not None, name
    for scheme in ("remotefile", "consul", "discovery", "nacos", "http", "https", "list"):
        assert find_naming_service(f"{scheme}://x") is not None, scheme


def test_concurrent_sse_calls_on_one_channel_all_finish():
    """Sessions one after another, then eight at once, on one http
    Channel (pooled connections): every stream ends with [DONE].  In the
    JAX package a connection handed back at the headers fails a later
    call ("remote closed connection") or loses its end."""
    gen = GenerateService(DecodeLoop(dim=8, device=CPU))
    srv = Server()
    srv.add_service(gen)
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(protocol="http", timeout_ms=20000))
    assert ch.init(f"127.0.0.1:{srv.port}") == 0
    got = {}

    def one(i):
        c = Controller()
        c.response_will_be_read_progressively()
        generate_stub(ch).GenerateSSE(c, EchoRequest(message=f"p{i}", code=6))
        parts, end = [], threading.Event()
        if not c.failed():
            c.read_progressive_attachment(
                lambda part: end.set() if part is None else parts.append(part))
        got[i] = (c.error_text(), end.wait(20), b"".join(parts).decode())

    try:
        for i in range(4):
            one(i)
        for _ in range(3):
            ts = [threading.Thread(target=one, args=(i,)) for i in range(8)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(30)
            assert not any(t.is_alive() for t in ts)
            for i in range(8):
                err, ended, body = got[i]
                assert err == "" and ended, (i, err)
                events = [ln[6:] for ln in body.split("\n") if ln.startswith("data: ")]
                assert len(events) == 7 and events[-1] == "[DONE]", events
        assert gen.sse_rows == 4 + 3 * 8
    finally:
        ch.close()
        srv.stop()
        gen.close()


# ---------------------------------------------------------------------------
# remote naming services (tests/test_naming_remote.py) against a port server
# ---------------------------------------------------------------------------

CONSUL = json.dumps([
    {"Node": {"Address": "10.1.1.1"},
     "Service": {"Address": "10.1.1.1", "Port": 9000, "Tags": ["1/2"],
                 "Weights": {"Passing": 5}}},
    {"Node": {"Address": "10.1.1.2"}, "Service": {"Address": "", "Port": 9001}},
])
DISCOVERY = json.dumps({"code": 0, "data": {"my.app": {"instances": [
    {"addrs": ["grpc://10.2.2.1:9000", "http://10.2.2.1:8080"]},
    {"addrs": ["grpc://10.2.2.2:9000"]}]}}})
NACOS = json.dumps({"hosts": [
    {"ip": "10.3.3.1", "port": 7000, "weight": 2.0, "healthy": True},
    {"ip": "10.3.3.2", "port": 7001, "healthy": False},
    {"ip": "10.3.3.3", "port": 7002, "enabled": False}]})
NAMING = [
    ("RemoteFileNamingService", "/cluster.txt", "10.0.0.1:8000 3\n# c\n10.0.0.2:8001\n",
     "/cluster.txt", 2),
    ("ConsulNamingService", "/v1/health/service/websvc", CONSUL, "/websvc", 2),
    ("DiscoveryNamingService", "/discovery/fetch", DISCOVERY, "/my.app", 3),
    ("NacosNamingService", "/nacos/v1/ns/instance/list", NACOS, "/svc", 1),
]


@pytest.mark.parametrize("cls,page,payload,path,n", NAMING, ids=[c[0] for c in NAMING])
def test_remote_naming_resolves_as_the_jax_package(server, cls, page, payload, path, n):
    from incubator_brpc_tpu.client import naming_remote as j_nr
    from incubator_brpc_tpu_torch.client import naming_remote as p_nr

    server.add_builtin_handler(page, lambda srv, msg: (200, payload, "text/plain"))
    url = f"127.0.0.1:{server.port}{path}"

    def nodes(mod):
        return [(nd.endpoint.host, nd.endpoint.port, nd.weight, nd.tag)
                for nd in getattr(mod, cls)().get_servers(url)]

    assert nodes(p_nr) == nodes(j_nr)
    assert len(nodes(p_nr)) == n


def test_channel_init_via_remotefile(server):
    real = Server()
    real.add_service(EchoService())
    assert real.start(0) == 0
    try:
        server.add_builtin_handler(
            "/live.txt", lambda srv, msg: (200, f"127.0.0.1:{real.port}\n", "text/plain"))
        ch = Channel(ChannelOptions(timeout_ms=5000))
        assert ch.init(f"remotefile://127.0.0.1:{server.port}/live.txt", "rr") == 0
        deadline = time.monotonic() + 5  # the naming service resolves on its own thread
        while True:
            c = Controller()
            r = echo_stub(ch).Echo(c, EchoRequest(message="via-remotefile"))
            if not c.failed() or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        assert not c.failed(), c.error_text()
        assert r.message == "via-remotefile"
        ch.close()
    finally:
        real.stop()
