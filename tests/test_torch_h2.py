"""The port's HTTP/2 + gRPC + HPACK, against the JAX package's tests of
them (``tests/test_h2_grpc.py``, mirrored case for case), the gRPC cases
of ``tests/test_admission.py`` and ``tests/test_ssl.py``, and the JAX
package's HPACK encoder as the oracle: the port's encoder must emit the
same bytes on RFC 7541 C.3-C.6 and leave the same dynamic table.

Hand-crafted wire bytes through the parser, plus a real client and a
real server over loopback, including the grpcio client where it is
installed.  ``global_init`` registers h2 with no guard, so a
``protocol="h2"`` channel needs no import of the protocol.
"""

import socket as _pysocket
import struct
import threading

import pytest

from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest, EchoResponse
from incubator_brpc_tpu_torch.protocols import h2
from incubator_brpc_tpu_torch.protocols.hpack import (
    HpackDecoder,
    HpackEncoder,
    decode_int,
    encode_int,
    huffman_decode,
    huffman_encode,
)
from incubator_brpc_tpu_torch.server.server import Server
from incubator_brpc_tpu_torch.utils.iobuf import IOBuf


# ---- HPACK conformance (RFC 7541 Appendix C vectors) -----------------------
def test_hpack_integers():
    assert encode_int(10, 5) == bytes([10])
    assert encode_int(1337, 5) == bytes([31, 154, 10])
    assert decode_int(bytes([31, 154, 10]), 0, 5) == (1337, 3)
    assert decode_int(bytes([42]), 0, 8) == (42, 1)


def test_hpack_huffman_roundtrip():
    for s in (b"www.example.com", b"no-cache", b"custom-value", bytes(range(256))):
        assert huffman_decode(huffman_encode(s)) == s


def test_hpack_rfc_c3_requests_plain():
    d = HpackDecoder()
    h1 = d.decode(bytes.fromhex("828684410f7777772e6578616d706c652e636f6d"))
    assert h1 == [
        (":method", "GET"),
        (":scheme", "http"),
        (":path", "/"),
        (":authority", "www.example.com"),
    ]
    h2_ = d.decode(bytes.fromhex("828684be58086e6f2d6361636865"))
    assert h2_[-1] == ("cache-control", "no-cache")
    h3 = d.decode(
        bytes.fromhex("828785bf400a637573746f6d2d6b65790c637573746f6d2d76616c7565")
    )
    assert h3[-1] == ("custom-key", "custom-value")
    assert h3[1] == (":scheme", "https")


def test_hpack_rfc_c4_requests_huffman():
    d = HpackDecoder()
    h1 = d.decode(bytes.fromhex("828684418cf1e3c2e5f23a6ba0ab90f4ff"))
    assert h1[-1] == (":authority", "www.example.com")
    h2_ = d.decode(bytes.fromhex("828684be5886a8eb10649cbf"))
    assert h2_[-1] == ("cache-control", "no-cache")
    h3 = d.decode(bytes.fromhex("828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf"))
    assert h3[-1] == ("custom-key", "custom-value")


def test_hpack_rfc_c6_responses_huffman_evictions():
    d = HpackDecoder(256)
    r1 = d.decode(
        bytes.fromhex(
            "488264025885aec3771a4b6196d07abe941054d444a8200595040b8166e082a62d1bff"
            "6e919d29ad171863c78f0b97c8e9ae82ae43d3"
        )
    )
    assert r1[0] == (":status", "302")
    assert r1[3][0] == "location"
    r2 = d.decode(bytes.fromhex("4883640effc1c0bf"))
    assert r2[0] == (":status", "307")
    r3 = d.decode(
        bytes.fromhex(
            "88c16196d07abe941054d444a8200595040b8166e084a62d1bffc05a839bd9ab77ad94"
            "e7821dd7f2e6c7b335dfdfcd5b3960d5af27087f3672c1ab270fb5291f9587316065c0"
            "03ed4ee5b1063d5007"
        )
    )
    assert r3[0] == (":status", "200")
    assert any(n == "set-cookie" for n, _ in r3)


def test_hpack_encoder_dynamic_indexing():
    e = HpackEncoder()
    d = HpackDecoder()
    hs = [
        (":method", "POST"),
        (":path", "/EchoService/Echo"),
        ("content-type", "application/grpc"),
        ("x-custom", "abc123"),
    ]
    for _ in range(3):
        assert d.decode(e.encode(hs)) == hs
    assert len(e.encode(hs)) <= 6  # fully indexed after warm-up


def test_hpack_sensitive_never_indexed():
    e = HpackEncoder()
    blob = e.encode([("authorization", "secret")], sensitive={"authorization"})
    # §6.2.3 never-indexed literal: first byte has 0x10 pattern
    assert blob[0] & 0xF0 == 0x10
    assert HpackDecoder().decode(blob) == [("authorization", "secret")]


# ---- h2 framing -------------------------------------------------------------
def test_h2_frame_pack_parse_roundtrip():
    class FakeSock:
        is_server_side = False
        h2_ctx = "present"  # parse only needs non-None on the client side

    sock = FakeSock()
    sock.h2_ctx = h2.H2Context(sock, is_server=False)
    buf = IOBuf(h2.pack_frame(h2.PING, h2.FLAG_ACK, 0, b"12345678"))
    res = h2.parse(buf, sock, False)
    frame = res.message
    assert frame.ftype == h2.PING and frame.flags == h2.FLAG_ACK
    assert frame.payload == b"12345678" and frame.sid == 0
    assert buf.empty()


def test_h2_parse_needs_more_bytes():
    class FakeSock:
        is_server_side = True
        h2_ctx = None

    from incubator_brpc_tpu_torch.protocols import ParseError

    # partial preface: not_enough; wrong magic: try_others
    buf = IOBuf(h2.PREFACE[:10])
    assert h2.parse(buf, FakeSock(), False).error == ParseError.NOT_ENOUGH_DATA
    buf = IOBuf(b"TRPC\x00\x00\x00\x00\x00\x00\x00\x00")
    assert h2.parse(buf, FakeSock(), False).error == ParseError.TRY_OTHERS


def test_grpc_timeout_parse():
    assert h2._parse_grpc_timeout("3000m") == 3000
    assert h2._parse_grpc_timeout("5S") == 5000
    assert h2._parse_grpc_timeout("1M") == 60000
    assert h2._parse_grpc_timeout("250000u") == 250
    assert h2._parse_grpc_timeout("") is None
    assert h2._parse_grpc_timeout("xx") is None


# ---- end-to-end: our client against our server ------------------------------
@pytest.fixture
def server():
    srv = Server()
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    yield srv
    srv.stop()


def grpc_channel(port, **kw):
    kw.setdefault("timeout_ms", 5000)
    ch = Channel(ChannelOptions(protocol="grpc", **kw))
    assert ch.init(f"127.0.0.1:{port}") == 0
    return ch


def test_grpc_echo_e2e(server):
    stub = echo_stub(grpc_channel(server.port))
    c = Controller()
    r = stub.Echo(c, EchoRequest(message="grpc-hello", code=7))
    assert not c.failed(), c.error_text()
    assert r.message == "grpc-hello" and r.code == 7


def test_grpc_multiplexed_concurrent_streams(server):
    stub = echo_stub(grpc_channel(server.port))
    n = 24
    results = [None] * n
    def call(i):
        c = Controller()
        r = stub.Echo(c, EchoRequest(message=f"m{i}"))
        results[i] = (c.failed(), getattr(r, "message", None))
    ts = [threading.Thread(target=call, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for i, (failed, msg) in enumerate(results):
        assert not failed and msg == f"m{i}", (i, results[i])


def test_grpc_error_status_mapping(server):
    stub = echo_stub(grpc_channel(server.port))
    c = Controller()
    stub.Echo(c, EchoRequest(message="x", server_fail=1004))  # ELIMIT-ish code
    assert c.failed()
    from incubator_brpc_tpu_torch.server.service import MethodSpec

    ch = grpc_channel(server.port)
    c2 = Controller()
    spec = MethodSpec("EchoService", "NoSuchMethod", EchoRequest, EchoResponse)
    ch.call_method(spec, c2, EchoRequest(message="x"), EchoResponse())
    assert c2.failed()
    from incubator_brpc_tpu_torch import errors as E

    assert c2.error_code == E.ENOMETHOD, c2.error_code  # UNIMPLEMENTED mapped back


def test_grpc_large_payload_flow_control(server):
    # > initial 64KB window: DATA must chunk and continue on WINDOW_UPDATEs
    stub = echo_stub(grpc_channel(server.port, timeout_ms=15000))
    big = "z" * (300 * 1024)
    c = Controller()
    r = stub.Echo(c, EchoRequest(message=big))
    assert not c.failed(), c.error_text()
    assert r.message == big


def test_grpc_same_port_as_tpu_std(server):
    """One port speaks h2 AND tpu_std (the InputMessenger inversion)."""
    grpc_stub = echo_stub(grpc_channel(server.port, connection_group="g1"))
    std = Channel(ChannelOptions(timeout_ms=5000, connection_group="g2"))
    assert std.init(f"127.0.0.1:{server.port}") == 0
    std_stub = echo_stub(std)
    for stub in (grpc_stub, std_stub, grpc_stub):
        c = Controller()
        r = stub.Echo(c, EchoRequest(message="mixed"))
        assert not c.failed(), c.error_text()
        assert r.message == "mixed"


# ---- interop: REAL grpcio client against our server -------------------------
def test_real_grpcio_client_interop(server):
    grpc = pytest.importorskip("grpc")
    channel = grpc.insecure_channel(f"127.0.0.1:{server.port}")
    stub = channel.unary_unary(
        "/EchoService/Echo",
        request_serializer=lambda m: m.SerializeToString(),
        response_deserializer=EchoResponse.FromString,
    )
    resp = stub(EchoRequest(message="from-real-grpc", code=3), timeout=10)
    assert resp.message == "from-real-grpc" and resp.code == 3
    # error mapping over real grpc
    with pytest.raises(grpc.RpcError) as ei:
        stub(EchoRequest(message="x", server_fail=2001), timeout=10)
    channel.close()


# ---- round-3 regressions (ADVICE r2 + frame-loop dispatch) ------------------
def test_grpcio_large_response_flow_control(server):
    """Response >> the peer's 64KB initial stream window: DATA must park
    on flow control and the trailers must follow the LAST data frame
    (pre-fix the trailers jumped the parked DATA and the response was
    truncated for any standard gRPC client)."""
    grpc = pytest.importorskip("grpc")
    big = "y" * (1 << 20)  # 1MB response >> 64KB initial window
    channel = grpc.insecure_channel(f"127.0.0.1:{server.port}")
    stub = channel.unary_unary(
        "/EchoService/Echo",
        request_serializer=lambda m: m.SerializeToString(),
        response_deserializer=EchoResponse.FromString,
    )
    resp = stub(EchoRequest(message=big), timeout=30)
    assert resp.message == big
    channel.close()


def test_h2_slow_handler_does_not_stall_other_streams(server):
    """User code runs off the frame loop: a slow handler on one stream
    must not delay another stream on the SAME connection."""
    import time as _t

    ch = Channel(ChannelOptions(protocol="grpc", timeout_ms=8000))
    assert ch.init(f"127.0.0.1:{server.port}") == 0
    stub = echo_stub(ch)
    done_at = {}

    def call(tag, us):
        c = Controller()
        r = stub.Echo(c, EchoRequest(message=tag, sleep_us=us))
        done_at[tag] = (_t.monotonic(), c.failed(), getattr(r, "message", None))

    start = _t.monotonic()
    t_slow = threading.Thread(target=call, args=("slow", 1_200_000))
    t_slow.start()
    _t.sleep(0.15)  # slow stream is in its handler now
    t_fast = threading.Thread(target=call, args=("fast", 0))
    t_fast.start()
    t_fast.join(10)
    t_slow.join(10)
    assert done_at["fast"][1:] == (False, "fast")
    assert done_at["slow"][1:] == (False, "slow")
    fast_elapsed = done_at["fast"][0] - start
    assert fast_elapsed < 0.9, f"fast stream waited for slow handler: {fast_elapsed}"


def test_malformed_grpc_status_fails_only_that_rpc():
    """A garbage grpc-status trailer must fail THAT rpc with ERESPONSE,
    not tear down the whole multiplexed connection."""
    from incubator_brpc_tpu_torch import errors as E
    from incubator_brpc_tpu_torch.runtime.call_id import default_pool

    pool = default_pool()
    ctrl = Controller()
    import time as _t

    ctrl._start_ns = _t.monotonic_ns()
    cid = pool.create(data=ctrl, on_error=Controller._id_on_error)
    ctrl._current_cid = cid
    stream = h2.H2Stream(1, h2.DEFAULT_WINDOW)
    stream.cid = cid
    stream.headers = [(":status", "200")]
    stream.trailers = [("grpc-status", "not-an-int")]
    h2._deliver_client_stream(None, stream, None, cid)
    assert ctrl.failed()
    assert ctrl.error_code == E.ERESPONSE


def test_goaway_graceful_drain(server):
    """GOAWAY lets in-flight streams finish, refuses new ones on that
    connection, and later RPCs ride a fresh connection."""
    from incubator_brpc_tpu_torch.protocols.h2 import send_goaway

    ch = Channel(ChannelOptions(protocol="grpc", timeout_ms=8000))
    assert ch.init(f"127.0.0.1:{server.port}") == 0
    stub = echo_stub(ch)
    # warm the connection so the server side has an h2 ctx
    c0 = Controller()
    assert stub.Echo(c0, EchoRequest(message="warm")).message == "warm"

    result = {}

    def slow_call():
        c = Controller()
        r = stub.Echo(c, EchoRequest(message="inflight", sleep_us=600_000))
        result["slow"] = (c.failed(), getattr(r, "message", None))

    t = threading.Thread(target=slow_call)
    t.start()
    import time as _t

    _t.sleep(0.2)  # slow stream is open on the connection
    h2_conns = [
        s
        for s in server._acceptor.connections()
        if s is not None and s.h2_ctx is not None and not s.failed
    ]
    assert h2_conns, "no server-side h2 connection found"
    for s in h2_conns:
        send_goaway(s)
    t.join(10)
    # the in-flight stream (sid <= last_stream_id) survived the GOAWAY
    assert result["slow"] == (False, "inflight"), result
    # and new RPCs work (fresh connection: old one is draining)
    c2 = Controller()
    r2 = stub.Echo(c2, EchoRequest(message="after-goaway"))
    assert not c2.failed(), c2.error_text()
    assert r2.message == "after-goaway"


# ---- the JAX package's HPACK encoder as the oracle ---------------------------
_D1, _D2 = "Mon, 21 Oct 2013 20:13:21 GMT", "Mon, 21 Oct 2013 20:13:22 GMT"
_LOC = "https://www.example.com"
_RFC_REQUESTS = [
    [(":method", "GET"), (":scheme", "http"), (":path", "/"), (":authority", "www.example.com")],
    [(":method", "GET"), (":scheme", "http"), (":path", "/"), (":authority", "www.example.com"),
     ("cache-control", "no-cache")],
    [(":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
     (":authority", "www.example.com"), ("custom-key", "custom-value")],
]
_RFC_RESPONSES = [
    [(":status", "302"), ("cache-control", "private"), ("date", _D1), ("location", _LOC)],
    [(":status", "307"), ("cache-control", "private"), ("date", _D1), ("location", _LOC)],
    [(":status", "200"), ("cache-control", "private"), ("date", _D2), ("location", _LOC),
     ("content-encoding", "gzip"),
     ("set-cookie", "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1")],
]
# RFC 7541 appendix: (blocks, table size, huffman)
_RFC_CASES = {
    "C.3": (_RFC_REQUESTS, 4096, False),
    "C.4": (_RFC_REQUESTS, 4096, True),
    "C.5": (_RFC_RESPONSES, 256, False),
    "C.6": (_RFC_RESPONSES, 256, True),
}


@pytest.mark.parametrize("case", sorted(_RFC_CASES))
def test_hpack_encoder_bytes_equal_the_jax_packages(case):
    """Each header block of RFC 7541 C.3-C.6, encoded in sequence on one
    encoder: the port's bytes equal the JAX package's, the dynamic table
    after each block is the same, and the port's decoder reads the
    headers back.  C.3 and C.4 are the RFC's own bytes."""
    from incubator_brpc_tpu.protocols.hpack import HpackEncoder as JaxEncoder

    blocks, size, huffman = _RFC_CASES[case]
    port, ref, dec = HpackEncoder(size, huffman=huffman), JaxEncoder(size, huffman=huffman), HpackDecoder(size)
    wire = []
    for headers in blocks:
        got = port.encode(headers)
        assert got == ref.encode(headers), (case, headers)
        assert list(port._table.entries) == list(ref._table.entries)
        assert port._table.size == ref._table.size <= size
        assert dec.decode(got) == headers
        wire.append(got.hex())
    rfc = {
        "C.3": ["828684410f7777772e6578616d706c652e636f6d", "828684be58086e6f2d6361636865",
                "828785bf400a637573746f6d2d6b65790c637573746f6d2d76616c7565"],
        "C.4": ["828684418cf1e3c2e5f23a6ba0ab90f4ff", "828684be5886a8eb10649cbf",
                "828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf"],
    }
    if case in rfc:
        assert wire == rfc[case]


class _CaptureSock:
    """The client half of a connection as ``h2.issue`` sees it: the
    writes are kept, nothing is sent."""

    is_server_side = False

    def __init__(self):
        self.h2_ctx = None
        self.remote = "127.0.0.1:8010"
        self.out = b""
        self.waiting = []

    def write(self, buf, ignore_eovercrowded=False):
        self.out += buf.to_bytes()
        return 0

    def add_response_waiter(self, cid):
        self.waiting.append(cid)


def _grpc_wire(pkg):
    """Three gRPC requests issued on one connection through one
    package's ``h2.issue`` (the preface, SETTINGS, HPACK-indexed
    headers, grpc-timeout, the tenant header, a DATA body split by the
    peer's frame size) and a GOAWAY, as bytes."""
    import importlib

    h2m = importlib.import_module(f"{pkg}.protocols.h2")
    ctl = importlib.import_module(f"{pkg}.client.controller")
    svc = importlib.import_module(f"{pkg}.server.service")
    pb = importlib.import_module(f"{pkg}.protos.echo_pb2")
    iob = importlib.import_module(f"{pkg}.utils.iobuf")
    sock = _CaptureSock()
    spec = svc.MethodSpec("EchoService", "Echo", pb.EchoRequest, pb.EchoResponse)
    for i, (timeout_ms, tenant, n) in enumerate([(5000, "", 3), (250, "batch", 40000), (0, "batch", 9)]):
        c = ctl.Controller()
        c.timeout_ms = timeout_ms
        if tenant:
            c.tenant = tenant
        req = pb.EchoRequest(message="g" * n, code=i)
        h2m.issue(sock, iob.IOBuf(req.SerializeToString()), 0x1000 + i, spec, c)
    sock.h2_ctx.is_server = True  # a GOAWAY as a server sends it
    out = sock.out
    h2m.send_goaway(sock)
    return out, sock.out[len(out):], sock.waiting


def test_grpc_request_wire_bytes_equal_the_jax_packages():
    port = _grpc_wire("incubator_brpc_tpu_torch")
    ref = _grpc_wire("incubator_brpc_tpu")
    assert port == ref
    assert port[0].startswith(h2.PREFACE) and port[2] == [0x1000, 0x1001, 0x1002]
    assert port[1][3] == h2.GOAWAY


# ---- the gRPC cases of tests/test_admission.py -----------------------------
import itertools  # noqa: E402
import time  # noqa: E402

from incubator_brpc_tpu_torch import errors  # noqa: E402
from incubator_brpc_tpu_torch.server.admission import AdmissionPolicy  # noqa: E402
from incubator_brpc_tpu_torch.server.server import ServerOptions  # noqa: E402

_group_seq = itertools.count(1)


class TaggedEcho(EchoService):
    SERVICE_NAME = "EchoService"

    def __init__(self, tag):
        super().__init__(attach_echo=False)
        self.tag = tag
        self.calls = 0

    def Echo(self, controller, request, response, done):
        self.calls += 1
        response.message = self.tag
        if request.sleep_us and request.message == f"slow:{self.tag}":
            time.sleep(request.sleep_us / 1e6)
        done()


def test_tenant_identity_rides_grpc_and_sheds_decode_overcrowded():
    """Tenant tiering applies over h2/grpc: controller.tenant travels
    as the x-tpu-tenant header, and a RESOURCE_EXHAUSTED shed decodes
    as EOVERCROWDED (retry-elsewhere), not the drop code ELIMIT."""
    pol = AdmissionPolicy(tenant_quotas={"noisy": 1})
    srv = Server(ServerOptions(admission_policy=pol))
    srv.add_service(EchoService(attach_echo=False))
    assert srv.start(0) == 0
    channels = []

    def grpc_channel_():
        ch = Channel(ChannelOptions(
            protocol="grpc", timeout_ms=5000, max_retry=0,
            connection_group=f"adm{next(_group_seq)}",
        ))
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        channels.append(ch)
        return ch

    try:
        codes = []

        def call(sleep_us):
            c = Controller()
            c.tenant = "noisy"
            echo_stub(grpc_channel_()).Echo(
                c, EchoRequest(message="g", sleep_us=sleep_us)
            )
            codes.append(c.error_code)

        ts = [threading.Thread(target=call, args=(300_000,))
              for _ in range(2)]
        ts[0].start()
        time.sleep(0.1)
        ts[1].start()
        for t in ts:
            t.join()
        assert sorted(codes) == [0, errors.EOVERCROWDED], codes
    finally:
        srv.stop()
        for ch in channels:
            ch.close()


def test_grpc_overcrowded_retry_lands_on_different_replica():
    """The retry-elsewhere contract holds over h2/grpc too: a
    RESOURCE_EXHAUSTED admission shed re-enters the port's retry
    arbitration and the reissue completes on the other replica."""
    svc0 = TaggedEcho("s0")
    srv0 = Server(ServerOptions(method_max_concurrency="constant=1"))
    srv0.add_service(svc0)
    assert srv0.start(0) == 0
    srv1 = Server()
    srv1.add_service(TaggedEcho("s1"))
    assert srv1.start(0) == 0
    url = f"list://127.0.0.1:{srv0.port},127.0.0.1:{srv1.port}"

    def grpc_cluster(max_retry):
        ch = Channel(ChannelOptions(
            protocol="grpc", timeout_ms=5000, max_retry=max_retry,
            connection_group=f"adm{next(_group_seq)}",
        ))
        assert ch.init(url, "rr") == 0
        return ch

    ch_park = grpc_cluster(0)
    ch = grpc_cluster(3)
    try:
        parked = threading.Thread(target=lambda: echo_stub(ch_park).Echo(
            Controller(), EchoRequest(message="slow:s0", sleep_us=700_000)
        ))
        parked.start()
        time.sleep(0.15)
        for _ in range(3):
            c = Controller()
            r = echo_stub(ch).Echo(c, EchoRequest(message="x"))
            assert not c.failed(), (c.error_code, c.error_text())
            assert r.message == "s1", r.message
        parked.join()
    finally:
        srv0.stop()
        srv1.stop()
        ch.close()
        ch_park.close()


def test_grpc_status_split_preserves_drop_vs_retry_codes():
    """ELIMIT (drop) and EOVERCROWDED (retry elsewhere) survive the
    h2/grpc status round trip as DISTINCT codes, as in the JAX package:
    ELIMIT -> OUT_OF_RANGE, EOVERCROWDED -> RESOURCE_EXHAUSTED."""
    from incubator_brpc_tpu.protocols import h2 as jax_h2
    from incubator_brpc_tpu_torch.protocols.h2 import _error_of_grpc, _grpc_status_of

    assert _error_of_grpc(_grpc_status_of(errors.ELIMIT)) == errors.ELIMIT
    assert (
        _error_of_grpc(_grpc_status_of(errors.EOVERCROWDED))
        == errors.EOVERCROWDED
    )
    assert _grpc_status_of(errors.ELIMIT) == h2.GRPC_OUT_OF_RANGE
    assert _grpc_status_of(errors.EOVERCROWDED) == h2.GRPC_RESOURCE_EXHAUSTED
    for code in range(0, 3000):
        assert _grpc_status_of(code) == jax_h2._grpc_status_of(code)
    for status in range(0, 20):
        assert _error_of_grpc(status) == jax_h2._error_of_grpc(status)


# ---- the gRPC cases of tests/test_ssl.py ------------------------------------
@pytest.fixture(scope="module")
def tls_certs(tmp_path_factory):
    import subprocess

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


def _tls_server(tls_certs):
    from incubator_brpc_tpu_torch.transport.ssl_helper import CertInfo, ServerSSLOptions

    srv = Server(ServerOptions(ssl_options=ServerSSLOptions(default_cert=CertInfo(
        certificate=tls_certs["cert"], private_key=tls_certs["key"]))))
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    return srv


def test_grpc_over_tls(tls_certs):
    """gRPC (h2) rides the TLS transport like any other protocol: the
    handshake happens beneath protocol framing."""
    from incubator_brpc_tpu_torch.transport.ssl_helper import ChannelSSLOptions

    srv = _tls_server(tls_certs)
    try:
        ch = Channel(ChannelOptions(protocol="grpc", timeout_ms=5000, ssl_options=ChannelSSLOptions(
            ca_file=tls_certs["cert"], sni_name="localhost", verify_hostname=True)))
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        stub = echo_stub(ch)
        for i in range(3):
            c = Controller()
            r = stub.Echo(c, EchoRequest(message=f"grpc-tls-{i}", code=i))
            assert not c.failed(), c.error_text()
            assert r.message == f"grpc-tls-{i}" and r.code == i
        ch.close()
    finally:
        srv.stop()


def test_real_grpcio_client_over_tls(tls_certs):
    """A real grpcio secure channel against the port's TLS port: ALPN
    negotiates h2 and the gRPC call round-trips."""
    grpc = pytest.importorskip("grpc")
    import pathlib

    srv = _tls_server(tls_certs)
    try:
        creds = grpc.ssl_channel_credentials(
            root_certificates=pathlib.Path(tls_certs["cert"]).read_bytes()
        )
        with grpc.secure_channel(
            f"localhost:{srv.port}", creds,
            options=[("grpc.ssl_target_name_override", "localhost")],
        ) as channel:
            stub = channel.unary_unary(
                "/EchoService/Echo",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=EchoResponse.FromString,
            )
            resp = stub(EchoRequest(message="grpcio-tls", code=9), timeout=15)
            assert resp.message == "grpcio-tls" and resp.code == 9
    finally:
        srv.stop()


# ---- global_init: no guard, every protocol registered ----------------------
_NO_IMPORT = """
import sys
from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server
before = sorted(m for m in sys.modules if m.startswith("incubator_brpc_tpu_torch.protocols."))
srv = Server(); srv.add_service(EchoService()); assert srv.start(0) == 0
ch = Channel(ChannelOptions(protocol="h2", timeout_ms=5000))
assert ch.init(f"127.0.0.1:{srv.port}") == 0
c = Controller()
r = echo_stub(ch).Echo(c, EchoRequest(message="no-import", code=5))
print("BEFORE", " ".join(before))
print("REPLY", c.failed(), r.message, r.code)
from incubator_brpc_tpu_torch.protocols import list_protocols
print("REGISTERED", " ".join(p.name for p in list_protocols()))
ch.close(); srv.stop()
print("JAX", any(m == "jax" or m.startswith("incubator_brpc_tpu.") for m in sys.modules))
"""


def test_global_init_registers_every_protocol_without_a_guard():
    """No ``except ImportError`` is left in the port's global_init, the
    registry holds the JAX package's protocols in its order with esp
    last, and in a fresh interpreter a ``protocol="h2"`` channel echoes
    against a port server with no import of the protocol."""
    import ast
    import os
    import subprocess
    import sys

    from incubator_brpc_tpu.global_init import global_init as jax_init
    from incubator_brpc_tpu.protocols import list_protocols as jax_list
    from incubator_brpc_tpu_torch.global_init import global_init
    from incubator_brpc_tpu_torch.protocols import list_protocols

    import incubator_brpc_tpu_torch.global_init as gi

    tree = ast.parse(open(gi.__file__).read())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
    global_init()
    jax_init()
    names = [p.name for p in list_protocols()]
    assert names == [p.name for p in jax_list()]
    assert names[-1] == "esp" and names[0] == "tpu_std"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _NO_IMPORT], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert "incubator_brpc_tpu_torch.protocols.h2" not in lines["BEFORE"].split()
    assert lines["REPLY"] == "False no-import 5"
    assert lines["REGISTERED"].split() == names
    assert lines["JAX"] == "False"
