"""The port's DCN bridge (``incubator_brpc_tpu_torch.parallel.dcn``)
held against the JAX package's: the scenarios of tests/test_dcn.py,
tests/test_ssl.py's TLS bridge and tests/test_chaos.py's ``dcn.send``
reorder, rerun against a PORT child process, plus wire interop in both
directions (a port client against a JAX child, a JAX client against a
port child) and the receive path's refusal to fall back to host bytes.

Every port entry point is given ``torch.device("cpu")``: a device
segment crosses the socket as bytes and becomes a CPU tensor of its
dtype and shape on the receiving side, where the fabric's receiving
hop runs the plain version of its copy kernel.  Device payloads are
numpy arrays from a seed, handed to both packages.
"""

import json
import os
import pathlib
import socket
import struct
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from incubator_brpc_tpu_torch.convert import tensor_from_reference

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")

# each child hosts an echo server at ici://slice{S}/chip7; the slices
# are this file's own (the JAX tests' children use slice0 in their own
# processes)
SLICES = {"port": 31, "jax": 32}

_CHILD = r"""
import json, os, sys
sys.path.insert(0, os.environ["REPO_ROOT"])
pkg = os.environ["CHILD_PKG"]
mode = os.environ.get("CHILD_MODE", "echo")
slice_id = int(os.environ["CHILD_SLICE"])
if pkg == "port":
    import torch
    from incubator_brpc_tpu_torch.models.echo import EchoService
    from incubator_brpc_tpu_torch.parallel import dcn
    from incubator_brpc_tpu_torch.server.server import Server
    kw = {"device": torch.device("cpu")}
else:
    from incubator_brpc_tpu.models.echo import EchoService
    from incubator_brpc_tpu.parallel import dcn
    from incubator_brpc_tpu.server.server import Server
    kw = {}

import functools
calls = [0]
_echo = EchoService.Echo


@functools.wraps(_echo)  # keeps the method's RPC spec
def _counting_echo(self, *args):
    calls[0] += 1
    return _echo(self, *args)


EchoService.Echo = _counting_echo
srv = Server()
srv.add_service(EchoService())
assert srv.start_ici(slice_id, 7, **kw) == 0
ssl_context = None
if mode == "tls":
    from incubator_brpc_tpu_torch.transport.ssl_helper import (
        CertInfo, ServerSSLOptions, make_server_context,
    )
    ssl_context = make_server_context(ServerSSLOptions(default_cert=CertInfo(
        certificate=os.environ["TLS_CERT"], private_key=os.environ["TLS_KEY"])))
if mode == "broken_upload":
    def _upload(*args, **kwargs):
        raise RuntimeError("injected upload failure")
    dcn._upload = _upload
port = dcn.listen_dcn(0, host="127.0.0.1", ssl_context=ssl_context)
print(json.dumps({"dcn_port": port}), flush=True)
sys.stdin.read()  # serve until the parent closes stdin
print(json.dumps({"echo_calls": calls[0]}), flush=True)
srv.stop()
"""


class Child:
    def __init__(self, pkg, mode="echo", slice_id=None, env_extra=None):
        env = dict(os.environ)
        env.update(
            REPO_ROOT=str(ROOT), CHILD_PKG=pkg, CHILD_MODE=mode,
            CHILD_SLICE=str(SLICES[pkg] if slice_id is None else slice_id),
            JAX_PLATFORMS="cpu",
        )
        env.update(env_extra or {})
        self.slice = int(env["CHILD_SLICE"])
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _CHILD], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True,
        )
        line = self.proc.stdout.readline()
        try:
            self.dcn_port = json.loads(line)["dcn_port"]
        except ValueError:
            self.proc.kill()
            raise RuntimeError(
                f"child failed: {line!r}\n{self.proc.stderr.read()[-3000:]}"
            )

    @property
    def addr(self):
        return f"ici://slice{self.slice}/chip7"

    def close(self) -> dict:
        """Stop the child; its last line (the echo calls it served)."""
        self.proc.stdin.close()
        try:
            out = self.proc.stdout.read()
            self.proc.wait(10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            return {}
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        return json.loads(lines[-1]) if lines else {}


@pytest.fixture(scope="module")
def children():
    kids = {pkg: Child(pkg) for pkg in ("port", "jax")}
    yield kids
    for kid in kids.values():
        kid.close()


def _client(pkg):
    """The client half of one package: modules and the device payload
    type of its side."""
    if pkg == "port":
        from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
        from incubator_brpc_tpu_torch.client.controller import Controller
        from incubator_brpc_tpu_torch.models.echo import echo_stub
        from incubator_brpc_tpu_torch.parallel import dcn
        from incubator_brpc_tpu_torch.parallel.ici import get_fabric
        from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest

        opts = {"ici_device": CPU}
        to_dev = lambda a: tensor_from_reference(a, CPU)  # noqa: E731
    else:
        from incubator_brpc_tpu.client.channel import Channel, ChannelOptions
        from incubator_brpc_tpu.client.controller import Controller
        from incubator_brpc_tpu.models.echo import echo_stub
        from incubator_brpc_tpu.parallel import dcn
        from incubator_brpc_tpu.parallel.ici import get_fabric
        from incubator_brpc_tpu.protos.echo_pb2 import EchoRequest

        opts = {}
        to_dev = jnp.asarray
    return types.SimpleNamespace(
        pkg=pkg, Channel=Channel, ChannelOptions=ChannelOptions,
        Controller=Controller, echo_stub=echo_stub, dcn=dcn,
        get_fabric=get_fabric, EchoRequest=EchoRequest, opts=opts,
        to_dev=to_dev,
    )


def _channel(P, addr, timeout_ms=30000):
    ch = P.Channel(P.ChannelOptions(timeout_ms=timeout_ms, **P.opts))
    assert ch.init(addr) == 0
    return ch


def _payloads(seed):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal((64, 256)).astype(np.float32),
        rng.standard_normal((32, 128)).astype(jnp.bfloat16),
        rng.integers(0, 256, (4096,), dtype=np.uint8),
    ]


def _seg_bytes(P, arr) -> bytes:
    if P.pkg == "port":
        assert isinstance(arr, torch.Tensor) and arr.device == CPU
        return arr.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(arr).tobytes()


# client package, child package: the port on both ends, then both
# directions of wire interop
PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port")]
PAIR_IDS = [f"{c}-client-{s}-child" for c, s in PAIRS]


@pytest.mark.parametrize("client,child", PAIRS, ids=PAIR_IDS)
def test_cross_process_ici_echo(children, client, child):
    P, kid = _client(client), children[child]
    coords = P.dcn.connect_dcn("127.0.0.1", kid.dcn_port)
    assert (kid.slice, 7) in coords, coords
    assert P.get_fabric().routable((kid.slice, 7))
    assert P.get_fabric().port((kid.slice, 7)) is None  # truly remote
    ch = _channel(P, kid.addr)
    stub = P.echo_stub(ch)
    for i in range(3):
        c = P.Controller()
        r = stub.Echo(c, P.EchoRequest(message=f"cross-process-{i}"))
        assert not c.failed(), c.error_text()
        assert r.message == f"cross-process-{i}"
    ch.close()


@pytest.mark.parametrize("client,child", PAIRS, ids=PAIR_IDS)
def test_device_segments_cross_byte_equal(children, client, child):
    """float32, bfloat16 and uint8 device segments echo byte-equal in
    one frame, whichever package writes and reads the wire; a port
    client gets each back as a tensor of its dtype and shape on the
    channel's device."""
    P, kid = _client(client), children[child]
    P.dcn.connect_dcn("127.0.0.1", kid.dcn_port)
    ch = _channel(P, kid.addr)
    arrays = _payloads(7)
    c = P.Controller()
    for a in arrays:
        c.request_attachment.append_device(P.to_dev(a))
    r = P.echo_stub(ch).Echo(c, P.EchoRequest(message="dtypes"))
    assert not c.failed(), c.error_text()
    assert r.message == "dtypes"
    segs = c.response_attachment.device_arrays()
    assert len(segs) == len(arrays)
    for got, want in zip(segs, arrays):
        assert _seg_bytes(P, got) == want.tobytes()
        assert tuple(got.shape) == want.shape
        if client == "port":
            assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    ch.close()


@pytest.mark.parametrize("client,child", PAIRS, ids=PAIR_IDS)
def test_cross_process_multi_segment_overlap(children, client, child):
    """Host bytes and two device segments in one frame
    (tests/test_dcn.py:138): all-at-once staging, windowed chunk writes
    and the receiver's uploads, the segments' order kept."""
    P, kid = _client(client), children[child]
    P.dcn.connect_dcn("127.0.0.1", kid.dcn_port)
    ch = _channel(P, kid.addr, 60000)
    a = np.arange(700_000, dtype=np.float32)  # ~2.8MB: more than one chunk
    b = np.full((300_000,), 7, dtype=np.int32)
    c = P.Controller()
    c.request_attachment.append(b"head-bytes")
    c.request_attachment.append_device(P.to_dev(a))
    c.request_attachment.append(b"mid")
    c.request_attachment.append_device(P.to_dev(b))
    r = P.echo_stub(ch).Echo(c, P.EchoRequest(message="multi"))
    assert not c.failed(), c.error_text()
    assert r.message == "multi"
    blob = c.response_attachment.to_bytes()
    assert blob == b"head-bytes" + a.tobytes() + b"mid" + b.tobytes()
    ch.close()


def test_tpu_ns_resolves_remote_servers(children):
    P, kid = _client("port"), children["port"]
    P.dcn.connect_dcn("127.0.0.1", kid.dcn_port)
    assert (kid.slice, 7) in P.get_fabric().server_coords()
    ch = P.Channel(P.ChannelOptions(timeout_ms=8000, **P.opts))
    assert ch.init("tpu://fabric", "rr") == 0  # resolve via topology NS
    stub = P.echo_stub(ch)
    deadline = time.monotonic() + 5
    last_err = ""
    while time.monotonic() < deadline:
        c = P.Controller()
        r = stub.Echo(c, P.EchoRequest(message="via-ns"))
        if not c.failed():
            assert r.message == "via-ns"
            break
        last_err = c.error_text()
        time.sleep(0.2)  # NS refresh may lag a beat
    else:
        raise AssertionError(f"tpu:// never resolved the remote server: {last_err}")
    ch.close()


def test_same_host_bridge_upgrades_to_uds(children):
    P, kid = _client("port"), children["port"]
    before = {id(c) for c in P.dcn.get_bridge()._conns}
    assert P.dcn.connect_dcn("127.0.0.1", kid.dcn_port)
    peers = [c.peer for c in P.dcn.get_bridge()._conns
             if id(c) not in before and not c.closed]
    assert peers and all(p.startswith("uds:") for p in peers), peers
    ch = _channel(P, kid.addr)
    c = P.Controller()
    c.request_attachment.append(b"U" * (1 << 20))
    r = P.echo_stub(ch).Echo(c, P.EchoRequest(message="uds-bridge"))
    assert not c.failed(), c.error_text()
    assert r.message == "uds-bridge"
    assert c.response_attachment.to_bytes() == b"U" * (1 << 20)
    ch.close()


def test_uds_bridge_socket_is_private():
    import stat

    from incubator_brpc_tpu_torch.parallel.dcn import DcnBridge

    bridge = DcnBridge()
    try:
        bridge.listen(0, host="127.0.0.1")
        assert bridge._uds_path is not None, "UDS listener did not start"
        st_dir = os.stat(os.path.dirname(bridge._uds_path))
        assert stat.S_IMODE(st_dir.st_mode) == 0o700
        st_sock = os.stat(bridge._uds_path)
        assert stat.S_IMODE(st_sock.st_mode) == 0o600
    finally:
        bridge.close()
    assert bridge._uds_path is None and bridge._uds_dir is None


def test_bridge_priming_exchange(children):
    P, kid = _client("port"), children["port"]
    bridge = P.dcn.get_bridge()
    before = {id(c) for c in bridge._conns}
    assert P.dcn.connect_dcn("127.0.0.1", kid.dcn_port)
    conns = [c for c in bridge._conns if id(c) not in before]
    assert conns, "connect_dcn created no bridge connection"
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not any(c.primed_seen for c in conns):
        time.sleep(0.02)
    assert any(c.primed_seen for c in conns), "the child's priming frame never arrived"


def test_dcn_bulk_echo_no_first_transfer_straggler(children):
    """tests/test_dcn.py:235 against a port child: after the priming
    exchange and the warmed receive path the FIRST 8 MB echo is no
    straggler — under 3.5x the median of the six after it, or under
    twice the slowest of them (a loaded host stalls any echo alike; the
    straggler this guards against was ~40x the median)."""
    P, kid = _client("port"), children["port"]
    P.dcn.connect_dcn("127.0.0.1", kid.dcn_port)
    ch = _channel(P, kid.addr)
    stub = P.echo_stub(ch)
    blob = b"\xa5" * (8 << 20)
    times = []
    for _ in range(7):
        c = P.Controller()
        c.request_attachment.append(blob)
        t0 = time.perf_counter()
        stub.Echo(c, P.EchoRequest(message="bulk"))
        times.append(time.perf_counter() - t0)
        assert not c.failed(), c.error_text()
        assert len(c.response_attachment) == len(blob)
    ch.close()
    first, rest = times[0], sorted(times[1:])
    assert first < 3.5 * rest[len(rest) // 2] or first < 2 * rest[-1], times


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
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        pytest.skip(f"openssl unavailable: {proc.stderr[-200:]}")
    return {"cert": cert, "key": key}


def test_tls_dcn_cross_process_echo(tls_certs):
    """tests/test_ssl.py:230 against a port child: an encrypted bridge
    (no UDS upgrade under TLS) carries a device payload."""
    from incubator_brpc_tpu_torch.transport.ssl_helper import (
        ChannelSSLOptions,
        make_client_context,
    )

    P = _client("port")
    kid = Child("port", mode="tls", slice_id=33,
                env_extra={"TLS_CERT": tls_certs["cert"], "TLS_KEY": tls_certs["key"]})
    try:
        ctx = make_client_context(ChannelSSLOptions(
            ca_file=tls_certs["cert"], sni_name="localhost", verify_hostname=True,
        ))
        coords = P.dcn.connect_dcn("127.0.0.1", kid.dcn_port, ssl_context=ctx,
                                   server_hostname="localhost")
        assert (33, 7) in coords, coords
        ch = _channel(P, kid.addr, 8000)
        x = tensor_from_reference(_payloads(3)[1], CPU)
        c = P.Controller()
        c.request_attachment.append_device(x)
        r = P.echo_stub(ch).Echo(c, P.EchoRequest(message="tls-dcn"))
        assert not c.failed(), c.error_text()
        assert r.message == "tls-dcn"
        assert torch.equal(c.response_attachment.device_arrays()[0], x)
        ch.close()
    finally:
        kid.close()


def _read_frames(sock, count):
    sock.settimeout(5)
    data, dsts = b"", []
    while len(dsts) < count:
        data += sock.recv(1 << 16)
        while len(data) >= 8 and data[:4] == b"ICIF":
            hlen = struct.unpack(">I", data[4:8])[0]
            if len(data) < 8 + hlen:
                break
            hdr = json.loads(data[8:8 + hlen].decode())
            body = sum(s["n"] for s in hdr["segs"])
            if len(data) < 8 + hlen + body:
                break
            dsts.append(tuple(hdr["dst"]))
            data = data[8 + hlen + body:]
    return dsts


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_dcn_send_reorder_swaps_adjacent_frames(pkg):
    """tests/test_chaos.py:384 on both packages: the dcn.send reorder
    action holds one frame back and ships it after its successor."""
    if pkg == "port":
        from incubator_brpc_tpu_torch.chaos import FaultPlan, FaultSpec, injector
        from incubator_brpc_tpu_torch.parallel.dcn import _BridgeConn
        from incubator_brpc_tpu_torch.utils.iobuf import IOBuf
    else:
        from incubator_brpc_tpu.chaos import FaultPlan, FaultSpec, injector
        from incubator_brpc_tpu.parallel.dcn import _BridgeConn
        from incubator_brpc_tpu.utils.iobuf import IOBuf

    a, b = socket.socketpair()
    conn = _BridgeConn(types.SimpleNamespace(_drop_conn=lambda c: None), a, "test-peer")
    injector.arm(FaultPlan(
        [FaultSpec("dcn.send", "reorder", probability=1.0, max_hits=1,
                   match={"peer": "test-peer"})],
        seed=29,
    ))
    try:
        assert conn.send_frame(IOBuf(b"first"), (0, 1), (9, 1)) == 0
        assert conn.send_frame(IOBuf(b"second"), (0, 2), (9, 1)) == 0
        injector.disarm()
        assert _read_frames(b, 2) == [(0, 2), (0, 1)]
    finally:
        injector.disarm()
        a.close()
        b.close()


# ---- the wire's dtype map ---------------------------------------------------


def test_wire_dtype_names_are_numpys():
    """Every dtype the map carries writes numpy's name, the string the
    JAX package writes (``str(np.dtype(arr.dtype))``), and reads back
    to the same torch dtype; a dtype the map lacks raises both ways."""
    from incubator_brpc_tpu_torch.parallel.dcn import (
        _WIRE_DTYPES,
        _torch_dtype,
        _wire_dtype,
    )

    for name in _WIRE_DTYPES:
        dt = getattr(torch, name)
        assert _wire_dtype(dt) == str(np.dtype(getattr(jnp, name if name != "bool" else "bool_")))
        assert _torch_dtype(_wire_dtype(dt)) is dt
    with pytest.raises(TypeError):
        _wire_dtype(torch.float8_e4m3fn)
    with pytest.raises(TypeError):
        _torch_dtype("float8_e4m3fn")


def test_plan_frame_writes_the_jax_header():
    """The port's frame header for the same IOBuf is the JAX package's,
    byte for byte, and so are the payload bytes."""
    from incubator_brpc_tpu.parallel import dcn as jdcn
    from incubator_brpc_tpu.utils.iobuf import IOBuf as JIOBuf
    from incubator_brpc_tpu_torch.parallel import dcn as pdcn
    from incubator_brpc_tpu_torch.utils.iobuf import IOBuf as PIOBuf

    arrays = _payloads(11)
    jbuf, pbuf = JIOBuf(b"meta"), PIOBuf(b"meta")
    for a in arrays:
        jbuf.append_device(jnp.asarray(a))
        pbuf.append_device(tensor_from_reference(a, CPU))
    jh, jprod, jtotal = jdcn._plan_frame(jbuf, (1, 2), ("client", "9-1"))
    ph, pprod, ptotal = pdcn._plan_frame(pbuf, (1, 2), ("client", "9-1"))
    assert ph == jh and ptotal == jtotal
    jbytes = b"".join(bytes(c) for p in jprod for c in p())
    pbytes = b"".join(bytes(c) for p in pprod for c in p())
    assert pbytes == jbytes


# ---- no fallback to host bytes --------------------------------------------


def test_failed_upload_fails_the_frame(monkeypatch):
    """A device segment whose upload raises is never delivered as host
    bytes: the reader logs the frame, closes the connection, and the
    destination port receives nothing."""
    from incubator_brpc_tpu_torch.parallel import dcn
    from incubator_brpc_tpu_torch.parallel.ici import get_fabric
    from incubator_brpc_tpu_torch.utils.iobuf import IOBuf

    def broken(*args, **kwargs):
        raise RuntimeError("injected upload failure")

    fab = get_fabric()
    coords = (34, 1)
    port = fab.register(coords, server=object(), device=CPU)
    delivered = []
    monkeypatch.setattr(port, "deliver", lambda frame, *a, **k: delivered.append(frame) or True)
    monkeypatch.setattr(dcn, "_upload", broken)
    a, b = socket.socketpair()
    closed = []
    bridge = types.SimpleNamespace(_drop_conn=closed.append, _lock=dcn.threading.Lock(),
                                   _routes={})
    reader = dcn._BridgeConn(bridge, a, "upload-peer")
    writer = dcn._BridgeConn(types.SimpleNamespace(_drop_conn=lambda c: None), b, "w")
    try:
        frame = IOBuf(b"head")
        frame.append_device(torch.arange(256, dtype=torch.float32))
        assert writer.send_frame(frame, coords, ("client", "9-2")) == 0
        reader.reader_loop()  # returns once it refused the frame
        assert reader.closed and closed == [reader]
        assert delivered == []
    finally:
        fab.unregister(coords)
        a.close()
        b.close()


def test_caller_sees_an_error_when_the_child_cannot_upload():
    """End to end: a port child whose upload fails runs no handler for
    the frame, and the caller's RPC fails instead of getting bytes."""
    P = _client("port")
    kid = Child("port", mode="broken_upload", slice_id=35)
    try:
        P.dcn.connect_dcn("127.0.0.1", kid.dcn_port)
        ch = _channel(P, kid.addr, 2000)
        c = P.Controller()
        c.request_attachment.append_device(torch.ones((16, 128)))
        P.echo_stub(ch).Echo(c, P.EchoRequest(message="refused"))
        assert c.failed()
        ch.close()
    finally:
        assert kid.close().get("echo_calls") == 0
