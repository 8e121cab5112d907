"""The port's RTMP (handshake, chunk stream, AMF0, publish/play relay),
against the JAX package's tests of it (``tests/test_rtmp.py``, mirrored
case for case), with the JAX package's AMF0 encoder as the oracle on the
wire and its RTMP client and server on the other end of a relay.
"""

import struct
import threading
import time

import pytest

from incubator_brpc_tpu_torch.models.echo import EchoService
from incubator_brpc_tpu_torch.protocols.rtmp import (
    MSG_AUDIO,
    MSG_DATA_AMF0,
    MSG_VIDEO,
    RtmpClient,
    RtmpService,
    amf0_decode_all,
    amf0_encode,
)
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions


def test_amf0_roundtrip():
    vals = [
        "connect",
        1.0,
        {"app": "live", "ok": True, "n": 3.5, "nil": None,
         "nested": {"a": "b"}},
        [1.0, "two", False],
    ]
    blob = amf0_encode(*vals)
    assert amf0_decode_all(blob) == vals


def test_amf0_wire_bytes():
    assert amf0_encode("hi") == b"\x02\x00\x02hi"
    assert amf0_encode(2.0) == b"\x00" + struct.pack(">d", 2.0)
    assert amf0_encode(True) == b"\x01\x01"
    assert amf0_encode(None) == b"\x05"
    assert amf0_encode({"a": 1.0}) == (
        b"\x03\x00\x01a\x00" + struct.pack(">d", 1.0) + b"\x00\x00\x09"
    )


@pytest.fixture
def rtmp_server():
    srv = Server()
    srv.add_service(EchoService())  # same port still answers tpu_std
    assert srv.start(0) == 0
    yield srv
    srv.stop()


def test_rtmp_connect_create_publish(rtmp_server):
    cli = RtmpClient("127.0.0.1", rtmp_server.port, app="live")
    sid = cli.create_stream()
    assert sid >= 1
    cli.publish(sid, "room1")
    cli.close()


def test_rtmp_publish_play_relay(rtmp_server):
    got = []
    done = threading.Event()

    def on_media(msg):
        got.append((msg.type_id, msg.timestamp, msg.payload))
        if len(got) >= 4:
            done.set()

    sub = RtmpClient("127.0.0.1", rtmp_server.port, app="live", on_media=on_media)
    ssid = sub.create_stream()
    sub.play(ssid, "movie")

    pub = RtmpClient("127.0.0.1", rtmp_server.port, app="live")
    psid = pub.create_stream()
    pub.publish(psid, "movie")
    # metadata + AVC sequence header + frames (one bigger than the
    # 128-byte default chunk size to exercise continuation chunks)
    pub.write_frame(psid, MSG_DATA_AMF0, 0, amf0_encode("onMetaData", {"w": 640.0}))
    pub.write_frame(psid, MSG_VIDEO, 0, b"\x17\x00" + b"SPS-PPS")
    pub.write_frame(psid, MSG_VIDEO, 40, b"\x17\x01" + b"F" * 5000)
    pub.write_frame(psid, MSG_AUDIO, 40, b"\xaf\x01" + b"A" * 300)

    assert done.wait(8), f"relay incomplete: got {len(got)} messages"
    types = [t for t, _, _ in got]
    assert MSG_DATA_AMF0 in types and MSG_VIDEO in types and MSG_AUDIO in types
    big = next(p for t, _, p in got if t == MSG_VIDEO and len(p) > 1000)
    assert big == b"\x17\x01" + b"F" * 5000  # chunk reassembly exact
    pub.close()
    sub.close()


def test_rtmp_late_joiner_gets_sequence_headers(rtmp_server):
    pub = RtmpClient("127.0.0.1", rtmp_server.port, app="live")
    psid = pub.create_stream()
    pub.publish(psid, "latejoin")
    pub.write_frame(psid, MSG_DATA_AMF0, 0, amf0_encode("onMetaData", {"h": 1.0}))
    pub.write_frame(psid, MSG_VIDEO, 0, b"\x17\x00" + b"HDR")  # AVC seq header
    time.sleep(0.3)

    got = []
    hdr_seen = threading.Event()

    def on_media(msg):
        got.append(msg.payload)
        if msg.payload.startswith(b"\x17\x00"):
            hdr_seen.set()

    sub = RtmpClient("127.0.0.1", rtmp_server.port, app="live", on_media=on_media)
    ssid = sub.create_stream()
    sub.play(ssid, "latejoin")
    assert hdr_seen.wait(8), "late joiner never received the sequence header"
    pub.close()
    sub.close()


def test_rtmp_service_hooks_can_reject(rtmp_server):
    class Gate(RtmpService):
        def on_publish(self, app, name):
            return name != "forbidden"

    rtmp_server.options.rtmp_service = Gate()
    cli = RtmpClient("127.0.0.1", rtmp_server.port, app="live")
    sid = cli.create_stream()
    with pytest.raises((RuntimeError, TimeoutError)):
        cli.publish(sid, "forbidden")
    cli.publish(cli.create_stream(), "allowed")
    cli.close()
    rtmp_server.options.rtmp_service = None


def test_rtmp_coexists_with_rpc(rtmp_server):
    """Same port: RTMP handshake + a tpu_std echo RPC."""
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.models.echo import echo_stub
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest

    cli = RtmpClient("127.0.0.1", rtmp_server.port, app="live")
    sid = cli.create_stream()
    cli.publish(sid, "mixed")
    ch = Channel(ChannelOptions(timeout_ms=5000))
    assert ch.init(f"127.0.0.1:{rtmp_server.port}") == 0
    c = Controller()
    r = echo_stub(ch).Echo(c, EchoRequest(message="rpc-beside-rtmp"))
    assert not c.failed(), c.error_text()
    assert r.message == "rpc-beside-rtmp"
    ch.close()
    cli.close()


def test_rtmp_extended_timestamp_multichunk(rtmp_server):
    """Frames with ts >= 0xFFFFFF spanning multiple chunks: fmt-3
    continuations repeat the extended timestamp (spec 5.3.1.3) and the
    parser must consume it."""
    got = []
    done = threading.Event()

    def on_media(msg):
        got.append(msg)
        done.set()

    sub = RtmpClient("127.0.0.1", rtmp_server.port, app="live", on_media=on_media)
    sub.play(sub.create_stream(), "longlived")
    pub = RtmpClient("127.0.0.1", rtmp_server.port, app="live")
    psid = pub.create_stream()
    pub.publish(psid, "longlived")
    big_ts = 0x1000000  # > 0xFFFFFF → extended timestamp on the wire
    payload = b"\x17\x01" + b"Z" * 9000  # multiple chunks
    pub.write_frame(psid, MSG_VIDEO, big_ts, payload)
    assert done.wait(8)
    assert got[0].payload == payload
    assert got[0].timestamp == big_ts
    pub.close()
    sub.close()


# ---------------------------------------------------------------------------
# the JAX package as the oracle
# ---------------------------------------------------------------------------


def test_amf0_bytes_equal_the_jax_packages():
    from incubator_brpc_tpu.protocols import rtmp as jax_rtmp

    vals = ["connect", 1.0, {"app": "live", "ok": True, "n": 3.5, "nil": None,
                             "nested": {"a": "b"}}, [1.0, "two", False], "", 0.0]
    blob = amf0_encode(*vals)
    assert blob == jax_rtmp.amf0_encode(*vals)
    assert amf0_decode_all(blob) == jax_rtmp.amf0_decode_all(blob) == vals


@pytest.mark.parametrize("publisher,server", [("port", "jax"), ("jax", "port")])
def test_rtmp_relay_across_packages(publisher, server):
    """One package's RTMP client publishes through the other package's
    server to a subscriber of each package: every subscriber gets every
    frame, byte for byte, multi-chunk frames and an extended timestamp
    included."""
    import importlib

    pkgs = {"port": "incubator_brpc_tpu_torch", "jax": "incubator_brpc_tpu"}
    srv_mod = importlib.import_module(f"{pkgs[server]}.server.server")
    echo = importlib.import_module(f"{pkgs[server]}.models.echo")
    srv = srv_mod.Server()
    srv.add_service(echo.EchoService())
    assert srv.start(0) == 0
    subs, pub = [], None
    try:
        frames = [(MSG_DATA_AMF0, 0, amf0_encode("onMetaData", {"w": 640.0})),
                  (MSG_VIDEO, 0, b"\x17\x00" + b"SPS-PPS"),
                  (MSG_VIDEO, 40, b"\x17\x01" + bytes(range(256)) * 20),
                  (MSG_AUDIO, 40, b"\xaf\x01" + b"A" * 300),
                  (MSG_VIDEO, 0x1000000, b"\x27\x01" + b"Z" * 9000)]
        for pkg in ("port", "jax"):
            mod = importlib.import_module(f"{pkgs[pkg]}.protocols.rtmp")
            got, done = [], threading.Event()

            def on_media(msg, got=got, done=done):
                got.append((msg.type_id, msg.timestamp, msg.payload))
                if len(got) >= len(frames):
                    done.set()

            cli = mod.RtmpClient("127.0.0.1", srv.port, app="live", on_media=on_media)
            cli.play(cli.create_stream(), "cross")
            subs.append((cli, got, done))
        mod = importlib.import_module(f"{pkgs[publisher]}.protocols.rtmp")
        pub = mod.RtmpClient("127.0.0.1", srv.port, app="live")
        psid = pub.create_stream()
        pub.publish(psid, "cross")
        for t, ts, payload in frames:
            pub.write_frame(psid, t, ts, payload)
        for _, got, done in subs:
            assert done.wait(8), f"relay incomplete: {len(got)} messages"
            assert got == frames
    finally:
        if pub is not None:
            pub.close()
        for cli, _, _ in subs:
            cli.close()
        srv.stop()
