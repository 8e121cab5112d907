"""The port's FLV remux and MPEG-TS/HLS muxer, against the JAX
package's tests of them (``tests/test_media_remux.py``, mirrored case
for case: golden byte vectors, and a structural TS demuxer in this file
that reads the muxer's output as a player would), and the JAX package
as the oracle: an FLV and an HLS/TS remux of the same seeded synthetic
stream give the same bytes through both packages.
"""

import struct

import pytest

from incubator_brpc_tpu_torch.protocols.flv import (
    FLV_TAG_AUDIO,
    FLV_TAG_VIDEO,
    FlvReader,
    FlvWriter,
)
from incubator_brpc_tpu_torch.protocols.rtmp import MSG_AUDIO, MSG_VIDEO, RtmpMessage
from incubator_brpc_tpu_torch.protocols.ts import (
    TS_PACKET_SIZE,
    TS_PID_AUDIO,
    TS_PID_PAT,
    TS_PID_PMT,
    TS_PID_VIDEO,
    TS_STREAM_AUDIO_AAC,
    TS_STREAM_VIDEO_H264,
    HlsSegmenter,
    TsMuxer,
    adts_header,
    avcc_to_annexb,
    build_pat,
    build_pmt,
    crc32_mpeg,
)

# ---------------------------------------------------------------------------
# FLV
# ---------------------------------------------------------------------------


def test_flv_golden_bytes():
    """Byte-exact: FLV header + one 3-byte video tag at ts=0x012345."""
    w = FlvWriter()
    w.write_tag(FLV_TAG_VIDEO, 0x012345, b"\x17\x00\x00")
    got = w.getvalue()
    want = bytes.fromhex(
        "464c5601"  # "FLV" version 1
        "05"        # audio+video
        "00000009"  # header size
        "00000000"  # previous_tag_size0
        "09"        # video tag
        "000003"    # data size 3
        "012345"    # timestamp low 24
        "00"        # timestamp ext
        "000000"    # stream id
        "170000"    # payload
        "0000000e"  # previous_tag_size = 11 + 3
    )
    assert got == want, got.hex()


def test_flv_roundtrip_with_extended_timestamp():
    w = FlvWriter()
    msgs = [
        RtmpMessage(MSG_VIDEO, 1, 0, b"\x17\x01" + b"v" * 50),
        RtmpMessage(MSG_AUDIO, 1, 40, b"\xaf\x01" + b"a" * 20),
        RtmpMessage(MSG_VIDEO, 1, 0x1234567, b"\x27\x01inter"),  # > 24 bits
    ]
    for m in msgs:
        w.write_message(m)
    r = FlvReader()
    r.feed(w.getvalue())
    out = []
    while (m := r.read_message()) is not None:
        out.append(m)
    assert [(m.type_id, m.timestamp, m.payload) for m in out] == [
        (m.type_id, m.timestamp, m.payload) for m in msgs
    ]
    assert r.content_type == 0x05


def test_flv_reader_incremental_and_errors():
    w = FlvWriter()
    w.write_tag(FLV_TAG_AUDIO, 7, b"\xaf\x01xyz")
    blob = w.getvalue()
    r = FlvReader()
    got = None
    for i in range(len(blob)):  # byte-at-a-time EAGAIN contract
        r.feed(blob[i : i + 1])
        if i < len(blob) - 1:
            assert r.read() is None
        else:
            got = r.read()
    assert got == (FLV_TAG_AUDIO, 7, b"\xaf\x01xyz")
    bad = FlvReader()
    bad.feed(b"NOTFLV.......")
    with pytest.raises(ValueError):
        bad.read()


# ---------------------------------------------------------------------------
# TS structural demux helpers
# ---------------------------------------------------------------------------


def split_packets(data):
    assert len(data) % TS_PACKET_SIZE == 0, "not 188-aligned"
    pkts = [
        data[i : i + TS_PACKET_SIZE]
        for i in range(0, len(data), TS_PACKET_SIZE)
    ]
    for p in pkts:
        assert p[0] == 0x47, "lost sync"
    return pkts


def pkt_pid(p):
    return struct.unpack(">H", p[1:3])[0] & 0x1FFF


def pkt_pusi(p):
    return bool(p[1] & 0x40)


def pkt_cc(p):
    return p[3] & 0x0F

def pkt_payload(p):
    afc = (p[3] >> 4) & 0x3
    pos = 4
    if afc in (2, 3):
        pos += 1 + p[4]
    if afc in (1, 3):
        return p[pos:]
    return b""


def reassemble_pid(pkts, pid):
    """Concatenate payloads of one pid across packets (single PES)."""
    return b"".join(pkt_payload(p) for p in pkts if pkt_pid(p) == pid)


def parse_pes(data):
    """→ (stream_id, pts, dts, es_bytes)."""
    assert data[:3] == b"\x00\x00\x01"
    sid = data[3]
    hdr_len = data[8]
    flags = data[7]
    pts = dts = None
    if flags & 0x80:
        pts = _decode_ts(data[9:14])
    if flags & 0x40:
        dts = _decode_ts(data[14:19])
    return sid, pts, dts, data[9 + hdr_len :]


def _decode_ts(b):
    return (
        ((b[0] >> 1) & 0x7) << 30
        | b[1] << 22
        | (b[2] >> 1) << 15
        | b[3] << 7
        | (b[4] >> 1)
    )


# ---------------------------------------------------------------------------
# TS tables
# ---------------------------------------------------------------------------


def test_crc32_mpeg_known_vector():
    # CRC-32/MPEG-2 check value (reveng catalogue): "123456789"
    assert crc32_mpeg(b"123456789") == 0x0376E6E7


def test_pat_golden_bytes():
    p = build_pat(cc=0)
    assert len(p) == TS_PACKET_SIZE
    want_head = bytes.fromhex(
        "47"      # sync
        "4000"    # PUSI + pid 0
        "10"      # payload only, cc 0
        "00"      # pointer_field
        "00"      # table_id PAT
        "b00d"    # syntax + length 13
        "0001"    # transport_stream_id
        "c1"      # version 0, current
        "00" "00" # section numbers
        "0001"    # program number 1
        "f001"    # pid 0x1001 (PMT) | 0xe000
    )
    assert p[: len(want_head)] == want_head, p[:20].hex()
    # crc over the section, then 0xff stuffing to 188
    sec = p[5 : 5 + 3 + 13]
    assert crc32_mpeg(sec[:-4]) == struct.unpack(">I", sec[-4:])[0]
    assert set(p[5 + 16 :]) == {0xFF}


def test_pmt_lists_h264_and_aac():
    p = build_pmt(cc=0)
    assert len(p) == TS_PACKET_SIZE and pkt_pid(p) == TS_PID_PMT
    sec_len = struct.unpack(">H", p[6:8])[0] & 0x0FFF
    sec = p[5 : 5 + 3 + sec_len]
    assert crc32_mpeg(sec[:-4]) == struct.unpack(">I", sec[-4:])[0]
    body = sec[8:-4]
    pcr_pid = struct.unpack(">H", body[0:2])[0] & 0x1FFF
    assert pcr_pid == TS_PID_VIDEO
    es = body[4:]
    assert es[0] == TS_STREAM_VIDEO_H264
    assert struct.unpack(">H", es[1:3])[0] & 0x1FFF == TS_PID_VIDEO
    assert es[5] == TS_STREAM_AUDIO_AAC
    assert struct.unpack(">H", es[6:8])[0] & 0x1FFF == TS_PID_AUDIO


def test_mux_pes_packetization_and_pts():
    m = TsMuxer()
    es = bytes(range(256)) * 3  # forces multiple packets + stuffing
    out = m.mux_pes(TS_PID_VIDEO, 0xE0, pts=90_000 * 3 + 45, dts=90_000 * 3,
                    es=es, pcr=90_000 * 3)
    pkts = split_packets(out)
    assert pkt_pusi(pkts[0]) and not any(pkt_pusi(p) for p in pkts[1:])
    assert [pkt_cc(p) for p in pkts] == list(range(len(pkts)))
    sid, pts, dts, got = parse_pes(reassemble_pid(pkts, TS_PID_VIDEO))
    assert sid == 0xE0 and pts == 90_000 * 3 + 45 and dts == 90_000 * 3
    assert got == es
    # PCR adaptation field on the first packet
    assert (pkts[0][3] >> 4) & 0x2, "no adaptation field on PCR packet"
    assert pkts[0][5] & 0x10, "PCR flag missing"


def test_avcc_to_annexb_and_adts():
    avcc = b"\x00\x00\x00\x02\x65\x88" + b"\x00\x00\x00\x01\x41"
    assert (
        avcc_to_annexb(avcc, 4)
        == b"\x00\x00\x00\x01\x65\x88\x00\x00\x00\x01\x41"
    )
    # AudioSpecificConfig: AAC-LC (2), 44.1kHz (idx 4), stereo (2)
    asc = bytes([0b00010_010, 0b0_0010_000])
    hdr = adts_header(asc, 100)
    assert hdr[0] == 0xFF and hdr[1] == 0xF1
    assert (hdr[2] >> 6) & 0x3 == 1          # profile-1 = LC-1 = 1
    assert (hdr[2] >> 2) & 0xF == 4          # rate index
    frame_len = ((hdr[3] & 0x3) << 11) | (hdr[4] << 3) | (hdr[5] >> 5)
    assert frame_len == 107                  # payload + 7


# ---------------------------------------------------------------------------
# HLS segmenter end-to-end
# ---------------------------------------------------------------------------


def _avc_seq_header():
    sps = b"\x67\x42\x00\x1e\xab"
    pps = b"\x68\xce\x06\xe2"
    avcc = (
        b"\x01\x42\x00\x1e\xff"        # version, profile..., 4-byte NALUs
        + b"\xe1" + struct.pack(">H", len(sps)) + sps
        + b"\x01" + struct.pack(">H", len(pps)) + pps
    )
    return b"\x17\x00\x00\x00\x00" + avcc


def _video_frame(key: bool, nal: bytes):
    first = b"\x17" if key else b"\x27"
    return first + b"\x01\x00\x00\x00" + struct.pack(">I", len(nal)) + nal


def _aac_seq_header():
    return b"\xaf\x00" + bytes([0b00010_010, 0b0_0010_000])


def _aac_frame(payload: bytes):
    return b"\xaf\x01" + payload


def test_hls_segmenter_end_to_end():
    seg = HlsSegmenter(target_duration_s=2.0, window=10)
    seg.on_message(RtmpMessage(MSG_VIDEO, 1, 0, _avc_seq_header()))
    seg.on_message(RtmpMessage(MSG_AUDIO, 1, 0, _aac_seq_header()))
    # 6s of 25fps video (keyframe every second) + audio every 100ms
    for ms in range(0, 6000, 40):
        key = ms % 1000 == 0
        nal = (b"\x65" if key else b"\x41") + ms.to_bytes(4, "big")
        seg.on_message(RtmpMessage(MSG_VIDEO, 1, ms, _video_frame(key, nal)))
        if ms % 100 == 0:
            seg.on_message(
                RtmpMessage(MSG_AUDIO, 1, ms, _aac_frame(b"A" * 32))
            )
    seg.finish_segment(6000)
    assert len(seg.segments) == 3, [s.duration_s for s in seg.segments]
    for s in seg.segments:
        assert abs(s.duration_s - 2.0) < 0.25, s.duration_s
        pkts = split_packets(bytes(s.data))
        # segment preamble: PAT then PMT, decodable standalone
        assert pkt_pid(pkts[0]) == TS_PID_PAT
        assert pkt_pid(pkts[1]) == TS_PID_PMT
        pids = {pkt_pid(p) for p in pkts}
        assert TS_PID_VIDEO in pids and TS_PID_AUDIO in pids
        # first video payload of the segment carries SPS/PPS re-injection
        vfirst = next(p for p in pkts if pkt_pid(p) == TS_PID_VIDEO)
        es = parse_pes(pkt_payload(vfirst))[3]
        assert b"\x00\x00\x00\x01\x67" in es, "SPS not re-injected at keyframe"
        assert b"\x00\x00\x00\x01\x68" in es, "PPS not re-injected at keyframe"
    pl = seg.playlist(end=True)
    assert pl.startswith("#EXTM3U")
    assert "#EXT-X-TARGETDURATION:2" in pl
    assert pl.count("#EXTINF:") == 3
    assert "seg0.ts" in pl and "#EXT-X-ENDLIST" in pl


def test_hls_audio_only_stream():
    seg = HlsSegmenter(target_duration_s=1.0, window=4)
    seg.on_message(RtmpMessage(MSG_AUDIO, 1, 0, _aac_seq_header()))
    for ms in range(0, 3000, 50):
        seg.on_message(RtmpMessage(MSG_AUDIO, 1, ms, _aac_frame(b"B" * 16)))
    seg.finish_segment(3000)
    assert len(seg.segments) == 3
    pkts = split_packets(bytes(seg.segments[0].data))
    audio = reassemble_pid(pkts, TS_PID_AUDIO)
    # parse_pes ignores trailing PES packets: the first frame's header
    # and payload prefix are what the assertions need
    sid, pts, dts, es = parse_pes(audio)
    assert sid == 0xC0 and pts == 0
    assert es[:2] == b"\xff\xf1", "ADTS header missing"


def test_media_gateway_over_real_rtmp():
    """End-to-end: an RTMP publisher feeds the server's relay; the
    MediaGatewayService tap produces an HLS playlist + parseable
    segments AND an FLV archive of the same stream."""
    import time

    from incubator_brpc_tpu_torch.protocols.media_gateway import MediaGatewayService
    from incubator_brpc_tpu_torch.protocols.rtmp import RtmpClient
    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    gw = MediaGatewayService(target_duration_s=1.0, window=8)
    srv = Server(ServerOptions(rtmp_service=gw))
    from incubator_brpc_tpu_torch.models.echo import EchoService

    srv.add_service(EchoService())
    assert srv.start(0) == 0
    try:
        pub = RtmpClient("127.0.0.1", srv.port, app="live")
        sid = pub.create_stream()
        pub.publish(sid, "room")
        pub.write_frame(sid, MSG_VIDEO, 0, _avc_seq_header())
        for ms in range(0, 3000, 40):
            key = ms % 500 == 0
            nal = (b"\x65" if key else b"\x41") + ms.to_bytes(4, "big")
            pub.write_frame(sid, MSG_VIDEO, ms, _video_frame(key, nal))
        deadline = time.monotonic() + 8
        while time.monotonic() < deadline:
            if "room" in gw.streams() and len(
                [l for l in (gw.playlist("room") or "").splitlines()
                 if l.startswith("#EXTINF")]
            ) >= 2:
                break
            time.sleep(0.05)
        pub.close()
        pl = gw.playlist("room")
        assert pl is not None and pl.count("#EXTINF") >= 2, pl
        seq = int(
            next(l for l in pl.splitlines() if l.endswith(".ts"))
            .split("seg")[1]
            .split(".")[0]
        )
        ts_bytes = gw.segment("room", seq)
        assert ts_bytes and len(ts_bytes) % TS_PACKET_SIZE == 0
        pkts = split_packets(ts_bytes)
        assert pkt_pid(pkts[0]) == TS_PID_PAT
        # the FLV archive of the same stream round-trips through FlvReader
        flv = gw.flv_snapshot("room")
        r = FlvReader()
        r.feed(flv)
        tags = []
        while (t := r.read()) is not None:
            tags.append(t)
        assert len(tags) >= 70, len(tags)  # seq header + 75 frames
        assert tags[0][0] == FLV_TAG_VIDEO and tags[0][2] == _avc_seq_header()
    finally:
        srv.stop()


def test_media_gateway_bounded_streams():
    """Unique-name churn must not grow memory forever (review finding):
    the registry caps at max_streams with LRU eviction; drop() forgets."""
    from incubator_brpc_tpu_torch.protocols.media_gateway import MediaGatewayService

    gw = MediaGatewayService(max_streams=4)
    for i in range(10):
        gw.on_message_probe = None  # no-op attr; feed via on_frame
        gw.on_frame(f"s{i}", RtmpMessage(MSG_AUDIO, 1, 0, _aac_seq_header()))
    assert len(gw.streams()) == 4
    assert "s9" in gw.streams() and "s0" not in gw.streams()
    gw.drop("s9")
    assert "s9" not in gw.streams()


def test_flv_writer_rejects_oversized_tag():
    w = FlvWriter()
    with pytest.raises(ValueError):
        w.write_tag(FLV_TAG_VIDEO, 0, b"x" * (0xFFFFFF + 1))


def test_adts_rejects_oversized_and_reserved():
    asc = bytes([0b00010_010, 0b0_0010_000])
    with pytest.raises(ValueError):
        adts_header(asc, 0x2000)
    bad_asc = bytes([0b00010_111, 0b1_0010_000])  # rate index 15
    with pytest.raises(ValueError):
        adts_header(bad_asc, 100)


def test_hls_audio_only_pmt_declares_audio_pcr():
    """Audio-only segments must not declare a phantom video stream nor
    point PCR_PID at the silent video pid (review finding)."""
    seg = HlsSegmenter(target_duration_s=1.0)
    seg.on_message(RtmpMessage(MSG_AUDIO, 1, 0, _aac_seq_header()))
    seg.on_message(RtmpMessage(MSG_AUDIO, 1, 10, _aac_frame(b"Z" * 8)))
    seg.finish_segment(20)
    pkts = split_packets(bytes(seg.segments[0].data))
    pmt = next(p for p in pkts if pkt_pid(p) == TS_PID_PMT)
    sec_len = struct.unpack(">H", pmt[6:8])[0] & 0x0FFF
    sec = pmt[5 : 5 + 3 + sec_len]
    body = sec[8:-4]
    assert struct.unpack(">H", body[0:2])[0] & 0x1FFF == TS_PID_AUDIO
    es = body[4:]
    assert es[0] == TS_STREAM_AUDIO_AAC
    assert TS_STREAM_VIDEO_H264 not in (es[0],), "phantom video stream"
    assert len(es) == 5, "exactly one elementary stream expected"


def test_hls_late_audio_header_forces_segment_cut():
    """AAC sequence header arriving after video started a segment must
    not leave audio PES on an undeclared pid (review finding): the
    segmenter cuts, and the next segment's PMT declares both."""
    seg = HlsSegmenter(target_duration_s=60.0)  # no duration cuts
    seg.on_message(RtmpMessage(MSG_VIDEO, 1, 0, _avc_seq_header()))
    nal = b"\x65" + b"KEY1"
    seg.on_message(RtmpMessage(MSG_VIDEO, 1, 0, _video_frame(True, nal)))
    # audio config + frame arrive late
    seg.on_message(RtmpMessage(MSG_AUDIO, 1, 100, _aac_seq_header()))
    seg.on_message(RtmpMessage(MSG_AUDIO, 1, 100, _aac_frame(b"A" * 16)))
    seg.on_message(
        RtmpMessage(MSG_VIDEO, 1, 140, _video_frame(False, b"\x41inter"))
    )
    seg.finish_segment(200)
    assert len(seg.segments) == 2
    first, second = seg.segments
    first_pids = {pkt_pid(p) for p in split_packets(bytes(first.data))}
    assert TS_PID_AUDIO not in first_pids, "audio leaked into video-only PMT"
    pkts2 = split_packets(bytes(second.data))
    pids2 = {pkt_pid(p) for p in pkts2}
    assert TS_PID_AUDIO in pids2 and TS_PID_VIDEO in pids2
    pmt = next(p for p in pkts2 if pkt_pid(p) == TS_PID_PMT)
    sec_len = struct.unpack(">H", pmt[6:8])[0] & 0x0FFF
    es = pmt[5 : 5 + 3 + sec_len][8:-4][4:]
    kinds = {es[i] for i in range(0, len(es), 5)}
    assert kinds == {TS_STREAM_VIDEO_H264, TS_STREAM_AUDIO_AAC}


# ---------------------------------------------------------------------------
# the JAX package as the oracle: one seeded synthetic stream, both remuxes
# ---------------------------------------------------------------------------


def synthetic_stream(rtmp_mod, seed, seconds=4.0):
    """A seeded synthetic A/V stream as RTMP messages of one package:
    onMetaData, the AVC and AAC sequence headers, then 25 fps H.264
    frames (a keyframe every second, NALs of random size and content)
    and an AAC frame every 23 ms, interleaved by timestamp; the last
    frames carry timestamps past 24 bits."""
    import numpy as np

    rng = np.random.RandomState(seed)
    msgs = [
        rtmp_mod.RtmpMessage(rtmp_mod.MSG_DATA_AMF0, 1, 0, rtmp_mod.amf0_encode(
            "onMetaData", {"width": 640.0, "height": 360.0, "framerate": 25.0})),
        rtmp_mod.RtmpMessage(MSG_VIDEO, 1, 0, _avc_seq_header()),
        rtmp_mod.RtmpMessage(MSG_AUDIO, 1, 0, _aac_seq_header()),
    ]
    frames = []
    for i, ms in enumerate(range(0, int(seconds * 1000), 40)):
        key = i % 25 == 0
        nal = (b"\x65" if key else b"\x41") + rng.randint(0, 256, int(rng.randint(20, 3000))).astype(np.uint8).tobytes()
        frames.append((ms, 0, MSG_VIDEO, _video_frame(key, nal)))
    for j, ms in enumerate(range(0, int(seconds * 1000), 23)):
        frames.append((ms, 1, MSG_AUDIO, _aac_frame(rng.randint(0, 256, int(rng.randint(8, 400))).astype(np.uint8).tobytes())))
    frames.sort()
    msgs += [rtmp_mod.RtmpMessage(t, 1, ms, body) for ms, _, t, body in frames]
    late = 0xFFFFFF + 17
    msgs.append(rtmp_mod.RtmpMessage(MSG_VIDEO, 1, late, _video_frame(True, b"\x65tail")))
    msgs.append(rtmp_mod.RtmpMessage(MSG_AUDIO, 1, late + 5, _aac_frame(b"tail")))
    return msgs


def remux(pkg, seed):
    """One package's FLV archive and HLS segments of the stream, and the
    stream's message count."""
    import importlib

    rtmp_mod = importlib.import_module(f"{pkg}.protocols.rtmp")
    flv_mod = importlib.import_module(f"{pkg}.protocols.flv")
    ts_mod = importlib.import_module(f"{pkg}.protocols.ts")
    msgs = synthetic_stream(rtmp_mod, seed)
    w = flv_mod.FlvWriter()
    seg = ts_mod.HlsSegmenter(target_duration_s=1.0, window=16)
    for m in msgs[:-2]:
        w.write_message(m)
        seg.on_message(m)
    seg.finish_segment(msgs[-3].timestamp + 40)
    for m in msgs[-2:]:
        w.write_message(m)
    segments = [(s.seq, s.duration_s, bytes(s.data)) for s in seg.segments]
    return w.getvalue(), segments, seg.playlist(end=True), len(msgs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flv_and_hls_remux_bytes_equal_the_jax_packages(seed):
    port_flv, port_segs, port_pl, n = remux("incubator_brpc_tpu_torch", seed)
    ref_flv, ref_segs, ref_pl, _ = remux("incubator_brpc_tpu", seed)
    assert port_flv == ref_flv
    assert port_segs == ref_segs and port_pl == ref_pl
    assert len(port_segs) == 4
    # and the bytes read back: every FLV tag, a PAT/PMT head per segment
    r = FlvReader()
    r.feed(port_flv)
    tags = []
    while (t := r.read()) is not None:
        tags.append(t)
    assert len(tags) == n
    for _, _, data in port_segs:
        pkts = split_packets(data)
        assert pkt_pid(pkts[0]) == TS_PID_PAT and pkt_pid(pkts[1]) == TS_PID_PMT
