"""MPEG-TS muxer + HLS segmenter — the HTTP-Live-Streaming half of the
media stack.

Analog of reference ts.{h,cpp} (SRS-derived TsPacket/TsChannelGroup/
TsWriter: PAT/PMT tables, PES encapsulation with PTS/DTS, PCR on
keyframes, 188-byte packets with continuity counters and stuffing) plus
the hls segment cutting its users build on top.  Same wire constants:
sync 0x47, PAT pid 0x0000, PMT pid 0x1001 (ts.cpp TS_PID_PMT), video
pid 0x0100 / audio pid 0x0101, stream types H264=0x1B AAC=0x0F
(ts.h Table 2-29), program/PMT number 1.

Input is the RTMP/FLV media model (protocols/rtmp.py RtmpMessage whose
payloads carry FLV VideoTagHeader/AudioTagHeader): the muxer performs
the same remux steps as the reference —

- H.264: AVCDecoderConfigurationRecord (AVC sequence header) supplies
  SPS/PPS + NALU length size; length-prefixed AVCC NALUs convert to
  AnnexB start codes, SPS/PPS re-injected before every keyframe.
- AAC: AudioSpecificConfig (AAC sequence header) supplies
  profile/rate/channels; every raw frame gets an ADTS header.
- PTS = (timestamp + composition_time) * 90, DTS = timestamp * 90
  (90 kHz clock); PCR rides the keyframe's first TS packet.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

from incubator_brpc_tpu_torch.protocols.rtmp import MSG_AUDIO, MSG_VIDEO, RtmpMessage

TS_PACKET_SIZE = 188
TS_SYNC_BYTE = 0x47
TS_PID_PAT = 0x0000
TS_PID_PMT = 0x1001
TS_PID_VIDEO = 0x0100
TS_PID_AUDIO = 0x0101
TS_PMT_NUMBER = 1
TS_STREAM_VIDEO_H264 = 0x1B
TS_STREAM_AUDIO_AAC = 0x0F

_PES_VIDEO_SID = 0xE0
_PES_AUDIO_SID = 0xC0

# ADTS sampling_frequency_index table (ISO 14496-3)
_ADTS_RATES = [
    96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
    16000, 12000, 11025, 8000, 7350,
]


def crc32_mpeg(data: bytes) -> int:
    """CRC-32/MPEG-2 over PSI sections (poly 0x04C11DB7, init all-ones,
    MSB-first, no reflection, no final xor) — ts.cpp crc32 table."""
    crc = 0xFFFFFFFF
    for b in data:
        crc ^= b << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7 if crc & 0x80000000 else crc << 1)
            crc &= 0xFFFFFFFF
    return crc


def _psi_packet(pid: int, table: bytes, cc: int) -> bytes:
    """One TS packet carrying a PSI section (PAT/PMT): pointer_field 0,
    section, then 0xFF stuffing to 188 bytes."""
    out = bytearray()
    out.append(TS_SYNC_BYTE)
    out += struct.pack(">H", 0x4000 | (pid & 0x1FFF))  # PUSI=1
    out.append(0x10 | (cc & 0x0F))  # payload only
    out.append(0x00)  # pointer_field
    out += table
    out += b"\xff" * (TS_PACKET_SIZE - len(out))
    return bytes(out)


def build_pat(cc: int = 0) -> bytes:
    """PAT: program TS_PMT_NUMBER → TS_PID_PMT (ts.cpp CreateAsPAT)."""
    body = struct.pack(">HH", TS_PMT_NUMBER, 0xE000 | TS_PID_PMT)
    return _finish_section(0x00, body, TS_PID_PAT, cc)


def build_pmt(cc: int = 0, has_video: bool = True, has_audio: bool = True) -> bytes:
    """PMT listing the H264/AAC elementary streams; PCR rides the video
    pid when present, else audio (ts.cpp CreateAsPMT:408-416)."""
    pcr_pid = TS_PID_VIDEO if has_video else TS_PID_AUDIO
    body = bytearray()
    body += struct.pack(">H", 0xE000 | pcr_pid)
    body += struct.pack(">H", 0xF000)  # program_info_length 0
    if has_video:
        body.append(TS_STREAM_VIDEO_H264)
        body += struct.pack(">HH", 0xE000 | TS_PID_VIDEO, 0xF000)
    if has_audio:
        body.append(TS_STREAM_AUDIO_AAC)
        body += struct.pack(">HH", 0xE000 | TS_PID_AUDIO, 0xF000)
    return _finish_section(0x02, bytes(body), TS_PID_PMT, cc)


def _finish_section(table_id: int, body: bytes, pid: int, cc: int) -> bytes:
    """Wrap a PSI body: header (id/length/number/version/sections) +
    CRC-32/MPEG, then packetize."""
    inner = struct.pack(">HBB", TS_PMT_NUMBER if table_id == 0x02 else 1,
                        0xC1, 0x00) + b"\x00" + body
    # section_length = inner + crc
    sec = bytearray([table_id])
    sec += struct.pack(">H", 0xB000 | (len(inner) + 4))
    sec += inner
    sec += struct.pack(">I", crc32_mpeg(bytes(sec)))
    return _psi_packet(pid, bytes(sec), cc)


def _pes_header(stream_id: int, pts: int, dts: Optional[int],
                payload_len: int) -> bytes:
    """PES packet header with PTS (and DTS when it differs)."""
    flags = 0x80 if dts is None or dts == pts else 0xC0
    hdr_data_len = 5 if flags == 0x80 else 10
    # PES_packet_length: 0 allowed (unbounded) for video; exact for audio
    total = 3 + hdr_data_len + payload_len
    pes_len = 0 if stream_id == _PES_VIDEO_SID and total > 0xFFFF else total
    out = bytearray(b"\x00\x00\x01")
    out.append(stream_id)
    out += struct.pack(">H", pes_len)
    out.append(0x80)  # marker bits
    out.append(flags)
    out.append(hdr_data_len)
    out += _encode_timestamp(pts, 0x2 if flags == 0x80 else 0x3)
    if flags == 0xC0:
        out += _encode_timestamp(dts, 0x1)
    return bytes(out)


def _encode_timestamp(ts: int, prefix: int) -> bytes:
    ts &= (1 << 33) - 1
    return bytes(
        [
            (prefix << 4) | (((ts >> 30) & 0x7) << 1) | 1,
            (ts >> 22) & 0xFF,
            (((ts >> 15) & 0x7F) << 1) | 1,
            (ts >> 7) & 0xFF,
            ((ts & 0x7F) << 1) | 1,
        ]
    )


class TsMuxer:
    """Packetize PES payloads into 188-byte TS packets.  Stateful per
    output stream: continuity counters per pid, PAT/PMT emitted at each
    segment start (TsChannelGroup analog)."""

    def __init__(self, has_video: bool = True, has_audio: bool = True):
        self._cc: Dict[int, int] = {}
        self.has_video = has_video
        self.has_audio = has_audio

    def _next_cc(self, pid: int) -> int:
        cc = self._cc.get(pid, 0)
        self._cc[pid] = (cc + 1) & 0x0F
        return cc

    def psi(self, has_video: Optional[bool] = None,
            has_audio: Optional[bool] = None) -> bytes:
        """PAT + PMT pair (segment preamble).  The flags may be decided
        per segment: a PMT declaring a phantom stream would point
        PCR_PID at a pid that never carries packets (strict demuxers
        then never clock-sync)."""
        hv = self.has_video if has_video is None else has_video
        ha = self.has_audio if has_audio is None else has_audio
        return build_pat(self._next_cc(TS_PID_PAT)) + build_pmt(
            self._next_cc(TS_PID_PMT), hv, ha
        )

    def mux_pes(self, pid: int, stream_id: int, pts: int,
                dts: Optional[int], es: bytes, pcr: Optional[int] = None) -> bytes:
        """One PES packet → N TS packets (write_pes analog,
        ts.cpp:424-...): PUSI on the first, PCR adaptation field if
        given, stuffing via adaptation field on the tail."""
        data = _pes_header(stream_id, pts, dts, len(es)) + es
        out = bytearray()
        pos = 0
        first = True
        n = len(data)
        while pos < n:
            header = bytearray()
            header.append(TS_SYNC_BYTE)
            header += struct.pack(
                ">H", (0x4000 if first else 0) | (pid & 0x1FFF)
            )
            remain = n - pos
            af = bytearray()
            want_pcr = first and pcr is not None
            space = TS_PACKET_SIZE - 4
            if want_pcr:
                base = pcr & ((1 << 33) - 1)
                af_body = bytearray([0x10])  # PCR flag
                af_body += bytes(
                    [
                        (base >> 25) & 0xFF,
                        (base >> 17) & 0xFF,
                        (base >> 9) & 0xFF,
                        (base >> 1) & 0xFF,
                        ((base & 1) << 7) | 0x7E,  # ext high bits
                        0x00,  # ext low
                    ]
                )
                af = bytearray([len(af_body)]) + af_body
                space -= len(af)
            if remain < space:
                # stuff through the adaptation field to fill 188
                pad = space - remain
                if not af:
                    if pad == 1:
                        af = bytearray([0x00])  # af_length=0 (one byte)
                        pad = 0
                    else:
                        af = bytearray([1, 0x00])  # length + flags
                        pad -= 2
                af += b"\xff" * pad
                if len(af) >= 2:
                    af[0] = len(af) - 1
                space = remain
            header.append(
                (0x30 if af else 0x10) | self._next_cc(pid)
            )
            out += header
            out += af
            out += data[pos : pos + space]
            pos += space
            first = False
        return bytes(out)


class _AvcConfig:
    """Parsed AVCDecoderConfigurationRecord (ISO 14496-15)."""

    def __init__(self, record: bytes):
        if len(record) < 7:
            raise ValueError("short avcC record")
        self.nalu_len_size = (record[4] & 0x03) + 1
        self.sps: List[bytes] = []
        self.pps: List[bytes] = []
        pos = 5
        nsps = record[pos] & 0x1F
        pos += 1
        for _ in range(nsps):
            (ln,) = struct.unpack_from(">H", record, pos)
            pos += 2
            self.sps.append(record[pos : pos + ln])
            pos += ln
        npps = record[pos]
        pos += 1
        for _ in range(npps):
            (ln,) = struct.unpack_from(">H", record, pos)
            pos += 2
            self.pps.append(record[pos : pos + ln])
            pos += ln


def avcc_to_annexb(data: bytes, nalu_len_size: int) -> bytes:
    """Length-prefixed AVCC NALUs → AnnexB start-code stream."""
    out = bytearray()
    pos = 0
    n = len(data)
    while pos + nalu_len_size <= n:
        ln = int.from_bytes(data[pos : pos + nalu_len_size], "big")
        pos += nalu_len_size
        if ln == 0 or pos + ln > n:
            break
        out += b"\x00\x00\x00\x01"
        out += data[pos : pos + ln]
        pos += ln
    return bytes(out)


def adts_header(asc: bytes, frame_len: int) -> bytes:
    """7-byte ADTS header from a 2-byte AudioSpecificConfig.  Raises
    ValueError for frames the 13-bit length field can't express and for
    reserved sampling-rate indices — silently wrapping either corrupts
    the whole elementary stream."""
    profile = (asc[0] >> 3) & 0x1F  # audioObjectType
    rate_idx = ((asc[0] & 0x07) << 1) | ((asc[1] >> 7) & 0x01)
    channels = (asc[1] >> 3) & 0x0F
    if rate_idx >= len(_ADTS_RATES):
        raise ValueError(f"reserved ADTS sampling index {rate_idx}")
    total = frame_len + 7
    if total > 0x1FFF:
        raise ValueError(f"AAC frame too large for ADTS: {frame_len}")
    hdr = bytearray(7)
    hdr[0] = 0xFF
    hdr[1] = 0xF1  # MPEG-4, no CRC
    hdr[2] = (((profile - 1) & 0x03) << 6) | ((rate_idx & 0x0F) << 2) | (
        (channels >> 2) & 0x01
    )
    hdr[3] = ((channels & 0x03) << 6) | ((total >> 11) & 0x03)
    hdr[4] = (total >> 3) & 0xFF
    hdr[5] = ((total & 0x07) << 5) | 0x1F
    hdr[6] = 0xFC
    return bytes(hdr)


class HlsSegment:
    def __init__(self, seq: int, first_ts_ms: int):
        self.seq = seq
        self.first_ts_ms = first_ts_ms
        self.last_ts_ms = first_ts_ms
        self.data = bytearray()
        # which elementary streams this segment's PMT declared (set at
        # PSI time); a frame of an undeclared kind forces a segment cut
        self.declared = (False, False)

    @property
    def duration_s(self) -> float:
        return max(0.0, (self.last_ts_ms - self.first_ts_ms) / 1000.0)


class HlsSegmenter:
    """RTMP media stream → rolling .ts segments + m3u8 playlist.

    Feed RtmpMessages (as delivered by the RTMP relay's on_frame);
    segments cut at video keyframes once ``target_duration_s`` is
    reached (audio-only streams cut on any frame).  Keeps the last
    ``window`` segments, live-HLS style."""

    def __init__(self, target_duration_s: float = 4.0, window: int = 5):
        self.target = target_duration_s
        self.window = window
        self.segments: List[HlsSegment] = []
        self._cur: Optional[HlsSegment] = None
        self._seq = 0
        self._mux = TsMuxer()
        self._avc: Optional[_AvcConfig] = None
        self._asc: Optional[bytes] = None

    # ---- ingest -------------------------------------------------------------
    def on_message(self, msg: RtmpMessage) -> None:
        if msg.type_id == MSG_VIDEO:
            self._on_video(msg.timestamp, msg.payload)
        elif msg.type_id == MSG_AUDIO:
            self._on_audio(msg.timestamp, msg.payload)

    def _on_video(self, ts_ms: int, payload: bytes) -> None:
        if len(payload) < 5:
            return
        frame_type = payload[0] >> 4
        codec = payload[0] & 0x0F
        if codec != 7:  # AVC only (reference hls path likewise)
            return
        pkt_type = payload[1]
        cts = int.from_bytes(payload[2:5], "big", signed=False)
        if cts & 0x800000:
            cts -= 1 << 24  # signed 24-bit composition offset
        body = payload[5:]
        if pkt_type == 0:  # AVC sequence header
            self._avc = _AvcConfig(body)
            return
        if pkt_type != 1 or self._avc is None:
            return
        keyframe = frame_type == 1
        annexb = avcc_to_annexb(body, self._avc.nalu_len_size)
        if keyframe:
            # re-inject SPS/PPS so every segment decodes standalone
            prefix = bytearray(b"\x00\x00\x00\x01\x09\xf0")  # AUD
            for nal in self._avc.sps + self._avc.pps:
                prefix += b"\x00\x00\x00\x01" + nal
            annexb = bytes(prefix) + annexb
        pts = (ts_ms + cts) * 90
        dts = ts_ms * 90
        self._cut_if_due(ts_ms, keyframe)
        self._ensure_declared(ts_ms, want_video=True)
        seg = self._segment(ts_ms)
        seg.data += self._mux.mux_pes(
            TS_PID_VIDEO, _PES_VIDEO_SID, pts, dts, annexb,
            pcr=dts if keyframe else None,
        )
        seg.last_ts_ms = max(seg.last_ts_ms, ts_ms)

    def _on_audio(self, ts_ms: int, payload: bytes) -> None:
        if len(payload) < 2:
            return
        fmt = payload[0] >> 4
        if fmt != 10:  # AAC only
            return
        if payload[1] == 0:  # AAC sequence header
            self._asc = payload[2:4]
            return
        if self._asc is None or len(self._asc) < 2:
            return
        frame = payload[2:]
        try:
            es = adts_header(self._asc, len(frame)) + frame
        except ValueError:
            return  # unframeable frame: drop it, keep the stream alive
        video_present = self._avc is not None
        if not video_present:
            self._cut_if_due(ts_ms, True)  # audio-only: cut anywhere
        self._ensure_declared(ts_ms, want_video=False)
        seg = self._segment(ts_ms)
        pts = ts_ms * 90
        seg.data += self._mux.mux_pes(
            TS_PID_AUDIO, _PES_AUDIO_SID, pts, None, es,
            pcr=None if video_present else pts,
        )
        seg.last_ts_ms = max(seg.last_ts_ms, ts_ms)

    # ---- segmentation -------------------------------------------------------
    def _segment(self, ts_ms: int) -> HlsSegment:
        if self._cur is None:
            hv = self._avc is not None
            ha = self._asc is not None
            self._cur = HlsSegment(self._seq, ts_ms)
            self._seq += 1
            # declare only the streams actually present (sequence
            # headers seen) so PCR_PID matches a live pid
            self._cur.data += self._mux.psi(has_video=hv, has_audio=ha)
            self._cur.declared = (hv, ha)
        return self._cur

    def _ensure_declared(self, ts_ms: int, want_video: bool) -> None:
        """A frame kind the open segment's PMT didn't declare (its
        sequence header arrived after the segment started) forces a cut:
        strict demuxers discard packets on undeclared pids, so the
        stream's first frames would silently vanish."""
        cur = self._cur
        if cur is None:
            return
        hv, ha = cur.declared
        if (want_video and not hv) or (not want_video and not ha):
            self.finish_segment(ts_ms)

    def _cut_if_due(self, ts_ms: int, at_boundary: bool) -> None:
        cur = self._cur
        if (
            cur is not None
            and at_boundary
            and ts_ms - cur.first_ts_ms >= self.target * 1000
        ):
            self.finish_segment(ts_ms)

    def finish_segment(self, ts_ms: Optional[int] = None) -> Optional[HlsSegment]:
        """Seal the open segment (stream end or keyframe cut)."""
        cur, self._cur = self._cur, None
        if cur is None:
            return None
        if ts_ms is not None:
            cur.last_ts_ms = max(cur.last_ts_ms, ts_ms)
        self.segments.append(cur)
        if len(self.segments) > self.window:
            del self.segments[: len(self.segments) - self.window]
        return cur

    # ---- playlist -----------------------------------------------------------
    def playlist(self, uri_prefix: str = "", end: bool = False) -> str:
        """m3u8 media playlist over the current window."""
        segs = self.segments
        target = max(
            [int(s.duration_s + 0.999) for s in segs] + [int(self.target)]
        )
        lines = [
            "#EXTM3U",
            "#EXT-X-VERSION:3",
            f"#EXT-X-TARGETDURATION:{target}",
            f"#EXT-X-MEDIA-SEQUENCE:{segs[0].seq if segs else 0}",
        ]
        for s in segs:
            lines.append(f"#EXTINF:{s.duration_s:.3f},")
            lines.append(f"{uri_prefix}seg{s.seq}.ts")
        if end:
            lines.append("#EXT-X-ENDLIST")
        return "\n".join(lines) + "\n"
