"""FLV remux — tag writer/reader over the RTMP message layer.

Analog of reference FlvWriter/FlvReader (rtmp.h:379-460, implementation
in rtmp.cpp): RTMP audio/video/script-data messages and an FLV byte
stream are trivially interconvertible — an FLV file is a 9-byte header
followed by (11-byte tag header + payload + u32 previous-tag-size)
records whose type/timestamp/payload map 1:1 onto RtmpMessage fields.

Wire layout (Adobe FLV spec v10.1, annex E):

    header:  "FLV" u8(version=1) u8(flags) u32(header_size=9)
             u32(previous_tag_size0 = 0)
    tag:     u8(type) u24(data_size) u24(timestamp) u8(timestamp_ext)
             u24(stream_id = 0) data  u32(previous_tag_size = 11 + size)

The reader mirrors the reference's EAGAIN contract: ``read()`` returns
None when the buffer holds no complete tag yet (wait for more bytes and
call again), and raises ValueError on structural corruption.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

from incubator_brpc_tpu_torch.protocols.rtmp import (
    MSG_AUDIO,
    MSG_DATA_AMF0,
    MSG_VIDEO,
    RtmpMessage,
)

# FlvHeaderFlags (rtmp.h:379-383)
FLV_CONTENT_VIDEO = 0x01
FLV_CONTENT_AUDIO = 0x04
FLV_CONTENT_AUDIO_AND_VIDEO = 0x05

# FlvTagType (rtmp.h:395-399) — identical to the RTMP message type ids
FLV_TAG_AUDIO = 8
FLV_TAG_VIDEO = 9
FLV_TAG_SCRIPT_DATA = 18

_HEADER_SIZE = 9
_TAG_HEADER = 11


class FlvWriter:
    """Append RTMP messages to a growing FLV byte stream.  The 9-byte
    file header is emitted before the first tag (FlvWriter ctor writes
    it lazily in the reference too — _write_header flag)."""

    def __init__(self, content_type: int = FLV_CONTENT_AUDIO_AND_VIDEO):
        self._content_type = content_type
        self._header_written = False
        self._out = bytearray()

    def write_message(self, msg: RtmpMessage) -> None:
        """Append an RTMP audio/video/script message as one FLV tag."""
        if msg.type_id not in (MSG_AUDIO, MSG_VIDEO, MSG_DATA_AMF0):
            raise ValueError(f"not an FLV-taggable message: {msg.type_id}")
        self.write_tag(msg.type_id, msg.timestamp, msg.payload)

    def write_tag(self, tag_type: int, timestamp: int, payload: bytes) -> None:
        if len(payload) > 0xFFFFFF:
            # u24 data_size: silently truncating would desync every
            # following tag (previous_tag_size is 32-bit and would lie)
            raise ValueError(f"FLV tag payload too large: {len(payload)}")
        if not self._header_written:
            self._header_written = True
            self._out += b"FLV\x01"
            self._out.append(self._content_type)
            self._out += struct.pack(">I", _HEADER_SIZE)
            self._out += struct.pack(">I", 0)  # previous_tag_size0
        ts = timestamp & 0xFFFFFFFF
        self._out.append(tag_type)
        self._out += struct.pack(">I", len(payload))[1:]  # u24 size
        self._out += struct.pack(">I", ts & 0xFFFFFF)[1:]  # u24 ts low
        self._out.append((ts >> 24) & 0xFF)  # ts extension
        self._out += b"\x00\x00\x00"  # stream id
        self._out += payload
        self._out += struct.pack(">I", _TAG_HEADER + len(payload))

    def take(self) -> bytes:
        """Drain everything written so far (progressive-download body
        chunks ride this)."""
        out, self._out = bytes(self._out), bytearray()
        return out

    def getvalue(self) -> bytes:
        return bytes(self._out)


class FlvReader:
    """Incremental FLV parser; feed() bytes, read() complete tags."""

    def __init__(self):
        self._buf = bytearray()
        self._header_parsed = False
        self.content_type = 0

    def feed(self, data: bytes) -> None:
        self._buf += data

    def peek_type(self) -> Optional[int]:
        """Next tag's type, or None until one is buffered (the
        reference's PeekMessageType EAGAIN contract)."""
        if not self._ensure_header():
            return None
        if len(self._buf) < 1:
            return None
        t = self._buf[0]
        if t not in (FLV_TAG_AUDIO, FLV_TAG_VIDEO, FLV_TAG_SCRIPT_DATA):
            raise ValueError(f"bad FLV tag type {t}")
        return t

    def read(self) -> Optional[Tuple[int, int, bytes]]:
        """→ (tag_type, timestamp_ms, payload) or None if incomplete."""
        t = self.peek_type()  # validates type byte + header
        if t is None or len(self._buf) < _TAG_HEADER:
            return None
        size = int.from_bytes(self._buf[1:4], "big")
        total = _TAG_HEADER + size + 4  # + previous_tag_size
        if len(self._buf) < total:
            return None
        ts = int.from_bytes(self._buf[4:7], "big") | (self._buf[7] << 24)
        payload = bytes(self._buf[_TAG_HEADER : _TAG_HEADER + size])
        prev = int.from_bytes(self._buf[total - 4 : total], "big")
        if prev != _TAG_HEADER + size:
            raise ValueError(f"bad previous_tag_size {prev}")
        del self._buf[:total]
        return t, ts, payload

    def read_message(self) -> Optional[RtmpMessage]:
        got = self.read()
        if got is None:
            return None
        t, ts, payload = got
        return RtmpMessage(t, 1, ts, payload)

    def _ensure_header(self) -> bool:
        if self._header_parsed:
            return True
        if len(self._buf) < _HEADER_SIZE + 4:
            return False
        if self._buf[:3] != b"FLV" or self._buf[3] != 1:
            raise ValueError("not an FLV stream")
        hdr_size = struct.unpack_from(">I", self._buf, 5)[0]
        if hdr_size < _HEADER_SIZE:
            raise ValueError(f"bad FLV header size {hdr_size}")
        if len(self._buf) < hdr_size + 4:
            return False
        self.content_type = self._buf[4]
        del self._buf[: hdr_size + 4]
        self._header_parsed = True
        return True
