"""Streaming RPC wire protocol — frames multiplexed on the RPC socket.

Analog of reference policy/streaming_rpc_protocol.cpp (:61-165):
after a stream is negotiated inside a normal RPC (stream_settings in
RpcMeta, baidu_rpc_protocol.cpp:212-264), DATA/FEEDBACK/RST/CLOSE
frames ride the same connection and are routed to the Stream by id.

Framing: b"TSTM" + stream_id(u64 BE) + frame_type(u8) + size(u32 BE)
+ payload. Over the ICI transport the payload IOBuf may carry device
segments — chunked ring-style neighbor exchange of HBM tensors uses
exactly this path (the fabric's staging-ring pipeline chunks them;
see docs/streaming.md).  Host payloads larger than the shared wire
chunk are split by the Stream into DATA_PART frames closed by one
DATA frame, so message boundaries survive segmentation.
"""

from __future__ import annotations

import struct

from incubator_brpc_tpu_torch.protocols import ParseResult, Protocol, register_protocol
from incubator_brpc_tpu_torch.utils.iobuf import IOBuf

MAGIC = b"TSTM"
HEADER_SIZE = 17

FRAME_DATA = 0
FRAME_RST = 1
FRAME_CLOSE = 2
FRAME_FEEDBACK = 3  # payload: consumed bytes (u64 BE)
FRAME_HALF_CLOSE = 4  # sender finished writing; still reads
FRAME_DATA_PART = 5  # one chunk of a segmented message (DATA closes it)

_VALID_FRAME_TYPES = frozenset(
    (FRAME_DATA, FRAME_RST, FRAME_CLOSE, FRAME_FEEDBACK,
     FRAME_HALF_CLOSE, FRAME_DATA_PART)
)

FRAME_NAMES = {
    FRAME_DATA: "data",
    FRAME_RST: "rst",
    FRAME_CLOSE: "close",
    FRAME_FEEDBACK: "feedback",
    FRAME_HALF_CLOSE: "half_close",
    FRAME_DATA_PART: "data_part",
}

# wire-controlled length guard: a frame bigger than this is framing
# corruption, not a legitimate message (bulk device payloads ride the
# fabric's own chunking, host payloads are segmented into wire chunks
# well below this)
MAX_FRAME_SIZE = 256 << 20


class StreamFrame:
    __slots__ = ("stream_id", "frame_type", "payload")

    def __init__(self, stream_id: int, frame_type: int, payload: IOBuf):
        self.stream_id = stream_id
        self.frame_type = frame_type
        self.payload = payload


def pack_frame(stream_id: int, frame_type: int, payload=None) -> IOBuf:
    payload = payload if payload is not None else IOBuf()
    out = IOBuf()
    out.append(MAGIC + struct.pack(">QBI", stream_id, frame_type, len(payload)))
    out.append(payload)
    return out


def parse(buf: IOBuf, sock, read_eof: bool) -> ParseResult:
    header = buf.fetch(HEADER_SIZE)
    if header is None:
        # fewer than HEADER_SIZE bytes buffered: claim the connection
        # only when what we have is consistent with our magic
        got = buf.fetch(min(len(buf), len(MAGIC))) or b""
        if len(got) < len(MAGIC):
            # partial prefix: b"TS" may still become b"TSTM"
            if MAGIC.startswith(got):
                return ParseResult.not_enough()
            return ParseResult.try_others()
        if got == MAGIC:
            return ParseResult.not_enough()
        return ParseResult.try_others()
    if header[:4] != MAGIC:
        return ParseResult.try_others()
    stream_id, frame_type, size = struct.unpack_from(">QBI", header, 4)
    # wire-controlled fields are validated before any allocation uses
    # them: an alien type byte or an absurd length is corruption — kill
    # the connection rather than stall waiting for 4GB that never comes
    if frame_type not in _VALID_FRAME_TYPES:
        return ParseResult.bad()
    if size > MAX_FRAME_SIZE:
        return ParseResult.bad()
    if len(buf) < HEADER_SIZE + size:
        return ParseResult.not_enough()
    buf.pop_front(HEADER_SIZE)
    payload = IOBuf()
    buf.cutn(payload, size)
    return ParseResult.ok(StreamFrame(stream_id, frame_type, payload))


def process_frame(msg: StreamFrame, sock) -> None:
    """Route the frame to the Stream registered on this socket
    (ParseStreamingMessage routing, streaming_rpc_protocol.cpp:61)."""
    stream = sock.stream_map.get(msg.stream_id)
    if stream is None:
        if msg.frame_type in (FRAME_DATA, FRAME_DATA_PART):
            # unknown stream: tell the peer to stop (SendStreamRst).
            # The wire carries no source id, so the only address we can
            # answer with is the one the DATA arrived under — which is
            # the SENDER's remote_stream_id, not its own id.
            sock.write(pack_frame(msg.stream_id, FRAME_RST))
        elif msg.frame_type == FRAME_RST:
            # …which is why an RST that misses the map by id is matched
            # by remote id: the sender registered itself under its OWN
            # id, and this RST is addressed with the id IT sends under
            for s in list(sock.stream_map.values()):
                if s.remote_stream_id == msg.stream_id:
                    s.on_frame(msg)
                    return
        return
    stream.on_frame(msg)


PROTOCOL = Protocol(
    name="streaming_rpc",
    parse=parse,
    process_request=process_frame,
    process_response=process_frame,
    support_client=True,
    support_server=True,
    process_in_place=True,
)


def register():
    register_protocol(PROTOCOL)
