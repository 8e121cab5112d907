"""RTMP — real-time media streaming protocol (client + server).

Analog of reference policy/rtmp_protocol.cpp + rtmp.{h,cpp} (~9k LoC;
SURVEY §2.5): the functional core of RTMP 1.0 —

  * plain handshake (C0/C1/C2 ↔ S0/S1/S2),
  * the chunk stream layer (basic-header formats 0-3, extended
    timestamps, Set Chunk Size both directions),
  * AMF0 (number/bool/string/object/null/ecma-array/strict-array),
  * protocol control + user-control (Stream Begin) messages,
  * NetConnection/NetStream commands: connect, createStream, publish,
    play, deleteStream/closeStream with _result/onStatus replies,
  * audio/video/data message relay from each publisher to the players
    of the same stream name (the media fan-out the reference's
    RtmpService provides).

Server side rides the shared transport: the parse chain recognizes the
0x03 handshake byte, so one port speaks RTMP alongside every other
protocol. User surface mirrors the reference's RtmpService hooks:
subclass RtmpService (on_publish/on_play/on_frame) and register via
ServerOptions.rtmp_service. The client is a standalone RtmpClient
(RTMP is stateful; it does not map onto request/response channels).
"""

from __future__ import annotations

import io
import os
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.protocols import ParseResult, Protocol, register_protocol
from incubator_brpc_tpu_torch.utils.iobuf import IOBuf
from incubator_brpc_tpu_torch.utils.logging import log_error, log_verbose

HANDSHAKE_SIZE = 1536
DEFAULT_CHUNK_SIZE = 128

# ---------------------------------------------------------------------------
# complex ("digested") handshake — reference policy/rtmp_protocol.cpp:149-533
# (C1S1Base/DigestBlock/KeyBlock + details/rtmp_utils DH).  Flash-era
# clients send a C1 carrying an HMAC-SHA256 digest and a Diffie-Hellman
# public key; servers must answer with a digested S1 (FMS key) and an
# S2 proving possession of C1's digest, or those clients disconnect.
# The key/digest constants are the public Adobe handshake constants
# every RTMP implementation ships.
# ---------------------------------------------------------------------------

import hashlib as _hashlib
import hmac as _hmaclib

_HS_FMS_KEY = (
    b"Genuine Adobe Flash Media Server 001"
    + bytes.fromhex(
        "f0eec24a8068bee82e00d0d1029e7e576eec5d2d29806fab93b8e636cfeb31ae"
    )
)  # 68 bytes
_HS_FP_KEY = (
    b"Genuine Adobe Flash Player 001"
    + bytes.fromhex(
        "f0eec24a8068bee82e00d0d1029e7e576eec5d2d29806fab93b8e636cfeb31ae"
    )
)  # 62 bytes
_HS_FP_VERSION = 0x80000702
_HS_FMS_VERSION = 0x01000504
# RFC 2409 second Oakley group (1024-bit MODP) — the RTMP handshake DH
_HS_DH_P = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE65381FFFFFFFFFFFFFFFF",
    16,
)
_HS_DH_G = 2


def _hs_digest_block_offset(blk: bytes) -> int:
    # digest block: offset(4) | random | digest(32) | random
    return (blk[0] + blk[1] + blk[2] + blk[3]) % (764 - 32 - 4)


def _hs_key_block_offset(blk: bytes) -> int:
    # key block: random | key(128) | random | offset(4 AT END)
    return (blk[760] + blk[761] + blk[762] + blk[763]) % (764 - 128 - 4)


def _hs_digest_slice(schema: int) -> int:
    """Byte offset of the digest BLOCK inside C1/S1 for a schema.
    Reference SCHEMA0 = key block first, SCHEMA1 = digest block first
    (rtmp_protocol.cpp C1S1Base::Save)."""
    return 8 + 764 if schema == 0 else 8


def _hs_extract_digest(c1s1: bytes, schema: int):
    """→ (digest_bytes, message_without_digest) for HMAC verification."""
    b0 = _hs_digest_slice(schema)
    blk = c1s1[b0 : b0 + 764]
    off = _hs_digest_block_offset(blk)
    dstart = b0 + 4 + off
    return c1s1[dstart : dstart + 32], c1s1[:dstart] + c1s1[dstart + 32 :]


def _hs_validate_c1(c1: bytes):
    """→ (schema, c1_digest) if C1 carries a valid FP digest, else
    (None, None) — plain-handshake clients land here."""
    for schema in (0, 1):
        digest, joined = _hs_extract_digest(c1, schema)
        calc = _hmaclib.new(_HS_FP_KEY[:30], joined, _hashlib.sha256).digest()
        if _hmaclib.compare_digest(calc, digest):
            return schema, digest
    return None, None


def _hs_client_dh_pub(c1: bytes, schema: int) -> int:
    k0 = 8 if schema == 0 else 8 + 764
    blk = c1[k0 : k0 + 764]
    off = _hs_key_block_offset(blk)
    return int.from_bytes(c1[k0 + off : k0 + off + 128], "big")


def _hs_build_s1s2(c1: bytes, schema: int, c1_digest: bytes):
    """Digested S1 (FMS[:36] digest, DH public key in the key block,
    same schema as C1) + S2 (random || HMAC(HMAC(FMS, c1_digest), random))."""
    body = bytearray(os.urandom(HANDSHAKE_SIZE))
    struct.pack_into(">II", body, 0, int(time.time()) & 0x7FFFFFFF,
                     _HS_FMS_VERSION)
    # key block: server DH public key at its offset
    k0 = 8 if schema == 0 else 8 + 764
    koff = _hs_key_block_offset(bytes(body[k0 : k0 + 764]))
    x = int.from_bytes(os.urandom(64), "big") | 1
    server_pub = pow(_HS_DH_G, x, _HS_DH_P)
    body[k0 + koff : k0 + koff + 128] = server_pub.to_bytes(128, "big")
    # digest block: compute over S1-without-digest with FMS[:36]
    b0 = _hs_digest_slice(schema)
    doff = _hs_digest_block_offset(bytes(body[b0 : b0 + 764]))
    dstart = b0 + 4 + doff
    joined = bytes(body[:dstart]) + bytes(body[dstart + 32 :])
    s1_digest = _hmaclib.new(
        _HS_FMS_KEY[:36], joined, _hashlib.sha256
    ).digest()
    body[dstart : dstart + 32] = s1_digest
    # S2: prove we saw C1's digest (C2S2Base::ComputeDigest)
    rand = os.urandom(HANDSHAKE_SIZE - 32)
    temp_key = _hmaclib.new(_HS_FMS_KEY, c1_digest, _hashlib.sha256).digest()
    s2_digest = _hmaclib.new(temp_key, rand, _hashlib.sha256).digest()
    return bytes(body), rand + s2_digest


def make_digested_c1(schema: int = 1) -> bytes:
    """Client-side digested C1 (FP key) — what a Flash-era client
    sends; used by RtmpClient's complex mode and the handshake tests."""
    body = bytearray(os.urandom(HANDSHAKE_SIZE))
    struct.pack_into(">II", body, 0, int(time.time()) & 0x7FFFFFFF,
                     _HS_FP_VERSION)
    k0 = 8 if schema == 0 else 8 + 764
    koff = _hs_key_block_offset(bytes(body[k0 : k0 + 764]))
    x = int.from_bytes(os.urandom(64), "big") | 1
    body[k0 + koff : k0 + koff + 128] = pow(
        _HS_DH_G, x, _HS_DH_P
    ).to_bytes(128, "big")
    b0 = _hs_digest_slice(schema)
    doff = _hs_digest_block_offset(bytes(body[b0 : b0 + 764]))
    dstart = b0 + 4 + doff
    joined = bytes(body[:dstart]) + bytes(body[dstart + 32 :])
    body[dstart : dstart + 32] = _hmaclib.new(
        _HS_FP_KEY[:30], joined, _hashlib.sha256
    ).digest()
    return bytes(body)
_OUT_CHUNK_SIZE = 4096

# message type ids
MSG_SET_CHUNK_SIZE = 1
MSG_ABORT = 2
MSG_ACK = 3
MSG_USER_CONTROL = 4
MSG_WINDOW_ACK_SIZE = 5
MSG_SET_PEER_BW = 6
MSG_AUDIO = 8
MSG_VIDEO = 9
MSG_DATA_AMF0 = 18
MSG_COMMAND_AMF0 = 20

_MEDIA_TYPES = (MSG_AUDIO, MSG_VIDEO, MSG_DATA_AMF0)


# ---------------------------------------------------------------------------
# AMF0
# ---------------------------------------------------------------------------
def amf0_encode(*values) -> bytes:
    out = bytearray()
    for v in values:
        _amf0_encode_one(out, v)
    return bytes(out)


def _amf0_encode_one(out: bytearray, v):
    if isinstance(v, bool):
        out += b"\x01" + (b"\x01" if v else b"\x00")
    elif isinstance(v, (int, float)):
        out += b"\x00" + struct.pack(">d", float(v))
    elif isinstance(v, str):
        raw = v.encode()
        out += b"\x02" + struct.pack(">H", len(raw)) + raw
    elif v is None:
        out += b"\x05"
    elif isinstance(v, dict):
        out += b"\x03"
        for k, val in v.items():
            raw = k.encode()
            out += struct.pack(">H", len(raw)) + raw
            _amf0_encode_one(out, val)
        out += b"\x00\x00\x09"
    elif isinstance(v, (list, tuple)):
        out += b"\x0a" + struct.pack(">I", len(v))
        for item in v:
            _amf0_encode_one(out, item)
    else:
        raise TypeError(f"amf0: unsupported {type(v)}")


def amf0_decode_all(data: bytes) -> List:
    vals = []
    pos = 0
    while pos < len(data):
        v, pos = _amf0_decode_one(data, pos)
        vals.append(v)
    return vals


def _amf0_decode_one(data: bytes, pos: int):
    marker = data[pos]
    pos += 1
    if marker == 0x00:
        return struct.unpack_from(">d", data, pos)[0], pos + 8
    if marker == 0x01:
        return data[pos] != 0, pos + 1
    if marker == 0x02:
        (n,) = struct.unpack_from(">H", data, pos)
        return data[pos + 2 : pos + 2 + n].decode("utf-8", "replace"), pos + 2 + n
    if marker in (0x03, 0x08):  # object / ecma array (skip count)
        if marker == 0x08:
            pos += 4
        obj = {}
        while True:
            (n,) = struct.unpack_from(">H", data, pos)
            pos += 2
            if n == 0 and data[pos] == 0x09:
                return obj, pos + 1
            key = data[pos : pos + n].decode("utf-8", "replace")
            pos += n
            obj[key], pos = _amf0_decode_one(data, pos)
    if marker == 0x05 or marker == 0x06:  # null / undefined
        return None, pos
    if marker == 0x0A:  # strict array
        (n,) = struct.unpack_from(">I", data, pos)
        pos += 4
        arr = []
        for _ in range(n):
            v, pos = _amf0_decode_one(data, pos)
            arr.append(v)
        return arr, pos
    raise ValueError(f"amf0: unsupported marker 0x{marker:02x}")


# ---------------------------------------------------------------------------
# chunk stream layer
# ---------------------------------------------------------------------------
class RtmpMessage:
    __slots__ = ("type_id", "stream_id", "timestamp", "payload")

    def __init__(self, type_id: int, stream_id: int, timestamp: int, payload: bytes):
        self.type_id = type_id
        self.stream_id = stream_id
        self.timestamp = timestamp
        self.payload = payload


class _CsState:
    """Per-chunk-stream header state (fmt 1-3 inherit prior values)."""

    __slots__ = ("timestamp", "ts_delta", "length", "type_id", "stream_id",
                 "partial", "has_ext")

    def __init__(self):
        self.timestamp = 0
        self.ts_delta = 0
        self.length = 0
        self.type_id = 0
        self.stream_id = 0
        self.partial = bytearray()
        self.has_ext = False  # fmt-3 continuations repeat the ext ts


class RtmpConn:
    """Per-socket RTMP state: handshake stage, chunk reassembly, and
    the negotiated chunk sizes (both directions)."""

    def __init__(self, is_server: bool):
        self.is_server = is_server
        self.stage = "hello"  # hello → ack → live
        self.in_chunk_size = DEFAULT_CHUNK_SIZE
        self.out_chunk_size = _OUT_CHUNK_SIZE
        self.cs: Dict[int, _CsState] = {}
        self.app = ""
        self.next_stream_id = 1
        # server-side roles on this connection
        self.publishing: Dict[int, str] = {}  # msg stream id → name
        self.playing: Dict[int, str] = {}
        self.out_lock = threading.Lock()
        self.sent_out_chunk_size = False


def _clamp_chunk_size(v: int) -> int:
    """RTMP requires 1 <= chunk size (and the wire caps at 0xFFFFFF);
    0 would make the parser consume headers forever without payload."""
    return max(1, min(v & 0x7FFFFFFF, 0xFFFFFF))


def pack_chunks(conn: RtmpConn, msg: RtmpMessage, csid: int = 3) -> bytes:
    """One message → fmt-0 chunk (+ fmt-3 continuations)."""
    out = bytearray()
    ts = msg.timestamp & 0x7FFFFFFF
    ext = ts >= 0xFFFFFF
    hdr_ts = 0xFFFFFF if ext else ts
    out += bytes([(0 << 6) | csid])
    out += struct.pack(">I", hdr_ts)[1:]  # 3 bytes
    out += struct.pack(">I", len(msg.payload))[1:]
    out += bytes([msg.type_id])
    out += struct.pack("<I", msg.stream_id)
    if ext:
        out += struct.pack(">I", ts)
    size = conn.out_chunk_size
    payload = msg.payload
    out += payload[:size]
    pos = size
    while pos < len(payload):
        out += bytes([(3 << 6) | csid])
        if ext:
            out += struct.pack(">I", ts)
        out += payload[pos : pos + size]
        pos += size
    return bytes(out)


def _cut_chunk(conn: RtmpConn, buf: IOBuf) -> Tuple[Optional[RtmpMessage], bool]:
    """Try to consume ONE chunk. → (complete_message|None, progressed)."""
    avail = len(buf)
    if avail < 1:
        return None, False
    first = buf.fetch(1)[0]
    fmt = first >> 6
    csid = first & 0x3F
    base = 1
    if csid == 0:
        if avail < 2:
            return None, False
        csid = 64 + buf.fetch(2)[1]
        base = 2
    elif csid == 1:
        if avail < 3:
            return None, False
        b = buf.fetch(3)
        csid = 64 + b[1] + (b[2] << 8)
        base = 3
    head_len = {0: 11, 1: 7, 2: 3, 3: 0}[fmt]
    need = base + head_len
    head = buf.fetch(need)
    if head is None:
        return None, False
    st = conn.cs.setdefault(csid, _CsState())
    p = base
    ext = False
    if fmt == 0:
        ts = int.from_bytes(head[p : p + 3], "big")
        st.length = int.from_bytes(head[p + 3 : p + 6], "big")
        st.type_id = head[p + 6]
        st.stream_id = struct.unpack_from("<I", head, p + 7)[0]
        ext = ts == 0xFFFFFF
        st.has_ext = ext
        if not ext:
            st.timestamp = ts
            st.ts_delta = 0
    elif fmt == 1:
        delta = int.from_bytes(head[p : p + 3], "big")
        st.length = int.from_bytes(head[p + 3 : p + 6], "big")
        st.type_id = head[p + 6]
        ext = delta == 0xFFFFFF
        st.has_ext = ext
        if not ext:
            st.ts_delta = delta
    elif fmt == 2:
        delta = int.from_bytes(head[p : p + 3], "big")
        ext = delta == 0xFFFFFF
        st.has_ext = ext
        if not ext:
            st.ts_delta = delta
    else:  # fmt 3: repeats the extended timestamp iff the message
        ext = st.has_ext  # opened with one (spec §5.3.1.3)
    if ext:
        ehead = buf.fetch(need + 4)
        if ehead is None:
            return None, False
        tsval = struct.unpack_from(">I", ehead, need)[0]
        if fmt == 0:
            st.timestamp = tsval
            st.ts_delta = 0
        elif fmt in (1, 2):
            st.ts_delta = tsval
        need += 4
    if st.length > 64 << 20:
        raise ValueError(f"rtmp message too large: {st.length}")
    remaining = st.length - len(st.partial)
    take = min(remaining, conn.in_chunk_size)
    total = need + take
    whole = buf.fetch(total)
    if whole is None:
        return None, False
    buf.pop_front(total)
    st.partial += whole[need:]
    if len(st.partial) < st.length:
        return None, True
    # message complete; fmt 1/2 advance the timestamp by their delta
    if fmt != 0:
        st.timestamp += st.ts_delta
    payload = bytes(st.partial)
    st.partial = bytearray()
    return RtmpMessage(st.type_id, st.stream_id, st.timestamp, payload), True


# ---------------------------------------------------------------------------
# parse (shared transport integration)
# ---------------------------------------------------------------------------
def parse(buf: IOBuf, sock, read_eof: bool) -> ParseResult:
    conn: Optional[RtmpConn] = getattr(sock, "_rtmp_conn", None)
    if conn is None:
        if not sock.is_server_side:
            return ParseResult.try_others()  # client uses RtmpClient
        head = buf.fetch(1)
        if head is None or head[0] != 0x03:
            return ParseResult.try_others()
        if len(buf) < 1 + HANDSHAKE_SIZE:
            return ParseResult.not_enough()
        # C0+C1 → reply S0+S1+S2.  A digested C1 (Flash-era "complex"
        # handshake) gets the digested S1/S2 it requires; plain C1s get
        # the simple echo handshake (reference tries digest first and
        # falls back, rtmp_protocol.cpp C1::Load)
        c0c1 = buf.fetch(1 + HANDSHAKE_SIZE)
        buf.pop_front(1 + HANDSHAKE_SIZE)
        c1 = c0c1[1:]
        schema, c1_digest = _hs_validate_c1(c1)
        if schema is not None:
            s1, s2 = _hs_build_s1s2(c1, schema, c1_digest)
            sock.write(IOBuf(b"\x03" + s1 + s2), ignore_eovercrowded=True)
        else:
            s1 = struct.pack(
                ">II", int(time.time()) & 0x7FFFFFFF, 0
            ) + os.urandom(HANDSHAKE_SIZE - 8)
            sock.write(IOBuf(b"\x03" + s1 + c1), ignore_eovercrowded=True)
        conn = RtmpConn(is_server=True)
        conn.stage = "ack"
        sock._rtmp_conn = conn
        return parse(buf, sock, read_eof)
    if conn.stage == "ack":
        if len(buf) < HANDSHAKE_SIZE:
            return ParseResult.not_enough()
        buf.pop_front(HANDSHAKE_SIZE)  # C2 (echo of S1) — accepted as-is
        conn.stage = "live"
    # live: cut chunks until one full message completes
    try:
        while True:
            msg, progressed = _cut_chunk(conn, buf)
            if msg is not None:
                if msg.type_id == MSG_SET_CHUNK_SIZE and len(msg.payload) >= 4:
                    conn.in_chunk_size = _clamp_chunk_size(
                        struct.unpack(">I", msg.payload[:4])[0]
                    )
                    continue
                if msg.type_id == MSG_ABORT and len(msg.payload) >= 4:
                    # drop the aborted chunk stream's partial message
                    # (spec §5.4.2) or its next message inherits it
                    (aborted,) = struct.unpack(">I", msg.payload[:4])
                    st = conn.cs.get(aborted)
                    if st is not None:
                        st.partial = bytearray()
                    continue
                if msg.type_id in (MSG_ACK, MSG_WINDOW_ACK_SIZE, MSG_SET_PEER_BW):
                    continue  # bookkeeping only
                return ParseResult.ok(msg)
            if not progressed:
                return ParseResult.not_enough()
    except (ValueError, IndexError, struct.error) as e:
        log_error("bad rtmp chunk: %r", e)
        return ParseResult.bad()


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------
class RtmpService:
    """User hooks (reference RtmpService/RtmpServerOptions): override to
    gate/observe streams. The built-in relay fans each publisher's
    media out to the stream's players either way."""

    def on_connect(self, app: str) -> bool:
        return True

    def on_publish(self, app: str, stream_name: str) -> bool:
        return True

    def on_play(self, app: str, stream_name: str) -> bool:
        return True

    def on_frame(self, stream_name: str, msg: RtmpMessage) -> None:
        pass


class _StreamHub:
    """name → players; the media fan-out registry (one per server)."""

    def __init__(self):
        self.lock = threading.Lock()
        # name → list of (sock, stream_id on that subscriber's conn)
        self.players: Dict[str, List[Tuple[object, int]]] = {}
        self.meta: Dict[str, List[RtmpMessage]] = {}  # cached sequence headers

    def subscribe(self, name: str, sock, stream_id: int):
        with self.lock:
            self.players.setdefault(name, []).append((sock, stream_id))
            cached = list(self.meta.get(name, ()))
        conn = sock._rtmp_conn
        for m in cached:  # metadata/sequence headers arrive late-joiners
            _send_msg(sock, conn, RtmpMessage(m.type_id, stream_id, m.timestamp, m.payload))

    def unsubscribe_sock(self, sock):
        with self.lock:
            for name in list(self.players):
                self.players[name] = [
                    (s, sid) for (s, sid) in self.players[name] if s is not sock
                ]

    _META_CAP = 16  # cached headers per stream (late-joiner replay)

    def relay(self, name: str, msg: RtmpMessage):
        if msg.type_id == MSG_DATA_AMF0 or _is_sequence_header(msg):
            with self.lock:
                cache = self.meta.setdefault(name, [])
                cache.append(msg)
                # bounded: periodic data messages must not accumulate
                # forever (keep the newest — they supersede)
                if len(cache) > self._META_CAP:
                    del cache[0 : len(cache) - self._META_CAP]
        with self.lock:
            targets = list(self.players.get(name, ()))
        dead = []
        for sock, sid in targets:
            conn = getattr(sock, "_rtmp_conn", None)
            if conn is None or sock.failed:
                dead.append(sock)
                continue
            _send_msg(sock, conn, RtmpMessage(msg.type_id, sid, msg.timestamp, msg.payload))
        for s in dead:
            self.unsubscribe_sock(s)

    def end_stream(self, name: str):
        with self.lock:
            self.meta.pop(name, None)


def _is_sequence_header(msg: RtmpMessage) -> bool:
    """AVC/AAC sequence headers must reach late joiners first."""
    if not msg.payload:
        return False
    if msg.type_id == MSG_VIDEO:
        return (msg.payload[0] & 0x0F) == 7 and len(msg.payload) > 1 and msg.payload[1] == 0
    if msg.type_id == MSG_AUDIO:
        return (msg.payload[0] >> 4) == 10 and len(msg.payload) > 1 and msg.payload[1] == 0
    return False


def _packed_with_preamble(conn: RtmpConn, msg: RtmpMessage, csid: int) -> bytes:
    """Chunk `msg`, prefixing the one-time Set Chunk Size announcement.
    Caller holds conn.out_lock (one helper serves server sockets and
    the client; the wire logic must not fork)."""
    parts = b""
    if not conn.sent_out_chunk_size:
        conn.sent_out_chunk_size = True
        parts += pack_chunks(
            conn,
            RtmpMessage(MSG_SET_CHUNK_SIZE, 0, 0, struct.pack(">I", conn.out_chunk_size)),
            csid=2,
        )
    return parts + pack_chunks(conn, msg, csid)


def _send_msg(sock, conn: RtmpConn, msg: RtmpMessage, csid: int = 3):
    with conn.out_lock:
        sock.write(
            IOBuf(_packed_with_preamble(conn, msg, csid)), ignore_eovercrowded=True
        )


def _hub_of(server) -> _StreamHub:
    hub = getattr(server, "_rtmp_hub", None)
    if hub is None:
        hub = server._rtmp_hub = _StreamHub()
    return hub


def process_request(msg: RtmpMessage, sock) -> None:
    server = sock.server
    conn: RtmpConn = sock._rtmp_conn
    svc = getattr(getattr(server, "options", None), "rtmp_service", None) or RtmpService()
    hub = _hub_of(server)
    if msg.type_id in _MEDIA_TYPES:
        name = conn.publishing.get(msg.stream_id)
        if name:
            try:
                svc.on_frame(name, msg)
            except Exception as e:  # noqa: BLE001
                log_error("rtmp on_frame raised: %r", e)
            hub.relay(name, msg)
        return
    if msg.type_id != MSG_COMMAND_AMF0:
        return
    try:
        vals = amf0_decode_all(msg.payload)
    except (ValueError, IndexError, struct.error):
        log_error("bad amf0 command; closing rtmp conn")
        sock.set_failed(errors.EREQUEST, "bad amf0")
        return
    if not vals or not isinstance(vals[0], str):
        return
    cmd = vals[0]
    txn = vals[1] if len(vals) > 1 else 0
    if cmd == "connect":
        cobj = vals[2] if len(vals) > 2 and isinstance(vals[2], dict) else {}
        conn.app = str(cobj.get("app", ""))
        if not svc.on_connect(conn.app):
            _send_msg(sock, conn, RtmpMessage(
                MSG_COMMAND_AMF0, 0, 0,
                amf0_encode("_error", txn, None, {
                    "level": "error", "code": "NetConnection.Connect.Rejected"})))
            sock.set_failed(errors.ERPCAUTH, "rtmp connect rejected")
            return
        _send_msg(sock, conn, RtmpMessage(
            MSG_WINDOW_ACK_SIZE, 0, 0, struct.pack(">I", 2500000)), csid=2)
        _send_msg(sock, conn, RtmpMessage(
            MSG_SET_PEER_BW, 0, 0, struct.pack(">IB", 2500000, 2)), csid=2)
        _send_msg(sock, conn, RtmpMessage(
            MSG_COMMAND_AMF0, 0, 0,
            amf0_encode("_result", txn,
                        {"fmsVer": "TPB/1.0", "capabilities": 31.0},
                        {"level": "status", "code": "NetConnection.Connect.Success",
                         "description": "Connection succeeded."})))
    elif cmd == "createStream":
        sid = conn.next_stream_id
        conn.next_stream_id += 1
        _send_msg(sock, conn, RtmpMessage(
            MSG_COMMAND_AMF0, 0, 0,
            amf0_encode("_result", txn, None, float(sid))))
    elif cmd == "publish":
        name = vals[3] if len(vals) > 3 and isinstance(vals[3], str) else ""
        if not name or not svc.on_publish(conn.app, name):
            _send_msg(sock, conn, RtmpMessage(
                MSG_COMMAND_AMF0, msg.stream_id, 0,
                amf0_encode("onStatus", 0, None, {
                    "level": "error", "code": "NetStream.Publish.BadName"})))
            return
        conn.publishing[msg.stream_id] = name
        hub.end_stream(name)  # a fresh session must not replay a dead
        # publisher's stale sequence headers to late joiners
        _send_msg(sock, conn, RtmpMessage(
            MSG_COMMAND_AMF0, msg.stream_id, 0,
            amf0_encode("onStatus", 0, None, {
                "level": "status", "code": "NetStream.Publish.Start",
                "description": f"{name} is now published."})))
    elif cmd == "play":
        name = vals[3] if len(vals) > 3 and isinstance(vals[3], str) else ""
        if not name or not svc.on_play(conn.app, name):
            _send_msg(sock, conn, RtmpMessage(
                MSG_COMMAND_AMF0, msg.stream_id, 0,
                amf0_encode("onStatus", 0, None, {
                    "level": "error", "code": "NetStream.Play.StreamNotFound"})))
            return
        conn.playing[msg.stream_id] = name
        # User Control: Stream Begin
        _send_msg(sock, conn, RtmpMessage(
            MSG_USER_CONTROL, 0, 0,
            struct.pack(">HI", 0, msg.stream_id)), csid=2)
        _send_msg(sock, conn, RtmpMessage(
            MSG_COMMAND_AMF0, msg.stream_id, 0,
            amf0_encode("onStatus", 0, None, {
                "level": "status", "code": "NetStream.Play.Start",
                "description": f"Started playing {name}."})))
        hub.subscribe(name, sock, msg.stream_id)
    elif cmd in ("deleteStream", "closeStream"):
        sid = int(vals[3]) if len(vals) > 3 and isinstance(vals[3], (int, float)) else msg.stream_id
        name = conn.publishing.pop(sid, None)
        if name:
            hub.end_stream(name)
        conn.playing.pop(sid, None)
    else:
        log_verbose("rtmp: ignoring command %r", cmd)


PROTOCOL = Protocol(
    name="rtmp",
    parse=parse,
    process_request=process_request,
    support_client=False,
    process_in_place=True,  # chunk state is per-connection and ordered
)


def register():
    register_protocol(PROTOCOL)


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------
class RtmpClient:
    """Blocking RTMP client (reference RtmpClientStream analog):

        cli = RtmpClient("127.0.0.1", port, app="live")
        sid = cli.create_stream()
        cli.publish(sid, "room1")
        cli.write_frame(sid, MSG_VIDEO, ts, payload)

        sub = RtmpClient(..., on_media=fn)      # fn(RtmpMessage)
        sid = sub.create_stream(); sub.play(sid, "room1")
    """

    def __init__(self, host: str, port: int, app: str = "live",
                 on_media: Optional[Callable] = None, timeout_s: float = 8.0,
                 complex_handshake: bool = False):
        import socket as pysock

        self._sock = pysock.create_connection((host, port), timeout=timeout_s)
        self._conn = RtmpConn(is_server=False)
        self._conn.stage = "live"
        self._on_media = on_media
        self._txn = 0
        self._buf = IOBuf()
        self._pending: Dict[float, List] = {}
        self._status: List[dict] = []
        self._cv = threading.Condition()
        self._closed = False
        self._complex_handshake = complex_handshake
        self._handshake()
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()
        self._command("connect", {"app": app, "flashVer": "TPB/1.0",
                                  "tcUrl": f"rtmp://{host}:{port}/{app}"})

    # -- wire helpers --
    def _handshake(self):
        if getattr(self, "_complex_handshake", False):
            # digested C1 (FP key) — Flash-era "complex" handshake; the
            # server must answer a digested S1 or we refuse
            schema = 1
            c1 = make_digested_c1(schema)
        else:
            schema = None
            c1 = struct.pack(
                ">II", int(time.time()) & 0x7FFFFFFF, 0
            ) + os.urandom(HANDSHAKE_SIZE - 8)
        self._sock.sendall(b"\x03" + c1)
        need = 1 + 2 * HANDSHAKE_SIZE
        got = b""
        while len(got) < need:
            chunk = self._sock.recv(need - len(got))
            if not chunk:
                raise ConnectionError("rtmp handshake EOF")
            got += chunk
        if got[0] != 0x03:
            raise ConnectionError("bad rtmp version")
        s1 = got[1 : 1 + HANDSHAKE_SIZE]
        if schema is not None:
            dig, joined = _hs_extract_digest(s1, schema)
            calc = _hmaclib.new(
                _HS_FMS_KEY[:36], joined, _hashlib.sha256
            ).digest()
            if not _hmaclib.compare_digest(calc, dig):
                raise ConnectionError(
                    "server S1 digest invalid (complex handshake)"
                )
        self._sock.sendall(s1)  # C2 = echo S1

    def _send(self, msg: RtmpMessage, csid: int = 3):
        with self._conn.out_lock:
            self._sock.sendall(_packed_with_preamble(self._conn, msg, csid))

    def _read_loop(self):
        try:
            while not self._closed:
                data = self._sock.recv(65536)
                if not data:
                    break
                self._buf.append(data)
                while True:
                    msg, progressed = _cut_chunk(self._conn, self._buf)
                    if msg is None:
                        if not progressed:
                            break
                        continue
                    try:
                        self._dispatch(msg)
                    except Exception as e:  # noqa: BLE001 — one malformed
                        # message must not silently kill the reader
                        log_error("rtmp client dispatch failed: %r", e)
        except OSError:
            pass
        except (ValueError, IndexError, struct.error) as e:
            log_error("rtmp client chunk desync: %r", e)
        finally:
            with self._cv:
                self._closed = True
                self._cv.notify_all()

    def _dispatch(self, msg: RtmpMessage):
        if msg.type_id == MSG_SET_CHUNK_SIZE and len(msg.payload) >= 4:
            self._conn.in_chunk_size = _clamp_chunk_size(
                struct.unpack(">I", msg.payload[:4])[0]
            )
            return
        if msg.type_id in _MEDIA_TYPES:
            if self._on_media:
                try:
                    self._on_media(msg)
                except Exception as e:  # noqa: BLE001
                    log_error("rtmp on_media raised: %r", e)
            return
        if msg.type_id != MSG_COMMAND_AMF0:
            return
        try:
            vals = amf0_decode_all(msg.payload)
        except (ValueError, IndexError, struct.error):
            return
        if not vals:
            return
        with self._cv:
            if vals[0] in ("_result", "_error"):
                self._pending[float(vals[1])] = vals
            elif vals[0] == "onStatus":
                self._status.append(vals[3] if len(vals) > 3 else {})
            self._cv.notify_all()

    def _command(self, name: str, *args, stream_id: int = 0, wait: bool = True):
        self._txn += 1
        txn = self._txn
        self._send(RtmpMessage(MSG_COMMAND_AMF0, stream_id, 0,
                               amf0_encode(name, float(txn), *args)))
        if not wait:
            return None
        deadline = time.monotonic() + 8
        with self._cv:
            while float(txn) not in self._pending:
                if self._closed or time.monotonic() > deadline:
                    raise TimeoutError(f"rtmp {name} got no _result")
                self._cv.wait(0.2)
            vals = self._pending.pop(float(txn))
        if vals[0] == "_error":
            raise RuntimeError(f"rtmp {name} rejected: {vals[3:]}" )
        return vals

    def _wait_status(self, code_prefix: str):
        deadline = time.monotonic() + 8
        with self._cv:
            while True:
                for st in self._status:
                    if isinstance(st, dict) and str(st.get("code", "")).startswith(code_prefix):
                        self._status.remove(st)
                        if st.get("level") == "error":
                            raise RuntimeError(f"rtmp status error: {st}")
                        return st
                if self._closed or time.monotonic() > deadline:
                    raise TimeoutError(f"no {code_prefix} status")
                self._cv.wait(0.2)

    # -- public API --
    def create_stream(self) -> int:
        vals = self._command("createStream", None)
        return int(vals[3])

    def publish(self, stream_id: int, name: str):
        self._command("publish", None, name, "live",
                      stream_id=stream_id, wait=False)
        self._wait_status("NetStream.Publish")

    def play(self, stream_id: int, name: str):
        self._command("play", None, name, -2.0,
                      stream_id=stream_id, wait=False)
        self._wait_status("NetStream.Play")

    def write_frame(self, stream_id: int, type_id: int, timestamp: int, payload: bytes):
        self._send(RtmpMessage(type_id, stream_id, timestamp, payload), csid=4)

    def delete_stream(self, stream_id: int):
        self._command("deleteStream", None, float(stream_id), wait=False)

    def close(self):
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
