"""HPACK — HTTP/2 header compression (RFC 7541).

Analog of reference details/hpack.{h,cpp} (881 LoC): static + dynamic
tables, N-bit-prefix integer coding, string literals with Huffman
coding. Encoder and decoder each own an independent dynamic table, as
the RFC requires (one per direction of one connection).

The two tables below are the RFC 7541 Appendix A/B constants.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Tuple

# RFC 7541 Appendix A: the 61-entry static header table.
STATIC_TABLE = (
    (':authority', ''),
    (':method', 'GET'),
    (':method', 'POST'),
    (':path', '/'),
    (':path', '/index.html'),
    (':scheme', 'http'),
    (':scheme', 'https'),
    (':status', '200'),
    (':status', '204'),
    (':status', '206'),
    (':status', '304'),
    (':status', '400'),
    (':status', '404'),
    (':status', '500'),
    ('accept-charset', ''),
    ('accept-encoding', 'gzip, deflate'),
    ('accept-language', ''),
    ('accept-ranges', ''),
    ('accept', ''),
    ('access-control-allow-origin', ''),
    ('age', ''),
    ('allow', ''),
    ('authorization', ''),
    ('cache-control', ''),
    ('content-disposition', ''),
    ('content-encoding', ''),
    ('content-language', ''),
    ('content-length', ''),
    ('content-location', ''),
    ('content-range', ''),
    ('content-type', ''),
    ('cookie', ''),
    ('date', ''),
    ('etag', ''),
    ('expect', ''),
    ('expires', ''),
    ('from', ''),
    ('host', ''),
    ('if-match', ''),
    ('if-modified-since', ''),
    ('if-none-match', ''),
    ('if-range', ''),
    ('if-unmodified-since', ''),
    ('last-modified', ''),
    ('link', ''),
    ('location', ''),
    ('max-forwards', ''),
    ('proxy-authenticate', ''),
    ('proxy-authorization', ''),
    ('range', ''),
    ('referer', ''),
    ('refresh', ''),
    ('retry-after', ''),
    ('server', ''),
    ('set-cookie', ''),
    ('strict-transport-security', ''),
    ('transfer-encoding', ''),
    ('user-agent', ''),
    ('vary', ''),
    ('via', ''),
    ('www-authenticate', ''),
)

# RFC 7541 Appendix B: canonical Huffman code for each of the 256
# octets plus EOS — (code, bit_length) per symbol.
HUFFMAN_CODES = (
    (0x1ff8, 13), (0x7fffd8, 23), (0xfffffe2, 28), (0xfffffe3, 28),
    (0xfffffe4, 28), (0xfffffe5, 28), (0xfffffe6, 28), (0xfffffe7, 28),
    (0xfffffe8, 28), (0xffffea, 24), (0x3ffffffc, 30), (0xfffffe9, 28),
    (0xfffffea, 28), (0x3ffffffd, 30), (0xfffffeb, 28), (0xfffffec, 28),
    (0xfffffed, 28), (0xfffffee, 28), (0xfffffef, 28), (0xffffff0, 28),
    (0xffffff1, 28), (0xffffff2, 28), (0x3ffffffe, 30), (0xffffff3, 28),
    (0xffffff4, 28), (0xffffff5, 28), (0xffffff6, 28), (0xffffff7, 28),
    (0xffffff8, 28), (0xffffff9, 28), (0xffffffa, 28), (0xffffffb, 28),
    (0x14, 6), (0x3f8, 10), (0x3f9, 10), (0xffa, 12),
    (0x1ff9, 13), (0x15, 6), (0xf8, 8), (0x7fa, 11),
    (0x3fa, 10), (0x3fb, 10), (0xf9, 8), (0x7fb, 11),
    (0xfa, 8), (0x16, 6), (0x17, 6), (0x18, 6),
    (0x0, 5), (0x1, 5), (0x2, 5), (0x19, 6),
    (0x1a, 6), (0x1b, 6), (0x1c, 6), (0x1d, 6),
    (0x1e, 6), (0x1f, 6), (0x5c, 7), (0xfb, 8),
    (0x7ffc, 15), (0x20, 6), (0xffb, 12), (0x3fc, 10),
    (0x1ffa, 13), (0x21, 6), (0x5d, 7), (0x5e, 7),
    (0x5f, 7), (0x60, 7), (0x61, 7), (0x62, 7),
    (0x63, 7), (0x64, 7), (0x65, 7), (0x66, 7),
    (0x67, 7), (0x68, 7), (0x69, 7), (0x6a, 7),
    (0x6b, 7), (0x6c, 7), (0x6d, 7), (0x6e, 7),
    (0x6f, 7), (0x70, 7), (0x71, 7), (0x72, 7),
    (0xfc, 8), (0x73, 7), (0xfd, 8), (0x1ffb, 13),
    (0x7fff0, 19), (0x1ffc, 13), (0x3ffc, 14), (0x22, 6),
    (0x7ffd, 15), (0x3, 5), (0x23, 6), (0x4, 5),
    (0x24, 6), (0x5, 5), (0x25, 6), (0x26, 6),
    (0x27, 6), (0x6, 5), (0x74, 7), (0x75, 7),
    (0x28, 6), (0x29, 6), (0x2a, 6), (0x7, 5),
    (0x2b, 6), (0x76, 7), (0x2c, 6), (0x8, 5),
    (0x9, 5), (0x2d, 6), (0x77, 7), (0x78, 7),
    (0x79, 7), (0x7a, 7), (0x7b, 7), (0x7ffe, 15),
    (0x7fc, 11), (0x3ffd, 14), (0x1ffd, 13), (0xffffffc, 28),
    (0xfffe6, 20), (0x3fffd2, 22), (0xfffe7, 20), (0xfffe8, 20),
    (0x3fffd3, 22), (0x3fffd4, 22), (0x3fffd5, 22), (0x7fffd9, 23),
    (0x3fffd6, 22), (0x7fffda, 23), (0x7fffdb, 23), (0x7fffdc, 23),
    (0x7fffdd, 23), (0x7fffde, 23), (0xffffeb, 24), (0x7fffdf, 23),
    (0xffffec, 24), (0xffffed, 24), (0x3fffd7, 22), (0x7fffe0, 23),
    (0xffffee, 24), (0x7fffe1, 23), (0x7fffe2, 23), (0x7fffe3, 23),
    (0x7fffe4, 23), (0x1fffdc, 21), (0x3fffd8, 22), (0x7fffe5, 23),
    (0x3fffd9, 22), (0x7fffe6, 23), (0x7fffe7, 23), (0xffffef, 24),
    (0x3fffda, 22), (0x1fffdd, 21), (0xfffe9, 20), (0x3fffdb, 22),
    (0x3fffdc, 22), (0x7fffe8, 23), (0x7fffe9, 23), (0x1fffde, 21),
    (0x7fffea, 23), (0x3fffdd, 22), (0x3fffde, 22), (0xfffff0, 24),
    (0x1fffdf, 21), (0x3fffdf, 22), (0x7fffeb, 23), (0x7fffec, 23),
    (0x1fffe0, 21), (0x1fffe1, 21), (0x3fffe0, 22), (0x1fffe2, 21),
    (0x7fffed, 23), (0x3fffe1, 22), (0x7fffee, 23), (0x7fffef, 23),
    (0xfffea, 20), (0x3fffe2, 22), (0x3fffe3, 22), (0x3fffe4, 22),
    (0x7ffff0, 23), (0x3fffe5, 22), (0x3fffe6, 22), (0x7ffff1, 23),
    (0x3ffffe0, 26), (0x3ffffe1, 26), (0xfffeb, 20), (0x7fff1, 19),
    (0x3fffe7, 22), (0x7ffff2, 23), (0x3fffe8, 22), (0x1ffffec, 25),
    (0x3ffffe2, 26), (0x3ffffe3, 26), (0x3ffffe4, 26), (0x7ffffde, 27),
    (0x7ffffdf, 27), (0x3ffffe5, 26), (0xfffff1, 24), (0x1ffffed, 25),
    (0x7fff2, 19), (0x1fffe3, 21), (0x3ffffe6, 26), (0x7ffffe0, 27),
    (0x7ffffe1, 27), (0x3ffffe7, 26), (0x7ffffe2, 27), (0xfffff2, 24),
    (0x1fffe4, 21), (0x1fffe5, 21), (0x3ffffe8, 26), (0x3ffffe9, 26),
    (0xffffffd, 28), (0x7ffffe3, 27), (0x7ffffe4, 27), (0x7ffffe5, 27),
    (0xfffec, 20), (0xfffff3, 24), (0xfffed, 20), (0x1fffe6, 21),
    (0x3fffe9, 22), (0x1fffe7, 21), (0x1fffe8, 21), (0x7ffff3, 23),
    (0x3fffea, 22), (0x3fffeb, 22), (0x1ffffee, 25), (0x1ffffef, 25),
    (0xfffff4, 24), (0xfffff5, 24), (0x3ffffea, 26), (0x7ffff4, 23),
    (0x3ffffeb, 26), (0x7ffffe6, 27), (0x3ffffec, 26), (0x3ffffed, 26),
    (0x7ffffe7, 27), (0x7ffffe8, 27), (0x7ffffe9, 27), (0x7ffffea, 27),
    (0x7ffffeb, 27), (0xffffffe, 28), (0x7ffffec, 27), (0x7ffffed, 27),
    (0x7ffffee, 27), (0x7ffffef, 27), (0x7fffff0, 27), (0x3ffffee, 26),
    (0x3fffffff, 30),
)

_EOS = 256
_STATIC_COUNT = len(STATIC_TABLE)  # 61

# decode map: (bit_length, code) -> symbol. Huffman codes are prefix-
# free, so matching at increasing lengths yields the unique symbol.
_HUFF_DECODE = {
    (ln, code): sym for sym, (code, ln) in enumerate(HUFFMAN_CODES)
}
_HUFF_LENGTHS = sorted({ln for _, ln in HUFFMAN_CODES})

# name -> smallest static index (1-based); (name, value) -> index
_STATIC_BY_PAIR = {}
_STATIC_BY_NAME = {}
for _i, (_n, _v) in enumerate(STATIC_TABLE):
    _STATIC_BY_PAIR.setdefault((_n, _v), _i + 1)
    _STATIC_BY_NAME.setdefault(_n, _i + 1)


class HpackError(ValueError):
    pass


# ---- primitive codings ------------------------------------------------------
def encode_int(value: int, prefix_bits: int, first_byte_flags: int = 0) -> bytes:
    """RFC 7541 §5.1 integer with an N-bit prefix."""
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytes((first_byte_flags | value,))
    out = bytearray((first_byte_flags | limit,))
    value -= limit
    while value >= 0x80:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_int(data, pos: int, prefix_bits: int) -> Tuple[int, int]:
    """Returns (value, new_pos)."""
    if pos >= len(data):
        raise HpackError("truncated integer")
    limit = (1 << prefix_bits) - 1
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HpackError("truncated varint")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos
        if shift > 35:
            raise HpackError("integer overflow")


def huffman_encode(data: bytes) -> bytes:
    acc = 0
    nbits = 0
    out = bytearray()
    for b in data:
        code, ln = HUFFMAN_CODES[b]
        acc = (acc << ln) | code
        nbits += ln
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
    if nbits:
        # pad with EOS prefix (all ones)
        out.append(((acc << (8 - nbits)) | ((1 << (8 - nbits)) - 1)) & 0xFF)
    return bytes(out)


def huffman_decode(data: bytes) -> bytes:
    acc = 0
    nbits = 0
    out = bytearray()
    decode = _HUFF_DECODE
    for byte in data:
        acc = (acc << 8) | byte
        nbits += 8
        matched = True
        while matched:
            matched = False
            for ln in _HUFF_LENGTHS:
                if ln > nbits:
                    break
                sym = decode.get((ln, acc >> (nbits - ln)))
                if sym is not None:
                    if sym == _EOS:
                        raise HpackError("EOS in huffman stream")
                    out.append(sym)
                    nbits -= ln
                    acc &= (1 << nbits) - 1
                    matched = True
                    break
    # residue must be an EOS prefix (all ones, < 8 bits)
    if nbits >= 8 or acc != (1 << nbits) - 1:
        raise HpackError("bad huffman padding")
    return bytes(out)


def encode_string(s: str, huffman: bool = True) -> bytes:
    raw = s.encode("utf-8") if isinstance(s, str) else s
    if huffman:
        enc = huffman_encode(raw)
        if len(enc) < len(raw):
            return encode_int(len(enc), 7, 0x80) + enc
    return encode_int(len(raw), 7, 0x00) + raw


def decode_string(data, pos: int) -> Tuple[str, int]:
    if pos >= len(data):
        raise HpackError("truncated string")
    huff = bool(data[pos] & 0x80)
    length, pos = decode_int(data, pos, 7)
    if pos + length > len(data):
        raise HpackError("string exceeds block")
    raw = bytes(data[pos : pos + length])
    pos += length
    if huff:
        raw = huffman_decode(raw)
    return raw.decode("utf-8", errors="replace"), pos


# ---- dynamic table ----------------------------------------------------------
class _DynamicTable:
    """FIFO of (name, value); size accounting per RFC 7541 §4.1
    (entry size = len(name) + len(value) + 32 octets)."""

    def __init__(self, max_size: int = 4096):
        self.entries: deque = deque()  # newest at index 0
        self.size = 0
        self.max_size = max_size
        self.cap_limit = max_size  # protocol ceiling (SETTINGS)

    @staticmethod
    def entry_size(name: str, value: str) -> int:
        return len(name.encode()) + len(value.encode()) + 32

    def add(self, name: str, value: str):
        sz = self.entry_size(name, value)
        while self.entries and self.size + sz > self.max_size:
            en, ev = self.entries.pop()
            self.size -= self.entry_size(en, ev)
        if sz <= self.max_size:
            self.entries.appendleft((name, value))
            self.size += sz
        else:
            self.entries.clear()
            self.size = 0

    def resize(self, new_max: int):
        if new_max > self.cap_limit:
            raise HpackError("table size update beyond limit")
        self.max_size = new_max
        while self.entries and self.size > self.max_size:
            en, ev = self.entries.pop()
            self.size -= self.entry_size(en, ev)

    def get(self, index_from_62: int) -> Tuple[str, str]:
        """index 0 = newest dynamic entry."""
        if index_from_62 >= len(self.entries):
            raise HpackError(f"dynamic index {index_from_62} out of range")
        return self.entries[index_from_62]

    def find(self, name: str, value: str) -> Tuple[Optional[int], Optional[int]]:
        """(pair_index, name_index) as absolute 1-based indices (62+)."""
        pair = name_only = None
        for i, (n, v) in enumerate(self.entries):
            if n == name:
                if v == value and pair is None:
                    pair = _STATIC_COUNT + 1 + i
                if name_only is None:
                    name_only = _STATIC_COUNT + 1 + i
        return pair, name_only


# ---- encoder / decoder ------------------------------------------------------
class HpackEncoder:
    def __init__(self, max_table_size: int = 4096, huffman: bool = True):
        self._table = _DynamicTable(max_table_size)
        self._huffman = huffman
        self._pending_resize: Optional[int] = None

    def set_max_table_size(self, n: int):
        self._table.cap_limit = n
        self._pending_resize = min(n, self._table.max_size)

    def encode(self, headers: List[Tuple[str, str]], sensitive=()) -> bytes:
        out = bytearray()
        if self._pending_resize is not None:
            self._table.resize(self._pending_resize)
            out += encode_int(self._pending_resize, 5, 0x20)
            self._pending_resize = None
        for name, value in headers:
            name = name.lower()
            out += self._encode_one(name, value, name in sensitive)
        return bytes(out)

    def _encode_one(self, name: str, value: str, sensitive: bool) -> bytes:
        if sensitive:
            # never-indexed literal (§6.2.3)
            idx = _STATIC_BY_NAME.get(name) or self._table.find(name, value)[1]
            head = encode_int(idx or 0, 4, 0x10)
            if not idx:
                head += encode_string(name, self._huffman)
            return head + encode_string(value, self._huffman)
        pair = _STATIC_BY_PAIR.get((name, value))
        if pair is None:
            pair, dyn_name = self._table.find(name, value)
        else:
            dyn_name = None
        if pair is not None:
            return encode_int(pair, 7, 0x80)  # indexed (§6.1)
        # literal with incremental indexing (§6.2.1)
        idx = _STATIC_BY_NAME.get(name) or dyn_name or 0
        head = encode_int(idx, 6, 0x40)
        if not idx:
            head += encode_string(name, self._huffman)
        out = head + encode_string(value, self._huffman)
        self._table.add(name, value)
        return out


class HpackDecoder:
    def __init__(self, max_table_size: int = 4096):
        self._table = _DynamicTable(max_table_size)

    def set_max_table_size(self, n: int):
        self._table.cap_limit = n

    def _lookup(self, index: int) -> Tuple[str, str]:
        if index == 0:
            raise HpackError("index 0")
        if index <= _STATIC_COUNT:
            return STATIC_TABLE[index - 1]
        return self._table.get(index - _STATIC_COUNT - 1)

    def decode(self, data) -> List[Tuple[str, str]]:
        headers: List[Tuple[str, str]] = []
        pos = 0
        n = len(data)
        while pos < n:
            b = data[pos]
            if b & 0x80:  # indexed (§6.1)
                idx, pos = decode_int(data, pos, 7)
                headers.append(self._lookup(idx))
            elif b & 0x40:  # literal w/ incremental indexing (§6.2.1)
                idx, pos = decode_int(data, pos, 6)
                name = self._lookup(idx)[0] if idx else None
                if name is None:
                    name, pos = decode_string(data, pos)
                value, pos = decode_string(data, pos)
                self._table.add(name, value)
                headers.append((name, value))
            elif b & 0x20:  # dynamic table size update (§6.3)
                new_max, pos = decode_int(data, pos, 5)
                self._table.resize(new_max)
            else:  # literal without indexing / never-indexed (§6.2.2/3)
                idx, pos = decode_int(data, pos, 4)
                name = self._lookup(idx)[0] if idx else None
                if name is None:
                    name, pos = decode_string(data, pos)
                value, pos = decode_string(data, pos)
                headers.append((name, value))
        return headers
