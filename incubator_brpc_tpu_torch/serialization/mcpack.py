"""mcpack2pb — mcpack v2 codec + protobuf bridge.

Analog of reference src/mcpack2pb/ (parser.cpp/serializer.cpp +
generator.cpp protoc plugin): mcpack is Baidu's binary JSON; the
reference generates per-message converters at protoc time, this module
converts at runtime through message descriptors (same approach as
json2pb).

DESIGN DEVIATION (deliberate): the reference's protoc plugin
(generator.cpp:1346,1424) exists because C++ needs codegen for
reflection-speed conversion; Python message descriptors already carry
full reflection, so a runtime walk is the idiomatic binding with
identical wire behavior. Wire compatibility with compack/mcpack v2
producers is pinned by hand-built byte corpora in
tests/test_mcpack_trackme.py (test_mcpack_conformance_corpus).

Wire facts (field_type.h, parser.cpp:27-81):

  head:  fixed (2B: type,name_size) when type&0x0F != 0 — value size is
         type&0x0F; short (3B: type|0x80,name_size,value_size u8) for
         strings<=254 / binary<=255; long (6B: type,name_size,
         value_size u32le) otherwise.
  names: C strings, name_size includes the terminating 0.
  OBJECT/ARRAY (0x10/0x20): long head; value = u32le item_count + items.
  ISOARRAY (0x30): long head; value = u8 item_type + packed values.
  STRING (0x50): value includes trailing 0.  BINARY (0x60): raw bytes.
  ints 0x11/12/14/18, uints 0x21/22/24/28, BOOL 0x31, FLOAT 0x44,
  DOUBLE 0x48, NULL 0x61 (one 0 byte).
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

F_OBJECT, F_ARRAY, F_ISOARRAY = 0x10, 0x20, 0x30
F_STRING, F_BINARY = 0x50, 0x60
F_INT8, F_INT16, F_INT32, F_INT64 = 0x11, 0x12, 0x14, 0x18
F_UINT8, F_UINT16, F_UINT32, F_UINT64 = 0x21, 0x22, 0x24, 0x28
F_BOOL, F_FLOAT, F_DOUBLE, F_NULL = 0x31, 0x44, 0x48, 0x61
_SHORT_MASK = 0x80
_FIXED_MASK = 0x0F

_FIXED_FMT = {
    F_INT8: "<b", F_INT16: "<h", F_INT32: "<i", F_INT64: "<q",
    F_UINT8: "<B", F_UINT16: "<H", F_UINT32: "<I", F_UINT64: "<Q",
    F_FLOAT: "<f", F_DOUBLE: "<d",
}


# ---------------------------------------------------------------------------
# encode: python value -> mcpack field bytes
# ---------------------------------------------------------------------------
def _head(ftype: int, name: bytes, value_size: int) -> bytes:
    if ftype & _FIXED_MASK:
        return struct.pack("<BB", ftype, len(name)) + name
    if ftype in (F_STRING, F_BINARY) and value_size <= (254 if ftype == F_STRING else 255):
        return struct.pack("<BBB", ftype | _SHORT_MASK, len(name), value_size) + name
    return struct.pack("<BBI", ftype, len(name), value_size) + name


def _name_bytes(name: Optional[str]) -> bytes:
    if not name:
        return b"\x00"
    return name.encode() + b"\x00"


def _int_type(v: int) -> Tuple[int, bytes]:
    for t in (F_INT8, F_INT16, F_INT32, F_INT64):
        try:
            return t, struct.pack(_FIXED_FMT[t], v)
        except struct.error:
            continue
    return F_UINT64, struct.pack("<Q", v)


def encode_field(name: Optional[str], v) -> bytes:
    nb = _name_bytes(name)
    if isinstance(v, bool):
        return _head(F_BOOL, nb, 1) + (b"\x01" if v else b"\x00")
    if isinstance(v, int):
        t, raw = _int_type(v)
        return _head(t, nb, len(raw)) + raw
    if isinstance(v, float):
        return _head(F_DOUBLE, nb, 8) + struct.pack("<d", v)
    if isinstance(v, str):
        raw = v.encode() + b"\x00"
        return _head(F_STRING, nb, len(raw)) + raw
    if isinstance(v, bytes):
        return _head(F_BINARY, nb, len(v)) + v
    if v is None:
        return _head(F_NULL, nb, 1) + b"\x00"
    if isinstance(v, dict):
        items = b"".join(encode_field(k, item) for k, item in v.items())
        value = struct.pack("<I", len(v)) + items
        return _head(F_OBJECT, nb, len(value)) + value
    if isinstance(v, (list, tuple)):
        items = b"".join(encode_field(None, item) for item in v)
        value = struct.pack("<I", len(v)) + items
        return _head(F_ARRAY, nb, len(value)) + value
    raise TypeError(f"mcpack: unsupported type {type(v)}")


def dumps(doc: Dict) -> bytes:
    """Serialize a dict as the root mcpack OBJECT."""
    return encode_field(None, doc)


# ---------------------------------------------------------------------------
# decode: mcpack field bytes -> python value
# ---------------------------------------------------------------------------
def _decode_field(data: bytes, pos: int) -> Tuple[str, object, int]:
    """→ (name, value, next_pos)."""
    first = data[pos]
    if first & _FIXED_MASK:
        ftype = first
        name_size = data[pos + 1]
        vstart = pos + 2 + name_size
        vsize = ftype & _FIXED_MASK
    elif first & _SHORT_MASK:
        ftype = first & ~_SHORT_MASK
        name_size = data[pos + 1]
        vsize = data[pos + 2]
        vstart = pos + 3 + name_size
    else:
        ftype = first
        name_size = data[pos + 1]
        (vsize,) = struct.unpack_from("<I", data, pos + 2)
        vstart = pos + 6 + name_size
    name = data[vstart - name_size : vstart - 1].decode("utf-8", "replace") if name_size else ""
    end = vstart + vsize
    if end > len(data):
        raise ValueError("mcpack field truncated")
    raw = data[vstart:end]
    if ftype in _FIXED_FMT:
        value = struct.unpack(_FIXED_FMT[ftype], raw)[0]
    elif ftype == F_BOOL:
        value = raw[0] != 0
    elif ftype == F_NULL:
        value = None
    elif ftype == F_STRING:
        value = raw[:-1].decode("utf-8", "replace")
    elif ftype == F_BINARY:
        value = raw
    elif ftype in (F_OBJECT, F_ARRAY):
        (count,) = struct.unpack_from("<I", raw, 0)
        cur = 4
        if ftype == F_OBJECT:
            obj: Dict = {}
            for _ in range(count):
                k, v, nxt = _decode_field(raw, cur)
                obj[k] = v
                cur = nxt
            value = obj
        else:
            arr = []
            for _ in range(count):
                _, v, nxt = _decode_field(raw, cur)
                arr.append(v)
                cur = nxt
            value = arr
    elif ftype == F_ISOARRAY:
        item_type = raw[0]
        fmt = _FIXED_FMT.get(item_type)
        if fmt is None:
            raise ValueError(f"mcpack: bad isoarray item type 0x{item_type:02x}")
        isz = item_type & _FIXED_MASK
        value = [
            struct.unpack_from(fmt, raw, 1 + i * isz)[0]
            for i in range((len(raw) - 1) // isz)
        ]
    else:
        raise ValueError(f"mcpack: unknown field type 0x{ftype:02x}")
    return name, value, end


def loads(data: bytes) -> Dict:
    name, value, _ = _decode_field(data, 0)
    if not isinstance(value, dict):
        raise ValueError("mcpack root is not an object")
    return value


# ---------------------------------------------------------------------------
# protobuf bridge (the mcpack2pb purpose: pb messages as the front-end)
# ---------------------------------------------------------------------------
def proto_to_mcpack(msg) -> bytes:
    """Serialize a protobuf message as mcpack (field names = keys)."""
    return dumps(_msg_to_dict(msg))


def _msg_to_dict(msg) -> Dict:
    out = {}
    for field, value in msg.ListFields():
        if field.is_repeated:
            if field.type == field.TYPE_MESSAGE:
                out[field.name] = [_msg_to_dict(v) for v in value]
            else:
                out[field.name] = list(value)
        elif field.type == field.TYPE_MESSAGE:
            out[field.name] = _msg_to_dict(value)
        else:
            out[field.name] = value
    return out


def mcpack_to_proto(data: bytes, msg) -> Tuple[bool, str]:
    """Parse mcpack bytes into a protobuf message. → (ok, error)."""
    try:
        doc = loads(data)
    except (ValueError, IndexError, struct.error) as e:
        return False, f"bad mcpack: {e}"
    try:
        _dict_to_msg(doc, msg)
    except (TypeError, ValueError, AttributeError) as e:
        return False, f"mcpack does not fit message: {e}"
    return True, ""


def _dict_to_msg(doc: Dict, msg):
    for field in msg.DESCRIPTOR.fields:
        if field.name not in doc:
            continue
        v = doc[field.name]
        if field.is_repeated:
            target = getattr(msg, field.name)
            for item in v:
                if field.type == field.TYPE_MESSAGE:
                    _dict_to_msg(item, target.add())
                else:
                    target.append(_coerce(field, item))
        elif field.type == field.TYPE_MESSAGE:
            _dict_to_msg(v, getattr(msg, field.name))
        else:
            setattr(msg, field.name, _coerce(field, v))


def _coerce(field, v):
    if field.type == field.TYPE_STRING and isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if field.type == field.TYPE_BYTES and isinstance(v, str):
        return v.encode()
    if field.cpp_type in (field.CPPTYPE_INT32, field.CPPTYPE_INT64,
                          field.CPPTYPE_UINT32, field.CPPTYPE_UINT64):
        return int(v)
    if field.cpp_type in (field.CPPTYPE_FLOAT, field.CPPTYPE_DOUBLE):
        return float(v)
    if field.cpp_type == field.CPPTYPE_BOOL:
        return bool(v)
    return v
