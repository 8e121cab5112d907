"""JSON ↔ protobuf conversion with the reference's per-call options.

Analog of reference src/json2pb/ (json_to_pb.{h,cpp}, pb_to_json.{h,cpp},
~1,740 LoC of rapidjson streaming): a descriptor-walking converter whose
option structs mirror Json2PbOptions / Pb2JsonOptions field for field —

- ``bytes_to_base64`` / ``base64_to_bytes``: bytes fields as base64
  strings (the default) or raw latin-1 strings (the baidu-std wire's
  historical mode, pb_to_json.h:52-55 / json_to_pb.h:32-35).
- ``enum_option``: enums by name or by number (pb_to_json.h:37-39).
- ``enable_protobuf_map``: proto3 maps as JSON objects, or as the
  underlying repeated {key,value} entry list (pb_to_json.h:47-50).
- ``jsonify_empty_array``, ``always_print_primitive_fields``,
  ``pretty_json`` (pb_to_json.h:57-66).
- ``single_repeated_to_array`` / ``array_to_single_repeated``: a
  message whose only field is repeated converts to/from a bare JSON
  array (pb_to_json.h:68-70, json_to_pb.h:37-39).
- ``allow_remaining_bytes_after_parsing`` + parsed offset
  (json_to_pb.h:41-58).
- ``allow_unknown_fields``: tolerate or reject unknown JSON keys.

Error surface matches JsonToProtoMessage: (ok, error_string) tuples,
never exceptions.  64-bit integers are emitted as JSON numbers like the
reference's rapidjson writer (canonical proto3 JSON would quote them).
"""

from __future__ import annotations

import base64
import json
import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

from google.protobuf import descriptor as _desc

from incubator_brpc_tpu_torch.utils.iobuf import IOBuf

_TYPE = _desc.FieldDescriptor

OUTPUT_ENUM_BY_NAME = "name"  # reference EnumOption (pb_to_json.h:37)
OUTPUT_ENUM_BY_NUMBER = "number"


@dataclass
class Json2PbOptions:
    """Mirrors reference Json2PbOptions (json_to_pb.h:29-44)."""

    base64_to_bytes: bool = True
    array_to_single_repeated: bool = False
    allow_remaining_bytes_after_parsing: bool = False
    allow_unknown_fields: bool = True


@dataclass
class Pb2JsonOptions:
    """Mirrors reference Pb2JsonOptions (pb_to_json.h:34-71)."""

    enum_option: str = OUTPUT_ENUM_BY_NAME
    pretty_json: bool = False
    enable_protobuf_map: bool = True
    bytes_to_base64: bool = True
    jsonify_empty_array: bool = False
    always_print_primitive_fields: bool = False
    single_repeated_to_array: bool = False


class _ConvertError(Exception):
    pass


# ---------------------------------------------------------------------------
# pb → json
# ---------------------------------------------------------------------------


def _is_map_field(f) -> bool:
    return (
        f.is_repeated
        and f.type == _TYPE.TYPE_MESSAGE
        and f.message_type.GetOptions().map_entry
    )


def _scalar_to_json(f, v, opts: Pb2JsonOptions):
    if f.type == _TYPE.TYPE_BYTES:
        if opts.bytes_to_base64:
            return base64.b64encode(v).decode("ascii")
        return v.decode("latin-1")
    if f.type == _TYPE.TYPE_ENUM:
        if opts.enum_option == OUTPUT_ENUM_BY_NUMBER:
            return v
        ev = f.enum_type.values_by_number.get(v)
        return ev.name if ev is not None else v
    if f.type in (_TYPE.TYPE_FLOAT, _TYPE.TYPE_DOUBLE):
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "Infinity" if v > 0 else "-Infinity"
        return v
    return v  # ints, bool, string


def _field_to_json(msg, f, opts: Pb2JsonOptions):
    if _is_map_field(f):
        entries = getattr(msg, f.name)
        vf = f.message_type.fields_by_name["value"]
        if opts.enable_protobuf_map:
            return {
                str(k): (
                    _message_to_dict(v, opts)
                    if vf.type == _TYPE.TYPE_MESSAGE
                    else _scalar_to_json(vf, v, opts)
                )
                for k, v in entries.items()
            }
        # raw entry list (reference with enable_protobuf_map=false)
        return [
            {
                "key": k,
                "value": _message_to_dict(v, opts)
                if vf.type == _TYPE.TYPE_MESSAGE
                else _scalar_to_json(vf, v, opts),
            }
            for k, v in entries.items()
        ]
    if f.is_repeated:
        items = getattr(msg, f.name)
        if f.type == _TYPE.TYPE_MESSAGE:
            return [_message_to_dict(m, opts) for m in items]
        return [_scalar_to_json(f, v, opts) for v in items]
    if f.type == _TYPE.TYPE_MESSAGE:
        return _message_to_dict(getattr(msg, f.name), opts)
    return _scalar_to_json(f, getattr(msg, f.name), opts)


def _message_to_dict(msg, opts: Pb2JsonOptions) -> dict:
    out = {}
    for f in msg.DESCRIPTOR.fields:
        if f.is_repeated:
            if not getattr(msg, f.name) and not opts.jsonify_empty_array:
                continue
            out[f.name] = _field_to_json(msg, f, opts)
            continue
        if f.type == _TYPE.TYPE_MESSAGE:
            if msg.HasField(f.name):
                out[f.name] = _field_to_json(msg, f, opts)
            continue
        # scalar: proto2 presence via HasField; proto3 default-skip
        # unless always_print_primitive_fields (pb_to_json.h:62-66)
        if f.has_presence:
            if msg.HasField(f.name):
                out[f.name] = _field_to_json(msg, f, opts)
            elif opts.always_print_primitive_fields:
                out[f.name] = _scalar_to_json(f, f.default_value, opts)
            continue
        v = getattr(msg, f.name)
        if v != f.default_value or opts.always_print_primitive_fields:
            out[f.name] = _field_to_json(msg, f, opts)
    return out


def proto_to_json_with_options(
    message, options: Optional[Pb2JsonOptions] = None
) -> Tuple[Optional[str], str]:
    """ProtoMessageToJson analog: → (json_string | None, error)."""
    opts = options or Pb2JsonOptions()
    try:
        fields = message.DESCRIPTOR.fields
        if (
            opts.single_repeated_to_array
            and len(fields) == 1
            and fields[0].is_repeated
            and not _is_map_field(fields[0])
        ):
            doc: Any = _field_to_json(message, fields[0], opts)
        else:
            doc = _message_to_dict(message, opts)
        return (
            json.dumps(doc, indent=2 if opts.pretty_json else None),
            "",
        )
    except Exception as e:  # noqa: BLE001 — (ok, error) surface
        return None, str(e)


# ---------------------------------------------------------------------------
# json → pb
# ---------------------------------------------------------------------------

_INT_TYPES = {
    _TYPE.TYPE_INT32, _TYPE.TYPE_INT64, _TYPE.TYPE_UINT32,
    _TYPE.TYPE_UINT64, _TYPE.TYPE_SINT32, _TYPE.TYPE_SINT64,
    _TYPE.TYPE_FIXED32, _TYPE.TYPE_FIXED64, _TYPE.TYPE_SFIXED32,
    _TYPE.TYPE_SFIXED64,
}


def _scalar_from_json(f, v, opts: Json2PbOptions):
    if f.type == _TYPE.TYPE_BYTES:
        if not isinstance(v, str):
            raise _ConvertError(f"expect string for bytes field {f.name}")
        if opts.base64_to_bytes:
            try:
                return base64.b64decode(v, validate=True)
            except Exception as e:  # noqa: BLE001
                raise _ConvertError(
                    f"invalid base64 in field {f.name}: {e}"
                ) from e
        return v.encode("latin-1")
    if f.type == _TYPE.TYPE_ENUM:
        if isinstance(v, str):
            ev = f.enum_type.values_by_name.get(v)
            if ev is None:
                raise _ConvertError(f"unknown enum value {v!r} for {f.name}")
            return ev.number
        if isinstance(v, int) and not isinstance(v, bool):
            return v
        raise _ConvertError(f"invalid enum value for {f.name}")
    if f.type == _TYPE.TYPE_BOOL:
        if not isinstance(v, bool):
            raise _ConvertError(f"expect bool for field {f.name}")
        return v
    if f.type in _INT_TYPES:
        if isinstance(v, bool) or not isinstance(v, (int, str)):
            raise _ConvertError(f"expect integer for field {f.name}")
        try:
            return int(v)
        except ValueError as e:
            raise _ConvertError(
                f"expect integer for field {f.name}: {v!r}"
            ) from e
    if f.type in (_TYPE.TYPE_FLOAT, _TYPE.TYPE_DOUBLE):
        if v in ("NaN", "Infinity", "-Infinity"):
            return float(v.replace("Infinity", "inf"))
        if isinstance(v, bool) or not isinstance(v, (int, float, str)):
            raise _ConvertError(f"expect number for field {f.name}")
        try:
            # canonical proto3 JSON allows quoted numbers; json_format
            # accepted them, so the restful path must keep doing so
            return float(v)
        except ValueError as e:
            raise _ConvertError(
                f"expect number for field {f.name}: {v!r}"
            ) from e
    if f.type == _TYPE.TYPE_STRING:
        if not isinstance(v, str):
            raise _ConvertError(f"expect string for field {f.name}")
        return v
    raise _ConvertError(f"unsupported field type {f.type} for {f.name}")


def _set_map_field(msg, f, v, opts: Json2PbOptions):
    target = getattr(msg, f.name)
    kf = f.message_type.fields_by_name["key"]
    vf = f.message_type.fields_by_name["value"]

    def coerce_key(k):
        if kf.type == _TYPE.TYPE_STRING:
            return k
        if kf.type == _TYPE.TYPE_BOOL:
            return k in ("true", "True", True)
        return int(k)

    def set_entry(k, val):
        if vf.type == _TYPE.TYPE_MESSAGE:
            _dict_to_message(val, target[coerce_key(k)], opts)
        else:
            target[coerce_key(k)] = _scalar_from_json(vf, val, opts)

    if isinstance(v, dict):
        for k, val in v.items():
            set_entry(k, val)
        return
    if isinstance(v, list):  # repeated {key,value} entry form
        for entry in v:
            if not isinstance(entry, dict) or "key" not in entry:
                raise _ConvertError(f"bad map entry for {f.name}")
            set_entry(entry["key"], entry.get("value"))
        return
    raise _ConvertError(f"expect object/array for map field {f.name}")


_JSON_NAME_CACHE: dict = {}  # descriptor → {json_name: field}


def _json_names(descriptor):
    m = _JSON_NAME_CACHE.get(descriptor)
    if m is None:
        m = _JSON_NAME_CACHE[descriptor] = {
            f.json_name: f for f in descriptor.fields
        }
    return m


def _dict_to_message(doc, msg, opts: Json2PbOptions):
    if not isinstance(doc, dict):
        raise _ConvertError(
            f"expect JSON object for message {msg.DESCRIPTOR.name}"
        )
    by_name = msg.DESCRIPTOR.fields_by_name
    by_json = _json_names(msg.DESCRIPTOR)
    for key, v in doc.items():
        f = by_name.get(key) or by_json.get(key)
        if f is None:
            if opts.allow_unknown_fields:
                continue
            raise _ConvertError(f"unknown field {key!r}")
        if v is None:
            continue
        if _is_map_field(f):
            _set_map_field(msg, f, v, opts)
        elif f.is_repeated:
            if not isinstance(v, list):
                raise _ConvertError(f"expect array for repeated {f.name}")
            tgt = getattr(msg, f.name)
            for item in v:
                if f.type == _TYPE.TYPE_MESSAGE:
                    _dict_to_message(item, tgt.add(), opts)
                else:
                    tgt.append(_scalar_from_json(f, item, opts))
        elif f.type == _TYPE.TYPE_MESSAGE:
            _dict_to_message(v, getattr(msg, f.name), opts)
        else:
            setattr(msg, f.name, _scalar_from_json(f, v, opts))


def json_to_proto_with_options(
    data, message, options: Optional[Json2PbOptions] = None
) -> Tuple[bool, str, int]:
    """JsonToProtoMessage analog → (ok, error, parsed_offset)."""
    opts = options or Json2PbOptions()
    if isinstance(data, IOBuf):
        data = data.to_bytes()
    was_bytes = isinstance(data, (bytes, bytearray))
    if was_bytes:
        data = bytes(data).decode("utf-8", errors="replace")
    stripped = data.lstrip()
    if not stripped:
        # reference: empty doc returns false; error text stays empty
        # under allow_remaining (json_to_pb.h:50-53)
        return False, (
            "" if opts.allow_remaining_bytes_after_parsing
            else "The document is empty"
        ), 0
    try:
        if opts.allow_remaining_bytes_after_parsing:
            doc, end = json.JSONDecoder().raw_decode(data, len(data) - len(stripped))
        else:
            doc = json.loads(data)
            end = len(data)
    except ValueError as e:
        return False, f"invalid JSON: {e}", 0
    try:
        fields = message.DESCRIPTOR.fields
        if isinstance(doc, list):
            if not (
                opts.array_to_single_repeated
                and len(fields) == 1
                and fields[0].is_repeated
                and not _is_map_field(fields[0])
            ):
                raise _ConvertError(
                    "JSON array needs array_to_single_repeated and a "
                    "single-repeated-field message (json_to_pb.h:37-39)"
                )
            _dict_to_message({fields[0].name: doc}, message, opts)
        else:
            _dict_to_message(doc, message, opts)
        # required-field check (proto2), ONCE over the whole tree —
        # FindInitializationErrors is itself recursive, so calling it
        # per nested message would be quadratic
        missing = message.FindInitializationErrors()
        if missing:
            raise _ConvertError(f"missing required fields: {missing}")
        if was_bytes:
            # parsed_offset is a BYTE offset into the caller's buffer
            # (json_to_pb.h:41-58); the decoder gave a character count.
            # Exact for cleanly-decoded UTF-8; inputs that hit the
            # errors='replace' substitution were never resumable anyway.
            end = len(data[:end].encode("utf-8"))
        return True, "", end
    except (_ConvertError, ValueError, TypeError) as e:
        # ValueError/TypeError: protobuf range checks (int32 overflow),
        # map-key coercion — the contract is (ok, error), no exceptions
        return False, str(e), 0


# ---------------------------------------------------------------------------
# legacy surface (pre-options wrappers; HTTP restful mapping uses these)
# ---------------------------------------------------------------------------


def json_to_proto(data, message) -> Tuple[bool, str]:
    """Parse JSON (bytes/str/IOBuf) into `message`. Returns (ok, error)."""
    ok, err, _ = json_to_proto_with_options(data, message)
    return ok, err


def proto_to_json(message, pretty: bool = False) -> str:
    out, err = proto_to_json_with_options(
        message, Pb2JsonOptions(pretty_json=pretty)
    )
    if out is None:
        raise ValueError(err)
    return out
