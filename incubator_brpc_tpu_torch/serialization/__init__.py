"""Serialization adjuncts (reference src/json2pb/ + mcpack2pb/)."""

from incubator_brpc_tpu_torch.serialization.json2pb import (  # noqa: F401
    json_to_proto,
    proto_to_json,
)
