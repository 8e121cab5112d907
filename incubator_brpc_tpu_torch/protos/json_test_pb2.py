# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: json_test.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0fjson_test.proto\x12\x17incubator_brpc_tpu.test\"%\n\x06SubMsg\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x05\"\x92\x04\n\tJsonProbe\x12\x0b\n\x03i32\x18\x01 \x01(\x05\x12\x0b\n\x03i64\x18\x02 \x01(\x03\x12\t\n\x01\x64\x18\x03 \x01(\x01\x12\x0c\n\x04\x66lag\x18\x04 \x01(\x08\x12\x0c\n\x04text\x18\x05 \x01(\t\x12\x0c\n\x04\x62lob\x18\x06 \x01(\x0c\x12-\n\x05\x63olor\x18\x07 \x01(\x0e\x32\x1e.incubator_brpc_tpu.test.Color\x12,\n\x03sub\x18\x08 \x01(\x0b\x32\x1f.incubator_brpc_tpu.test.SubMsg\x12\x0c\n\x04nums\x18\t \x03(\x05\x12-\n\x04subs\x18\n \x03(\x0b\x32\x1f.incubator_brpc_tpu.test.SubMsg\x12>\n\x06\x63ounts\x18\x0b \x03(\x0b\x32..incubator_brpc_tpu.test.JsonProbe.CountsEntry\x12<\n\x05items\x18\x0c \x03(\x0b\x32-.incubator_brpc_tpu.test.JsonProbe.ItemsEntry\x12\x14\n\x07opt_i32\x18\r \x01(\x05H\x00\x88\x01\x01\x1a-\n\x0b\x43ountsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x05:\x02\x38\x01\x1aM\n\nItemsEntry\x12\x0b\n\x03key\x18\x01 \x01(\x05\x12.\n\x05value\x18\x02 \x01(\x0b\x32\x1f.incubator_brpc_tpu.test.SubMsg:\x02\x38\x01\x42\n\n\x08_opt_i32\"\x19\n\x08OnlyList\x12\r\n\x05names\x18\x01 \x03(\t*%\n\x05\x43olor\x12\x07\n\x03RED\x10\x00\x12\t\n\x05GREEN\x10\x01\x12\x08\n\x04\x42LUE\x10\x02\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'json_test_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _JSONPROBE_COUNTSENTRY._options = None
  _JSONPROBE_COUNTSENTRY._serialized_options = b'8\001'
  _JSONPROBE_ITEMSENTRY._options = None
  _JSONPROBE_ITEMSENTRY._serialized_options = b'8\001'
  _COLOR._serialized_start=643
  _COLOR._serialized_end=680
  _SUBMSG._serialized_start=44
  _SUBMSG._serialized_end=81
  _JSONPROBE._serialized_start=84
  _JSONPROBE._serialized_end=614
  _JSONPROBE_COUNTSENTRY._serialized_start=478
  _JSONPROBE_COUNTSENTRY._serialized_end=523
  _JSONPROBE_ITEMSENTRY._serialized_start=525
  _JSONPROBE_ITEMSENTRY._serialized_end=602
  _ONLYLIST._serialized_start=616
  _ONLYLIST._serialized_end=641
# @@protoc_insertion_point(module_scope)
