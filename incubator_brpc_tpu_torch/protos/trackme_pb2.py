# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: trackme.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rtrackme.proto\x12\x07tpubrpc\":\n\x0eTrackMeRequest\x12\x13\n\x0brpc_version\x18\x01 \x01(\x03\x12\x13\n\x0bserver_addr\x18\x02 \x01(\t\"g\n\x0fTrackMeResponse\x12*\n\x08severity\x18\x01 \x01(\x0e\x32\x18.tpubrpc.TrackMeSeverity\x12\x12\n\nerror_text\x18\x02 \x01(\t\x12\x14\n\x0cnew_interval\x18\x03 \x01(\x05*F\n\x0fTrackMeSeverity\x12\r\n\tTrackMeOK\x10\x00\x12\x12\n\x0eTrackMeWarning\x10\x01\x12\x10\n\x0cTrackMeFatal\x10\x02')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'trackme_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TRACKMESEVERITY._serialized_start=191
  _TRACKMESEVERITY._serialized_end=261
  _TRACKMEREQUEST._serialized_start=26
  _TRACKMEREQUEST._serialized_end=84
  _TRACKMERESPONSE._serialized_start=86
  _TRACKMERESPONSE._serialized_end=189
# @@protoc_insertion_point(module_scope)
