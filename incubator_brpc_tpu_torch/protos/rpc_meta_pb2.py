# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: rpc_meta.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0erpc_meta.proto\x12\x07tpubrpc"\x96\x01\n\x0eRpcRequestMeta\x12\x14\n\x0cservice_name\x18\x01 \x01(\t\x12\x13\n\x0bmethod_name\x18\x02 \x01(\t\x12\x0e\n\x06log_id\x18\x03 \x01(\x03\x12\x10\n\x08trace_id\x18\x04 \x01(\x03\x12\x0f\n\x07span_id\x18\x05 \x01(\x03\x12\x16\n\x0eparent_span_id\x18\x06 \x01(\x03\x12\x0e\n\x06tenant\x18\x07 \x01(\t"Q\n\x0fRpcResponseMeta\x12\x12\n\nerror_code\x18\x01 \x01(\x05\x12\x12\n\nerror_text\x18\x02 \x01(\t\x12\x16\n\x0eserver_time_us\x18\x03 \x01(\x03"\x80\x01\n\x0eStreamSettings\x12\x11\n\tstream_id\x18\x01 \x01(\x03\x12\x15\n\rneed_feedback\x18\x02 \x01(\x08\x12\x18\n\x10remote_stream_id\x18\x03 \x01(\x03\x12\x14\n\x0cmin_buf_size\x18\x04 \x01(\x03\x12\x14\n\x0cmax_buf_size\x18\x05 \x01(\x03"T\n\x11DeviceSegmentMeta\x12\r\n\x05dtype\x18\x01 \x01(\t\x12\r\n\x05shape\x18\x02 \x03(\x03\x12\x0e\n\x06nbytes\x18\x03 \x01(\x03\x12\x11\n\tplacement\x18\x04 \x01(\x05"\xb1\x02\n\x07RpcMeta\x12(\n\x07request\x18\x01 \x01(\x0b2\x17.tpubrpc.RpcRequestMeta\x12*\n\x08response\x18\x02 \x01(\x0b2\x18.tpubrpc.RpcResponseMeta\x12\x15\n\rcompress_type\x18\x03 \x01(\x05\x12\x16\n\x0ecorrelation_id\x18\x04 \x01(\x03\x12\x17\n\x0fattachment_size\x18\x05 \x01(\x05\x120\n\x0fstream_settings\x18\x06 \x01(\x0b2\x17.tpubrpc.StreamSettings\x123\n\x0fdevice_segments\x18\x07 \x03(\x0b2\x1a.tpubrpc.DeviceSegmentMeta\x12\x11\n\tauth_data\x18\x08 \x01(\t\x12\x0e\n\x06cancel\x18\t \x01(\x08b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'rpc_meta_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _RPCREQUESTMETA._serialized_start=28
  _RPCREQUESTMETA._serialized_end=178
  _RPCRESPONSEMETA._serialized_start=180
  _RPCRESPONSEMETA._serialized_end=261
  _STREAMSETTINGS._serialized_start=264
  _STREAMSETTINGS._serialized_end=392
  _DEVICESEGMENTMETA._serialized_start=394
  _DEVICESEGMENTMETA._serialized_end=478
  _RPCMETA._serialized_start=481
  _RPCMETA._serialized_end=786
# @@protoc_insertion_point(module_scope)
