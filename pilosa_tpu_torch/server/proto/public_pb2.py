# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: public.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0cpublic.proto\x12\npilosa_tpu\"E\n\x03Row\x12\x0f\n\x07\x43olumns\x18\x01 \x03(\x04\x12\x0c\n\x04Keys\x18\x03 \x03(\t\x12\x1f\n\x05\x41ttrs\x18\x02 \x03(\x0b\x32\x10.pilosa_tpu.Attr\".\n\x04Pair\x12\n\n\x02ID\x18\x01 \x01(\x04\x12\x0b\n\x03Key\x18\x03 \x01(\t\x12\r\n\x05\x43ount\x18\x02 \x01(\x04\"&\n\x08ValCount\x12\x0b\n\x03Val\x18\x01 \x01(\x03\x12\r\n\x05\x43ount\x18\x02 \x01(\x03\"9\n\x03\x42it\x12\r\n\x05RowID\x18\x01 \x01(\x04\x12\x10\n\x08\x43olumnID\x18\x02 \x01(\x04\x12\x11\n\tTimestamp\x18\x03 \x01(\x03\"I\n\rColumnAttrSet\x12\n\n\x02ID\x18\x01 \x01(\x04\x12\x0b\n\x03Key\x18\x03 \x01(\t\x12\x1f\n\x05\x41ttrs\x18\x02 \x03(\x0b\x32\x10.pilosa_tpu.Attr\"o\n\x04\x41ttr\x12\x0b\n\x03Key\x18\x01 \x01(\t\x12\x0c\n\x04Type\x18\x02 \x01(\x04\x12\x13\n\x0bStringValue\x18\x03 \x01(\t\x12\x10\n\x08IntValue\x18\x04 \x01(\x03\x12\x11\n\tBoolValue\x18\x05 \x01(\x08\x12\x12\n\nFloatValue\x18\x06 \x01(\x01\"*\n\x07\x41ttrMap\x12\x1f\n\x05\x41ttrs\x18\x01 \x03(\x0b\x32\x10.pilosa_tpu.Attr\"\x83\x01\n\x0cQueryRequest\x12\r\n\x05Query\x18\x01 \x01(\t\x12\x0e\n\x06Shards\x18\x02 \x03(\x04\x12\x13\n\x0b\x43olumnAttrs\x18\x03 \x01(\x08\x12\x0e\n\x06Remote\x18\x05 \x01(\x08\x12\x17\n\x0f\x45xcludeRowAttrs\x18\x06 \x01(\x08\x12\x16\n\x0e\x45xcludeColumns\x18\x07 \x01(\x08\"y\n\rQueryResponse\x12\x0b\n\x03\x45rr\x18\x01 \x01(\t\x12(\n\x07Results\x18\x02 \x03(\x0b\x32\x17.pilosa_tpu.QueryResult\x12\x31\n\x0e\x43olumnAttrSets\x18\x03 \x03(\x0b\x32\x19.pilosa_tpu.ColumnAttrSet\"\x9e\x01\n\x0bQueryResult\x12\x0c\n\x04Type\x18\x06 \x01(\r\x12\x1c\n\x03Row\x18\x01 \x01(\x0b\x32\x0f.pilosa_tpu.Row\x12\t\n\x01N\x18\x02 \x01(\x04\x12\x1f\n\x05Pairs\x18\x03 \x03(\x0b\x32\x10.pilosa_tpu.Pair\x12&\n\x08ValCount\x18\x05 \x01(\x0b\x32\x14.pilosa_tpu.ValCount\x12\x0f\n\x07\x43hanged\x18\x04 \x01(\x08\"\x98\x01\n\rImportRequest\x12\r\n\x05Index\x18\x01 \x01(\t\x12\r\n\x05\x46ield\x18\x02 \x01(\t\x12\r\n\x05Shard\x18\x03 \x01(\x04\x12\x0e\n\x06RowIDs\x18\x04 \x03(\x04\x12\x11\n\tColumnIDs\x18\x05 \x03(\x04\x12\x0f\n\x07RowKeys\x18\x07 \x03(\t\x12\x12\n\nColumnKeys\x18\x08 \x03(\t\x12\x12\n\nTimestamps\x18\x06 \x03(\x03\"x\n\x12ImportValueRequest\x12\r\n\x05Index\x18\x01 \x01(\t\x12\r\n\x05\x46ield\x18\x02 \x01(\t\x12\r\n\x05Shard\x18\x03 \x01(\x04\x12\x11\n\tColumnIDs\x18\x05 \x03(\x04\x12\x12\n\nColumnKeys\x18\x07 \x03(\t\x12\x0e\n\x06Values\x18\x06 \x03(\x03\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'public_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _ROW._serialized_start=28
  _ROW._serialized_end=97
  _PAIR._serialized_start=99
  _PAIR._serialized_end=145
  _VALCOUNT._serialized_start=147
  _VALCOUNT._serialized_end=185
  _BIT._serialized_start=187
  _BIT._serialized_end=244
  _COLUMNATTRSET._serialized_start=246
  _COLUMNATTRSET._serialized_end=319
  _ATTR._serialized_start=321
  _ATTR._serialized_end=432
  _ATTRMAP._serialized_start=434
  _ATTRMAP._serialized_end=476
  _QUERYREQUEST._serialized_start=479
  _QUERYREQUEST._serialized_end=610
  _QUERYRESPONSE._serialized_start=612
  _QUERYRESPONSE._serialized_end=733
  _QUERYRESULT._serialized_start=736
  _QUERYRESULT._serialized_end=894
  _IMPORTREQUEST._serialized_start=897
  _IMPORTREQUEST._serialized_end=1049
  _IMPORTVALUEREQUEST._serialized_start=1051
  _IMPORTVALUEREQUEST._serialized_end=1171
# @@protoc_insertion_point(module_scope)
