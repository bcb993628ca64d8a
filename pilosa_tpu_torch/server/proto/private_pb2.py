# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: private.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rprivate.proto\x12\x12pilosa_tpu.private\"\x19\n\tIndexMeta\x12\x0c\n\x04Keys\x18\x03 \x01(\x08\"\x7f\n\x0c\x46ieldOptions\x12\x0c\n\x04Type\x18\x08 \x01(\t\x12\x11\n\tCacheType\x18\x03 \x01(\t\x12\x11\n\tCacheSize\x18\x04 \x01(\r\x12\x0b\n\x03Min\x18\t \x01(\x03\x12\x0b\n\x03Max\x18\n \x01(\x03\x12\x13\n\x0bTimeQuantum\x18\x05 \x01(\t\x12\x0c\n\x04Keys\x18\x0b \x01(\x08\"{\n\tMaxShards\x12=\n\x08Standard\x18\x01 \x03(\x0b\x32+.pilosa_tpu.private.MaxShards.StandardEntry\x1a/\n\rStandardEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x04:\x02\x38\x01\"2\n\x12\x43reateShardMessage\x12\r\n\x05Index\x18\x01 \x01(\t\x12\r\n\x05Shard\x18\x02 \x01(\x04\"#\n\x12\x44\x65leteIndexMessage\x12\r\n\x05Index\x18\x01 \x01(\t\"P\n\x12\x43reateIndexMessage\x12\r\n\x05Index\x18\x01 \x01(\t\x12+\n\x04Meta\x18\x02 \x01(\x0b\x32\x1d.pilosa_tpu.private.IndexMeta\"b\n\x12\x43reateFieldMessage\x12\r\n\x05Index\x18\x01 \x01(\t\x12\r\n\x05\x46ield\x18\x02 \x01(\t\x12.\n\x04Meta\x18\x03 \x01(\x0b\x32 .pilosa_tpu.private.FieldOptions\"2\n\x12\x44\x65leteFieldMessage\x12\r\n\x05Index\x18\x01 \x01(\t\x12\r\n\x05\x46ield\x18\x02 \x01(\t\"T\n\x05\x46ield\x12\x0c\n\x04Name\x18\x01 \x01(\t\x12.\n\x04Meta\x18\x02 \x01(\x0b\x32 .pilosa_tpu.private.FieldOptions\x12\r\n\x05Views\x18\x03 \x03(\t\"4\n\x06Schema\x12*\n\x07Indexes\x18\x01 \x03(\x0b\x32\x19.pilosa_tpu.private.Index\"@\n\x05Index\x12\x0c\n\x04Name\x18\x01 \x01(\t\x12)\n\x06\x46ields\x18\x04 \x03(\x0b\x32\x19.pilosa_tpu.private.Field\"1\n\x03URI\x12\x0e\n\x06Scheme\x18\x01 \x01(\t\x12\x0c\n\x04Host\x18\x02 \x01(\t\x12\x0c\n\x04Port\x18\x03 \x01(\r\"O\n\x04Node\x12\n\n\x02ID\x18\x01 \x01(\t\x12$\n\x03URI\x18\x02 \x01(\x0b\x32\x17.pilosa_tpu.private.URI\x12\x15\n\rIsCoordinator\x18\x03 \x01(\x08\"1\n\x10NodeStateMessage\x12\x0e\n\x06NodeID\x18\x01 \x01(\t\x12\r\n\x05State\x18\x02 \x01(\t\"I\n\x10NodeEventMessage\x12\r\n\x05\x45vent\x18\x01 \x01(\r\x12&\n\x04Node\x18\x02 \x01(\x0b\x32\x18.pilosa_tpu.private.Node\"\x92\x01\n\nNodeStatus\x12&\n\x04Node\x18\x01 \x01(\x0b\x32\x18.pilosa_tpu.private.Node\x12\x30\n\tMaxShards\x18\x02 \x01(\x0b\x32\x1d.pilosa_tpu.private.MaxShards\x12*\n\x06Schema\x18\x03 \x01(\x0b\x32\x1a.pilosa_tpu.private.Schema\"Z\n\rClusterStatus\x12\x11\n\tClusterID\x18\x01 \x01(\t\x12\r\n\x05State\x18\x02 \x01(\t\x12\'\n\x05Nodes\x18\x03 \x03(\x0b\x32\x18.pilosa_tpu.private.Node\"?\n\x11\x43reateViewMessage\x12\r\n\x05Index\x18\x01 \x01(\t\x12\r\n\x05\x46ield\x18\x02 \x01(\t\x12\x0c\n\x04View\x18\x03 \x01(\t\"?\n\x11\x44\x65leteViewMessage\x12\r\n\x05Index\x18\x01 \x01(\t\x12\r\n\x05\x46ield\x18\x02 \x01(\t\x12\x0c\n\x04View\x18\x03 \x01(\t\"\x92\x02\n\x11ResizeInstruction\x12\r\n\x05JobID\x18\x01 \x01(\x03\x12&\n\x04Node\x18\x02 \x01(\x0b\x32\x18.pilosa_tpu.private.Node\x12-\n\x0b\x43oordinator\x18\x03 \x01(\x0b\x32\x18.pilosa_tpu.private.Node\x12\x31\n\x07Sources\x18\x04 \x03(\x0b\x32 .pilosa_tpu.private.ResizeSource\x12*\n\x06Schema\x18\x05 \x01(\x0b\x32\x1a.pilosa_tpu.private.Schema\x12\x38\n\rClusterStatus\x18\x06 \x01(\x0b\x32!.pilosa_tpu.private.ClusterStatus\"q\n\x0cResizeSource\x12&\n\x04Node\x18\x01 \x01(\x0b\x32\x18.pilosa_tpu.private.Node\x12\r\n\x05Index\x18\x02 \x01(\t\x12\r\n\x05\x46ield\x18\x03 \x01(\t\x12\x0c\n\x04View\x18\x04 \x01(\t\x12\r\n\x05Shard\x18\x05 \x01(\x04\"a\n\x19ResizeInstructionComplete\x12\r\n\x05JobID\x18\x01 \x01(\x03\x12&\n\x04Node\x18\x02 \x01(\x0b\x32\x18.pilosa_tpu.private.Node\x12\r\n\x05\x45rror\x18\x03 \x01(\t\">\n\x15SetCoordinatorMessage\x12%\n\x03New\x18\x01 \x01(\x0b\x32\x18.pilosa_tpu.private.Node\"A\n\x18UpdateCoordinatorMessage\x12%\n\x03New\x18\x01 \x01(\x0b\x32\x18.pilosa_tpu.private.Node\".\n\x08Topology\x12\x11\n\tClusterID\x18\x01 \x01(\t\x12\x0f\n\x07NodeIDs\x18\x02 \x03(\t\"\x13\n\x11RecalculateCachesb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'private_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _MAXSHARDS_STANDARDENTRY._options = None
  _MAXSHARDS_STANDARDENTRY._serialized_options = b'8\001'
  _INDEXMETA._serialized_start=37
  _INDEXMETA._serialized_end=62
  _FIELDOPTIONS._serialized_start=64
  _FIELDOPTIONS._serialized_end=191
  _MAXSHARDS._serialized_start=193
  _MAXSHARDS._serialized_end=316
  _MAXSHARDS_STANDARDENTRY._serialized_start=269
  _MAXSHARDS_STANDARDENTRY._serialized_end=316
  _CREATESHARDMESSAGE._serialized_start=318
  _CREATESHARDMESSAGE._serialized_end=368
  _DELETEINDEXMESSAGE._serialized_start=370
  _DELETEINDEXMESSAGE._serialized_end=405
  _CREATEINDEXMESSAGE._serialized_start=407
  _CREATEINDEXMESSAGE._serialized_end=487
  _CREATEFIELDMESSAGE._serialized_start=489
  _CREATEFIELDMESSAGE._serialized_end=587
  _DELETEFIELDMESSAGE._serialized_start=589
  _DELETEFIELDMESSAGE._serialized_end=639
  _FIELD._serialized_start=641
  _FIELD._serialized_end=725
  _SCHEMA._serialized_start=727
  _SCHEMA._serialized_end=779
  _INDEX._serialized_start=781
  _INDEX._serialized_end=845
  _URI._serialized_start=847
  _URI._serialized_end=896
  _NODE._serialized_start=898
  _NODE._serialized_end=977
  _NODESTATEMESSAGE._serialized_start=979
  _NODESTATEMESSAGE._serialized_end=1028
  _NODEEVENTMESSAGE._serialized_start=1030
  _NODEEVENTMESSAGE._serialized_end=1103
  _NODESTATUS._serialized_start=1106
  _NODESTATUS._serialized_end=1252
  _CLUSTERSTATUS._serialized_start=1254
  _CLUSTERSTATUS._serialized_end=1344
  _CREATEVIEWMESSAGE._serialized_start=1346
  _CREATEVIEWMESSAGE._serialized_end=1409
  _DELETEVIEWMESSAGE._serialized_start=1411
  _DELETEVIEWMESSAGE._serialized_end=1474
  _RESIZEINSTRUCTION._serialized_start=1477
  _RESIZEINSTRUCTION._serialized_end=1751
  _RESIZESOURCE._serialized_start=1753
  _RESIZESOURCE._serialized_end=1866
  _RESIZEINSTRUCTIONCOMPLETE._serialized_start=1868
  _RESIZEINSTRUCTIONCOMPLETE._serialized_end=1965
  _SETCOORDINATORMESSAGE._serialized_start=1967
  _SETCOORDINATORMESSAGE._serialized_end=2029
  _UPDATECOORDINATORMESSAGE._serialized_start=2031
  _UPDATECOORDINATORMESSAGE._serialized_end=2096
  _TOPOLOGY._serialized_start=2098
  _TOPOLOGY._serialized_end=2144
  _RECALCULATECACHES._serialized_start=2146
  _RECALCULATECACHES._serialized_end=2165
# @@protoc_insertion_point(module_scope)
