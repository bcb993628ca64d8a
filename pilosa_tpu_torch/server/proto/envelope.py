"""Type-byte + protobuf envelope for the private cluster plane.

The reference frames every node-to-node cluster message as one type byte
followed by a protobuf payload (broadcast.go:52-162, 16 message types from
internal/private.proto). This codec speaks that envelope — same type-byte
order, same message field numbers — translating to/from the dict shapes
`Server.receive_message` dispatches on, so the cluster plane negotiates
protobuf exactly like the public query plane already does (Content-Type:
application/x-protobuf), with JSON kept as the debug fallback.

Extensions (documented divergence, all invisible to a reference parser —
proto3 skips unknown fields):
  - CreateShardMessage carries Field=15/View=16 (our shard broadcast
    creates the fragment remotely; the reference's only bumps max-shard).
  - Node carries ProcessIdx=15 (multi-host collective-plane slot mapping).
  - Index carries Meta=15 (index keys flag survives schema sync).
  - ResizeInstruction carries MaxShards=15 (remote max-shard seeding).
  - Type byte 0xFF wraps repo-native messages (schema sync,
    collective-exec, remove-node...) as JSON — planes the reference has no
    vocabulary for.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, Tuple

from . import private_pb2 as pb
from ..mux import split_host_port

# Reference broadcast.go:52-69 type-byte order.
TYPE_CREATE_SHARD = 0
TYPE_CREATE_INDEX = 1
TYPE_DELETE_INDEX = 2
TYPE_CREATE_FIELD = 3
TYPE_DELETE_FIELD = 4
TYPE_CREATE_VIEW = 5
TYPE_DELETE_VIEW = 6
TYPE_CLUSTER_STATUS = 7
TYPE_RESIZE_INSTRUCTION = 8
TYPE_RESIZE_INSTRUCTION_COMPLETE = 9
TYPE_SET_COORDINATOR = 10
TYPE_UPDATE_COORDINATOR = 11
TYPE_NODE_STATE = 12
TYPE_RECALCULATE_CACHES = 13
TYPE_NODE_EVENT = 14
TYPE_NODE_STATUS = 15
TYPE_JSON_EXT = 0xFF

# Reference event.go:20-24.
EVENT_JOIN = 0
EVENT_LEAVE = 1
EVENT_UPDATE = 2

# Extension field numbers (see module docstring).
_F_SHARD_FIELD = 15
_F_SHARD_VIEW = 16


# ------------------------------------------------------------- node codecs


def _encode_node(node_pb, d: dict) -> None:
    """dict {id, uri, isCoordinator, processIdx} -> pb.Node. Our uri is
    'host:port' (optionally 'scheme://host:port'); the reference splits it
    into a URI message (uri.go:45)."""
    node_pb.ID = d.get("id", "")
    uri = d.get("uri", "") or ""
    scheme = "http"
    if "://" in uri:
        scheme, uri = uri.split("://", 1)
    # One splitter for the whole codebase (mux.split_host_port): the
    # mux dialer and this codec must agree on bracketed '[::1]:10101'
    # and bare '::1' IPv6 forms, so neither grows its own parse. A
    # malformed netloc (unclosed bracket, non-numeric port) rides
    # whole as the host — the reference's tolerant parse.
    try:
        host, port = split_host_port(uri)
        port = port or 0
    except ValueError:
        host, port = uri, 0
    node_pb.URI.Scheme = scheme
    node_pb.URI.Host = host
    node_pb.URI.Port = port
    node_pb.IsCoordinator = bool(d.get("isCoordinator", False))
    if d.get("processIdx") is not None:
        _set_ext_varint(node_pb, 15, int(d["processIdx"]) + 1)


def _decode_node(node_pb) -> dict:
    uri = node_pb.URI.Host
    if node_pb.URI.Port:
        # Re-bracket IPv6 hosts so 'host:port' parses unambiguously.
        if ":" in uri:
            uri = f"[{uri}]:{node_pb.URI.Port}"
        else:
            uri = f"{uri}:{node_pb.URI.Port}"
    if node_pb.URI.Scheme and node_pb.URI.Scheme != "http":
        uri = f"{node_pb.URI.Scheme}://{uri}"
    d = {"id": node_pb.ID, "uri": uri,
         "isCoordinator": node_pb.IsCoordinator}
    pidx = _get_ext_varint(node_pb, 15)
    if pidx is not None:
        d["processIdx"] = pidx - 1
    return d


def _set_ext_varint(msg, field_num: int, value: int) -> None:
    """Attach a varint in an extension field number the schema does not
    declare: serialized as an unknown field, skipped by reference parsers,
    recovered by _get_ext_varint. Zigzag-free (values are small and
    non-negative; 0 is reserved as 'absent' so callers bias by +1)."""
    if value <= 0:
        return
    key = (field_num << 3) | 0  # wire type 0: varint
    out = bytearray()
    for tag_or_val in (key, value):
        v = tag_or_val
        while True:
            b = v & 0x7F
            v >>= 7
            out.append(b | (0x80 if v else 0))
            if not v:
                break
    # MergeFromString appends the bytes as an unknown field.
    msg.MergeFromString(bytes(out))


def _get_ext_varint(msg, field_num: int):
    """Read back an extension varint from a message's unknown fields by
    re-scanning its serialization (protobuf python's UnknownFieldSet API
    moved across versions; the wire scan is stable)."""
    data = msg.SerializeToString()
    i, n = 0, len(data)

    def varint():
        nonlocal i
        shift = v = 0
        while True:
            b = data[i]
            i += 1
            v |= (b & 0x7F) << shift
            if not (b & 0x80):
                return v
            shift += 7

    while i < n:
        key = varint()
        fnum, wt = key >> 3, key & 7
        if wt == 0:
            v = varint()
            if fnum == field_num:
                return v
        elif wt == 2:
            ln = varint()
            i += ln
        elif wt == 5:
            i += 4
        elif wt == 1:
            i += 8
        else:  # groups unused in proto3
            return None
    return None


# ---------------------------------------------------------- schema codecs


def _encode_field_options(fo_pb, opts: dict) -> None:
    fo_pb.Type = opts.get("type", "")
    fo_pb.CacheType = opts.get("cacheType", "")
    fo_pb.CacheSize = int(opts.get("cacheSize", 0) or 0)
    fo_pb.Min = int(opts.get("min", 0) or 0)
    fo_pb.Max = int(opts.get("max", 0) or 0)
    fo_pb.TimeQuantum = opts.get("timeQuantum", "") or ""
    fo_pb.Keys = bool(opts.get("keys", False))


def _decode_field_options(fo_pb) -> dict:
    return {
        "type": fo_pb.Type,
        "cacheType": fo_pb.CacheType,
        "cacheSize": fo_pb.CacheSize,
        "min": fo_pb.Min,
        "max": fo_pb.Max,
        "timeQuantum": fo_pb.TimeQuantum,
        "keys": fo_pb.Keys,
    }


def _encode_schema(schema_pb, schema: list) -> None:
    for idx_info in schema or []:
        ix = schema_pb.Indexes.add()
        ix.Name = idx_info.get("name", "")
        if idx_info.get("options", {}).get("keys"):
            # Extension Meta=15 (IndexMeta{Keys=3}): field 3 varint 1
            # inside a length-delimited field 15.
            _set_ext_bytes(ix, 15, bytes([0x18, 0x01]))
        for f_info in idx_info.get("fields", []):
            f = ix.Fields.add()
            f.Name = f_info.get("name", "")
            _encode_field_options(f.Meta, f_info.get("options", {}))
            f.Views.extend(
                v.get("name", "") if isinstance(v, dict) else str(v)
                for v in f_info.get("views", [])
            )


def _set_ext_bytes(msg, field_num: int, payload: bytes) -> None:
    key = (field_num << 3) | 2  # wire type 2: length-delimited
    out = bytearray()
    for v in (key, len(payload)):
        while True:
            b = v & 0x7F
            v >>= 7
            out.append(b | (0x80 if v else 0))
            if not v:
                break
    msg.MergeFromString(bytes(out) + payload)


def _decode_schema(schema_pb) -> list:
    out = []
    for ix in schema_pb.Indexes:
        # Extension Meta=15 (length-delimited IndexMeta) present => keys.
        keys = _get_ext_bytes(ix.SerializeToString(), 15) is not None
        out.append({
            "name": ix.Name,
            "options": {"keys": keys},
            "fields": [
                {
                    "name": f.Name,
                    "options": _decode_field_options(f.Meta),
                    "views": [{"name": v} for v in f.Views],
                }
                for f in ix.Fields
            ],
        })
    return out


# --------------------------------------------------------- message codecs


def _enc_create_shard(msg: dict):
    m = pb.CreateShardMessage(Index=msg["index"], Shard=int(msg["shard"]))
    if msg.get("field"):
        _set_ext_bytes(m, _F_SHARD_FIELD, msg["field"].encode())
    if msg.get("view"):
        _set_ext_bytes(m, _F_SHARD_VIEW, msg["view"].encode())
    return TYPE_CREATE_SHARD, m


def _dec_create_shard(data: bytes) -> dict:
    m = pb.CreateShardMessage()
    m.ParseFromString(data)
    out = {"type": "create-shard", "index": m.Index, "shard": m.Shard}
    field = _get_ext_bytes(data, _F_SHARD_FIELD)
    view = _get_ext_bytes(data, _F_SHARD_VIEW)
    if field:
        out["field"] = field.decode()
    if view:
        out["view"] = view.decode()
    return out


def _get_ext_bytes(data: bytes, field_num: int):
    i, n = 0, len(data)

    def varint():
        nonlocal i
        shift = v = 0
        while True:
            b = data[i]
            i += 1
            v |= (b & 0x7F) << shift
            if not (b & 0x80):
                return v
            shift += 7

    while i < n:
        key = varint()
        fnum, wt = key >> 3, key & 7
        if wt == 0:
            varint()
        elif wt == 2:
            ln = varint()
            if fnum == field_num:
                return data[i:i + ln]
            i += ln
        elif wt == 5:
            i += 4
        elif wt == 1:
            i += 8
        else:
            return None
    return None


def encode_message(msg: dict) -> bytes:
    """dict -> type byte + protobuf bytes (JSON-ext framed if unmapped)."""
    typ = msg.get("type")
    enc = _ENCODERS.get(typ)
    if enc is None:
        return bytes([TYPE_JSON_EXT]) + json.dumps(msg).encode()
    tb, m = enc(msg)
    return bytes([tb]) + m.SerializeToString()


def decode_message(buf: bytes) -> dict:
    if not buf:
        raise ValueError("empty cluster message")
    tb, data = buf[0], buf[1:]
    if tb == TYPE_JSON_EXT:
        return json.loads(data.decode())
    dec = _DECODERS.get(tb)
    if dec is None:
        raise ValueError(f"invalid cluster message type byte: {tb}")
    return dec(data)


def _simple(tb: int, cls, fields: Dict[str, str], type_name: str):
    """(encoder, decoder) for flat string/int messages: `fields` maps dict
    key -> proto attribute."""

    def enc(msg: dict):
        m = cls()
        for k, attr in fields.items():
            if k in msg and msg[k] is not None:
                setattr(m, attr, msg[k])
        return tb, m

    def dec(data: bytes) -> dict:
        m = cls()
        m.ParseFromString(data)
        out = {"type": type_name}
        for k, attr in fields.items():
            out[k] = getattr(m, attr)
        return out

    return enc, dec


def _enc_create_index(msg: dict):
    m = pb.CreateIndexMessage(Index=msg["index"])
    m.Meta.Keys = bool(msg.get("options", {}).get("keys", False))
    return TYPE_CREATE_INDEX, m


def _dec_create_index(data: bytes) -> dict:
    m = pb.CreateIndexMessage()
    m.ParseFromString(data)
    return {"type": "create-index", "index": m.Index,
            "options": {"keys": m.Meta.Keys}}


def _enc_create_field(msg: dict):
    m = pb.CreateFieldMessage(Index=msg["index"], Field=msg["field"])
    _encode_field_options(m.Meta, msg.get("options", {}))
    return TYPE_CREATE_FIELD, m


def _dec_create_field(data: bytes) -> dict:
    m = pb.CreateFieldMessage()
    m.ParseFromString(data)
    return {"type": "create-field", "index": m.Index, "field": m.Field,
            "options": _decode_field_options(m.Meta)}


def _enc_cluster_status(msg: dict):
    m = pb.ClusterStatus(ClusterID=msg.get("clusterID", ""),
                         State=msg.get("state", ""))
    for nd in msg.get("nodes", []):
        _encode_node(m.Nodes.add(), nd)
    return TYPE_CLUSTER_STATUS, m


def _dec_cluster_status(data: bytes) -> dict:
    m = pb.ClusterStatus()
    m.ParseFromString(data)
    out = {"type": "cluster-status", "state": m.State,
           "nodes": [_decode_node(n) for n in m.Nodes]}
    if m.ClusterID:
        out["clusterID"] = m.ClusterID
    return out


def _enc_resize_instruction(msg: dict):
    m = pb.ResizeInstruction()
    try:
        m.JobID = int(str(msg.get("jobID", "0")), 16)
    except ValueError:
        m.JobID = 0
    _encode_node(m.Node, {"id": msg.get("nodeID", "")})
    _encode_node(m.Coordinator, {"id": msg.get("coordinatorID", ""),
                                 "uri": msg.get("coordinatorURI", "")})
    for src in msg.get("sources", []):
        s = m.Sources.add()
        _encode_node(s.Node, {"id": src.get("sourceNodeID", "")})
        s.Index = src.get("index", "")
        s.Field = src.get("field", "")
        s.View = src.get("view", "")
        s.Shard = int(src.get("shard", 0))
    _encode_schema(m.Schema, msg.get("schema", []))
    # Node URI map rides ClusterStatus.Nodes (the reference carries the
    # post-resize membership the same way).
    for node_id, uri in (msg.get("nodeURIs", {}) or {}).items():
        _encode_node(m.ClusterStatus.Nodes.add(), {"id": node_id, "uri": uri})
    m.ClusterStatus.State = "RESIZING"
    # Extension MaxShards=15: {index: maxShard} map for remote seeding.
    ms = pb.MaxShards()
    for k, v in (msg.get("maxShards", {}) or {}).items():
        ms.Standard[k] = int(v)
    payload = ms.SerializeToString()
    if payload:
        _set_ext_bytes(m, 15, payload)
    return TYPE_RESIZE_INSTRUCTION, m


def _dec_resize_instruction(data: bytes) -> dict:
    m = pb.ResizeInstruction()
    m.ParseFromString(data)
    out = {
        "type": "resize-instruction",
        "jobID": f"{m.JobID:08x}",
        "nodeID": m.Node.ID,
        "coordinatorID": m.Coordinator.ID,
        "coordinatorURI": _decode_node(m.Coordinator)["uri"],
        "schema": _decode_schema(m.Schema),
        "sources": [
            {"sourceNodeID": s.Node.ID, "index": s.Index, "field": s.Field,
             "view": s.View, "shard": s.Shard}
            for s in m.Sources
        ],
        "nodeURIs": {n.ID: _decode_node(n)["uri"] for n in m.ClusterStatus.Nodes},
        "maxShards": {},
    }
    raw = _get_ext_bytes(data, 15)
    if raw:
        ms = pb.MaxShards()
        ms.ParseFromString(raw)
        out["maxShards"] = dict(ms.Standard)
    return out


def _enc_resize_complete(msg: dict):
    m = pb.ResizeInstructionComplete()
    try:
        m.JobID = int(str(msg.get("jobID", "0")), 16)
    except ValueError:
        m.JobID = 0
    _encode_node(m.Node, {"id": msg.get("nodeID", "")})
    m.Error = msg.get("error", "") or ""
    return TYPE_RESIZE_INSTRUCTION_COMPLETE, m


def _dec_resize_complete(data: bytes) -> dict:
    m = pb.ResizeInstructionComplete()
    m.ParseFromString(data)
    out = {"type": "resize-complete", "jobID": f"{m.JobID:08x}",
           "nodeID": m.Node.ID}
    if m.Error:
        out["error"] = m.Error
    return out


def _enc_set_coordinator(msg: dict):
    m = pb.SetCoordinatorMessage()
    _encode_node(m.New, {"id": msg.get("nodeID", "")})
    return TYPE_SET_COORDINATOR, m


def _dec_set_coordinator(data: bytes) -> dict:
    m = pb.SetCoordinatorMessage()
    m.ParseFromString(data)
    return {"type": "set-coordinator", "nodeID": m.New.ID}


def _dec_update_coordinator(data: bytes) -> dict:
    # The reference's UpdateCoordinatorMessage (broadcast after a
    # SetCoordinator lands, server.go receiveMessage) has identical
    # semantics to our set-coordinator dispatch: apply the new flags.
    m = pb.UpdateCoordinatorMessage()
    m.ParseFromString(data)
    return {"type": "set-coordinator", "nodeID": m.New.ID}


def _enc_node_event(msg: dict):
    m = pb.NodeEventMessage()
    if msg["type"] == "node-join":
        m.Event = EVENT_JOIN
        _encode_node(m.Node, msg.get("node", {}))
    else:
        m.Event = EVENT_LEAVE
        _encode_node(m.Node, {"id": msg.get("nodeID", "")})
    return TYPE_NODE_EVENT, m


def _dec_node_event(data: bytes) -> dict:
    m = pb.NodeEventMessage()
    m.ParseFromString(data)
    if m.Event == EVENT_JOIN:
        return {"type": "node-join", "node": _decode_node(m.Node)}
    if m.Event == EVENT_LEAVE:
        return {"type": "node-leave", "nodeID": m.Node.ID}
    # EVENT_UPDATE (reference nodeUpdate, event.go:23) refreshes node
    # metadata — it must NOT decode as a leave (that would drop a live
    # member). Server.receive_message applies it as a metadata refresh.
    return {"type": "node-update", "node": _decode_node(m.Node)}


def _enc_node_state(msg: dict):
    m = pb.NodeStateMessage(NodeID=msg.get("nodeID", ""),
                            State=msg.get("state", ""))
    return TYPE_NODE_STATE, m


def _dec_node_state(data: bytes) -> dict:
    m = pb.NodeStateMessage()
    m.ParseFromString(data)
    return {"type": "node-state", "nodeID": m.NodeID, "state": m.State}


def _enc_node_status(msg: dict):
    m = pb.NodeStatus()
    _encode_node(m.Node, msg.get("node", {}))
    for k, v in (msg.get("maxShards", {}) or {}).items():
        m.MaxShards.Standard[k] = int(v)
    _encode_schema(m.Schema, msg.get("schema", []))
    return TYPE_NODE_STATUS, m


def _dec_node_status(data: bytes) -> dict:
    m = pb.NodeStatus()
    m.ParseFromString(data)
    return {
        "type": "node-status",
        "node": _decode_node(m.Node),
        "maxShards": dict(m.MaxShards.Standard),
        "schema": _decode_schema(m.Schema),
    }


def _enc_recalculate(msg: dict):
    return TYPE_RECALCULATE_CACHES, pb.RecalculateCaches()


def _dec_recalculate(data: bytes) -> dict:
    return {"type": "recalculate-caches"}


_e_delidx, _d_delidx = _simple(
    TYPE_DELETE_INDEX, pb.DeleteIndexMessage, {"index": "Index"},
    "delete-index")
_e_delfld, _d_delfld = _simple(
    TYPE_DELETE_FIELD, pb.DeleteFieldMessage,
    {"index": "Index", "field": "Field"}, "delete-field")
_e_cview, _d_cview = _simple(
    TYPE_CREATE_VIEW, pb.CreateViewMessage,
    {"index": "Index", "field": "Field", "view": "View"}, "create-view")
_e_dview, _d_dview = _simple(
    TYPE_DELETE_VIEW, pb.DeleteViewMessage,
    {"index": "Index", "field": "Field", "view": "View"}, "delete-view")

_ENCODERS: Dict[str, Callable[[dict], Tuple[int, object]]] = {
    "create-shard": _enc_create_shard,
    "create-index": _enc_create_index,
    "delete-index": _e_delidx,
    "create-field": _enc_create_field,
    "delete-field": _e_delfld,
    "create-view": _e_cview,
    "delete-view": _e_dview,
    "cluster-status": _enc_cluster_status,
    "resize-instruction": _enc_resize_instruction,
    "resize-complete": _enc_resize_complete,
    "set-coordinator": _enc_set_coordinator,
    "node-state": _enc_node_state,
    "recalculate-caches": _enc_recalculate,
    "node-join": _enc_node_event,
    "node-leave": _enc_node_event,
    "node-status": _enc_node_status,
}

_DECODERS: Dict[int, Callable[[bytes], dict]] = {
    TYPE_CREATE_SHARD: _dec_create_shard,
    TYPE_CREATE_INDEX: _dec_create_index,
    TYPE_DELETE_INDEX: _d_delidx,
    TYPE_DELETE_FIELD: _d_delfld,
    TYPE_CREATE_FIELD: _dec_create_field,
    TYPE_CREATE_VIEW: _d_cview,
    TYPE_DELETE_VIEW: _d_dview,
    TYPE_CLUSTER_STATUS: _dec_cluster_status,
    TYPE_RESIZE_INSTRUCTION: _dec_resize_instruction,
    TYPE_RESIZE_INSTRUCTION_COMPLETE: _dec_resize_complete,
    TYPE_SET_COORDINATOR: _dec_set_coordinator,
    TYPE_UPDATE_COORDINATOR: _dec_update_coordinator,
    TYPE_NODE_STATE: _dec_node_state,
    TYPE_RECALCULATE_CACHES: _dec_recalculate,
    TYPE_NODE_EVENT: _dec_node_event,
    TYPE_NODE_STATUS: _dec_node_status,
}
