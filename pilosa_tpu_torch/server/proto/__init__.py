"""Protobuf wire codec for the public HTTP API.

Message-compatible with the reference's internal/public.proto (same field
numbers), so protobuf clients of the reference interoperate. The handler
negotiates on Content-Type / Accept: application/x-protobuf.
"""

from __future__ import annotations

from typing import Any, List, Optional

from . import public_pb2 as pb

# QueryResult type tags (reference http/handler.go:1098-1103).
TYPE_NIL = 0
TYPE_ROW = 1
TYPE_PAIRS = 2
TYPE_VALCOUNT = 3
TYPE_UINT64 = 4
TYPE_BOOL = 5

# Attr value types (reference attr.go:27-30).
ATTR_STRING = 1
ATTR_INT = 2
ATTR_BOOL = 3
ATTR_FLOAT = 4


def _encode_attrs(attrs: dict, out) -> None:
    for key in sorted(attrs):
        v = attrs[key]
        a = out.add()
        a.Key = key
        if isinstance(v, bool):
            a.Type = ATTR_BOOL
            a.BoolValue = v
        elif isinstance(v, int):
            a.Type = ATTR_INT
            a.IntValue = v
        elif isinstance(v, float):
            a.Type = ATTR_FLOAT
            a.FloatValue = v
        else:
            a.Type = ATTR_STRING
            a.StringValue = str(v)


def decode_attrs(attrs) -> dict:
    out = {}
    for a in attrs:
        if a.Type == ATTR_BOOL:
            out[a.Key] = a.BoolValue
        elif a.Type == ATTR_INT:
            out[a.Key] = a.IntValue
        elif a.Type == ATTR_FLOAT:
            out[a.Key] = a.FloatValue
        else:
            out[a.Key] = a.StringValue
    return out


def decode_query_request(data: bytes) -> dict:
    req = pb.QueryRequest()
    req.ParseFromString(data)
    return {
        "query": req.Query,
        "shards": list(req.Shards) or None,
        "columnAttrs": req.ColumnAttrs,
        "remote": req.Remote,
        "excludeRowAttrs": req.ExcludeRowAttrs,
        "excludeColumns": req.ExcludeColumns,
    }


def encode_query_response(results: List[Any], column_attr_sets=None, err: str = "") -> bytes:
    from ...core.cache import Pair as PairObj
    from ...core.row import Row as RowObj
    from ...executor import ValCount as ValCountObj

    resp = pb.QueryResponse()
    if err:
        resp.Err = err
    for r in results:
        qr = resp.Results.add()
        if isinstance(r, RowObj):
            qr.Type = TYPE_ROW
            qr.Row.Columns.extend(int(c) for c in r.columns())
            if r.keys:
                qr.Row.Keys.extend(r.keys)
            if r.attrs:
                _encode_attrs(r.attrs, qr.Row.Attrs)
        elif isinstance(r, ValCountObj):
            qr.Type = TYPE_VALCOUNT
            qr.ValCount.Val = r.val
            qr.ValCount.Count = r.count
        elif isinstance(r, list) and (not r or isinstance(r[0], PairObj)):
            qr.Type = TYPE_PAIRS
            for p in r:
                pp = qr.Pairs.add()
                pp.ID = p.id
                pp.Count = p.count
                if p.key:
                    pp.Key = p.key
        elif isinstance(r, bool):
            qr.Type = TYPE_BOOL
            qr.Changed = r
        elif isinstance(r, int):
            qr.Type = TYPE_UINT64
            qr.N = r
        else:
            qr.Type = TYPE_NIL
    for cas in column_attr_sets or []:
        s = resp.ColumnAttrSets.add()
        s.ID = cas["id"]
        _encode_attrs(cas.get("attrs", {}), s.Attrs)
    return resp.SerializeToString()


def decode_query_response(data: bytes):
    """Decode a QueryResponse into python objects (client side)."""
    from ...core.cache import Pair as PairObj
    from ...core.row import Row as RowObj
    from ...executor import ValCount as ValCountObj

    resp = pb.QueryResponse()
    resp.ParseFromString(data)
    results: List[Any] = []
    for qr in resp.Results:
        if qr.Type == TYPE_ROW:
            row = RowObj(columns=list(qr.Row.Columns))
            row.keys = list(qr.Row.Keys)
            row.attrs = decode_attrs(qr.Row.Attrs)
            results.append(row)
        elif qr.Type == TYPE_PAIRS:
            results.append(
                [PairObj(id=p.ID, count=p.Count, key=p.Key) for p in qr.Pairs]
            )
        elif qr.Type == TYPE_VALCOUNT:
            results.append(ValCountObj(val=qr.ValCount.Val, count=qr.ValCount.Count))
        elif qr.Type == TYPE_UINT64:
            results.append(qr.N)
        elif qr.Type == TYPE_BOOL:
            results.append(qr.Changed)
        else:
            results.append(None)
    return resp.Err, results


def decode_import_request(data: bytes) -> dict:
    req = pb.ImportRequest()
    req.ParseFromString(data)
    return {
        "index": req.Index,
        "field": req.Field,
        "shard": req.Shard,
        "rowIDs": list(req.RowIDs),
        "columnIDs": list(req.ColumnIDs),
        "rowKeys": list(req.RowKeys) or None,
        "columnKeys": list(req.ColumnKeys) or None,
        "timestamps": [t or None for t in req.Timestamps] or None,
    }


def decode_import_value_request(data: bytes) -> dict:
    req = pb.ImportValueRequest()
    req.ParseFromString(data)
    return {
        "index": req.Index,
        "field": req.Field,
        "shard": req.Shard,
        "columnIDs": list(req.ColumnIDs),
        "values": list(req.Values),
    }
