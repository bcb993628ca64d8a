"""The cases of tests/test_proto.py, run against the port on the CPU.

Protobuf wire format tests: content negotiation on /query and /import,
message compatibility with the reference's public.proto field layout."""

import urllib.request

import pytest

from pilosa_tpu_torch.server.proto import (
    decode_query_response,
    encode_query_response,
    public_pb2 as pb,
)
from pilosa_tpu_torch.server.server import Server as _Server


def Server(*args, **kw):
    """The port's server on the CPU."""
    kw.setdefault("device", "cpu")
    return _Server(*args, **kw)


@pytest.fixture
def server(tmp_path):
    s = Server(data_dir=str(tmp_path / "srv"), cache_flush_interval=0)
    s.open()
    yield s
    s.close()


def _post(url, body, content_type=None, accept=None):
    req = urllib.request.Request(url, data=body, method="POST")
    if content_type:
        req.add_header("Content-Type", content_type)
    if accept:
        req.add_header("Accept", accept)
    with urllib.request.urlopen(req) as resp:
        return resp.read(), resp.headers.get("Content-Type")


def test_proto_query_roundtrip(server):
    host = f"localhost:{server.port}"
    _post(f"http://{host}/index/p", b"{}")
    _post(f"http://{host}/index/p/field/f", b"{}")
    _post(f"http://{host}/index/p/query", b"Set(1, f=10) Set(2, f=10)")

    req = pb.QueryRequest()
    req.Query = "Row(f=10) Count(Row(f=10)) TopN(f, n=1)"
    data, ctype = _post(
        f"http://{host}/index/p/query",
        req.SerializeToString(),
        content_type="application/x-protobuf",
        accept="application/x-protobuf",
    )
    assert ctype == "application/x-protobuf"
    err, results = decode_query_response(data)
    assert err == ""
    row, count, pairs = results
    assert list(row.columns()) == [1, 2]
    assert count == 2
    assert [(p.id, p.count) for p in pairs] == [(10, 2)]


def test_proto_query_shards_restriction(server):
    from pilosa_tpu_torch.constants import SHARD_WIDTH

    host = f"localhost:{server.port}"
    _post(f"http://{host}/index/ps", b"{}")
    _post(f"http://{host}/index/ps/field/f", b"{}")
    _post(f"http://{host}/index/ps/query",
          f"Set(1, f=1) Set({SHARD_WIDTH + 1}, f=1)".encode())
    req = pb.QueryRequest()
    req.Query = "Count(Row(f=1))"
    req.Shards.extend([0])
    data, _ = _post(
        f"http://{host}/index/ps/query", req.SerializeToString(),
        content_type="application/x-protobuf", accept="application/x-protobuf",
    )
    _, results = decode_query_response(data)
    assert results[0] == 1  # only shard 0 counted


def test_proto_import(server):
    host = f"localhost:{server.port}"
    _post(f"http://{host}/index/pi", b"{}")
    _post(f"http://{host}/index/pi/field/f", b"{}")
    req = pb.ImportRequest()
    req.Index = "pi"
    req.Field = "f"
    req.Shard = 0
    req.RowIDs.extend([1, 1, 2])
    req.ColumnIDs.extend([10, 20, 30])
    _post(
        f"http://{host}/index/pi/field/f/import",
        req.SerializeToString(),
        content_type="application/x-protobuf",
    )
    data, _ = _post(f"http://{host}/index/pi/query", b"Row(f=1)")
    import json

    assert json.loads(data)["results"][0]["columns"] == [10, 20]


def test_proto_import_values(server):
    host = f"localhost:{server.port}"
    _post(f"http://{host}/index/pv", b"{}")
    _post(f"http://{host}/index/pv/field/v",
          b'{"options": {"type": "int", "min": 0, "max": 1000}}')
    req = pb.ImportValueRequest()
    req.Index = "pv"
    req.Field = "v"
    req.Shard = 0
    req.ColumnIDs.extend([1, 2])
    req.Values.extend([100, 200])
    _post(
        f"http://{host}/index/pv/field/v/import",
        req.SerializeToString(),
        content_type="application/x-protobuf",
    )
    data, _ = _post(f"http://{host}/index/pv/query", b"Sum(field=v)")
    import json

    assert json.loads(data)["results"][0] == {"value": 300, "count": 2}


def test_proto_attrs_roundtrip(server):
    host = f"localhost:{server.port}"
    _post(f"http://{host}/index/pa", b"{}")
    _post(f"http://{host}/index/pa/field/f", b"{}")
    _post(f"http://{host}/index/pa/query",
          b'Set(1, f=3) SetRowAttrs(f, 3, color="red", n=7, active=true)')
    req = pb.QueryRequest()
    req.Query = "Row(f=3)"
    data, _ = _post(
        f"http://{host}/index/pa/query", req.SerializeToString(),
        content_type="application/x-protobuf", accept="application/x-protobuf",
    )
    _, results = decode_query_response(data)
    assert results[0].attrs == {"color": "red", "n": 7, "active": True}


def test_proto_error_response(server):
    host = f"localhost:{server.port}"
    req = pb.QueryRequest()
    req.Query = "Row(f=1)"
    r = urllib.request.Request(
        f"http://{host}/index/nosuch/query", data=req.SerializeToString(),
        method="POST",
    )
    r.add_header("Content-Type", "application/x-protobuf")
    r.add_header("Accept", "application/x-protobuf")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(r)
    err, results = decode_query_response(ei.value.read())
    assert "not found" in err


def test_encode_decode_helpers():
    from pilosa_tpu_torch.core.cache import Pair
    from pilosa_tpu_torch.core.row import Row
    from pilosa_tpu_torch.executor import ValCount

    row = Row(columns=[1, 5])
    row.attrs = {"x": 1.5}
    results = [row, 7, True, [Pair(id=3, count=9, key="k")], ValCount(10, 2), None]
    err, decoded = decode_query_response(encode_query_response(results))
    assert err == ""
    assert list(decoded[0].columns()) == [1, 5]
    assert decoded[0].attrs == {"x": 1.5}
    assert decoded[1] == 7
    assert decoded[2] is True
    assert decoded[3][0].key == "k"
    assert decoded[4].val == 10
    assert decoded[5] is None


def test_golden_query_response_bytes():
    """Pin the public QueryResponse WIRE BYTES against the reference
    schema (internal/public.proto:56-69 QueryResponse/QueryResult, field
    numbers and proto3 packed/varint rules applied by hand below). The
    internal node-to-node plane is deliberately NOT reference-compatible
    (docs/architecture.md "Interoperability"); this golden guarantees the
    PUBLIC plane stays byte-compatible — a reference protobuf client must
    parse our responses forever."""
    from pilosa_tpu_torch.core.cache import Pair
    from pilosa_tpu_torch.core.row import Row
    from pilosa_tpu_torch.executor import ValCount

    row = Row(columns=[1, 2**20 + 1])  # crosses a varint width
    got = encode_query_response([7, row, [Pair(id=10, count=3)],
                                 ValCount(val=-2, count=4), True])

    golden = bytes.fromhex(
        # QueryResponse.Results is field 2 (tag 0x12), one length-
        # delimited QueryResult each. QueryResult fields: Row=1, N=2,
        # Pairs=3, Changed=4, ValCount=5, Type=6 (serialized in field-
        # number order by canonical protobuf encoders).
        "12 04"        # Results[0], 4 bytes: Count result
        "10 07"        #   N=7        (field 2 varint)
        "30 04"        #   Type=4     (TYPE_UINT64, http/handler.go tag)
        "12 0a"        # Results[1], 10 bytes: Row result
        "0a 06"        #   Row=       (field 1, message, 6 bytes)
        "0a 04"        #     Columns= (field 1, packed varints, 4 bytes)
        "01"           #       1
        "81 80 40"     #       1048577 = 2^20+1 as varint
        "30 01"        #   Type=1     (TYPE_ROW)
        "12 08"        # Results[2], 8 bytes: Pairs result
        "1a 04"        #   Pairs[0]=  (field 3, message, 4 bytes)
        "08 0a"        #     ID=10    (field 1 varint)
        "10 03"        #     Count=3  (field 2 varint)
        "30 02"        #   Type=2     (TYPE_PAIRS)
        "12 11"        # Results[3], 17 bytes: ValCount result
        "2a 0d"        #   ValCount=  (field 5, message, 13 bytes)
        "08" + "fe" + "ff" * 8 + "01"       # Val=-2 (int64 varint, 10B)
        "10 04"        #     Count=4  (field 2 varint)
        "30 03"        #   Type=3     (TYPE_VALCOUNT)
        "12 04"        # Results[4], 4 bytes: Changed result
        "20 01"        #   Changed=true (field 4 varint)
        "30 05"        #   Type=5     (TYPE_BOOL)
        .replace(" ", "")
    )
    assert got == golden, (got.hex(), golden.hex())
    # And it round-trips through the decoder.
    decoded = pb.QueryResponse()
    decoded.ParseFromString(got)
    assert decoded.Results[0].N == 7
    assert list(decoded.Results[1].Row.Columns) == [1, 2**20 + 1]
    assert decoded.Results[3].ValCount.Val == -2
