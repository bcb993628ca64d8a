"""The cases of tests/test_wire.py, run against the port on the CPU.

Binary node-to-node wire codec tests (reference ships protobuf
QueryResponses between nodes, internal/private.proto; this framework ships
packed bitplanes)."""

import numpy as np
import pytest

from pilosa_tpu_torch.constants import SHARD_WIDTH
from pilosa_tpu_torch.core.cache import Pair
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.executor import ValCount
from pilosa_tpu_torch.server import wire


def test_roundtrip_mixed_results():
    dense_cols = np.arange(0, SHARD_WIDTH, 2, dtype=np.uint64)
    sparse_cols = np.array([5, 99, SHARD_WIDTH + 7], dtype=np.uint64)
    row = Row(columns=np.concatenate([dense_cols, sparse_cols]))
    row.attrs = {"x": 1}
    results = [
        row,
        ValCount(val=42, count=7),
        [Pair(id=1, count=10), Pair(id=2, count=5, key="k")],
        True,
        12345,
        None,
    ]
    data = wire.encode_results(results)
    assert wire.is_wire(data)
    out = wire.decode_results(data)
    assert np.array_equal(out[0].columns(), row.columns())
    assert out[0].attrs == {"x": 1}
    assert out[1].val == 42 and out[1].count == 7
    assert [(p.id, p.count, p.key) for p in out[2]] == [(1, 10, ""), (2, 5, "k")]
    assert out[3] is True
    assert out[4] == 12345
    assert out[5] is None


def test_dense_row_is_compact():
    """A dense 1M-column row must ship as a plane (~128KiB), not a column
    list (~8MB binary / ~10MB JSON)."""
    import json

    from pilosa_tpu_torch.server.handler import serialize_remote

    row = Row(columns=np.arange(0, SHARD_WIDTH, dtype=np.uint64))
    data = wire.encode_results([row])
    assert len(data) < 150_000
    json_len = len(json.dumps(serialize_remote(row)))
    assert len(data) * 10 < json_len


def test_sparse_row_is_column_form():
    row = Row(columns=np.array([3, 10_000], dtype=np.uint64))
    data = wire.encode_results([row])
    assert len(data) < 1000
    out = wire.decode_results(data)
    assert out[0].columns().tolist() == [3, 10_000]


def test_decode_rejects_garbage():
    with pytest.raises(ValueError):
        wire.decode_results(b"{\"results\": []}")


def test_corrupt_blob_span_rejected():
    """Corrupt segment offsets must raise, not wrap (negative) or
    silently truncate (past-the-end) into a plausible-looking Row."""
    import json
    import struct

    body = wire.encode_results([Row(columns=[1, 5, 9])])
    (head_len,) = struct.unpack_from("<I", body, 4)
    header = json.loads(body[8 : 8 + head_len])
    for bad_off, bad_len in ((-8, 8), (1 << 30, 8), (0, 1 << 30), ("x", 8)):
        h = json.loads(json.dumps(header))
        h["results"][0]["segs"][0][2] = bad_off
        h["results"][0]["segs"][0][3] = bad_len
        new_head = json.dumps(h).encode()
        forged = wire.MAGIC + struct.pack("<I", len(new_head)) + new_head \
            + body[8 + head_len:]
        with pytest.raises(ValueError, match="bad blob span|bad plane"):
            wire.decode_results(forged)
