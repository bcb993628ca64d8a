"""The cases of tests/test_misc.py, run against the port on the CPU.

Tests for URI, iterators, diagnostics, sysinfo, topology, holder cleaner,
stats, time quantum, and translate replication."""

import json
import time
from datetime import datetime

import numpy as np
import pytest

from pilosa_tpu_torch import timeq
from pilosa_tpu_torch.cluster.node import Cluster, Node
from pilosa_tpu_torch.cluster.topology import HolderCleaner, Topology
from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.diagnostics import DiagnosticsCollector
from pilosa_tpu_torch.iterator import BufIterator, fragment_iterator, limit_iterator, slice_iterator
from pilosa_tpu_torch.stats import InMemoryStatsClient, MultiStatsClient, NopStatsClient, Timer
from pilosa_tpu_torch.sysinfo import system_info
from pilosa_tpu_torch.translate import TranslateStore
from pilosa_tpu_torch.uri import URI, URIError


def Holder(*args, **kw):
    """The port's holder on the CPU."""
    from pilosa_tpu_torch.core.holder import Holder as _Holder

    kw.setdefault("device", "cpu")
    return _Holder(*args, **kw)


def test_uri_parse():
    u = URI.parse("https://example.com:8080")
    assert (u.scheme, u.host, u.port) == ("https", "example.com", 8080)
    assert URI.parse("example.com").port == 10101
    assert URI.parse(":9999").host == "localhost"
    assert URI.parse("localhost:1").normalize() == "http://localhost:1"
    with pytest.raises(URIError):
        URI.parse("")


def test_fragment_iterator(tmp_path):
    f = Fragment(str(tmp_path / "frag"), "i", "f", "standard", 2)
    f.open()
    from pilosa_tpu_torch.constants import SHARD_WIDTH

    base = 2 * SHARD_WIDTH
    f.set_bit(0, base + 5)
    f.set_bit(3, base + 1)
    pairs = list(fragment_iterator(f))
    assert pairs == [(0, base + 5), (3, base + 1)]
    assert list(fragment_iterator(f, seek_row=1)) == [(3, base + 1)]
    f.close()


def test_buf_slice_limit_iterators():
    it = BufIterator(slice_iterator([2, 1, 1], [5, 9, 3]))
    assert it.peek() == (1, 3)
    assert it.next() == (1, 3)
    it.unread((1, 3))
    assert it.next() == (1, 3)
    assert list(limit_iterator(slice_iterator([0, 1, 2], [1, 2, 3]), 2, 100)) == [
        (0, 1), (1, 2),
    ]


def test_time_quantum_views():
    t = datetime(2018, 3, 5, 14)
    assert timeq.views_by_time("standard", t, "YMDH") == [
        "standard_2018", "standard_201803", "standard_20180305",
        "standard_2018030514",
    ]
    views = timeq.views_by_time_range(
        "standard", datetime(2018, 1, 31, 22), datetime(2018, 2, 2, 0), "YMDH"
    )
    # 2 hours + 1 day cover the range minimally.
    assert views == [
        "standard_2018013122", "standard_2018013123", "standard_20180201",
    ]


def test_stats_clients():
    s = InMemoryStatsClient()
    s.count("x", 2)
    s.count("x", 3)
    s.gauge("g", 7)
    tagged = s.with_tags("index:i")
    tagged.count("x", 1)
    snap = s.snapshot()
    assert snap["counters"]["x"] == 5
    assert snap["counters"]["x|index:i"] == 1
    assert snap["gauges"]["g"] == 7
    multi = MultiStatsClient([NopStatsClient(), s])
    multi.count("y", 1)
    assert s.snapshot()["counters"]["y"] == 1
    with Timer(s, "op"):
        pass
    assert "op" in s.snapshot()["timings"]


def test_sysinfo():
    info = system_info()
    assert info["OS"] == "Linux"
    assert info["numCPU"] > 0
    assert info["memTotal"] > 0


def test_topology_persistence(tmp_path):
    path = str(tmp_path / ".topology")
    t = Topology.load(path)
    assert t.node_ids == []
    t.save([Node(id="a"), Node(id="b")])
    t2 = Topology.load(path)
    assert t2.node_ids == ["a", "b"]
    assert t2.contains_id("a") and not t2.contains_id("c")


class _FakeServer:
    def __init__(self, holder, cluster):
        self.holder = holder
        self.cluster = cluster


def test_holder_cleaner(tmp_path):
    from pilosa_tpu_torch.cluster.hash import ModHasher
    from pilosa_tpu_torch.constants import SHARD_WIDTH
    from tests.test_torch_misc import Holder

    holder = Holder(str(tmp_path / "data"))
    holder.open()
    idx = holder.create_index("i")
    fld = idx.create_field("f")
    for s in range(4):
        fld.set_bit(1, s * SHARD_WIDTH + 1)
    nodes = [Node(id="me"), Node(id="other")]
    cluster = Cluster(node=nodes[0], nodes=nodes, hasher=ModHasher())
    removed = HolderCleaner(_FakeServer(holder, cluster)).clean_holder()
    view = fld.view("standard")
    kept = set(view.fragments)
    assert all(cluster.owns_shard("me", "i", s) for s in kept)
    assert len(removed) == 4 - len(kept)
    holder.close()


def test_diagnostics_gather_and_flush(tmp_path):
    import http.server
    import threading

    received = []

    class H(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            received.append(json.loads(self.rfile.read(n)))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *a):
            pass

    httpd = http.server.HTTPServer(("localhost", 0), H)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()

    from tests.test_torch_misc import Holder

    holder = Holder(None)
    holder.open()
    holder.create_index("i").create_field("f")
    cluster = Cluster()
    server = _FakeServer(holder, cluster)
    d = DiagnosticsCollector(
        server, endpoint=f"http://localhost:{httpd.server_address[1]}/diag"
    )
    assert d.flush()
    assert received[0]["numIndexes"] == 1
    assert received[0]["numFields"] == 1
    assert received[0]["OS"] == "Linux"
    httpd.shutdown()
    # No endpoint -> gather only.
    d2 = DiagnosticsCollector(server)
    assert not d2.flush()
    assert d2.last_report["numIndexes"] == 1


def test_translate_replication(tmp_path):
    primary = TranslateStore(str(tmp_path / "primary")).open()
    primary.translate_columns_to_uint64("i", ["a", "b"])
    primary.translate_rows_to_uint64("i", "f", ["x"])
    replica = TranslateStore(str(tmp_path / "replica"), read_only=True).open()
    data = primary.read_from(0)
    replica.apply_log(data)
    assert replica.translate_columns_to_uint64("i", ["a", "b"]) == [1, 2]
    assert replica.translate_row_to_string("i", "f", 1) == "x"
    # Replica refuses new keys.
    from pilosa_tpu_torch.errors import TranslateStoreReadOnlyError

    with pytest.raises(TranslateStoreReadOnlyError):
        replica.translate_columns_to_uint64("i", ["new"])
    # Incremental tail.
    size = replica.size()
    primary.translate_columns_to_uint64("i", ["c"])
    replica.apply_log(primary.read_from(size))
    assert replica.translate_columns_to_uint64("i", ["c"]) == [3]


def test_statsd_client_wire_format():
    import socket
    import threading as th

    from pilosa_tpu_torch.stats import StatsDClient, new_stats_client

    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    sock.settimeout(2)
    port = sock.getsockname()[1]
    c = StatsDClient("127.0.0.1", port, tags=["env:test"])
    c.count("setBit", 3)
    c.gauge("heap", 42.5)
    c.with_tags("index:i").timing("query", 1.25)
    msgs = sorted(sock.recv(1024).decode() for _ in range(3))
    assert msgs[0] == "pilosa_tpu.heap:42.5|g|#env:test"
    assert msgs[1] == "pilosa_tpu.query:1.25|ms|#env:test,index:i"
    assert msgs[2] == "pilosa_tpu.setBit:3|c|#env:test"
    sock.close()
    # Factory selection.
    from pilosa_tpu_torch.stats import InMemoryStatsClient, MultiStatsClient, NopStatsClient

    assert isinstance(new_stats_client("nop"), NopStatsClient)
    assert isinstance(new_stats_client("inmem"), InMemoryStatsClient)
    assert isinstance(new_stats_client("statsd", "127.0.0.1:8125"), MultiStatsClient)


def test_bitmap_check():
    import numpy as np

    from pilosa_tpu_torch.storage.bitmap import Bitmap

    b = Bitmap([1, 2, 3, 100000])
    assert b.check() == []
    b.containers[99] = np.array([5, 5, 4], dtype=np.uint16)  # corrupt
    problems = b.check()
    assert any("ascending" in p for p in problems)


def test_diagnostics_version_compare():
    """compareVersion parity (diagnostics.go:133-146)."""
    from pilosa_tpu_torch.diagnostics import DiagnosticsCollector, _version_segments
    from pilosa_tpu_torch import __version__

    assert _version_segments("v1.2.3-rc1") == [1, 2, 3]
    assert _version_segments("2.0") == [2, 0, 0]
    d = DiagnosticsCollector.__new__(DiagnosticsCollector)
    d.logger = None
    major = _version_segments(__version__)
    newer_major = f"v{major[0]+1}.0.0"
    w = d.compare_version(newer_major)
    assert w and "newer version" in w
    assert d.compare_version(__version__) is None
    newer_patch = f"v{major[0]}.{major[1]}.{major[2]+1}"
    w = d.compare_version(newer_patch)
    assert w and "patch release" in w
    # Unreachable endpoint: swallowed, returns None.
    assert d.check_version("http://127.0.0.1:1/none") is None


def test_translate_store_binary_log_reopen(tmp_path):
    """Offset-indexed binary log: keys round-trip across reopen with only
    offsets held in memory (reference translate.go:733-900)."""
    from pilosa_tpu_torch.translate import TranslateStore

    path = str(tmp_path / "keys")
    ts = TranslateStore(path).open()
    ids = ts.translate_columns_to_uint64("i", [f"user-{n}" for n in range(500)])
    assert ids == list(range(1, 501))
    rids = ts.translate_rows_to_uint64("i", "f", ["alpha", "beta", "alpha"])
    assert rids == [1, 2, 1]
    ts.close()

    ts2 = TranslateStore(path).open()
    # existing keys resolve to the same ids; new keys continue the sequence
    assert ts2.translate_columns_to_uint64("i", ["user-7", "user-new"]) == [8, 501]
    assert ts2.translate_column_to_string("i", 8) == "user-7"
    assert ts2.translate_row_to_string("i", "f", 2) == "beta"
    assert ts2.translate_rows_to_string("i", "f", [1, 2, 99]) == ["alpha", "beta", ""]
    ts2.close()


def test_translate_store_legacy_json_migration(tmp_path):
    import json as _json
    import struct as _struct

    from pilosa_tpu_torch.translate import TranslateStore

    path = str(tmp_path / "keys")
    with open(path, "wb") as f:
        for ns, key, id in [("i:x", "a", 1), ("i:x", "b", 2), ("f:x:g", "r", 1)]:
            e = _json.dumps([ns, key, id]).encode()
            f.write(_struct.pack("<I", len(e)) + e)
    ts = TranslateStore(path).open()
    assert ts.translate_columns_to_uint64("x", ["a", "b", "c"]) == [1, 2, 3]
    assert ts.translate_row_to_string("x", "g", 1) == "r"
    ts.close()
    # migrated file reopens as binary
    ts2 = TranslateStore(path).open()
    assert ts2.translate_column_to_string("x", 3) == "c"
    ts2.close()


def test_translate_legacy_readonly_does_not_rewrite(tmp_path):
    """A read-only replica opening a round-1 legacy log must not mutate the
    shared on-disk file; it decodes in memory and still serves lookups and
    downstream streaming (read-only contract)."""
    import json as _json
    import struct as _struct

    from pilosa_tpu_torch.translate import TranslateStore

    path = str(tmp_path / "keys")
    with open(path, "wb") as f:
        for ns, key, id in [("i:x", "a", 1), ("i:x", "b", 2)]:
            e = _json.dumps([ns, key, id]).encode()
            f.write(_struct.pack("<I", len(e)) + e)
    before = open(path, "rb").read()
    ts = TranslateStore(path, read_only=True).open()
    assert ts.translate_columns_to_uint64("x", ["a", "b"]) == [1, 2]
    assert open(path, "rb").read() == before  # untouched on disk
    # Downstream streaming serves the decoded binary entries from the tail.
    data = ts.read_from(0)
    assert len(data) == ts.size() and data
    chained = TranslateStore(None, read_only=True)
    chained.apply_log(data)
    assert chained.translate_column_to_string("x", 2) == "b"
    ts.close()


def test_translate_readonly_read_from_includes_tail(tmp_path):
    """read_from on a read-only replica with a path must serve applied log
    entries living only in the in-memory tail — size() already counts them,
    so a chained replica polling read_from(size) would otherwise stall."""
    from pilosa_tpu_torch.translate import TranslateStore

    primary = TranslateStore(str(tmp_path / "primary")).open()
    primary.translate_columns_to_uint64("i", ["a", "b"])
    replica = TranslateStore(str(tmp_path / "replica"), read_only=True).open()
    replica.apply_log(primary.read_from(0))
    assert replica.size() == primary.size()
    # The replica's copy is all tail (its own disk file is empty): stream it.
    data = replica.read_from(0)
    assert data == primary.read_from(0)
    # Offsets into the tail work too.
    assert replica.read_from(4) == data[4:]
    assert replica.read_from(replica.size()) == b""
    primary.close()
    replica.close()


def test_translate_store_memory_is_offsets_not_keys(tmp_path):
    """1M keys must not hold 1M python strings resident."""
    import sys

    from pilosa_tpu_torch.translate import TranslateStore

    ts = TranslateStore(str(tmp_path / "keys")).open()
    n = 100_000
    CHUNK = 10_000
    for i in range(0, n, CHUNK):
        ts.translate_columns_to_uint64("big", [f"key-{j:012d}" for j in range(i, i + CHUNK)])
    # table slots + id offsets are numpy/array-backed: ~16B/key, far below
    # what 100k resident str objects (~60B+ each) would need.
    table_bytes = ts._table.slots.nbytes
    ids_bytes = sum(a.itemsize * len(a) for a in ts._ids.values())
    assert table_bytes + ids_bytes < 6_000_000
    assert ts.translate_columns_to_uint64("big", ["key-000000000042"]) == [43]
    assert ts.translate_column_to_string("big", 43) == "key-000000000042"
    ts.close()


def test_translate_store_truncated_tail_recovery(tmp_path):
    """A crash mid-append leaves a partial entry; reopen must truncate it so
    new entries land at clean offsets."""
    from pilosa_tpu_torch.translate import TranslateStore

    path = str(tmp_path / "keys")
    ts = TranslateStore(path).open()
    ts.translate_columns_to_uint64("i", ["a", "b"])
    ts.close()
    with open(path, "ab") as f:
        f.write(b"\xff\x00\x00\x00partial")  # garbage tail
    ts2 = TranslateStore(path).open()
    assert ts2.translate_columns_to_uint64("i", ["a", "c"]) == [1, 3]
    ts2.close()
    ts3 = TranslateStore(path).open()
    assert ts3.translate_column_to_string("i", 3) == "c"
    assert ts3.translate_columns_to_uint64("i", ["c"]) == [3]
    ts3.close()
