"""The cases of tests/test_ingest.py, run against the port on the CPU.

Amortized-ingest tests: bulk WAL records, the snapshot trigger policy,
the background snapshotter (copy-on-write handoff, off-lock I/O, mid-
snapshot write splicing), and the parallel import fan-out.

Crash-safety for the new record types (SIGKILL / injected-crash
subprocess harness) lives in tests/test_durability.py.
"""

import os
import threading
import time

import numpy as np
import pytest

from pilosa_tpu_torch import failpoints
from pilosa_tpu_torch.constants import SHARD_WIDTH
from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.core.holder import Holder as _Holder
from pilosa_tpu_torch.errors import CorruptFragmentError
from pilosa_tpu_torch.storage import StorageConfig
from pilosa_tpu_torch.storage.bitmap import (
    OP_ADD,
    Bitmap,
    encode_bulk_op,
    encode_op,
)
from pilosa_tpu_torch.storage.snapshotter import Snapshotter


def Holder(*args, **kw):
    """The port's holder on the CPU."""
    kw.setdefault("device", "cpu")
    return _Holder(*args, **kw)


def Server(*args, **kw):
    """The port's server on the CPU."""
    from pilosa_tpu_torch.server.server import Server as _Server

    kw.setdefault("device", "cpu")
    return _Server(*args, **kw)


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoints.reset()
    yield
    failpoints.reset()


def make_frag(tmp_path, name="0", **kw):
    f = Fragment(str(tmp_path / "fragments" / name), "i", "f", "standard", 0, **kw)
    f.open()
    return f


# ----------------------------------------------------- bulk WAL record codec


def test_bulk_record_roundtrip_with_point_ops():
    base = Bitmap([1, 2, 3]).to_bytes()
    rec = encode_bulk_op(
        np.array([100, 200, 70_000], dtype=np.uint64),
        np.array([2], dtype=np.uint64),
    )
    out = Bitmap.from_buffer(base + rec + encode_op(OP_ADD, 99))
    assert out.contains(100) and out.contains(70_000) and out.contains(99)
    assert not out.contains(2)
    assert out.op_n == 2  # one bulk record + one point op
    assert out.ops_bytes == len(rec) + 13
    assert out.truncated_bytes == 0


def test_bulk_record_empty_sides():
    base = Bitmap([5]).to_bytes()
    only_adds = encode_bulk_op(np.array([7], dtype=np.uint64), None)
    only_rems = encode_bulk_op(None, np.array([5], dtype=np.uint64))
    out = Bitmap.from_buffer(base + only_adds + only_rems)
    assert out.contains(7) and not out.contains(5)


def test_bulk_record_torn_tail_truncates():
    base = Bitmap([1]).to_bytes()
    good = encode_bulk_op(np.array([50], dtype=np.uint64), None)
    torn = encode_bulk_op(np.array([60, 61], dtype=np.uint64), None)
    for cut in (1, 5, 12, len(torn) - 1):
        out = Bitmap.from_buffer(base + good + torn[:cut])
        assert out.contains(50) and not out.contains(60)
        assert out.valid_len == len(base) + len(good)
        assert out.truncated_bytes == cut


def test_bulk_record_corrupt_final_checksum_truncates():
    base = Bitmap([1]).to_bytes()
    bad = bytearray(encode_bulk_op(np.array([60], dtype=np.uint64), None))
    bad[-1] ^= 0xFF  # flip checksum byte
    out = Bitmap.from_buffer(base + bytes(bad))
    assert not out.contains(60)
    assert out.truncated_bytes == len(bad)


def test_bulk_record_corrupt_mid_log_raises():
    base = Bitmap([1]).to_bytes()
    bad = bytearray(encode_bulk_op(np.array([60], dtype=np.uint64), None))
    bad[9] ^= 0xFF  # flip a payload byte; checksum now fails
    with pytest.raises(CorruptFragmentError, match="mid-log"):
        Bitmap.from_buffer(base + bytes(bad) + encode_op(OP_ADD, 70))


def test_failed_append_truncates_partial_record(tmp_path):
    """A failed append (ENOSPC-style) that left PARTIAL record bytes must
    truncate back to the last whole-record boundary — otherwise the next
    successful append buries the garbage mid-log and reopen quarantines
    the fragment as bit rot."""
    frag = make_frag(tmp_path)
    frag.bulk_import(np.zeros(100, dtype=np.uint64),
                     np.arange(100, dtype=np.uint64))
    good_size = os.path.getsize(frag.path)
    assert good_size == frag.storage_bytes + frag.wal_bytes
    # Simulate the partial flush a failing disk leaves behind.
    rec = encode_bulk_op(np.arange(200, 300, dtype=np.uint64), None)
    frag._wal.write(rec[:11])
    frag._wal.flush()
    frag._truncate_torn_append()
    assert os.path.getsize(frag.path) == good_size
    # Writes keep working on the restored handle; reopen replays clean.
    frag.bulk_import(np.ones(50, dtype=np.uint64),
                     np.arange(50, dtype=np.uint64))
    frag.close()
    frag2 = make_frag(tmp_path)
    assert frag2.row_count(0) == 100 and frag2.row_count(1) == 50
    assert frag2.recovered_tail_bytes == 0
    frag2.close()


# -------------------------------------------------- copy-on-write snapshots


def test_cow_clone_freezes_under_live_writes():
    bm = Bitmap(np.arange(100_000, dtype=np.uint64))
    snap = bm.cow_clone()
    bm.add(500_000)
    bm.remove(5)
    bm.add_many(np.arange(200_000, 201_000, dtype=np.uint64))
    bm.remove_many(np.arange(10, 20, dtype=np.uint64))
    assert snap.contains(5) and snap.contains(15)
    assert not snap.contains(500_000) and not snap.contains(200_500)
    assert bm.contains(500_000) and not bm.contains(5)
    # The clone serializes the frozen state.
    out = Bitmap.from_bytes(snap.to_bytes())
    assert out.count() == 100_000


# -------------------------------------------- amortized fragment bulk writes


def test_bulk_import_appends_wal_instead_of_snapshot(tmp_path):
    frag = make_frag(tmp_path)
    rows = np.repeat(np.arange(4, dtype=np.uint64), 1000)
    cols = np.tile(np.arange(1000, dtype=np.uint64), 4)
    frag.bulk_import(rows, cols)
    # The old path snapshotted (op_n back to 0, file rewritten); the
    # amortized path leaves ONE op-log record.
    assert frag.op_n == 1
    assert frag.wal_bytes > 0
    frag.bulk_import(rows, cols + np.uint64(1000))
    assert frag.op_n == 2
    assert frag.row_count(2) == 2000
    frag.close()
    frag2 = make_frag(tmp_path)
    assert frag2.op_n == 2  # replayed, not folded
    assert frag2.row_count(2) == 2000
    frag2.close()


def test_remove_bulk_roundtrip(tmp_path):
    frag = make_frag(tmp_path)
    rows = np.repeat(np.arange(4, dtype=np.uint64), 100)
    cols = np.tile(np.arange(100, dtype=np.uint64), 4)
    frag.bulk_import(rows, cols)
    frag.remove_bulk(
        np.full(50, 2, dtype=np.uint64), np.arange(50, dtype=np.uint64))
    assert frag.row_count(2) == 50 and frag.row_count(1) == 100
    frag.close()
    frag2 = make_frag(tmp_path)
    assert frag2.row_count(2) == 50 and frag2.row_count(1) == 100
    frag2.close()


def test_import_value_replays_without_snapshot(tmp_path):
    frag = make_frag(tmp_path)
    cols = np.arange(30, dtype=np.uint64)
    frag.import_value(cols, cols * np.uint64(3), 8)
    assert frag.op_n == 1  # one bsi-import record, no snapshot
    # Overwrite some values: clears must replay too.
    frag.import_value(cols[:10], np.full(10, 7, dtype=np.uint64), 8)
    frag.close()
    frag2 = make_frag(tmp_path)
    for c in range(10):
        assert frag2.value(c, 8) == (7, True)
    for c in range(10, 30):
        assert frag2.value(c, 8) == (c * 3, True)
    frag2.close()


def test_row_counts_matches_per_row(tmp_path):
    frag = make_frag(tmp_path)
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 9, 5000).astype(np.uint64)
    cols = rng.integers(0, SHARD_WIDTH, 5000, dtype=np.uint64)
    frag.bulk_import(rows, cols)
    ids = [0, 1, 5, 7, 8, 12]  # 12 is empty
    batched = list(frag.row_counts(ids))
    assert batched == [frag.row_count(r) for r in ids]
    assert frag.row_counts([]).size == 0
    frag.close()


def test_snapshot_due_policy(tmp_path):
    frag = make_frag(
        tmp_path,
        storage_config=StorageConfig(snapshot_ratio=0.5),
    )
    assert not frag.snapshot_due()
    # Below the 1 MiB floor nothing triggers.
    frag.bulk_import(
        np.zeros(100, dtype=np.uint64), np.arange(100, dtype=np.uint64))
    assert not frag.snapshot_due()
    # Force the accounting over ratio x floor: policy fires.
    frag.wal_bytes = StorageConfig.SNAPSHOT_MIN_BASE
    assert frag.snapshot_due()
    frag.snapshot()
    assert frag.wal_bytes == 0 and not frag.snapshot_due()
    # Op-count trigger still applies (the reference's 2000-op threshold).
    frag.op_n = frag.max_op_n
    assert frag.snapshot_due()
    frag.close()

    # ratio=0 disables the byte trigger entirely.
    frag2 = make_frag(
        tmp_path, name="1",
        storage_config=StorageConfig(snapshot_ratio=0),
    )
    frag2.wal_bytes = 1 << 30
    assert not frag2.snapshot_due()
    frag2.close()


def test_storage_config_validation():
    with pytest.raises(ValueError, match="snapshot-ratio"):
        StorageConfig(snapshot_ratio=-1).validate()
    with pytest.raises(ValueError, match="snapshot-interval"):
        StorageConfig(snapshot_interval=-2).validate()
    StorageConfig(snapshot_ratio=0, snapshot_interval=0).validate()


# ------------------------------------------------------ background snapshots


def holder_with_snapshotter(tmp_path, **cfg):
    h = Holder(
        str(tmp_path / "indexes"),
        storage_config=StorageConfig(snapshot_interval=0, **cfg),
    )
    h.open()
    return h


def test_background_snapshot_folds_wal(tmp_path):
    h = holder_with_snapshotter(tmp_path)
    assert h.snapshotter is not None
    fld = h.create_index("t").create_field("f")
    rows = np.repeat(np.arange(4, dtype=np.uint64), 50_000)
    cols = np.tile(np.arange(50_000, dtype=np.uint64), 4)
    fld.import_bits(rows, cols)  # 1.6 MB record > 0.5 * 1 MiB floor
    frag = h.fragment("t", "f", "standard", 0)
    for _ in range(200):
        if h.snapshotter.counters["snapshots_taken"] >= 1:
            break
        time.sleep(0.02)
    assert h.snapshotter.counters["snapshots_taken"] >= 1
    assert frag.wal_bytes == 0 and frag.op_n == 0
    assert frag.row_count(2) == 50_000
    h.close()
    h2 = Holder(str(tmp_path / "indexes")).open()
    assert h2.fragment("t", "f", "standard", 0).row_count(2) == 50_000
    h2.close()


def test_background_snapshot_does_not_block_writers_or_readers(tmp_path):
    """The acceptance gate: with the snapshot's write/fsync phase stalled
    via failpoint, a reader AND a writer (fragment-mutex holder) must
    complete — proof there is no fragment-mutex hold across snapshot
    I/O."""
    h = holder_with_snapshotter(tmp_path)
    fld = h.create_index("t").create_field("f")
    rows = np.repeat(np.arange(4, dtype=np.uint64), 10_000)
    cols = np.tile(np.arange(10_000, dtype=np.uint64), 4)
    fld.import_bits(rows, cols)
    frag = h.fragment("t", "f", "standard", 0)
    before = h.snapshotter.counters["snapshots_taken"]

    failpoints.configure("snapshot-write", "latency", arg=2000)
    frag._request_snapshot()
    # Wait until the snapshot thread is INSIDE the stalled write phase
    # (it popped the queue but hasn't finished).
    for _ in range(100):
        if h.snapshotter.queue_depth() == 0:
            break
        time.sleep(0.01)
    t0 = time.monotonic()
    assert frag.set_bit(99, 123)          # takes the fragment mutex
    assert frag.row_count(2) == 10_000    # lock-free read
    assert frag.bit(99, 123)
    elapsed = time.monotonic() - t0
    assert elapsed < 1.0, f"blocked {elapsed:.2f}s behind snapshot I/O"

    # The snapshot itself completes and the mid-snapshot write survived.
    for _ in range(400):
        if h.snapshotter.counters["snapshots_taken"] > before:
            break
        time.sleep(0.01)
    assert h.snapshotter.counters["snapshots_taken"] > before
    h.close()
    h2 = Holder(str(tmp_path / "indexes")).open()
    f2 = h2.fragment("t", "f", "standard", 0)
    assert f2.bit(99, 123) and f2.row_count(2) == 10_000
    h2.close()


def test_mid_snapshot_writes_splice_onto_new_file(tmp_path):
    """Writes landing between handoff and rename ride the WAL tail onto
    the NEW file: reopening right after the snapshot must see them."""
    h = holder_with_snapshotter(tmp_path)
    fld = h.create_index("t").create_field("f")
    fld.set_bit(1, 1)
    frag = h.fragment("t", "f", "standard", 0)

    failpoints.configure("snapshot-write", "latency", arg=300)
    frag._request_snapshot()
    time.sleep(0.05)  # snapshot thread inside the stalled phase
    for i in range(10):
        frag.set_bit(2, i)  # mid-snapshot writes
    before = h.snapshotter.counters["snapshots_taken"]
    for _ in range(400):
        if h.snapshotter.counters["snapshots_taken"] >= 1 \
                and h.snapshotter.queue_depth() == 0:
            break
        time.sleep(0.01)
    failpoints.reset()
    # WAL tail carries exactly the mid-snapshot ops.
    assert frag.op_n <= 10
    h.close()
    h2 = Holder(str(tmp_path / "indexes")).open()
    f2 = h2.fragment("t", "f", "standard", 0)
    assert f2.bit(1, 1)
    for i in range(10):
        assert f2.bit(2, i), i
    h2.close()


def test_background_snapshot_error_keeps_wal_handle(tmp_path):
    h = holder_with_snapshotter(tmp_path)
    fld = h.create_index("t").create_field("f")
    fld.set_bit(1, 1)
    frag = h.fragment("t", "f", "standard", 0)
    failpoints.configure("snapshot-rename", "error", count=1)
    frag._request_snapshot()
    for _ in range(200):
        if h.snapshotter.counters["snapshot_errors"] >= 1:
            break
        time.sleep(0.01)
    assert h.snapshotter.counters["snapshot_errors"] == 1
    assert not os.path.exists(frag.path + ".snapshotting.bg")
    # Writes keep working and stay durable (WAL handle intact).
    assert frag.set_bit(3, 3)
    h.close()
    h2 = Holder(str(tmp_path / "indexes")).open()
    assert h2.fragment("t", "f", "standard", 0).bit(3, 3)
    h2.close()


def test_inline_snapshot_mid_background_aborts_stale_rewrite(tmp_path):
    """An inline snapshot (replica restore path) racing a stalled
    background snapshot wins: the background rename must abort rather
    than clobber the newer file."""
    h = holder_with_snapshotter(tmp_path)
    fld = h.create_index("t").create_field("f")
    fld.set_bit(1, 1)
    frag = h.fragment("t", "f", "standard", 0)
    failpoints.configure("snapshot-write", "latency", arg=400)
    frag._request_snapshot()
    time.sleep(0.05)
    frag.set_bit(5, 5)
    frag.snapshot()  # inline: folds everything, bumps the seq
    wal_after_inline = frag.wal_bytes
    time.sleep(0.6)  # let the background attempt finish (and abort)
    assert frag.wal_bytes == wal_after_inline  # bg didn't reset accounting
    assert not os.path.exists(frag.path + ".snapshotting.bg")
    assert frag.bit(5, 5) and frag.bit(1, 1)
    h.close()


def test_snapshotter_periodic_sweep(tmp_path):
    h = Holder(
        str(tmp_path / "indexes"),
        storage_config=StorageConfig(snapshot_interval=0.05),
    )
    h.open()
    fld = h.create_index("t").create_field("f")
    fld.set_bit(1, 1)  # tiny WAL: never hits ratio/op triggers
    frag = h.fragment("t", "f", "standard", 0)
    assert frag.wal_bytes > 0
    for _ in range(200):
        if frag.wal_bytes == 0:
            break
        time.sleep(0.02)
    assert frag.wal_bytes == 0, "periodic sweep never snapshotted"
    h.close()


def test_snapshotter_dedup_and_close_drain(tmp_path):
    s = Snapshotter()
    frag = make_frag(tmp_path)
    frag.set_bit(1, 1)
    assert s.enqueue(frag)
    assert not s.enqueue(frag)  # deduplicated while queued
    assert s.queue_depth() == 1
    s.close()  # drains without a running thread
    assert s.queue_depth() == 0
    assert frag.wal_bytes == 0  # the drain snapshotted it
    frag.close()


def test_concurrent_ingest_readers_see_consistent_counts(tmp_path):
    """Satellite: readers racing bulk imports + background snapshots see
    counts that are always one of the acked states (monotone non-
    decreasing for pure-set ingest), never torn garbage."""
    h = holder_with_snapshotter(tmp_path)
    fld = h.create_index("t").create_field("f")
    stop = threading.Event()
    errors = []

    def reader():
        frag = None
        last = 0
        while not stop.is_set():
            frag = frag or h.fragment("t", "f", "standard", 0)
            if frag is None:
                continue
            n = frag.row_count(1)
            if n < last or n % 500:
                errors.append(f"count went {last} -> {n}")
                return
            last = n

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    rows = np.zeros(500, dtype=np.uint64) + 1
    for i in range(20):
        cols = np.arange(i * 500, (i + 1) * 500, dtype=np.uint64)
        fld.import_bits(rows, cols)
        if i % 7 == 0:
            h.fragment("t", "f", "standard", 0)._request_snapshot()
    stop.set()
    t.join(timeout=5)
    assert not errors, errors
    assert h.fragment("t", "f", "standard", 0).row_count(1) == 10_000
    h.close()


# ------------------------------------------------------- parallel fan-out


def test_tolerant_group_fanout_local_only():
    from pilosa_tpu_torch.executor import Executor

    holder = Holder(None)
    holder.open()
    ex = Executor(holder, workers=4)
    applied = []
    ex.tolerant_group_fanout(
        "i", [0, 1, 2, 3], False,
        lambda shard: applied.append(shard),
        lambda node, shard: (_ for _ in ()).throw(AssertionError("no remotes")),
        workers=4,
    )
    assert sorted(applied) == [0, 1, 2, 3]
    ex.close()
    holder.close()


def test_tolerant_group_fanout_surfaces_local_error_after_all():
    from pilosa_tpu_torch.errors import QueryError
    from pilosa_tpu_torch.executor import Executor

    holder = Holder(None)
    holder.open()
    ex = Executor(holder, workers=0)  # serial path
    applied = []

    def apply_local(shard):
        if shard == 1:
            raise QueryError("bad batch")
        applied.append(shard)

    with pytest.raises(QueryError, match="bad batch"):
        ex.tolerant_group_fanout(
            "i", [0, 1, 2], False, apply_local, lambda n, s: None)
    # The other shards still got their data before the error surfaced.
    assert sorted(applied) == [0, 2]
    ex.close()
    holder.close()


def test_key_mode_import_fans_out_across_shards(tmp_path):
    from tests.test_torch_ingest import Server

    s = Server(data_dir=str(tmp_path / "node"), cache_flush_interval=0,
               member_monitor_interval=0)
    s.open()
    try:
        s.api.create_index("ki", {"keys": True})
        s.api.create_field("ki", "f", {"keys": True})
        n = 40
        row_keys = [f"r{i % 4}" for i in range(n)]
        col_keys = [f"c{i}" for i in range(n)]
        s.api.import_bits("ki", "f", 0, None, None,
                          row_keys=row_keys, column_keys=col_keys)
        assert s.api.import_batches >= 1
        total = s.api.query("ki", "Count(Union(Row(f=r0), Row(f=r1), "
                            "Row(f=r2), Row(f=r3)))")
        assert total[0] == n
    finally:
        s.close()


def test_import_values_key_mode_groups(tmp_path):
    from tests.test_torch_ingest import Server

    s = Server(data_dir=str(tmp_path / "node"), cache_flush_interval=0,
               member_monitor_interval=0)
    s.open()
    try:
        s.api.create_index("kv", {"keys": True})
        s.api.create_field("kv", "v", {"type": "int", "min": 0, "max": 1000})
        col_keys = [f"c{i}" for i in range(20)]
        s.api.import_values("kv", "v", 0, None, list(range(20)),
                            column_keys=col_keys)
        res = s.api.query("kv", "Sum(field=v)")
        assert res[0].val == sum(range(20))
    finally:
        s.close()


# ------------------------------------------------------------- timestamps


def test_epoch_zero_timestamp_not_dropped(tmp_path):
    from pilosa_tpu_torch.server.api import _to_datetime
    from tests.test_torch_ingest import Server

    # Epoch-0 is a real timestamp, not "absent".
    assert _to_datetime(0) is not None
    assert _to_datetime(0).year == 1970
    assert _to_datetime(None) is None

    s = Server(data_dir=str(tmp_path / "node"), cache_flush_interval=0,
               member_monitor_interval=0)
    s.open()
    try:
        s.api.create_index("ts")
        s.api.create_field("ts", "t", {"type": "time", "timeQuantum": "Y"})
        # int 0 = epoch-0 nanoseconds: the old `any(t for t in ...)`
        # presence check treated the whole batch as untimestamped.
        s.api.import_bits("ts", "t", 0, [1], [5], timestamps=[0])
        fld = s.holder.field("ts", "t")
        assert "standard_1970" in fld.view_names()
    finally:
        s.close()


# ---------------------------------------------------------------- config


def test_ingest_config_sources(tmp_path, monkeypatch):
    from pilosa_tpu_torch.config import Config
    from pilosa_tpu_torch.ingest import IngestConfig

    toml = tmp_path / "c.toml"
    toml.write_text(
        "[storage]\nsnapshot-ratio = 0.25\nsnapshot-interval = 30.0\n"
        "[ingest]\nimport-workers = 3\n"
    )
    cfg = Config.load(str(toml))
    assert cfg.storage.snapshot_ratio == 0.25
    assert cfg.storage.snapshot_interval == 30.0
    assert cfg.ingest.import_workers == 3
    monkeypatch.setenv("PILOSA_TPU_INGEST_IMPORT_WORKERS", "5")
    monkeypatch.setenv("PILOSA_TPU_STORAGE_SNAPSHOT_RATIO", "0.75")
    cfg = Config.load(str(toml))
    assert cfg.ingest.import_workers == 5  # env beats file
    assert cfg.storage.snapshot_ratio == 0.75
    cfg = Config.load(str(toml), flags={"ingest_import_workers": 7,
                                        "storage_snapshot_interval": 12.5})
    assert cfg.ingest.import_workers == 7  # flags beat env
    assert cfg.storage.snapshot_interval == 12.5
    dumped = cfg.to_toml()
    assert "[ingest]" in dumped and "import-workers = 7" in dumped
    assert "snapshot-ratio" in dumped
    with pytest.raises(ValueError, match="import-workers"):
        IngestConfig(import_workers=0).validate()


def test_debug_vars_ingest_group(tmp_path):
    import json
    import urllib.request

    from tests.test_torch_ingest import Server

    s = Server(data_dir=str(tmp_path / "node"), cache_flush_interval=0,
               member_monitor_interval=0)
    s.open()
    try:
        s.api.create_index("dv")
        s.api.create_field("dv", "f")
        s.api.import_bits("dv", "f", 0, [1, 1], [2, 3])
        with urllib.request.urlopen(
                f"http://localhost:{s.port}/debug/vars") as r:
            dv = json.load(r)
        ing = dv["ingest"]
        assert ing["import_batches"] >= 1
        assert ing["wal_bytes"] > 0
        for key in ("snapshots_deferred", "snapshots_taken",
                    "snapshot_queue_depth"):
            assert key in ing
    finally:
        s.close()
