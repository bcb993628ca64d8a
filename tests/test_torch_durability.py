"""The cases of tests/test_durability.py, run against the port on the CPU.

Crash-safety tests: durable WAL + torn-tail recovery, corrupt-fragment
quarantine + anti-entropy repair, and the failpoint fault-injection layer.

The subprocess tests prove the kill -9 contract end to end: a child
process is crashed (SIGKILL or an injected os._exit at an exact code
point) mid-op-append / mid-snapshot, and the parent reopens the holder
and asserts every acknowledged write survived.
"""

import io
import os
import signal
import struct
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from pilosa_tpu_torch import failpoints
from pilosa_tpu_torch.constants import SHARD_WIDTH
from pilosa_tpu_torch.core.fragment import Fragment
from pilosa_tpu_torch.core.holder import Holder as _Holder
from pilosa_tpu_torch.errors import CorruptFragmentError, PilosaError
from pilosa_tpu_torch.storage import StorageConfig
from pilosa_tpu_torch.storage.bitmap import OP_ADD, Bitmap, encode_op, parse_op


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


# ------------------------------------------------------------- failpoints


def test_failpoint_inactive_is_noop():
    failpoints.fire("anything")  # no registry, no error


def test_failpoint_error_and_count():
    failpoints.configure("p", "error", count=2, message="boom")  # pilint: allow-failpoint(registry test fires the point by hand below)
    with pytest.raises(failpoints.InjectedFault, match="boom"):
        failpoints.fire("p")
    with pytest.raises(failpoints.InjectedFault):
        failpoints.fire("p")
    failpoints.fire("p")  # count exhausted: inert but still counted
    assert failpoints.hits("p") == 3


def test_failpoint_spec_parsing():
    failpoints.activate("a=error;b=3*crash;c=1*error(disk gone)")  # pilint: allow-failpoint(spec-grammar test, never fired)
    assert failpoints.active() == {"a": "error", "b": "3*crash", "c": "1*error"}
    with pytest.raises(failpoints.InjectedFault, match="disk gone"):
        failpoints.fire("c")
    failpoints.deactivate("a")
    assert "a" not in failpoints.active()
    with pytest.raises(ValueError, match="bad failpoint spec"):
        failpoints.activate("oops")
    with pytest.raises(ValueError):
        failpoints.activate("x=explode")


# ------------------------------------------------- torn-tail WAL recovery


def test_parse_op_checksum_is_typed_with_offset():
    op = encode_op(OP_ADD, 7)
    bad = bytes([op[0] ^ 1]) + op[1:]
    with pytest.raises(CorruptFragmentError) as ei:
        parse_op(b"\x00" * 4 + bad, 4)
    assert ei.value.offset == 4
    assert isinstance(ei.value, ValueError)  # legacy callers keep working


def test_from_buffer_truncates_incomplete_tail():
    bm = Bitmap([1, 2, 3])
    base = bm.to_bytes()
    data = base + encode_op(OP_ADD, 99) + encode_op(OP_ADD, 100)[:5]
    out = Bitmap.from_buffer(data)
    assert out.contains(99)
    assert not out.contains(100)
    assert out.valid_len == len(base) + 13
    assert out.truncated_bytes == 5


def test_from_buffer_truncates_corrupt_final_record():
    """A checksum-failing FINAL record is a torn append: truncate."""
    bm = Bitmap([1])
    base = bm.to_bytes()
    good = encode_op(OP_ADD, 50)
    bad = bytearray(encode_op(OP_ADD, 60))
    bad[2] ^= 0xFF
    out = Bitmap.from_buffer(base + good + bytes(bad))
    assert out.contains(50) and not out.contains(60)
    assert out.valid_len == len(base) + 13
    assert out.truncated_bytes == 13


def test_from_buffer_rejects_mid_log_checksum_failure():
    """A checksum failure with more data beyond it cannot be a torn append
    (appends only tear the final record) — it's bit rot. Raising routes
    the fragment to quarantine + replica repair instead of silently
    truncating away every acknowledged op after the bad sector."""
    bm = Bitmap([1])
    base = bm.to_bytes()
    bad = bytearray(encode_op(OP_ADD, 60))
    bad[2] ^= 0xFF
    good = encode_op(OP_ADD, 70)
    with pytest.raises(CorruptFragmentError, match="mid-log"):
        Bitmap.from_buffer(base + bytes(bad) + good)


def test_from_buffer_rejects_short_container_payload():
    """A container region cut mid-payload is typed corruption, not a bare
    numpy ValueError — repair loops keying on PilosaError must catch it."""
    bm = Bitmap(np.arange(10, dtype=np.uint64))
    data = bm.to_bytes()
    with pytest.raises(CorruptFragmentError, match="out of bounds"):
        Bitmap.from_buffer(data[: len(data) - 3])


def test_fragment_reopen_truncates_torn_tail(tmp_path):
    frag = make_frag(tmp_path)
    for i in range(10):
        frag.set_bit(2, i)
    frag.close()
    path = frag.path
    clean_size = os.path.getsize(path)
    with open(path, "ab") as fh:
        fh.write(encode_op(OP_ADD, 12345)[:7])  # torn mid-record
    frag2 = make_frag(tmp_path)
    assert all(frag2.bit(2, i) for i in range(10))
    assert frag2.recovered_tail_bytes == 7
    assert os.path.getsize(path) == clean_size  # file cut to valid boundary
    # The next append lands on a clean boundary and replays fine.
    frag2.set_bit(2, 11)
    frag2.close()
    frag3 = make_frag(tmp_path)
    assert frag3.bit(2, 11) and frag3.bit(2, 9)
    frag3.close()


# ------------------------------------------------------ quarantine at open


def test_fragment_quarantine_on_corrupt_file(tmp_path):
    frag = make_frag(tmp_path)
    frag.set_bit(1, 5)
    frag.close()
    path = frag.path
    with open(path, "r+b") as fh:
        fh.write(b"\xff" * 8)  # clobber the cookie
    frag2 = make_frag(tmp_path)
    assert frag2.quarantined
    assert frag2.quarantine_reason
    assert os.path.exists(path + ".corrupt")
    assert frag2.row_count(1) == 0  # serves empty, not an error
    # Still writable while degraded; acks are durable in the fresh file.
    assert frag2.set_bit(1, 7)
    frag2.close()
    # Quarantine persists across restart (the .corrupt file is the marker)
    # so a later anti-entropy sweep still knows to repair.
    frag3 = make_frag(tmp_path)
    assert frag3.quarantined
    assert frag3.bit(1, 7) and not frag3.bit(1, 5)
    frag3.close()


def test_holder_open_survives_corrupt_fragment(tmp_path):
    holder = Holder(str(tmp_path / "indexes")).open()
    idx = holder.create_index("q")
    fld = idx.create_field("f")
    fld.set_bit(3, 11)
    frag = holder.fragment("q", "f", "standard", 0)
    path = frag.path
    holder.close()
    with open(path, "r+b") as fh:
        fh.write(b"junkjunk")
    holder.reopen()  # must not raise
    qs = holder.quarantined_fragments()
    assert len(qs) == 1 and qs[0].shard == 0
    assert holder.fragment("q", "f", "standard", 0).row_count(3) == 0
    holder.close()


# --------------------------------------------------------- snapshot safety


def test_snapshot_fail_recovers_and_file_stays_whole(tmp_path):
    frag = make_frag(tmp_path)
    for i in range(20):
        frag.set_bit(0, i)
    failpoints.configure("snapshot-rename", "error", count=1)
    with pytest.raises(failpoints.InjectedFault):
        frag.snapshot()
    assert not os.path.exists(frag.path + ".snapshotting")
    # WAL handle was restored: writes keep working after the failure...
    assert frag.set_bit(0, 21)
    # ...and a later snapshot succeeds.
    frag.snapshot()
    frag.close()
    frag2 = make_frag(tmp_path)
    assert all(frag2.bit(0, i) for i in range(20)) and frag2.bit(0, 21)
    assert frag2.op_n == 0  # snapshot folded the ops in
    frag2.close()


def test_open_cleans_leftover_snapshot_tmp(tmp_path):
    frag = make_frag(tmp_path)
    frag.set_bit(0, 1)
    frag.close()
    tmp = frag.path + ".snapshotting"
    with open(tmp, "wb") as fh:
        fh.write(b"partial snapshot garbage")
    frag2 = make_frag(tmp_path)
    assert not os.path.exists(tmp)
    assert frag2.bit(0, 1)
    frag2.close()


def test_fsync_modes(tmp_path, monkeypatch):
    calls = {"n": 0}
    real_fsync = os.fsync

    def counting_fsync(fd):
        calls["n"] += 1
        return real_fsync(fd)

    monkeypatch.setattr(os, "fsync", counting_fsync)

    frag = make_frag(tmp_path, name="never",
                     storage_config=StorageConfig(fsync="never"))
    for i in range(10):
        frag.set_bit(0, i)
    frag.close()
    assert calls["n"] == 0

    calls["n"] = 0
    frag = make_frag(tmp_path, name="always",
                     storage_config=StorageConfig(fsync="always"))
    for i in range(10):
        frag.set_bit(0, i)
    assert calls["n"] == 10  # one per acknowledged op

    calls["n"] = 0
    frag = make_frag(tmp_path, name="batch",
                     storage_config=StorageConfig(fsync="batch", fsync_batch_ops=4))
    for i in range(10):
        frag.set_bit(0, i)
    assert calls["n"] == 2  # at ops 4 and 8
    frag.close()  # close boundary syncs the 2 stragglers
    assert calls["n"] == 3


# ------------------------------------------------- cache + stream hardening


def test_load_cache_tolerates_truncation(tmp_path):
    frag = make_frag(tmp_path)
    for r in range(5):
        frag.set_bit(r, r)
    frag.close()  # flushes the TopN cache
    cache = frag.cache_path()
    with open(cache, "rb") as fh:
        data = fh.read()
    with open(cache, "wb") as fh:
        fh.write(data[: len(data) - 6])  # torn cache write
    frag2 = make_frag(tmp_path)  # must not raise
    assert frag2.cache.top()  # rebuilt from storage
    frag2.close()


def test_read_from_rejects_short_stream(tmp_path):
    frag = make_frag(tmp_path)
    with pytest.raises(PilosaError, match="expected 8 header bytes"):
        frag.read_from(io.BytesIO(b"\x01\x02"))
    data = Bitmap([1, 2]).to_bytes()
    stream = struct.pack("<Q", len(data) + 50) + data
    with pytest.raises(PilosaError, match=r"expected \d+ payload bytes"):
        frag.read_from(io.BytesIO(stream))
    # And a payload whose op tail is torn is a sender fault, not a local
    # recovery situation: reject rather than install partial data.
    torn = data + encode_op(OP_ADD, 9)[:6]
    stream = struct.pack("<Q", len(torn)) + torn
    with pytest.raises(PilosaError, match="torn op log"):
        frag.read_from(io.BytesIO(stream))
    frag.close()


# ------------------------------------------------------------- config knobs


def test_storage_config_sources(tmp_path, monkeypatch):
    from pilosa_tpu_torch.config import Config

    toml = tmp_path / "c.toml"
    toml.write_text("[storage]\nfsync = \"never\"\nfsync-batch-ops = 7\n")
    cfg = Config.load(str(toml))
    assert cfg.storage.fsync == "never" and cfg.storage.fsync_batch_ops == 7
    monkeypatch.setenv("PILOSA_TPU_STORAGE_FSYNC", "always")
    cfg = Config.load(str(toml))
    assert cfg.storage.fsync == "always"  # env beats file
    cfg = Config.load(str(toml), flags={"storage_fsync": "batch"})
    assert cfg.storage.fsync == "batch"  # flags beat env
    assert "[storage]" in cfg.to_toml()
    with pytest.raises(ValueError, match="storage.fsync"):
        StorageConfig(fsync="sometimes").validate()


# --------------------------------------------- kill -9 subprocess recovery


CHILD_PRELUDE = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    from pilosa_tpu_torch import failpoints
    from pilosa_tpu_torch.core.fragment import Fragment
""")


def _run_child(body, *args, timeout=120):
    return subprocess.Popen(
        [sys.executable, "-c", CHILD_PRELUDE + textwrap.dedent(body), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )


def test_sigkill_mid_append_preserves_acked_writes(tmp_path):
    """The raw kill -9 contract: the parent SIGKILLs the writer at an
    arbitrary acked point; every write acknowledged before the kill must
    be present after reopen (WAL appends flush before the ack)."""
    path = str(tmp_path / "fragments" / "0")
    child = _run_child("""
        frag = Fragment(sys.argv[1], "i", "f", "standard", 0)
        frag.open()
        for i in range(10_000):
            frag.set_bit(1, i)
            print(i, flush=True)  # the ack
    """, path)
    acked = -1
    try:
        for line in child.stdout:
            acked = int(line)
            if acked >= 120:
                break
    finally:
        child.kill()
        child.wait(timeout=30)
    assert acked >= 120
    frag = Fragment(path, "i", "f", "standard", 0)
    frag.open()
    missing = [i for i in range(acked + 1) if not frag.bit(1, i)]
    assert not missing, f"lost acked writes: {missing[:10]}"
    frag.close()


def test_injected_crash_mid_append_then_torn_tail(tmp_path):
    """Deterministic variant: a failpoint crashes the child at the exact
    WAL-append boundary of write N+1 (the os._exit models kill -9: no
    flush, no unwinding). The parent then also tears the tail by hand and
    asserts recovery truncates to the last valid boundary."""
    path = str(tmp_path / "fragments" / "0")
    child = _run_child("""
        frag = Fragment(sys.argv[1], "i", "f", "standard", 0)
        frag.open()
        for i in range(50):
            frag.set_bit(1, i)
        print("acked 50", flush=True)
        failpoints.configure("wal-append", "crash")
        frag.set_bit(1, 50)  # crashes before the record hits the file
        print("NEVER", flush=True)
    """, path)
    out, err = child.communicate(timeout=120)
    assert child.returncode == failpoints.CRASH_EXIT_CODE, err
    assert "acked 50" in out and "NEVER" not in out
    with open(path, "ab") as fh:
        fh.write(b"\x00\x01\x02")  # a torn half-record on top
    frag = Fragment(path, "i", "f", "standard", 0)
    frag.open()
    assert all(frag.bit(1, i) for i in range(50))
    assert not frag.bit(1, 50)
    assert frag.recovered_tail_bytes == 3
    frag.close()


def test_injected_crash_mid_snapshot(tmp_path):
    """Crash at the snapshot rename boundary: the temp file is garbage,
    the original file (container section + full op log) is the durable
    truth, and reopen recovers every acked write and cleans the temp."""
    path = str(tmp_path / "fragments" / "0")
    child = _run_child("""
        failpoints.configure("snapshot-rename", "crash")
        frag = Fragment(sys.argv[1], "i", "f", "standard", 0, max_op_n=8)
        frag.open()
        for i in range(8):  # the 8th append triggers the snapshot
            frag.set_bit(1, i)
        print("NEVER", flush=True)
    """, path)
    out, err = child.communicate(timeout=120)
    assert child.returncode == failpoints.CRASH_EXIT_CODE, err
    assert "NEVER" not in out
    assert os.path.exists(path + ".snapshotting")
    frag = Fragment(path, "i", "f", "standard", 0)
    frag.open()
    assert not os.path.exists(path + ".snapshotting")
    assert all(frag.bit(1, i) for i in range(8))
    assert not frag.quarantined
    frag.close()


def test_sigkill_mid_bulk_import_preserves_acked_batches(tmp_path):
    """kill -9 during a stream of WAL-amortized bulk imports: every batch
    acknowledged before the kill must replay whole after reopen (bulk
    records flush before the ack; a torn final record truncates)."""
    path = str(tmp_path / "fragments" / "0")
    child = _run_child("""
        import numpy as np
        frag = Fragment(sys.argv[1], "i", "f", "standard", 0)
        frag.open()
        for i in range(10_000):
            rows = np.full(100, i % 7, dtype=np.uint64)
            cols = np.arange(i * 100, (i + 1) * 100, dtype=np.uint64) % (1 << 20)
            frag.bulk_import(rows, cols)
            print(i, flush=True)  # the ack
    """, path)
    acked = -1
    try:
        for line in child.stdout:
            acked = int(line)
            if acked >= 30:
                break
    finally:
        child.kill()
        child.wait(timeout=30)
    assert acked >= 30
    frag = Fragment(path, "i", "f", "standard", 0)
    frag.open()
    for i in range(acked + 1):
        col = (i * 100) % (1 << 20)
        assert frag.bit(i % 7, col), f"lost acked batch {i}"
    frag.close()


def test_injected_crash_mid_bulk_append_torn_tail(tmp_path):
    """Deterministic: crash at the bulk-append boundary, then tear the
    tail by hand — recovery truncates back to the last whole record."""
    path = str(tmp_path / "fragments" / "0")
    child = _run_child("""
        import numpy as np
        frag = Fragment(sys.argv[1], "i", "f", "standard", 0)
        frag.open()
        frag.bulk_import(np.zeros(50, dtype=np.uint64),
                         np.arange(50, dtype=np.uint64))
        print("acked", flush=True)
        failpoints.configure("bulk-wal-append", "crash")
        frag.bulk_import(np.ones(50, dtype=np.uint64),
                         np.arange(50, dtype=np.uint64))
        print("NEVER", flush=True)
    """, path)
    out, err = child.communicate(timeout=120)
    assert child.returncode == failpoints.CRASH_EXIT_CODE, err
    assert "acked" in out and "NEVER" not in out
    from pilosa_tpu_torch.storage.bitmap import encode_bulk_op

    rec = encode_bulk_op(np.arange(10, dtype=np.uint64), None)
    with open(path, "ab") as fh:
        fh.write(rec[: len(rec) - 5])  # torn bulk record on top
    frag = Fragment(path, "i", "f", "standard", 0)
    frag.open()
    assert frag.row_count(0) == 50
    assert frag.row_count(1) == 0  # the crashed batch was never acked
    assert frag.recovered_tail_bytes == len(rec) - 5
    frag.close()


def test_sigkill_mid_hint_append_truncates_torn_tail(tmp_path):
    """Hinted-handoff durability twin of the WAL kill -9 contract
    (cluster/hints.py): the parent SIGKILLs a writer appending hint
    records at an arbitrary acked point. After reopen, every ACKED hint
    is present in order and parseable; a torn tail (the mid-append
    artifact, plus hand-written garbage) truncates at the last whole
    record and is NEVER replayed toward a peer."""
    hints_dir = str(tmp_path / "hints")
    child = _run_child("""
        from pilosa_tpu_torch.cluster.hints import HintStore, ReplicationConfig
        from pilosa_tpu_torch.storage.bitmap import encode_op, OP_ADD

        class F:
            index = "i"; field = "f"; view = "standard"; shard = 0
        hs = HintStore(sys.argv[1], ReplicationConfig())
        for i in range(100_000):
            assert hs.add("peer-a:1", "i", 0, [(F, encode_op(OP_ADD, i))])
            print(i, flush=True)  # the ack
    """, hints_dir)
    acked = -1
    try:
        for line in child.stdout:
            acked = int(line)
            if acked >= 150:
                break
    finally:
        child.kill()
        child.wait(timeout=30)
    assert acked >= 150
    from pilosa_tpu_torch.cluster.hints import HintStore, ReplicationConfig
    from pilosa_tpu_torch.storage.bitmap import decode_op_records

    hs = HintStore(hints_dir, ReplicationConfig())
    recs = hs.records("peer-a:1")
    assert len(recs) >= acked + 1, f"lost acked hints: {len(recs)}/{acked+1}"
    for i, rec in enumerate(recs[: acked + 1]):
        adds, rems = decode_op_records(rec.ops)[0]
        assert adds.tolist() == [i] and not len(rems)
    hs.close()
    # Tear the tail by hand on top: reopen truncates, counts it, and
    # the surviving prefix still parses whole.
    log_path = os.path.join(hints_dir, "peer-a%3A1", "log")
    whole = os.path.getsize(log_path)
    with open(log_path, "ab") as fh:
        fh.write(b"\x00\x01\x02garbage")
    hs2 = HintStore(hints_dir, ReplicationConfig())
    assert hs2.snapshot()["hints_truncated"] == 1
    assert os.path.getsize(log_path) == whole
    assert len(hs2.records("peer-a:1")) == len(recs)
    hs2.close()


def test_sigkill_mid_background_snapshot(tmp_path):
    """Crash at the BACKGROUND snapshot's rename boundary (the crash
    fires on the snapshotter thread; os._exit models kill -9): the
    original file with its bulk op log is the durable truth, reopen
    recovers every acked write and cleans the leftover temp."""
    data_dir = str(tmp_path / "indexes")
    child = _run_child("""
        import numpy as np, time
        from tests.test_torch_durability import Holder
        from pilosa_tpu_torch.storage import StorageConfig

        failpoints.configure("snapshot-rename", "crash")
        h = Holder(sys.argv[1],
                   storage_config=StorageConfig(snapshot_interval=0))
        h.open()
        fld = h.create_index("t").create_field("f")
        rows = np.repeat(np.arange(4, dtype=np.uint64), 50_000)
        cols = np.tile(np.arange(50_000, dtype=np.uint64), 4)
        fld.import_bits(rows, cols)  # 1.6 MB WAL record: policy fires
        print("acked", flush=True)
        # The snapshotter thread crashes the process at the rename; a
        # snapshot that ends any other way ends the wait at once.
        done = h.snapshotter.counters
        deadline = time.monotonic() + 30
        while (done["snapshots_taken"] + done["snapshot_errors"] == 0
               and time.monotonic() < deadline):
            time.sleep(0.01)
        print("NEVER", flush=True)
    """, data_dir)
    out, err = child.communicate(timeout=120)
    assert child.returncode == failpoints.CRASH_EXIT_CODE, err
    assert "acked" in out and "NEVER" not in out
    from tests.test_torch_durability import Holder

    h = Holder(data_dir).open()
    frag = h.fragment("t", "f", "standard", 0)
    assert not frag.quarantined
    assert not os.path.exists(frag.path + ".snapshotting.bg")
    for r in range(4):
        assert frag.row_count(r) == 50_000, r
    h.close()


# ----------------------------------- quarantine repair via anti-entropy


def free_port():
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def cluster3r(tmp_path):
    """3 nodes, replica_n=3: every shard lives everywhere, and majority
    voting (2 of 3) is live — the case where a quarantined-empty fragment
    voting in the block merge could drop acked bits."""
    from pilosa_tpu_torch.cluster.hash import ModHasher
    from tests.test_torch_durability import Server

    ports = [free_port() for _ in range(3)]
    hosts = [f"localhost:{p}" for p in ports]
    servers = []
    for i, port in enumerate(ports):
        s = Server(
            data_dir=str(tmp_path / f"node{i}"),
            port=port,
            cluster_hosts=hosts,
            replica_n=3,
            hasher=ModHasher(),
            cache_flush_interval=0,
            anti_entropy_interval=0,  # manual sync in tests
            executor_workers=0,
        )
        s.open()
        servers.append(s)
    yield servers
    for s in servers:
        s.close()


def test_quarantine_repair_from_replica(cluster3r):
    from pilosa_tpu_torch.cluster.syncer import HolderSyncer
    from pilosa_tpu_torch.server.client import InternalClient

    client = InternalClient()
    h0 = f"localhost:{cluster3r[0].port}"
    client.create_index(h0, "q")
    client.create_field(h0, "q", "f")
    time.sleep(0.05)
    for i in range(6):
        client.query(h0, "q", f"Set({i}, f=1)")
    client.query(h0, "q", "Set(3, f=2)")

    # Corrupt node0's fragment file on disk and reboot its holder: the node
    # must finish opening with the fragment quarantined, not crash.
    frag0 = cluster3r[0].holder.fragment("q", "f", "standard", 0)
    path = frag0.path
    cluster3r[0].holder.close()
    with open(path, "r+b") as fh:
        fh.write(b"\xde\xad\xbe\xef" * 4)
    cluster3r[0].holder.reopen()
    frag0 = cluster3r[0].holder.fragment("q", "f", "standard", 0)
    assert frag0.quarantined
    assert os.path.exists(path + ".corrupt")
    # Quarantined-but-unrepaired serves empty instead of erroring.
    assert frag0.row_count(1) == 0
    r = client.query(h0, "q", "Count(Row(f=1))")
    assert r["results"][0] == 0

    # A quarantined fragment must refuse to serve as a shard-ship source
    # (a resize pulling the empty copy would then GC the healthy replicas).
    from pilosa_tpu_torch.server.client import ClientError

    with pytest.raises(ClientError, match="quarantined"):
        client.retrieve_shard_from_uri(h0, "q", "f", "standard", 0)

    # A write acknowledged while degraded (fans out to all replicas).
    client.query(h0, "q", "Set(90, f=1)")

    # ONE anti-entropy sweep: restore from a replica BEFORE block voting,
    # then the normal checksum walk finds replicas already converged.
    HolderSyncer(cluster3r[0]).sync_holder()
    frag0 = cluster3r[0].holder.fragment("q", "f", "standard", 0)
    assert not frag0.quarantined
    for i in range(6):
        assert frag0.bit(1, i), i
    assert frag0.bit(2, 3)
    assert frag0.bit(1, 90)  # degraded-period ack survived the repair

    # Byte-identical to its replica once both sit at a canonical snapshot
    # (read_from snapshots the repaired fragment internally).
    frag1 = cluster3r[1].holder.fragment("q", "f", "standard", 0)
    frag1.snapshot()
    frag0.snapshot()
    with open(frag0.path, "rb") as a, open(frag1.path, "rb") as b:
        assert a.read() == b.read()
    assert frag0.checksum() == frag1.checksum()

    # The healthy replicas never lost anything to the empty local vote.
    frag2 = cluster3r[2].holder.fragment("q", "f", "standard", 0)
    for i in range(6):
        assert frag2.bit(1, i)
