"""tests/test_cdc.py against the port: change streams, retention and
bootstrap, point-in-time reads and standing queries, with port servers
on the CPU."""

import base64
import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request
import zlib

import pytest

from pilosa_tpu_torch import failpoints
from pilosa_tpu_torch.cdc import CdcConfig
from pilosa_tpu_torch.cdc.log import (CdcRecord, decode_cdc_records,
                                encode_cdc_record)
from pilosa_tpu_torch.errors import CdcGoneError, QueryError
from pilosa_tpu_torch.server.server import Server as _Server
from pilosa_tpu_torch.storage.bitmap import Bitmap, replay_ops
from pilosa_tpu_torch.storage.logscan import scan_log


def Server(*args, **kw):
    """The port's server on the CPU."""
    return _Server(*args, device="cpu", **kw)


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def make_server(tmp_path, name="node0", open_http=False, **cdc_kw):
    cdc_kw.setdefault("enabled", True)
    cdc_kw.setdefault("standing_interval", 0)  # tests drive evaluate_once
    s = Server(data_dir=str(tmp_path / name), cache_flush_interval=0,
               cdc_config=CdcConfig(**cdc_kw))
    if open_http:
        s.open()
    else:
        s.holder.open()
    return s


def _close(s):
    s.cdc.close()
    s.holder.close()


@pytest.fixture
def server(tmp_path):
    s = make_server(tmp_path)
    yield s
    _close(s)


def frag_of(s, index="i", field="f", shard=0):
    return s.holder.index(index).fields[field].views["standard"] \
        .fragments[shard]


# -------------------------------------------------------------- log scan


def test_logscan_chunk_boundary_tear(tmp_path):
    """A record spanning a chunk boundary decodes whole; a torn tail
    truncates at the last record boundary — with a chunk size small
    enough that every record straddles at least one boundary."""
    path = str(tmp_path / "log")
    frames = [encode_cdc_record(CdcRecord(i + 1, "idx", "f", "standard",
                                          i, b"op" * (5 + i)))
              for i in range(9)]
    with open(path, "wb") as f:
        for fr in frames:
            f.write(fr)
        f.write(frames[0][: len(frames[0]) - 3])  # torn tail
    got = []
    res = scan_log(path, decode_cdc_records, chunk_size=7,
                   on_record=got.append)
    assert res.records == 9 and res.truncated
    assert [r.position for r in got] == list(range(1, 10))
    assert os.path.getsize(path) == sum(len(fr) for fr in frames)
    # A second scan of the truncated file is clean and identical.
    res2 = scan_log(path, decode_cdc_records, chunk_size=7)
    assert res2.records == 9 and not res2.truncated


# ----------------------------------------------------- positions + stream


def test_positions_dense_and_stream_matches_wal(server):
    s = server
    idx = s.holder.create_index("i")
    idx.create_field("f")
    for col in range(20):
        s.api.query("i", f"Set({col}, f=1)")
    log = s.cdc.log("i")
    assert log.last_pos == 20
    data, nxt, inc = s.cdc.stream("i", 0, None, timeout=0)
    recs = [r for r, _ in decode_cdc_records(data)]
    assert [r.position for r in recs] == list(range(1, 21))
    assert nxt == 20 and inc == log.incarnation
    # Replaying the streamed op bytes reproduces the fragment exactly.
    bm = Bitmap()
    for r in recs:
        assert (r.field, r.view, r.shard) == ("f", "standard", 0)
        replay_ops(bm, r.ops)
    assert bm.to_bytes() == frag_of(s).storage.to_bytes()
    # Resume from a mid-stream cursor: exactly the remainder, no overlap.
    data2, nxt2, _ = s.cdc.stream("i", 7, inc, timeout=0)
    assert [r.position for r, _ in decode_cdc_records(data2)] == \
        list(range(8, 21))
    # Bounded chunks still end on a record boundary with >= 1 record.
    data3, nxt3, _ = s.cdc.stream("i", 0, inc, timeout=0, max_bytes=1)
    assert [r.position for r, _ in decode_cdc_records(data3)] == [1]
    assert nxt3 == 1
    # At the head an expired long-poll returns empty with the cursor.
    data4, nxt4, _ = s.cdc.stream("i", 20, inc, timeout=0.05)
    assert data4 == b"" and nxt4 == 20


def test_long_poll_wakes_on_append(server):
    s = server
    idx = s.holder.create_index("i")
    idx.create_field("f")
    out = {}

    def consume():
        out["r"] = s.cdc.stream("i", 0, None, timeout=10)

    t = threading.Thread(target=consume)
    t.start()
    time.sleep(0.1)
    s.api.query("i", "Set(3, f=1)")
    t.join(timeout=10)
    assert not t.is_alive()
    data, nxt, _ = out["r"]
    assert nxt == 1
    assert [r.position for r, _ in decode_cdc_records(data)] == [1]


def test_retention_fold_410_and_bootstrap_bit_exact(tmp_path):
    """Crossing retention folds the oldest records into base images; a
    cursor behind the fold 410s and the bootstrap images + remaining
    stream reproduce the live fragment byte-for-byte."""
    s = make_server(tmp_path, retention_ops=8)
    try:
        idx = s.holder.create_index("i")
        idx.create_field("f")
        for col in range(30):
            s.api.query("i", f"Set({col}, f=1)")
        log = s.cdc.log("i")
        assert log.compactions >= 1 and log.base_pos > 0
        assert log.ops < 30  # the prefix really left the log
        with pytest.raises(CdcGoneError) as ei:
            s.cdc.stream("i", 0, None, timeout=0)
        assert ei.value.first == log.base_pos + 1
        assert ei.value.last == 30
        boot = s.cdc.bootstrap("i")
        assert boot["incarnation"] == log.incarnation
        bm = Bitmap()
        for fr in boot["fragments"]:
            assert fr["position"] == 30
            bm = Bitmap.from_bytes(zlib.decompress(
                base64.b64decode(fr["data"])))
        data, _nxt, _ = s.cdc.stream("i", boot["from"], None, timeout=0)
        for r, _ in decode_cdc_records(data):
            replay_ops(bm, r.ops)  # overlap applies idempotently
        assert bm.to_bytes() == frag_of(s).storage.to_bytes()
    finally:
        _close(s)


def test_parked_long_poll_410s_when_fold_passes_cursor(tmp_path):
    """A reader parked in the long-poll wait re-validates its cursor
    after waking: the append that wakes it can trigger compaction that
    folds positions past the cursor IN THE SAME lock hold. Reading on
    from the rebased offsets would silently skip the folded span (or
    jump the cursor to last_pos with no data) — the reader must get the
    typed 410 and re-seed via bootstrap, never a silent gap."""
    s = make_server(tmp_path, retention_ops=1)
    try:
        idx = s.holder.create_index("i")
        idx.create_field("f")
        s.api.query("i", "Set(1, f=1)")  # pos 1; ops=1, no fold yet
        log = s.cdc.log("i")
        assert log.base_pos == 0 and log.last_pos == 1
        out = {}

        def consume():
            try:
                out["r"] = s.cdc.stream("i", 1, log.incarnation, timeout=10)
            except CdcGoneError as e:
                out["gone"] = e

        t = threading.Thread(target=consume)
        t.start()
        time.sleep(0.2)  # reader parked at the head (cursor == last_pos)
        # ops crosses retention_ops=1: this append folds BOTH records
        # into base images under the same lock hold, then wakes the
        # parked reader — whose entry-time cursor check predates the
        # fold.
        s.api.query("i", "Set(2, f=1)")
        t.join(timeout=10)
        assert not t.is_alive()
        assert log.base_pos == 2  # the fold really passed the cursor
        e = out.get("gone")
        assert e is not None, f"expected 410, got chunk {out.get('r')!r}"
        assert e.last == 2
    finally:
        _close(s)


def test_positions_survive_restart_and_snapshot_splice(tmp_path):
    """The change log is its own artifact: fragment WAL splicing (the
    background snapshotter) and a full server restart neither renumber
    nor drop positions."""
    s = make_server(tmp_path)
    idx = s.holder.create_index("i")
    idx.create_field("f")
    for col in range(10):
        s.api.query("i", f"Set({col}, f=1)")
    frag = frag_of(s)
    frag.snapshot()  # splices the fragment WAL into the container image
    for col in range(10, 15):
        s.api.query("i", f"Set({col}, f=1)")
    log = s.cdc.log("i")
    inc = log.incarnation
    assert log.last_pos == 15
    _close(s)
    s2 = make_server(tmp_path)
    try:
        log2 = s2.cdc.log("i")
        assert log2.incarnation == inc  # same index life
        assert log2.last_pos == 15
        s2.api.query("i", "Set(99, f=1)")
        assert log2.last_pos == 16  # counter continues, no reuse
        data, _nxt, _ = s2.cdc.stream("i", 0, inc, timeout=0)
        assert [r.position for r, _ in decode_cdc_records(data)] == \
            list(range(1, 17))
    finally:
        _close(s2)


def test_background_snapshot_concurrent_with_tailing_consumer(server):
    """A tailing consumer sees a dense, loss-free stream while the
    background snapshotter splices the fragment WAL under the writes."""
    s = server
    idx = s.holder.create_index("i")
    idx.create_field("f")
    s.api.query("i", "Set(0, f=1)")
    frag = frag_of(s)
    frag.max_op_n = 16  # force many background snapshots
    n = 300
    seen = []
    bm = Bitmap()
    done = threading.Event()

    def consume():
        cur, inc = 0, None
        while seen[-1:] != [n]:
            data, cur, inc = s.cdc.stream("i", cur, inc, timeout=5)
            for r, _ in decode_cdc_records(data):
                seen.append(r.position)
                replay_ops(bm, r.ops)
        done.set()

    t = threading.Thread(target=consume)
    t.start()
    for col in range(1, n):
        frag.set_bit(1, col)
    assert done.wait(timeout=60)
    t.join(timeout=10)
    assert seen == list(range(1, n + 1))  # dense: no gap, no renumber
    # Quiesce any in-flight background snapshot before comparing bytes.
    frag.snapshot()
    assert bm.to_bytes() == frag.storage.to_bytes()


def test_index_recreate_fresh_incarnation_410(server):
    s = server
    idx = s.holder.create_index("i")
    idx.create_field("f")
    s.api.query("i", "Set(1, f=1)")
    inc = s.cdc.log("i").incarnation
    s.holder.delete_index("i")
    idx = s.holder.create_index("i")
    idx.create_field("f")
    s.api.query("i", "Set(2, f=1)")
    log = s.cdc.log("i")
    assert log.incarnation != inc
    assert log.last_pos == 1  # fresh sequence, new life
    with pytest.raises(CdcGoneError):
        s.cdc.stream("i", 1, inc, timeout=0)  # stale-life cursor
    # Without the incarnation pin the cursor is accepted — that is
    # exactly why consumers must echo the header back.
    data, nxt, _ = s.cdc.stream("i", 0, None, timeout=0)
    assert nxt == 1


# ------------------------------------------------------ point-in-time reads


def test_at_position_reads_bit_exact(tmp_path):
    """An at-position query equals the answer a frozen twin gave at that
    position — across several checkpoints, after more writes, and after
    a fold moved part of the history into base images."""
    s = make_server(tmp_path, retention_ops=64, pit_cache=4)
    try:
        idx = s.holder.create_index("i")
        idx.create_field("f")
        checkpoints = {}  # position -> frozen Row columns
        for col in range(40):
            s.api.query("i", f"Set({col}, f=1)")
            if col % 10 == 9:
                pos = s.cdc.log("i").last_pos
                checkpoints[pos] = list(
                    s.api.query("i", "Row(f=1)")[0].columns())
        for pos, frozen in checkpoints.items():
            got = s.api.query("i", "Row(f=1)", at_position=pos)
            assert list(got[0].columns()) == frozen, pos
            cnt = s.api.query("i", "Count(Row(f=1))", at_position=pos)
            assert cnt[0] == len(frozen)
        # Materialized twin is byte-exact, not just answer-exact.
        pos = max(checkpoints)
        assert pos == s.cdc.log("i").last_pos
        hist = s.cdc.historical_fragment("i", "f", "standard", 0, pos)
        assert hist.storage.to_bytes() == frag_of(s).storage.to_bytes()
        # LRU stays bounded and serves repeats from cache.
        hits0 = s.cdc.pit.hits
        s.api.query("i", "Row(f=1)", at_position=pos)
        assert s.cdc.pit.hits > hits0
        assert len(s.cdc.pit._cache) <= 4
        # Write-only guard and the 410 gate.
        with pytest.raises(QueryError):
            s.api.query("i", "Set(999, f=1)", at_position=pos)
        for _ in range(200):  # push the early history behind the fold
            s.api.query("i", "Set(1000, f=2)")
            s.api.query("i", "Clear(1000, f=2)")
        base = s.cdc.log("i").base_pos
        assert base > min(checkpoints)
        with pytest.raises(CdcGoneError):
            s.api.query("i", "Row(f=1)", at_position=min(checkpoints))
    finally:
        _close(s)


def test_at_position_requires_cdc(tmp_path):
    s = Server(data_dir=str(tmp_path / "plain"), cache_flush_interval=0)
    s.holder.open()
    try:
        idx = s.holder.create_index("i")
        idx.create_field("f")
        with pytest.raises(QueryError, match="cdc.enabled"):
            s.api.query("i", "Row(f=1)", at_position=1)
    finally:
        s.holder.close()


# --------------------------------------------------------- standing queries


def test_standing_register_dedupes_respellings(server):
    s = server
    idx = s.holder.create_index("i")
    idx.create_field("f")
    a, created_a = s.cdc.standing.register(
        "i", "Count(Union(Row(f=1), Row(f=2)))")
    b, created_b = s.cdc.standing.register(
        "i", "Count(Union(Row(f=2), Row(f=1)))")  # commuted operands
    assert created_a and not created_b
    assert a.id == b.id and a is b
    assert len(s.cdc.standing.list()) == 1
    with pytest.raises(QueryError):
        s.cdc.standing.register("i", "Set(1, f=1)")  # writes refused


def test_standing_pushes_only_on_real_change(server):
    s = server
    idx = s.holder.create_index("i")
    idx.create_field("f")
    s.api.query("i", "Set(1, f=1)")
    sq, _ = s.cdc.standing.register("i", "Count(Row(f=1))")
    assert s.cdc.standing.evaluate_once() == 1  # first eval always runs
    assert (sq.version, sq.pushes) == (1, 1)
    assert sq.to_dict()["result"] == 1
    # No writes since: the sweep skips it entirely (no execution).
    assert s.cdc.standing.evaluate_once() == 0
    assert sq.evals == 1
    # A write that does NOT change the answer: re-evaluates (the epoch
    # moved — it cannot know without looking) but does not re-push.
    s.api.query("i", "Set(7, f=2)")
    assert s.cdc.standing.evaluate_once() == 1
    assert sq.stale == 1 and sq.evals == 2
    assert (sq.version, sq.pushes) == (1, 1)
    # A write that changes the answer re-pushes and wakes pollers.
    got = {}

    def poll():
        got["d"] = s.cdc.standing.poll(sq.id, after_version=1, timeout=10)

    t = threading.Thread(target=poll)
    t.start()
    time.sleep(0.05)
    s.api.query("i", "Set(2, f=1)")
    s.cdc.standing.evaluate_once()
    t.join(timeout=10)
    assert not t.is_alive()
    assert got["d"]["version"] == 2 and got["d"]["result"] == 2
    assert (sq.version, sq.pushes, sq.stale) == (2, 2, 2)


# ------------------------------------------------------------- failpoints


def test_cdc_append_fault_assigns_no_position(server):
    """A change-log disk fault surfaces to the writer, but the WAL write
    stands, no position is assigned, and the stream stays dense."""
    s = server
    idx = s.holder.create_index("i")
    idx.create_field("f")
    s.api.query("i", "Set(1, f=1)")
    failpoints.configure("cdc-append", "error", count=1)
    try:
        with pytest.raises(OSError):
            s.api.query("i", "Set(2, f=1)")
    finally:
        failpoints.reset()
    log = s.cdc.log("i")
    assert log.last_pos == 1
    assert s.cdc.counters.get("cdc_append_errors") == 1
    assert frag_of(s).bit(1, 2)  # the WAL write itself acked
    s.api.query("i", "Set(3, f=1)")
    data, _nxt, _ = s.cdc.stream("i", 0, None, timeout=0)
    assert [r.position for r, _ in decode_cdc_records(data)] == [1, 2]


def test_cdc_deliver_and_bootstrap_faults(server):
    s = server
    idx = s.holder.create_index("i")
    idx.create_field("f")
    s.api.query("i", "Set(1, f=1)")
    failpoints.configure("cdc-deliver", "error", count=1)
    try:
        with pytest.raises(OSError):
            s.cdc.stream("i", 0, None, timeout=0)
    finally:
        failpoints.reset()
    failpoints.configure("cdc-snapshot-bootstrap", "error", count=1)
    try:
        with pytest.raises(OSError):
            s.cdc.bootstrap("i")
    finally:
        failpoints.reset()
    # Neither fault poisoned the log: both paths work afterwards.
    data, nxt, _ = s.cdc.stream("i", 0, None, timeout=0)
    assert nxt == 1
    assert len(s.cdc.bootstrap("i")["fragments"]) == 1


# ------------------------------------------------------------ HTTP surface


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, dict(r.headers), r.read()


def test_http_stream_bootstrap_and_standing(tmp_path):
    s = make_server(tmp_path, open_http=True)
    try:
        base = f"http://localhost:{s.port}"
        s.api.create_index("i")
        s.api.create_field("i", "f")
        for col in range(5):
            s.api.query("i", f"Set({col}, f=1)")
        st, hdr, data = _get(f"{base}/cdc/stream?index=i&from=0&timeout=0")
        assert st == 200
        assert hdr["Content-Type"] == "application/octet-stream"
        assert int(hdr["X-Pilosa-Cdc-Next"]) == 5
        inc = hdr["X-Pilosa-Cdc-Incarnation"]
        assert [r.position for r, _ in decode_cdc_records(data)] == \
            [1, 2, 3, 4, 5]
        # Stale incarnation over HTTP is a typed 410 with resume hints.
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{base}/cdc/stream?index=i&from=0&timeout=0"
                 f"&incarnation=not-{inc}")
        assert ei.value.code == 410
        body = json.loads(ei.value.read())
        assert body["incarnation"] == inc and body["last"] == 5
        st, _hdr, data = _get(f"{base}/cdc/bootstrap?index=i")
        boot = json.loads(data)
        assert boot["from"] == 5 and len(boot["fragments"]) == 1
        # at-position over HTTP, header spelling.
        req = urllib.request.Request(
            f"{base}/index/i/query", data=b"Count(Row(f=1))",
            headers={"X-Pilosa-At-Position": "3"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert json.loads(r.read())["results"][0] == 3
        # Standing lifecycle over HTTP.
        req = urllib.request.Request(
            f"{base}/cdc/standing",
            data=json.dumps({"index": "i",
                             "query": "Count(Row(f=1))"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            reg = json.loads(r.read())
        assert reg["created"]
        s.cdc.standing.evaluate_once()
        st, _hdr, data = _get(
            f"{base}/cdc/standing/{reg['id']}/poll?version=0&timeout=5")
        got = json.loads(data)
        assert got["version"] == 1 and got["result"] == 5
        st, _hdr, data = _get(f"{base}/cdc/standing")
        assert len(json.loads(data)["queries"]) == 1
        req = urllib.request.Request(
            f"{base}/cdc/standing/{reg['id']}", method="DELETE")
        with urllib.request.urlopen(req, timeout=30) as r:
            r.read()
        assert s.cdc.standing.list() == []
        # /debug/vars carries the cdc group.
        st, _hdr, data = _get(f"{base}/debug/vars")
        dv = json.loads(data)["cdc"]
        assert dv["indexes"]["i"]["last_pos"] == 5
    finally:
        s.close()


def test_http_cdc_disabled_is_typed_error(tmp_path):
    s = Server(data_dir=str(tmp_path / "off"), cache_flush_interval=0)
    s.open()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"http://localhost:{s.port}/cdc/stream?index=i&from=0")
        assert ei.value.code == 400
        assert "cdc.enabled" in json.loads(ei.value.read())["error"]
    finally:
        s.close()


# ------------------------------------------------------------ config knobs


def test_cdc_config_sources(tmp_path, monkeypatch):
    from pilosa_tpu_torch.config import Config

    toml = tmp_path / "c.toml"
    toml.write_text("[cdc]\nenabled = true\nretention-ops = 77\n")
    cfg = Config.load(str(toml))
    assert cfg.cdc.enabled and cfg.cdc.retention_ops == 77
    monkeypatch.setenv("PILOSA_TPU_CDC_RETENTION_OPS", "99")
    cfg = Config.load(str(toml))
    assert cfg.cdc.retention_ops == 99  # env beats file
    cfg = Config.load(str(toml), flags={"cdc_retention_ops": 55,
                                        "cdc_pit_cache": 3})
    assert cfg.cdc.retention_ops == 55 and cfg.cdc.pit_cache == 3
    assert "[cdc]" in cfg.to_toml()
    with pytest.raises(ValueError, match="cdc.pit-cache"):
        CdcConfig(pit_cache=0).validate()


# ----------------------------------------------- kill -9 consumer recovery


CONSUMER = textwrap.dedent("""
    import base64, json, os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    import urllib.request
    from pilosa_tpu_torch.cdc.log import decode_cdc_records
    from pilosa_tpu_torch.storage.bitmap import Bitmap, replay_ops

    url, state_path, target = sys.argv[1], sys.argv[2], int(sys.argv[3])
    cur, bm = 0, Bitmap()
    if os.path.exists(state_path):
        st = json.load(open(state_path))
        cur = st["from"]
        bm = Bitmap.from_bytes(base64.b64decode(st["bitmap"]))
    applied = cur
    while cur < target:
        with urllib.request.urlopen(
                f"{url}/cdc/stream?index=i&from={cur}&timeout=5"
                "&max-bytes=150", timeout=30) as r:
            data = r.read()
            nxt = int(r.headers["X-Pilosa-Cdc-Next"])
        for rec, _ in decode_cdc_records(data):
            assert rec.position == applied + 1, (rec.position, applied)
            replay_ops(bm, rec.ops)
            applied = rec.position
        cur = nxt
        # Cursor and applied state persist as ONE atomic artifact, so a
        # kill -9 between requests can never desync them.
        tmp = state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"from": cur, "bitmap":
                       base64.b64encode(bm.to_bytes()).decode()}, f)
        os.replace(tmp, state_path)
        print(cur, flush=True)
    print("DONE", flush=True)
""")


def test_sigkill_mid_stream_consumer_resumes_loss_free(tmp_path):
    """The resumability contract end to end: a real subprocess consumer
    checkpoints (cursor, applied-state) atomically, is SIGKILLed
    mid-stream, restarts from its checkpoint, and converges to the exact
    live fragment — dense positions prove no record was lost, skipped,
    or double-applied."""
    s = make_server(tmp_path, open_http=True)
    try:
        s.api.create_index("i")
        s.api.create_field("i", "f")
        n = 120
        for col in range(n):
            s.api.query("i", f"Set({col}, f=1)")
        state = str(tmp_path / "consumer.json")
        args = [sys.executable, "-c", CONSUMER,
                f"http://localhost:{s.port}", state, str(n)]
        env = {**os.environ, "JAX_PLATFORMS": "cpu"}
        child = subprocess.Popen(args, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=env)
        acked = 0
        try:
            for line in child.stdout:
                acked = int(line)
                if acked >= 20:
                    break  # mid-stream, checkpoint on disk
        finally:
            child.kill()
            child.wait(timeout=30)
        assert 0 < acked < n
        child = subprocess.Popen(args, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=env)
        out, err = child.communicate(timeout=120)
        assert child.returncode == 0, err
        assert "DONE" in out
        st = json.load(open(state))
        assert st["from"] == n
        got = Bitmap.from_bytes(base64.b64decode(st["bitmap"]))
        assert got.to_bytes() == frag_of(s).storage.to_bytes()
    finally:
        s.close()


def test_long_poll_consumer_observes_server_close(tmp_path):
    """Shutdown regression: a consumer parked in the stream long-poll
    must observe Server.close() promptly. close() interrupts the CDC
    log waiters BEFORE joining HTTP handler threads, so shutdown never
    has to wait out a poll timeout — the parked request returns empty
    at its cursor (a normal resumable response, not an error)."""
    s = make_server(tmp_path, open_http=True)
    closed = False
    try:
        s.api.create_index("i")
        s.api.create_field("i", "f")
        s.api.query("i", "Set(1, f=1)")
        base = f"http://localhost:{s.port}"
        out = {}
        started = threading.Event()

        def consume():
            # Parked at the head: nothing past position 1 is coming.
            started.set()
            out["r"] = _get(f"{base}/cdc/stream?index=i&from=1&timeout=60",
                            timeout=90)

        t = threading.Thread(target=consume)
        t.start()
        assert started.wait(5)
        time.sleep(0.3)  # let the request actually park in the wait
        t0 = time.monotonic()
        s.close()
        closed = True
        took = time.monotonic() - t0
        t.join(timeout=30)
        assert not t.is_alive()
        assert took < 15.0, f"close() waited out the long-poll: {took:.1f}s"
        st, hdr, data = out["r"]
        assert st == 200 and data == b""
        assert int(hdr["X-Pilosa-Cdc-Next"]) == 1  # cursor unchanged
    finally:
        if not closed:
            s.close()


def test_bootstrap_racing_compaction_consistent_cut(tmp_path):
    """A bootstrap whose image serialization races the retention fold
    must still hand the consumer a consistent (base image, cut
    position) pair: replaying the stream from the returned cursor over
    the images reproduces the live fragment byte-for-byte, with dense
    positions (no gap) and no double-apply (the workload mixes Set and
    Clear, so a replayed stale record would corrupt the bytes). If the
    fold outruns the pinned cut the consumer sees a clean 410 and
    re-seeds — never a silent gap. The `cdc-snapshot-bootstrap`
    latency failpoint holds the serialization window open while the
    writer forces folds through it."""
    import random

    s = make_server(tmp_path, retention_ops=8)
    try:
        idx = s.holder.create_index("i")
        idx.create_field("f")
        rng = random.Random(1337)  # seed-pinned interleave
        writes = 0

        def write_one():
            nonlocal writes
            col = rng.randrange(64)
            if rng.random() < 0.3:
                s.api.query("i", f"Clear({col}, f=1)")
            else:
                s.api.query("i", f"Set({col}, f=1)")
            writes += 1

        for _ in range(40):
            write_one()
        log = s.cdc.log("i")
        assert log.compactions >= 1  # folds really happen at this scale

        stop = threading.Event()

        def writer():
            while not stop.is_set():
                write_one()
                time.sleep(0.002)

        # Hold each bootstrap's off-lock serialization window open so
        # the writer drives retention folds straight through it.
        failpoints.configure("cdc-snapshot-bootstrap", "latency", arg=150)
        w = threading.Thread(target=writer)
        w.start()
        try:
            boots = [s.cdc.bootstrap("i") for _ in range(3)]
        finally:
            stop.set()
            w.join(timeout=30)
            failpoints.deactivate("cdc-snapshot-bootstrap")
        final = s.cdc.log("i").last_pos
        assert final > 40  # the race window saw live writes
        frag = frag_of(s)
        frag.snapshot()  # quiesce before byte compares
        want = frag.storage.to_bytes()

        for boot in boots:
            bm = Bitmap()
            for fr in boot["fragments"]:
                bm = Bitmap.from_bytes(zlib.decompress(
                    base64.b64decode(fr["data"])))
            cur, inc = boot["from"], boot["incarnation"]
            for _ in range(10):
                try:
                    data, cur, inc = s.cdc.stream("i", cur, inc, timeout=0)
                except CdcGoneError:
                    # The fold outran this cut: typed 410, clean re-seed
                    # — the documented recovery, never a silent gap.
                    boot2 = s.cdc.bootstrap("i")
                    for fr in boot2["fragments"]:
                        bm = Bitmap.from_bytes(zlib.decompress(
                            base64.b64decode(fr["data"])))
                    cur, inc = boot2["from"], boot2["incarnation"]
                    continue
                got = [r.position for r, _ in decode_cdc_records(data)]
                # Dense from the cursor: no gap, no double-delivery.
                assert got == list(range(cur - len(got) + 1, cur + 1))
                for r, _ in decode_cdc_records(data):
                    replay_ops(bm, r.ops)
                if cur == final:
                    break
            assert cur == final
            assert bm.to_bytes() == want
    finally:
        _close(s)


def test_point_in_time_read_needs_the_holders_device():
    """A manager not yet wired to its holder refuses a point-in-time read
    instead of building the historical planes on a default device."""
    from pilosa_tpu_torch.cdc.manager import CdcManager
    from pilosa_tpu_torch.storage import StorageConfig

    mgr = CdcManager(CdcConfig(enabled=True), None, StorageConfig())
    mgr.log("i", create=True)
    try:
        with pytest.raises(RuntimeError, match="has a holder"):
            mgr.historical_fragment("i", "f", "standard", 0, 0)
    finally:
        mgr.close()
