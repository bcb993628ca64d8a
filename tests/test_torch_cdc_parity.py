"""CDC on the port answers as CDC on pilosa_tpu.

The same ops (Sets, Clears, SetValues and a bulk import, made from a
numpy seed) go into a port server (on the CPU) and a pilosa_tpu server,
both with `[cdc] enabled`. Each log stamps its records with the wall
clock, so both modules read one fixed clock here; then they must give:
- the same position after every op;
- byte-equal `/cdc/stream` frames and the same next cursor;
- byte-equal `/cdc/bootstrap` images at the same cut positions;
- equal `X-Pilosa-At-Position` answers at several positions, which also
  equal a numpy replay of the ops up to each position.
The port then reopens the pilosa_tpu data directory, `cdc/` log
included, and continues its positions. A point-in-time read leaves the
live engine's caches, memos and kernel counters as they were.
"""

import base64
import http.client
import json
import time
import zlib

import numpy as np
import pytest

import pilosa_tpu.cdc.log as jlog
import pilosa_tpu_torch.cdc.log as tlog
from pilosa_tpu.cdc import CdcConfig as JCdcConfig
from pilosa_tpu.server.server import Server as JServer
from pilosa_tpu_torch.cdc import CdcConfig as TCdcConfig
from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.server.server import Server as TServer

W = 1 << 20  # SHARD_WIDTH
N_SHARDS = 3
STAMP = 1_700_000_000.25


class FixedClock:
    """The log's clock with time() fixed, so stamps match byte for byte."""

    monotonic = staticmethod(time.monotonic)
    sleep = staticmethod(time.sleep)

    @staticmethod
    def time():
        return STAMP


@pytest.fixture(autouse=True)
def fixed_clock(monkeypatch):
    monkeypatch.setattr(jlog, "time", FixedClock)
    monkeypatch.setattr(tlog, "time", FixedClock)


def open_server(pkg, data_dir):
    kw = dict(data_dir=data_dir, cache_flush_interval=0, executor_workers=0,
              anti_entropy_interval=0, member_monitor_interval=0)
    if pkg == "jax":
        return JServer(cdc_config=JCdcConfig(enabled=True, standing_interval=0),
                       **kw).open()
    return TServer(cdc_config=TCdcConfig(enabled=True, standing_interval=0),
                   device="cpu", **kw).open()


def request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("localhost", port, timeout=60)
    try:
        conn.request(method, path, body=body.encode() if isinstance(body, str) else body,
                     headers=headers or {})
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, dict(resp.getheaders()), raw
    finally:
        conn.close()


def query(port, pql, at=None):
    headers = {"X-Pilosa-At-Position": str(at)} if at is not None else None
    status, _, raw = request(port, "POST", "/index/i/query", pql, headers)
    return status, json.loads(raw)


SCHEMA = [("/index/i", "{}"), ("/index/i/field/f", "{}"),
          ("/index/i/field/v", '{"options": {"type": "int", "min": 0, "max": 1000}}')]


def seeded_ops(seed=5, n=120):
    """(pql or import body, [(op, row, col)] of field f) in write order."""
    rng = np.random.default_rng(seed)
    out = []
    rows = rng.integers(0, 4, n)
    cols = rng.integers(0, N_SHARDS * W, n)
    for i, (r, c) in enumerate(zip(rows, cols)):
        if i % 5 == 4:
            pr, pc = rows[i - 3], cols[i - 3]
            out.append((f"Clear({pc}, f={pr})", [(0, pr, pc)]))
        elif i % 7 == 6:
            out.append((f"SetValue(col={c}, v={int(rng.integers(0, 1001))})", []))
        else:
            out.append((f"Set({c}, f={r})", [(1, r, c)]))
        if i == n // 2:
            icols = [int(x) for x in rng.integers(0, W, 16)]
            out.append(({"shard": 0, "rowIDs": [3] * 16, "columnIDs": icols},
                        [(1, 3, x) for x in icols]))
    return out


def apply(port, op):
    if isinstance(op, dict):
        status, _, raw = request(port, "POST", "/index/i/field/f/import", json.dumps(op))
    else:
        status, _, raw = request(port, "POST", "/index/i/query", op)
    assert status == 200, raw


def replay(ops, upto):
    """numpy state of field f after the first `upto` ops: {row: set(cols)}."""
    state = {}
    for _, bits in ops[:upto]:
        for op, r, c in bits:
            s = state.setdefault(int(r), set())
            (s.add if op else s.discard)(int(c))
    return state


def stream(port, frm=0):
    status, headers, raw = request(
        port, "GET", f"/cdc/stream?index=i&from={frm}&timeout=0")
    assert status == 200, raw
    return raw, int(headers["X-Pilosa-Cdc-Next"])


def bootstrap(port):
    status, _, raw = request(port, "GET", "/cdc/bootstrap?index=i")
    assert status == 200, raw
    body = json.loads(raw)
    for frag in body["fragments"]:
        frag["raw"] = zlib.decompress(base64.b64decode(frag["data"]))
    return body["from"], body["fragments"]


READS = ["Count(Row(f=1))", "Count(Intersect(Row(f=1), Row(f=2)))", "Row(f=3)",
         "TopN(f, n=3)", "Sum(field=v)", "Max(field=v)"]


def test_same_ops_give_equal_streams_and_reads(tmp_path):
    j = open_server("jax", str(tmp_path / "jax"))
    t = open_server("torch", str(tmp_path / "torch"))
    try:
        for path, body in SCHEMA:
            for s in (j, t):
                assert request(s.port, "POST", path, body)[0] == 200
        ops = seeded_ops()
        positions = []  # (ops applied, position)
        for k, (op, _) in enumerate(ops):
            for s in (j, t):
                apply(s.port, op)
            pj, pt = j.cdc.log("i").last_pos, t.cdc.log("i").last_pos
            assert pj == pt, (k, op)
            positions.append((k + 1, pt))
        assert positions[-1][1] > len(ops) // 2

        (js, jn), (ts, tn) = stream(j.port), stream(t.port)
        assert ts == js and tn == jn == positions[-1][1]
        recs = list(tlog.decode_cdc_records(ts))
        assert [r.position for r, _ in recs] == list(range(1, tn + 1))
        mid = positions[len(positions) // 3][1]
        assert stream(t.port, mid) == stream(j.port, mid)

        jb, tb = bootstrap(j.port), bootstrap(t.port)
        assert tb == jb

        for k, pos in [positions[9], positions[len(ops) // 2], positions[-5],
                       positions[-1]]:
            want = replay(ops, k)
            status, body = query(t.port, "Count(Intersect(Row(f=1), Row(f=2)))", at=pos)
            assert status == 200
            assert body["results"][0] == len(want.get(1, set()) & want.get(2, set()))
            status, body = query(t.port, "Row(f=3)", at=pos)
            assert body["results"][0]["columns"] == sorted(want.get(3, set()))
            for pql in READS:
                assert query(t.port, pql, at=pos) == query(j.port, pql, at=pos), (pos, pql)
        for pql in READS:
            assert query(t.port, pql) == query(j.port, pql)
    finally:
        t.close()
        j.close()


def test_port_reopens_a_jax_cdc_log_and_continues(tmp_path):
    d = str(tmp_path / "d")
    j = open_server("jax", d)
    ops = seeded_ops(seed=6, n=40)
    try:
        for path, body in SCHEMA:
            assert request(j.port, "POST", path, body)[0] == 200
        for op, _ in ops:
            apply(j.port, op)
        last = j.cdc.log("i").last_pos
        before, _ = stream(j.port)
        at = {p: query(j.port, "Row(f=1)", at=p) for p in (5, last // 2, last)}
    finally:
        j.close()
    t = open_server("torch", d)
    try:
        assert t.cdc.log("i").last_pos == last
        again, nxt = stream(t.port)
        assert again == before and nxt == last
        for p, want in at.items():
            assert query(t.port, "Row(f=1)", at=p) == want
        apply(t.port, f"Set({2 * W + 17}, f=1)")
        assert t.cdc.log("i").last_pos == last + 1
        tail, nxt = stream(t.port, last)
        (rec, _), = list(tlog.decode_cdc_records(tail))
        assert (rec.position, rec.shard, rec.field, nxt) == (last + 1, 2, "f", last + 1)
    finally:
        t.close()


def test_point_in_time_read_leaves_the_live_engine_alone(tmp_path):
    """A PIT query runs on the shadow executor: the live engine's caches,
    memo and counters, and the kernels' launch and twin counters, do not
    move, and a live repeat still hits the memo."""
    t = open_server("torch", str(tmp_path / "t"))
    try:
        for path, body in SCHEMA:
            assert request(t.port, "POST", path, body)[0] == 200
        ops = seeded_ops(seed=7, n=60)
        for op, _ in ops:
            apply(t.port, op)
        live = "Count(Intersect(Row(f=1), Row(f=2)))"
        want = query(t.port, live)
        assert query(t.port, live) == want  # a memo hit
        eng = t.executor.engine
        snap = eng.snapshot()
        caches = (len(eng._leaf_cache), len(eng._stack_cache), len(eng._memo))
        counts = (dict(kernels.LAUNCHES), dict(kernels.PLAIN_CALLS))
        last = t.cdc.log("i").last_pos
        for pos in (3, last // 2, last):
            for pql in (live, "Row(f=1)", "TopN(f, n=2)", "Sum(field=v)"):
                assert query(t.port, pql, at=pos)[0] == 200
        assert query(t.port, live, at=last) == want
        assert eng.snapshot() == snap
        assert (len(eng._leaf_cache), len(eng._stack_cache), len(eng._memo)) == caches
        assert (dict(kernels.LAUNCHES), dict(kernels.PLAIN_CALLS)) == counts
        assert query(t.port, live) == want
        assert eng.snapshot()["memo_hits"] == snap["memo_hits"] + 1
    finally:
        t.close()
