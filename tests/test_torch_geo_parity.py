"""Geo replication across the two packages, on the CPU.

A follower of one package tails a leader of the other (both ways:
pilosa_tpu leader with a port follower, port leader with a pilosa_tpu
follower). After seeded writes the two sides converge to equal fragment
bytes and answer Count, Intersect, Row, TopN and Sum with the same JSON.
Then POST /geo/promote to the follower: the old leader is fenced, the new
leader takes writes, the old one re-tails them, and the answers agree
again. Last, the fenced node's data directory reopens as a follower of
the OTHER package: it resumes from the cursor the first package
checkpointed, with no bootstrap, and converges on writes made while it
was down.
"""

import json
import os
import socket
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from pilosa_tpu.cdc import CdcConfig as JCdcConfig
from pilosa_tpu.geo import GeoConfig as JGeoConfig
from pilosa_tpu.parallel import EngineConfig as JEngineConfig
from pilosa_tpu.server.server import Server as JServer
from pilosa_tpu_torch.cdc import CdcConfig as TCdcConfig
from pilosa_tpu_torch.geo import GeoConfig as TGeoConfig
from pilosa_tpu_torch.server.server import Server as TServer

W = 1 << 20  # SHARD_WIDTH
N_SHARDS = 3
READS = [
    "Count(Row(f=1))",
    "Count(Intersect(Row(f=1), Row(f=2)))",
    "Row(f=2)",
    "TopN(f, n=5)",
    "Sum(field=v)",
    "Sum(Row(f=1), field=v)",
]


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def make(pkg, data_dir, **geo):
    kw = dict(data_dir=str(data_dir), port=free_port(), cache_flush_interval=0,
              executor_workers=0)
    if pkg == "jax":
        return JServer(engine_config=JEngineConfig(gather_workers=1),
                       cdc_config=JCdcConfig(enabled=True),
                       geo_config=JGeoConfig(**geo), **kw).open()
    return TServer(device="cpu", cdc_config=TCdcConfig(enabled=True),
                   geo_config=TGeoConfig(**geo), **kw).open()


def post(port, path, body=""):
    req = urllib.request.Request(f"http://localhost:{port}{path}", data=body.encode())
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def answers(port):
    return [post(port, "/index/i/query", q) for q in READS]


def frag_bytes(srv):
    out = {}
    for name in ("f", "v"):
        fld = srv.holder.field("i", name)
        for view in (fld.views.values() if fld is not None else ()):
            for shard, frag in view.fragments.items():
                if frag.storage.count():
                    out[(name, view.name, shard)] = frag.storage.to_bytes()
    return out


def wait_equal(a, b, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if frag_bytes(a) == frag_bytes(b):
            return
        time.sleep(0.05)
    raise AssertionError("the two sides never converged")


def writes(rng, n):
    out = []
    for _ in range(n):
        col = int(rng.integers(N_SHARDS * W))
        kind = rng.integers(4)
        if kind == 0:
            out.append(f"Clear({col}, f={int(rng.integers(1, 3))})")
        elif kind == 1:
            out.append(f"Set({col}, v={int(rng.integers(0, 1000))})")
        else:
            out.append(f"Set({col}, f={int(rng.integers(1, 4))})")
    return out


def write_all(port, qs):
    for q in qs:
        st, body = post(port, "/index/i/query", q)
        assert st == 200, (q, body)


@pytest.mark.parametrize("leader_pkg,follower_pkg", [("jax", "torch"), ("torch", "jax")])
def test_follower_of_the_other_package(tmp_path, leader_pkg, follower_pkg):
    rng = np.random.default_rng(3)
    servers = []
    try:
        leader = make(leader_pkg, tmp_path / "leader", role="leader")
        servers.append(leader)
        assert post(leader.port, "/index/i", "{}")[0] == 200
        assert post(leader.port, "/index/i/field/f", "{}")[0] == 200
        assert post(leader.port, "/index/i/field/v",
                    '{"options": {"type": "int", "min": 0, "max": 1000}}')[0] == 200
        write_all(leader.port, writes(rng, 60))
        follower = make(follower_pkg, tmp_path / "follower", role="follower",
                        leader=f"localhost:{leader.port}", backoff=0.05)
        servers.append(follower)
        write_all(leader.port, writes(rng, 60))
        wait_equal(leader, follower)
        assert answers(follower.port) == answers(leader.port)
        assert follower.geo.tailer.counters["apply_errors"] == 0

        # Promotion: the follower leads, the old leader is fenced and re-tails.
        st, body = post(follower.port, "/geo/promote")
        assert st == 200 and body["role"] == "leader" and body["epoch"] == 1, body
        deadline = time.monotonic() + 30
        while leader.geo.status()["role"] != "follower":
            assert time.monotonic() < deadline, "the old leader was not fenced"
            time.sleep(0.05)
        st, body = post(leader.port, "/index/i/query", "Set(7, f=1)")
        assert st == 409 and body["current"] == 1, body
        write_all(follower.port, writes(rng, 40))
        wait_equal(follower, leader)
        assert answers(leader.port) == answers(follower.port)

        # The fenced node reopens as a follower of the other package and
        # resumes from the cursor its own package checkpointed.
        old_dir = leader.data_dir
        leader.close()
        servers.remove(leader)
        with open(os.path.join(old_dir, "geo", "tail", "i", "cursor")) as f:
            cursor = json.load(f)["pos"]
        assert cursor == follower.cdc.log("i").last_pos
        write_all(follower.port, writes(rng, 40))
        again = make(follower_pkg, old_dir, role="follower",
                     leader=f"localhost:{follower.port}", backoff=0.05)
        servers.append(again)
        wait_equal(follower, again)
        assert again.geo.status()["epoch"] == 1
        assert again.geo.tailer.counters["bootstraps"] == 0
        # Exactly the records past the checkpointed cursor were applied.
        assert again.geo.tailer.counters["records_applied"] == \
            follower.cdc.log("i").last_pos - cursor > 0
        assert answers(again.port) == answers(follower.port)
    finally:
        for s in reversed(servers):
            s.close()
