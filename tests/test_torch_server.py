"""One pilosa node over HTTP: the port's server against pilosa_tpu's.

A reference Server (JAX on the CPU) and a port Server(device="cpu") get
the same HTTP script (schema, Set/Clear, SetValue, imports with and
without keys, Count/Row/TopN/Sum/Min/Max, BSI and time Range, attrs,
columnAttrs), and the JSON bodies must be equal. Then each server's data
directory (indexes/ and keys/) is reopened by the other package and the
reads answer the same. The route walk sends every route of the handler
(and the collective-exec cluster message) to both single nodes: the port
answers as the reference does, with the typed not-ported error, or with a
typed 400 where the reference answers 500, and never 500. A static
cluster (`cluster_hosts`, `replica_n`) opens; every other peer setting is
refused at Server.__init__, and so is every message that would change
the node set; a collective-exec descriptor is served. The wire codec, the
config file and the CLI match.
"""

import contextlib
import io
import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import pilosa_tpu_torch
from pilosa_tpu.parallel import EngineConfig as JEngineConfig
from pilosa_tpu.server.server import Server as JServer
from pilosa_tpu_torch.errors import QueryError
from pilosa_tpu_torch.server.server import Server as TServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def open_pair(jdir, tdir):
    """A reference and a port server; the reference engine walks serially
    (no pool threads) and is built before any test runs."""
    j = JServer(data_dir=jdir, cache_flush_interval=0, executor_workers=0,
                engine_config=JEngineConfig(gather_workers=1))
    t = TServer(data_dir=tdir, cache_flush_interval=0, executor_workers=0,
                device="cpu")
    j.open()
    t.open()
    return j, t


def request(port, method, path, body=None, headers=None):
    import http.client

    conn = http.client.HTTPConnection("localhost", port, timeout=120)
    try:
        data = body.encode() if isinstance(body, str) else body
        conn.request(method, path, body=data, headers=headers or {})
        resp = conn.getresponse()
        raw = resp.read()
    finally:
        conn.close()
    try:
        return resp.status, json.loads(raw)
    except ValueError:
        return resp.status, raw.decode(errors="replace")


SCHEMA = [
    ("POST", "/index/i", "{}"),
    ("POST", "/index/i/field/f", "{}"),
    ("POST", "/index/i/field/v", '{"options": {"type": "int", "min": -1000, "max": 1000}}'),
    ("POST", "/index/i/field/t", '{"options": {"type": "time", "timeQuantum": "YMD"}}'),
    ("POST", "/index/k", '{"options": {"keys": true}}'),
    ("POST", "/index/k/field/seg", '{"options": {"type": "set", "keys": true}}'),
]


def q(index, pql, params=""):
    return ("POST", f"/index/{index}/query{params}", pql)


def imp(index, field, body):
    return ("POST", f"/index/{index}/field/{field}/import", json.dumps(body))


def seeded_bits(seed=5, n=300):
    rng = np.random.default_rng(seed)
    rows = rng.integers(20, 26, n).tolist()
    cols = rng.integers(0, 3 * (1 << 20), n).tolist()
    return rows, cols


ROWS, COLS = seeded_bits()
WRITES = [
    q("i", "Set(1, f=10) Set(2, f=10) Set(3, f=11) Set(1048577, f=10)"),
    q("i", "Clear(2, f=10)"),
    q("i", "Clear(4, f=10)"),
    q("i", "SetValue(col=1, v=-5) SetValue(col=2, v=300) SetValue(col=1048577, v=999)"),
    q("i", "Set(5, t=1, 2018-01-05T00:00) Set(6, t=1, 2018-02-03T00:00)"),
    q("i", 'SetRowAttrs(f, 10, color="red", n=3)'),
    q("i", 'SetColumnAttrs(1, name="alice")'),
    imp("i", "f", {"rowIDs": ROWS, "columnIDs": COLS}),
    imp("i", "f", {"rowIDs": [12, 12, 13], "columnIDs": [7, 2097155, 8]}),
    imp("i", "v", {"columnIDs": [7, 8, 2097155], "values": [17, -3, 640]}),
    imp("k", "seg", {"rowKeys": ["a", "a", "b", "c"], "columnKeys": ["x", "y", "z", "x"]}),
    q("k", 'Set("w", seg="b")'),
    q("k", 'Clear("y", seg="a")'),
]
READS = [
    q("i", "Count(Row(f=10))"),
    q("i", "Row(f=10)"),
    q("i", "Row(f=12)"),
    q("i", "Row(f=10)", "?columnAttrs=true"),
    q("i", "Count(Union(Row(f=10), Row(f=11), Row(f=12)))"),
    q("i", "Count(Intersect(Row(f=20), Row(f=21)))"),
    q("i", "Difference(Union(Row(f=20), Row(f=22)), Row(f=23))"),
    q("i", "Count(Xor(Row(f=24), Row(f=25)))"),
    q("i", "TopN(f, n=3)"),
    q("i", "TopN(f, Row(f=21), n=4)"),
    q("i", "Sum(field=v)"),
    q("i", "Min(field=v)"),
    q("i", "Max(field=v)"),
    q("i", "Sum(Row(f=10), field=v)"),
    q("i", "Range(v > 0)"),
    q("i", "Count(Range(v < 100))"),
    q("i", "Range(v >< [-10, 20])"),
    q("i", "Range(t=1, 2018-01-01T00:00, 2018-03-01T00:00)"),
    q("i", "Count(Range(t=1, 2018-01-01T00:00, 2018-01-31T00:00))"),
    q("k", 'Row(seg="a")'),
    q("k", 'Count(Row(seg="b"))'),
    q("k", "TopN(seg, n=5)"),
    q("k", 'Count(Union(Row(seg="a"), Row(seg="c")))'),
    ("GET", "/index/i", None),
    ("GET", "/export?index=i&field=f&shard=0", None),
    ("GET", "/schema", None),
]
SCRIPT = SCHEMA + WRITES + READS


def step_id(step):
    method, path, body = step
    return f"{method} {path} {body or ''}"[:90]


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """The script on both servers, then the read steps on each data
    directory reopened by the other package. Every server is closed
    before the tests read the answers."""
    base = tmp_path_factory.mktemp("parity")
    jdir, tdir = str(base / "jax"), str(base / "torch")
    j, t = open_pair(jdir, tdir)
    try:
        answers = {step_id(s): (request(j.port, *s), request(t.port, *s)) for s in SCRIPT}
    finally:
        t.close()
        j.close()
    # Swapped: the port opens the reference's directory and vice versa.
    j2, t2 = open_pair(tdir, jdir)
    try:
        swapped = {step_id(s): (request(j2.port, *s), request(t2.port, *s)) for s in READS}
    finally:
        t2.close()
        j2.close()
    return answers, swapped


@pytest.mark.parametrize("step", SCRIPT, ids=step_id)
def test_http_script_answers_like_jax(parity, step):
    (jstatus, jbody), (tstatus, tbody) = parity[0][step_id(step)]
    assert jstatus == 200, jbody
    assert (tstatus, tbody) == (jstatus, jbody)


@pytest.mark.parametrize("step", READS, ids=step_id)
def test_data_directory_reopens_in_the_other_package(parity, step):
    """Each package reads the other's data directory (indexes/ and keys/)
    and answers what the writer answered."""
    first = parity[0][step_id(step)][0]
    (jstatus, jbody), (tstatus, tbody) = parity[1][step_id(step)]
    assert (jstatus, jbody) == first  # the reference on the port's directory
    assert (tstatus, tbody) == first  # the port on the reference's directory


# ------------------------------------------------------------ route walk

ROUTES = [
    ("GET", "/", None), ("GET", "/index", None), ("GET", "/index/i", None),
    ("POST", "/index/j", "{}"), ("POST", "/index/j/field/g", "{}"),
    ("POST", "/index/i/field/f/import", '{"rowIDs": [1], "columnIDs": [5]}'),
    ("POST", "/index/i/query", "Count(Row(f=1))"),
    ("GET", "/export?index=i&field=f&shard=0", None),
    ("GET", "/schema", None), ("GET", "/status", None), ("GET", "/info", None),
    ("GET", "/version", None), ("POST", "/recalculate-caches", ""),
    ("POST", "/cluster/resize/abort", ""),
    ("POST", "/internal/cluster/message", '{"type": "recalculate-caches"}'),
    ("POST", "/internal/collective/count", '{"index": "i", "field": "f", "rows": [1]}'),
    ("GET", "/internal/fragment/blocks?index=i&field=f&view=standard&shard=0", None),
    ("GET", "/internal/fragment/block/data?index=i&field=f&view=standard&shard=0&block=0",
     None),
    ("POST", "/internal/fragment/block/data?index=i&field=f&view=standard&shard=0",
     '{"sets": [[1, 9]], "clears": []}'),
    ("GET", "/internal/fragment/nodes?index=i&shard=0", None),
    ("GET", "/internal/fragment/data?index=i&field=f&view=standard&shard=0", None),
    ("POST", "/internal/fragment/data?index=i&field=f&view=standard&shard=9", ""),
    ("POST", "/internal/migrate/begin",
     '{"index": "i", "field": "f", "view": "standard", "shard": 0}'),
    ("POST", "/internal/migrate/delta", '{"session": "nosuch"}'),
    ("POST", "/internal/migrate/freeze", '{"index": "i", "shard": 0}'),
    ("POST", "/internal/migrate/close", '{"sessions": []}'),
    ("GET", "/internal/shards/max", None), ("GET", "/internal/translate/data?offset=0", None),
    ("POST", "/internal/index/i/attr/diff", '{"blocks": []}'),
    ("POST", "/internal/index/i/field/f/attr/diff", '{"blocks": []}'),
    ("POST", "/internal/fragment/hints?index=i&field=f&view=standard&shard=0", ""),
    ("GET", "/cdc/stream?index=i", None), ("GET", "/cdc/bootstrap?index=i", None),
    ("POST", "/cdc/standing", "{}"), ("GET", "/cdc/standing", None),
    ("GET", "/cdc/standing/x/poll", None), ("DELETE", "/cdc/standing/x", None),
    ("POST", "/geo/promote", ""), ("POST", "/geo/demote", ""), ("GET", "/geo/status", None),
    ("GET", "/debug/vars", None), ("GET", "/debug/traces", None), ("GET", "/metrics", None),
    ("POST", "/debug/profile?seconds=0", ""), ("GET", "/debug/threads", None),
    ("GET", "/internal/diagnostics", None),
    ("POST", "/cluster/resize/set-coordinator", '{"id": "nosuch"}'),
    ("POST", "/cluster/resize/remove-node", '{"id": "nosuch"}'),
    ("DELETE", "/index/j/field/g", None), ("DELETE", "/index/j", None),
]


# Cluster message types walked beside the routes: both nodes answer. A
# collective-exec message without a seq is malformed: the reference's
# runner raises KeyError on it (a 500), the port refuses it at receipt
# with a typed 400.
MESSAGES = [
    ("POST", "/internal/cluster/message", '{"type": "collective-exec"}'),
]


@pytest.fixture(scope="module")
def walked(tmp_path_factory):
    base = tmp_path_factory.mktemp("walk")
    j, t = open_pair(str(base / "jax"), str(base / "torch"))
    try:
        for s in SCHEMA[:2] + [q("i", "Set(5, f=1)")]:
            request(j.port, *s)
            request(t.port, *s)
        return {step_id(r): (request(j.port, *r), request(t.port, *r))
                for r in ROUTES + MESSAGES}
    finally:
        t.close()
        j.close()


def test_route_walk_covers_the_handler():
    """One walked request per entry of the handler's route table."""
    src = open(os.path.join(ROOT, "pilosa_tpu_torch", "server", "handler.py")).read()
    assert src.count("            Route(") == len(ROUTES)


@pytest.mark.parametrize("route", ROUTES + MESSAGES, ids=step_id)
def test_route_answers_like_the_reference_node(walked, route):
    (jstatus, jbody), (tstatus, tbody) = walked[step_id(route)]
    assert tstatus != 500, tbody
    if tstatus != jstatus and jstatus == 500:
        # The reference faults where the port answers a typed error.
        assert tstatus == 400 and tbody["error"], (jstatus, jbody, tbody)
    elif tstatus != jstatus:
        assert tstatus == 400 and "not ported" in tbody["error"], (jstatus, jbody, tbody)


# ------------------------------------------------ refused and lifted settings


@pytest.mark.parametrize("kw", [
    {"join_addr": "localhost:1"},
    {"primary_translate_store_url": "localhost:1"},
    {"cdc_config": "enabled"},
    {"geo_config": "follower"},
    {"transport_config": "enabled"},
    {"autoscale_config": "interval"},
    {"engine_config": "mesh"},
], ids=lambda kw: next(iter(kw)))
def test_peer_settings_are_refused(tmp_path, kw):
    """An engine mesh (by design) raises the typed not-ported error naming
    the setting. Every other peer setting is lifted: the server builds and
    the setting does what it does on pilosa_tpu (a joining node is
    admitted by its seed, a replica opens its key store read-only, a Set
    gets CDC position 1, a follower builds its geo manager and tailer, the
    mux transport is installed on the shared client, the autoscaler takes
    the interval)."""
    from pilosa_tpu_torch.cdc import CdcConfig
    from pilosa_tpu_torch.cluster.autoscale import AutoscaleConfig
    from pilosa_tpu_torch.geo import GeoConfig
    from pilosa_tpu_torch.parallel import EngineConfig
    from pilosa_tpu_torch.server.mux import TransportConfig

    made = {"cdc_config": lambda: CdcConfig(enabled=True, standing_interval=0),
            "geo_config": lambda: GeoConfig(role="follower", leader="localhost:1"),
            "transport_config": lambda: TransportConfig(enabled=True),
            "autoscale_config": lambda: AutoscaleConfig(interval=5.0),
            "engine_config": lambda: EngineConfig(mesh_devices=2)}
    (name, value), = kw.items()
    if name in made:
        value = made[name]()
    if name == "join_addr":
        seed = TServer(data_dir=str(tmp_path / "seed"), port=free_port(),
                       device="cpu", cache_flush_interval=0,
                       member_monitor_interval=0).open()
        try:
            port = free_port()
            node = TServer(data_dir=str(tmp_path / "n"), port=port,
                           device="cpu", cache_flush_interval=0,
                           member_monitor_interval=0,
                           join_addr=f"localhost:{seed.port}").open()
            try:
                assert sorted(n.id for n in seed.cluster.nodes) == sorted(
                    [seed.node.id, f"localhost:{port}"])
                assert sorted(n.id for n in node.cluster.nodes) == sorted(
                    n.id for n in seed.cluster.nodes)
            finally:
                node.close()
        finally:
            seed.close()
        return
    if name == "primary_translate_store_url":
        s = TServer(data_dir=str(tmp_path / "r"), port=1, device="cpu",
                    primary_translate_store_url=value)
        assert s.translate_store.read_only
        s.close()
        return
    if name == "cdc_config":
        s = TServer(data_dir=str(tmp_path / "c"), device="cpu",
                    cache_flush_interval=0, cdc_config=value)
        s.holder.open()
        try:
            s.api.create_index("i")
            s.api.create_field("i", "f")
            s.api.query("i", "Set(5, f=1)")
            assert s.cdc.log("i").last_pos == 1
        finally:
            s.cdc.close()
            s.holder.close()
        return
    if name != "engine_config":
        s = TServer(data_dir=str(tmp_path / "g"), port=1, device="cpu",
                    cache_flush_interval=0, **{name: value})
        try:
            if name == "geo_config":
                assert s.geo is not None and s.executor.geo is s.geo
                assert s.geo.status()["role"] == "follower"
            elif name == "transport_config":
                assert s.client.mux is s.mux_transport is not None
                assert s.mux_server is not None
            else:
                assert s.autoscaler.config.interval == 5.0
        finally:
            s.close()
        return
    with pytest.raises(QueryError, match=f"not ported.*|{name}") as ei:
        TServer(data_dir=None, port=1, device="cpu", **{name: value})
    assert "not ported" in str(ei.value) and name in str(ei.value)


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("setting", ["cluster_hosts", "replica_n"])
def test_cluster_settings_are_accepted(setting):
    """A static cluster of two port nodes opens and answers a Count that
    crosses them: `cluster_hosts` alone places each shard on one node,
    with `replica_n = 2` on both."""
    from pilosa_tpu_torch.cluster.hash import ModHasher
    from pilosa_tpu_torch.constants import SHARD_WIDTH

    ports = [free_port() for _ in range(2)]
    hosts = [f"localhost:{p}" for p in ports]
    replica_n = 2 if setting == "replica_n" else 1
    servers = [TServer(data_dir=None, port=p, cluster_hosts=hosts,
                       replica_n=replica_n, hasher=ModHasher(),
                       cache_flush_interval=0, anti_entropy_interval=0,
                       member_monitor_interval=0, executor_workers=0,
                       device="cpu").open() for p in ports]
    try:
        assert request(ports[0], "POST", "/index/i", "{}")[0] == 200
        assert request(ports[0], "POST", "/index/i/field/f", "{}")[0] == 200
        cols = [3, SHARD_WIDTH + 4, 2 * SHARD_WIDTH + 5]
        for col in cols:
            assert request(ports[0], "POST", "/index/i/query", f"Set({col}, f=1)")[0] == 200
        holds = [{s for s in range(3) if srv.holder.fragment("i", "f", "standard", s)
                  is not None and srv.holder.fragment("i", "f", "standard", s).bit(1, cols[s])}
                 for srv in servers]
        owned = [{s for s in range(3) if any(
            n.id == srv.node.id for n in srv.cluster.shard_nodes("i", s))}
            for srv in servers]
        assert holds == owned
        if replica_n == 2:
            assert owned == [{0, 1, 2}] * 2
        else:
            assert sorted(owned, key=len) == [{1}, {0, 2}]
        for port in ports:
            assert request(port, "POST", "/index/i/query", "Count(Row(f=1))") == (
                200, {"results": [3]})
    finally:
        for srv in servers:
            srv.close()


@pytest.mark.parametrize("msg", [
    {"type": "node-join", "node": {"id": "localhost:1", "uri": "localhost:1"}},
    {"type": "node-leave", "nodeID": "localhost:1"},
    {"type": "cluster-status", "state": "NORMAL",
     "nodes": [{"id": "localhost:1", "uri": "localhost:1"}]},
    {"type": "rebalance-begin"},
    {"type": "resize-instruction", "jobID": "j1", "sources": [],
     "coordinatorID": "<self>"},
    {"type": "collective-exec", "seq": 1, "kind": "count", "index": "i",
     "queries": ["Row(f=1)"], "slots": [[0]], "k": 1, "processes": 1,
     "timeoutMs": 1000, "epoch": 0},
], ids=lambda m: m["type"])
def test_membership_and_collective_messages_are_refused(tmp_path, msg):
    """The membership messages apply as they do on a pilosa_tpu node
    holding the same data: the same status, the same membership (this
    node plus or minus the named one), the same state, and the same
    answer (or error) to the next Count. A collective-exec descriptor is
    served as the reference serves it: the peer side enqueues it for its
    runner (200)."""
    if msg["type"] == "collective-exec":
        s = TServer(data_dir=str(tmp_path / "d"), device="cpu", cache_flush_interval=0)
        s.open()
        try:
            request(s.port, "POST", "/index/i", "{}")
            request(s.port, "POST", "/index/i/field/f", "{}")
            request(s.port, "POST", "/index/i/query", "Set(5, f=1)")
            status, body = request(s.port, "POST", "/internal/cluster/message",
                                   json.dumps(msg))
            assert status == 200, (status, body)
            assert [n.id for n in s.cluster.nodes] == [s.node.id]
            assert request(s.port, "POST", "/index/i/query", "Count(Row(f=1))") == (
                200, {"results": [1]})
        finally:
            s.close()
        return
    seen = []
    for name, S, kw in (("jax", JServer, {}), ("torch", TServer, {"device": "cpu"})):
        s = S(data_dir=str(tmp_path / name), cache_flush_interval=0,
              member_monitor_interval=0, **kw)
        s.open()
        try:
            request(s.port, "POST", "/index/i", "{}")
            request(s.port, "POST", "/index/i/field/f", "{}")
            request(s.port, "POST", "/index/i/query", "Set(5, f=1)")
            body = json.dumps(msg).replace("<self>", s.node.id)
            status, _ = request(s.port, "POST", "/internal/cluster/message", body)
            nodes = sorted("self" if n.id == s.node.id else n.id
                           for n in s.cluster.nodes)
            seen.append((status, nodes, s.cluster.state, request(
                s.port, "POST", "/index/i/query", "Count(Row(f=1))")))
        finally:
            s.close()
    assert seen[0] == seen[1], seen
    assert seen[1][0] == 200


def test_own_cluster_status_is_accepted(tmp_path):
    """A cluster-status naming exactly the configured nodes applies."""
    s = TServer(data_dir=str(tmp_path / "d"), device="cpu", cache_flush_interval=0)
    s.open()
    try:
        msg = {"type": "cluster-status", "state": "NORMAL",
               "nodes": [s.node.to_dict()]}
        status, _ = request(s.port, "POST", "/internal/cluster/message", json.dumps(msg))
        assert status == 200 and [n.id for n in s.cluster.nodes] == [s.node.id]
    finally:
        s.close()


def test_own_host_in_cluster_hosts_is_allowed():
    s = TServer(data_dir=None, port=4321, device="cpu",
                cluster_hosts=["localhost:4321"])
    s.close()


def test_building_a_server_opens_no_engine(tmp_path):
    s = TServer(data_dir=str(tmp_path / "d"), device="cpu", cache_flush_interval=0)
    s.open()
    try:
        status, _ = request(s.port, "GET", "/status")
        assert status == 200 and s.executor._engine is None
        # The collective backend is built at open, off the plane on one
        # process without `[collective] single-process`.
        assert s.executor.collective is s.collective
        assert not s.collective.active()
    finally:
        s.close()


def test_delta_journal_ops_reaches_the_holder():
    from pilosa_tpu_torch.parallel import EngineConfig

    s = TServer(data_dir=None, device="cpu",
                engine_config=EngineConfig(delta_journal_ops=17))
    try:
        assert s.holder.delta_journal_ops == 17
    finally:
        s.close()


# ------------------------------------------------------ wire, config, CLI


def wire_results(pkg):
    row = pkg.core.row.Row(columns=[1, 5, 9, (1 << 20) + 3])
    dense = pkg.core.row.Row(columns=list(range(0, 1 << 20, 3)))
    dense.attrs = {"k": "v"}
    pairs = [pkg.core.cache.Pair(id=3, count=9), pkg.core.cache.Pair(id=4, count=2, key="x")]
    return [row, dense, pkg.executor.ValCount(7, 2), pairs, True, 42, None]


def test_wire_bytes_equal_the_reference():
    import pilosa_tpu
    import pilosa_tpu.core.cache  # noqa: F401
    import pilosa_tpu.core.row  # noqa: F401
    import pilosa_tpu_torch.core.cache  # noqa: F401
    import pilosa_tpu_torch.core.row  # noqa: F401
    from pilosa_tpu.server import wire as jwire
    from pilosa_tpu_torch.server import wire as twire

    data = twire.encode_results(wire_results(pilosa_tpu_torch))
    assert data == jwire.encode_results(wire_results(pilosa_tpu))
    out = twire.decode_results(data, device="cpu")
    assert out[0].columns().tolist() == [1, 5, 9, (1 << 20) + 3]
    assert out[1].count() == len(range(0, 1 << 20, 3)) and out[1].attrs == {"k": "v"}
    assert out[1].segments[0].device == torch.device("cpu")
    assert (out[2].val, out[2].count) == (7, 2)
    assert [p.to_dict() for p in out[3]] == [{"id": 3, "count": 9},
                                             {"id": 4, "count": 2, "key": "x"}]
    assert out[4:] == [True, 42, None]


TOML = """
data-dir = "/srv/pilosa"
bind = "localhost:10111"
[engine]
gather-workers = 1
delta-journal-ops = 999
[scheduler]
batch-window = 0.001
batch-max = 32
[qos]
rate = 5.0
[tier]
host-bytes = 1048576
"""


def test_config_file_loads_the_same_in_both_packages(tmp_path):
    from pilosa_tpu.config import Config as JConfig
    from pilosa_tpu_torch.config import Config as TConfig

    path = tmp_path / "c.toml"
    path.write_text(TOML)
    j, t = JConfig.load(str(path)), TConfig.load(str(path))
    assert t.to_toml() == j.to_toml()
    assert t.engine.delta_journal_ops == 999 and t.scheduler.batch_max == 32
    # With no file the defaults differ only where the port chose to:
    # gather-workers (1, serial, against the reference's 0 = auto).
    diff = [(a, b) for a, b in zip(JConfig().to_toml().splitlines(),
                                   TConfig().to_toml().splitlines()) if a != b]
    assert diff == [("gather-workers = 0", "gather-workers = 1")]


def run_cli(module_main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = module_main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("argv", [["generate-config"], ["config", "--bind", "localhost:1"]],
                         ids=["generate-config", "config"])
def test_cli_config_commands_match(argv):
    from pilosa_tpu import cli as jcli
    from pilosa_tpu_torch import cli as tcli

    (jrc, jout), (trc, tout) = run_cli(jcli.main, argv), run_cli(tcli.main, argv)
    assert jrc == trc == 0
    assert [x for x in zip(jout.splitlines(), tout.splitlines()) if x[0] != x[1]] == [
        ("gather-workers = 0", "gather-workers = 1")]


def test_cli_server_getting_started_flow(tmp_path):
    """`python -m pilosa_tpu_torch.cli server --device cpu`: the README's
    flow, a keyed Set, SIGTERM and a relaunch that keeps counts and keys."""
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, JAX_PLATFORMS="cpu")

    def launch():
        proc = subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "--data-dir",
             str(tmp_path / "d"), "--bind", f"localhost:{port}", "--device", "cpu"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            if "listening on" in line:
                assert line.startswith("pilosa-tpu server listening on"), line
                return proc
        proc.wait(timeout=30)
        raise AssertionError("server did not start")

    proc = launch()
    try:
        for step in (("POST", "/index/repository", "{}"),
                     ("POST", "/index/repository/field/stargazer", "{}"),
                     ("POST", "/index/users", '{"options": {"keys": true}}'),
                     ("POST", "/index/users/field/seg", '{"options": {"keys": true}}')):
            assert request(port, *step)[0] == 200
        for col in (1, 2, 3):
            assert request(port, *q("repository", f"Set({col}, stargazer=10)"))[1] == {
                "results": [True]}
        assert request(port, *q("users", 'Set("ann", seg="fans") Set("bo", seg="fans")'))[0] == 200
        assert request(port, *q("repository", "Count(Row(stargazer=10))"))[1] == {"results": [3]}
        assert request(port, *q("repository", "TopN(stargazer, n=1)"))[1] == {
            "results": [[{"id": 10, "count": 3}]]}
        status, dv = request(port, "GET", "/debug/vars")
        assert status == 200 and dv["engine_cache"]["count_dispatches"] > 0
        before = request(port, *q("users", 'Row(seg="fans")'))[1]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        proc = launch()
        assert request(port, *q("repository", "Count(Row(stargazer=10))"))[1] == {"results": [3]}
        after = request(port, *q("users", 'Row(seg="fans")'))[1]
        assert after == before and sorted(after["results"][0]["keys"]) == ["ann", "bo"]
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)


def test_cli_cluster_of_two_nodes(tmp_path):
    """`--cluster-hosts` and `--cluster-replicas` reach the server: two
    CLI nodes form one cluster, a write through one lands on both
    replicas, and each answers a Count over shards that cross them."""
    ports = [free_port() for _ in range(2)]
    hosts = ",".join(f"localhost:{p}" for p in ports)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = []
    try:
        for p in ports:
            proc = subprocess.Popen(
                [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "--data-dir",
                 str(tmp_path / f"n{p}"), "--bind", f"localhost:{p}", "--cluster-hosts",
                 hosts, "--cluster-replicas", "2", "--device", "cpu"],
                cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
            procs.append(proc)
            for line in proc.stdout:
                if "listening on" in line:
                    break
            else:
                raise AssertionError("server did not start")
        for p in ports:
            status, st = request(p, "GET", "/status")
            assert status == 200 and sorted(n["id"] for n in st["nodes"]) == sorted(
                f"localhost:{x}" for x in ports), st
        assert request(ports[0], "POST", "/index/i", "{}")[0] == 200
        assert request(ports[0], "POST", "/index/i/field/f", "{}")[0] == 200
        assert request(ports[0], *q("i", "Set(1, f=3) Set(2097153, f=3)"))[0] == 200
        for p in ports:
            assert request(p, *q("i", "Count(Row(f=3))")) == (200, {"results": [2]})
            status, got = request(p, "POST", "/index/i/query?remote=true",
                                  '{"query": "Count(Row(f=3))", "shards": [0, 2]}')
            assert status == 200 and got["results"][0]["value"] == 2, got
    finally:
        for proc in procs:
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=60)


def test_cdc_rebalance_and_translation_settings_reach_the_server(tmp_path):
    """The `[cdc]`, `[rebalance]` and `[translation]` settings of a config
    (flags here, as the CLI passes them) build a port server with change
    capture on, the rebalance knobs set and a read-only key store, as the
    same config builds a pilosa_tpu server."""
    from pilosa_tpu.config import Config as JConfig
    from pilosa_tpu_torch.config import Config

    flags = {"data_dir": str(tmp_path / "d"), "cdc_enabled": 1, "cdc_pit_cache": 5,
             "rebalance_cutover_pause_max": 1.5, "rebalance_max_concurrent_streams": 3,
             "translation_primary_url": "localhost:1"}
    built = []
    for cfg, kw in ((JConfig.load(flags=flags), {}),
                    (Config.load(flags=flags), {"device": "cpu"})):
        s = cfg.build_server(**kw)
        try:
            built.append((s.cdc is not None, s.cdc_config.pit_cache,
                          s.rebalance_config.cutover_pause_max,
                          s.rebalance_config.max_concurrent_streams,
                          s.executor.cutover_wait, s.translate_store.read_only))
        finally:
            s.cdc.close()
    assert built[1] == built[0] == (True, 5, 1.5, 3, 1.5, True)


def test_bind_to_a_taken_port_raises_oserror():
    """A listener whose bind fails raises the bind's OSError: the stdlib
    calls server_close() from inside the failed constructor, and that
    close must not fault on state the constructor never set."""
    from http.server import BaseHTTPRequestHandler

    from pilosa_tpu_torch.server.handler import _Server

    taken = socket.socket()
    taken.bind(("localhost", 0))
    taken.listen(1)
    try:
        with pytest.raises(OSError) as ei:
            _Server(("localhost", taken.getsockname()[1]), BaseHTTPRequestHandler)
        assert not isinstance(ei.value, AttributeError)
        # A free port still binds and closes.
        ok = _Server(("localhost", 0), BaseHTTPRequestHandler)
        ok.server_close()
    finally:
        taken.close()
