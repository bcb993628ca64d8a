"""The port's collective plane against pilosa_tpu's on the same seeded
data: answers must be exactly equal (tolerance 0).

1. The port's CollectiveBackend at world size 1 against pilosa_tpu's
   one-process backend (the reference tests' `_pod` pattern, JAX on the
   CPU's 8-device test mesh): count_batch over set-op trees including a
   Difference and a Range(v != x) (zero padding must not add to a
   count), topn_counts with and without a source, and bsi_val_count for
   sum, min and max with, without and with an empty filter.
2. The same backends with the mesh width set to N = 2, 3 (5 shards
   padded to 6) and 8: the reference on N devices of its CPU mesh, the
   port on N partitions of the CPU; equal descriptors' k, Counts,
   count_batch with duplicates, TopN with and without a filter and
   Sum/Min/Max with the maximum tied across partitions, each kernel
   called once per partition.
3. A two-rank port job (two Server processes over gloo, each rank
   counting only the shards its placement gives it) against one
   pilosa_tpu node holding all the data, through Executor.execute:
   Counts, TopN, Sum/Min/Max, with the maximum of v planted in every
   shard so that Max is tied across the ranks — the collective rung
   counts every column that holds it, as one node does. Once with one
   partition per rank, once with `[engine] mesh-devices 2` per rank.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest

from pilosa_tpu.cluster.node import Cluster as JCluster, Node as JNode
from pilosa_tpu.core.field import FieldOptions as JFieldOptions
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.executor import Executor as JExecutor
from pilosa_tpu.logger import NopLogger as JNopLogger
from pilosa_tpu.parallel import CollectiveConfig as JCollectiveConfig
from pilosa_tpu.parallel.collective import CollectiveBackend as JBackend
from pilosa_tpu.pql.parser import parse as jparse
from pilosa_tpu_torch.cluster.node import Cluster, Node
from pilosa_tpu_torch.constants import SHARD_WIDTH
from pilosa_tpu_torch.core.field import FieldOptions
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.logger import NopLogger
from pilosa_tpu_torch.parallel import CollectiveConfig
from pilosa_tpu_torch.parallel.collective import CollectiveBackend
from pilosa_tpu_torch.pql.parser import parse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SHARDS = 5  # not a multiple of the JAX test mesh's 8 devices: k pads
N_ROWS = 6
V_MIN, V_MAX = -20, 300
V_TOP = V_MAX  # planted in every shard: Max ties across shards and ranks


def seeded_data(n_shards=N_SHARDS, seed=23):
    """(rows, cols) bits of f and {col: value} of v, from numpy's seed."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for row in range(1, N_ROWS + 1):
        for s in range(n_shards):
            local = np.flatnonzero(rng.random(4096) < 0.05 * row)
            rows.extend([row] * len(local))
            cols.extend(int(s * SHARD_WIDTH + c) for c in local)
    vals = {}
    for s in range(n_shards):
        for c in rng.choice(4096, 300, replace=False):
            vals[int(s * SHARD_WIDTH + c)] = int(rng.integers(V_MIN, V_MAX))
        vals[s * SHARD_WIDTH + 4095] = V_TOP
    return rows, cols, vals


def fill(holder, field_options, data):
    rows, cols, vals = data
    idx = holder.create_index_if_not_exists("ci")
    idx.create_field_if_not_exists("f")
    idx.field("f").import_bits(rows, cols)
    idx.create_field_if_not_exists(
        "v", field_options(type="int", min=V_MIN, max=V_MAX))
    for col, val in vals.items():
        idx.field("v").set_value(col, val)
    return idx


@pytest.fixture(scope="module")
def pods():
    """(JAX backend, port backend) over holders filled with the same
    seeded data, each a one-process, one-node pod."""
    data = seeded_data()
    jh = JHolder(None)
    jh.open()
    fill(jh, JFieldOptions, data)
    th = Holder(None, device="cpu")
    th.open()
    fill(th, FieldOptions, data)
    jnode = JNode(id="n0", process_idx=0)
    jb = JBackend(SimpleNamespace(
        holder=jh, logger=JNopLogger(), client=None,
        cluster=JCluster(node=jnode, nodes=[jnode], replica_n=1)),
        JCollectiveConfig(single_process=1))
    tnode = Node(id="n0", process_idx=0)
    tb = CollectiveBackend(SimpleNamespace(
        holder=th, logger=NopLogger(), client=None,
        cluster=Cluster(node=tnode, nodes=[tnode], replica_n=1)),
        CollectiveConfig(single_process=1))
    yield jb, tb, jh
    tb.close()
    jb.close()
    th.close()
    jh.close()


def both(query):
    return jparse(query).calls[0].children[0], parse(query).calls[0].children[0]


# One batch shares one canonical signature (the descriptor carries it):
# the rows vary, a Range's predicate does not, and no tree names a row
# twice.
BATCHES = {
    "intersect": "Count(Intersect(Row(f={a}), Row(f={b})))",
    "difference": "Count(Difference(Row(f={a}), Row(f={b})))",
    "union-xor": "Count(Union(Row(f={a}), Xor(Row(f={b}), Row(f=3))))",
    "range-neq": "Count(Range(v != 7))",
    "difference-range": "Count(Difference(Row(f={a}), Range(v != 7)))",
    "intersect-range": "Count(Intersect(Row(f={b}), Range(v < 150)))",
    "between": "Count(Intersect(Row(f={a}), Range(-20 < v < 250)))",
}


@pytest.mark.parametrize("shape", sorted(BATCHES))
def test_count_batch_equals_the_reference(pods, shape):
    jb, tb, _ = pods
    args = [dict(a=a, b=b) for a, b in [(1, 2), (2, 5), (6, 4), (1, 2), (5, 4)]]
    pairs = [both(BATCHES[shape].format(**kw)) for kw in args]
    want = jb.count_batch("ci", [j for j, _ in pairs])
    got = tb.count_batch("ci", [t for _, t in pairs])
    assert got == want
    assert tb.count("ci", pairs[0][1]) == jb.count("ci", pairs[0][0])


@pytest.mark.parametrize("src", [None, "Count(Row(f=2))",
                                 "Count(Difference(Row(f=3), Range(v != 7)))"],
                         ids=["no-source", "row-source", "range-source"])
def test_topn_counts_equal_the_reference(pods, src):
    jb, tb, _ = pods
    rows = [6, 1, 3, 2, 9]  # 9 is empty everywhere
    jsrc, tsrc = both(src) if src else (None, None)
    want = jb.topn_counts("ci", "f", rows, jsrc)
    got = tb.topn_counts("ci", "f", rows, tsrc)
    assert got.dtype == np.int64
    assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("flt", [None, "Count(Row(f=4))", "Count(Row(f=99))"],
                         ids=["no-filter", "filter", "empty-filter"])
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_bsi_val_count_equals_the_reference(pods, kind, flt):
    jb, tb, jh = pods
    depth = jh.index("ci").field("v").bsi_group("v").bit_depth()
    jf, tf = both(flt) if flt else (None, None)
    want = jb.bsi_val_count("ci", "v", kind, depth, jf)
    got = tb.bsi_val_count("ci", "v", kind, depth, tf)
    if kind == "sum":
        assert got.tolist() == np.asarray(want).tolist()
    else:
        assert (got[0].tolist(), got[1]) == (np.asarray(want[0]).tolist(), want[1])
        if flt is None and kind == "max":
            assert got[1] == N_SHARDS  # V_TOP in every shard


# ----------------------- one process over N partitions vs the N-device mesh


@pytest.fixture(params=[2, 3, 8], ids=lambda n: f"N{n}")
def mesh_pods(pods, request):
    """The pods with both backends' mesh width set to N: the reference's
    on N devices of its CPU test mesh, the port's on N partitions of the
    CPU. 5 shards pad to k = 6 at N = 2 and 3, and to 8 at N = 8."""
    jb, tb, jh = pods
    jb.mesh_devices = tb.mesh_devices = request.param
    yield jb, tb, jh, request.param
    jb.mesh_devices = tb.mesh_devices = None


def test_descriptors_k_equal_across_packages(mesh_pods):
    jb, tb, _, n = mesh_pods
    c = both("Count(Row(f=1))")
    jd = jb._descriptor("count", "ci", queries=[str(c[0])])
    td = tb._descriptor("count", "ci", queries=[str(c[1])])
    assert td["k"] == jd["k"] == -(-N_SHARDS // n) * n
    assert td["meshDevices"] == jd["meshDevices"] == n
    assert td["dLocal"] == n


def test_mesh_counts_equal_the_reference(mesh_pods):
    """Count, and count_batch with duplicates, over N partitions: K1 once
    per partition per entry (the plain twin's calls, on the CPU)."""
    from pilosa_tpu_torch.ops import kernels

    jb, tb, _, n = mesh_pods
    args = [(1, 2), (2, 5), (6, 4), (1, 2), (5, 4), (1, 2)]
    pairs = [both(BATCHES["intersect"].format(a=a, b=b)) for a, b in args]
    before = kernels.PLAIN_CALLS["gather_expr_count"]
    got = tb.count_batch("ci", [t for _, t in pairs])
    assert kernels.PLAIN_CALLS["gather_expr_count"] - before == n
    assert got == jb.count_batch("ci", [j for j, _ in pairs])
    for shape in ("difference-range", "between"):
        j, t = both(BATCHES[shape].format(a=3, b=5))
        assert tb.count("ci", t) == jb.count("ci", j)


@pytest.mark.parametrize("src", [None, "Count(Row(f=2))"], ids=["no-filter", "filter"])
def test_mesh_topn_equals_the_reference(mesh_pods, src):
    from pilosa_tpu_torch.ops import kernels

    jb, tb, _, n = mesh_pods
    rows = [6, 1, 3, 2, 9]
    jsrc, tsrc = both(src) if src else (None, None)
    before = kernels.PLAIN_CALLS["masked_plane_counts"]
    got = tb.topn_counts("ci", "f", rows, tsrc)
    assert kernels.PLAIN_CALLS["masked_plane_counts"] - before == n
    assert got.tolist() == np.asarray(jb.topn_counts("ci", "f", rows, jsrc)).tolist()


@pytest.mark.parametrize("flt", [None, "Count(Row(f=4))"], ids=["no-filter", "filter"])
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_mesh_bsi_val_count_equals_the_reference(mesh_pods, kind, flt):
    """Sum, Min and Max over N partitions; V_TOP sits in every shard, so
    the maximum ties across partitions and every holder counts."""
    from pilosa_tpu_torch.ops import kernels

    jb, tb, jh, n = mesh_pods
    depth = jh.index("ci").field("v").bsi_group("v").bit_depth()
    jf, tf = both(flt) if flt else (None, None)
    name = "masked_plane_counts" if kind == "sum" else "bsi_minmax"
    before = kernels.PLAIN_CALLS[name]
    got = tb.bsi_val_count("ci", "v", kind, depth, tf)
    assert kernels.PLAIN_CALLS[name] - before == n
    want = jb.bsi_val_count("ci", "v", kind, depth, jf)
    if kind == "sum":
        assert got.tolist() == np.asarray(want).tolist()
    else:
        assert (got[0].tolist(), got[1]) == (np.asarray(want[0]).tolist(), want[1])
        if flt is None and kind == "max":
            assert got[1] == N_SHARDS


# ------------------------------------- a two-rank port job vs one JAX node

QUERIES = [
    "Count(Intersect(Row(f=1), Row(f=2)))",
    "Count(Difference(Row(f=5), Row(f=2)))",
    "Count(Union(Row(f=3), Xor(Row(f=4), Row(f=6))))",
    "Count(Range(v != 17))",
    "Count(Intersect(Row(f=6), Range(v > 100)))",
    "TopN(f, n=3)",
    "TopN(f, Row(f=2), n=4)",
    "Sum(field=v)", "Sum(Row(f=3), field=v)",
    "Min(field=v)", "Min(Row(f=5), field=v)",
    "Max(field=v)", "Max(Row(f=6), field=v)", "Max(Row(f=99), field=v)",
]


def plain(result):
    """An executor result as JSON-comparable data."""
    if hasattr(result, "val") and hasattr(result, "count"):
        return ["valcount", int(result.val), int(result.count)]
    if isinstance(result, list):
        return [[int(p.id), int(p.count)] for p in result]
    return int(result)


JOB_WORKER = textwrap.dedent("""
    import json, os, sys, time
    import urllib.request

    import numpy as np

    coord, pid, port0, port1, tmp = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
        sys.argv[5])
    os.environ["PILOSA_JAX_COORDINATOR"] = coord
    os.environ["PILOSA_JAX_NUM_PROCESSES"] = "2"
    os.environ["PILOSA_JAX_PROCESS_ID"] = str(pid)

    from pilosa_tpu_torch.core.field import FieldOptions
    from pilosa_tpu_torch.ops import kernels
    from pilosa_tpu_torch.parallel import EngineConfig
    from pilosa_tpu_torch.pql.parser import parse
    from pilosa_tpu_torch.server.server import Server

    job = json.load(open(f"{tmp}/job.json"))
    data = np.load(f"{tmp}/data.npz")

    def plain(result):
        if hasattr(result, "val") and hasattr(result, "count"):
            return ["valcount", int(result.val), int(result.count)]
        if isinstance(result, list):
            return [[int(p.id), int(p.count)] for p in result]
        return int(result)

    hosts = [f"localhost:{port0}", f"localhost:{port1}"]
    s = Server(data_dir=None, port=[port0, port1][pid], cluster_hosts=hosts,
               replica_n=1, cache_flush_interval=0, anti_entropy_interval=0,
               member_monitor_interval=0.2, executor_workers=0, device="cpu",
               engine_config=EngineConfig(mesh_devices=job["mesh_devices"]))
    s.open()
    try:
        # Every node holds all the data; the placement decides which
        # shards each rank counts (and which its peer's fan-out asks of
        # it), so a rank contributes only what it owns.
        idx = s.holder.create_index_if_not_exists("ci")
        idx.create_field_if_not_exists("f")
        idx.field("f").import_bits(data["rows"].tolist(), data["cols"].tolist())
        idx.create_field_if_not_exists(
            "v", FieldOptions(type="int", min=job["v_min"], max=job["v_max"]))
        for col, val in zip(data["vcols"].tolist(), data["vvals"].tolist()):
            idx.field("v").set_value(col, val)
        if pid == 1:
            # Rank 0 queries only once this rank holds all its data.
            open(f"{tmp}/loaded", "w").close()
            while not os.path.exists(f"{tmp}/done"):
                time.sleep(0.05)
            print("WORKER1_OK")
            sys.exit(0)
        deadline = time.time() + 30
        while time.time() < deadline and not (
                s.collective.active() and os.path.exists(f"{tmp}/loaded")):
            time.sleep(0.1)
        assert s.collective.active() and os.path.exists(f"{tmp}/loaded")
        owned = [sh for sh in range(job["n_shards"]) if any(
            n.id == s.node.id for n in s.cluster.shard_nodes("ci", sh))]
        answers = {q: plain(s.executor.execute("ci", q)[0]) for q in job["queries"]}
        raw = urllib.request.urlopen(f"http://{hosts[0]}/debug/vars", timeout=5).read()
        counters = json.loads(raw)["counters"]
        desc = s.collective._descriptor("count", "ci", queries=[])
        # This rank's K1 calls (the plain twin's, on the CPU) in one entry.
        before = kernels.PLAIN_CALLS["gather_expr_count"]
        s.collective.count("ci", parse("Count(Row(f=2))").calls[0].children[0])
        k1_per_entry = kernels.PLAIN_CALLS["gather_expr_count"] - before
        json.dump({"answers": answers, "counters": counters, "owned": owned,
                   "collective": s.collective.snapshot(), "k": desc["k"],
                   "d_local": desc["dLocal"], "k1_per_entry": k1_per_entry},
                  open(f"{tmp}/answers.json", "w"), default=str)
        print("WORKER0_OK")
    finally:
        open(f"{tmp}/done", "w").close()
        s.close()
""")


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def placed_ports():
    """Two HTTP ports whose jump-hash placement of the index gives each
    node at least one of the N_SHARDS shards (node ids are host:port)."""
    for _ in range(50):
        ports = [free_port(), free_port()]
        nodes = [Node(id=f"localhost:{p}", uri=f"localhost:{p}") for p in ports]
        c = Cluster(node=nodes[0], nodes=sorted(nodes, key=lambda n: n.id),
                    replica_n=1)
        first = {c.shard_nodes("ci", s)[0].id for s in range(N_SHARDS)}
        if len(first) == 2:
            return ports
    raise AssertionError("no port pair splits the shards")


def test_two_rank_job_equals_one_reference_node(tmp_path):
    got = two_rank_job(tmp_path, mesh_devices=0)
    assert (got["d_local"], got["k1_per_entry"]) == (1, 1)


def test_two_rank_job_over_two_partitions_per_rank_equals_one_reference_node(tmp_path):
    """Each rank with `[engine] mesh-devices 2`: its k slots held as two
    blocks, K1/K2/K3 launched once per partition, the same answers."""
    got = two_rank_job(tmp_path, mesh_devices=2)
    assert got["d_local"] == 2 and got["k"] % 2 == 0
    assert got["k1_per_entry"] == 2
    assert got["collective"]["leaf_cache_entries"] > 0


def two_rank_job(tmp_path, mesh_devices):
    """A two-rank port job (each rank's engine with `mesh_devices`)
    answering QUERIES through the collective plane, held against one
    pilosa_tpu node with all the data; returns rank 0's report."""
    rows, cols, vals = seeded_data()
    np.savez(tmp_path / "data.npz", rows=np.asarray(rows), cols=np.asarray(cols),
             vcols=np.asarray(list(vals)), vvals=np.asarray(list(vals.values())))
    (tmp_path / "job.json").write_text(json.dumps(
        {"queries": QUERIES, "n_shards": N_SHARDS, "v_min": V_MIN, "v_max": V_MAX,
         "mesh_devices": mesh_devices}))
    script = tmp_path / "worker.py"
    script.write_text(JOB_WORKER)
    ports = placed_ports()
    coord = f"localhost:{free_port()}"
    # One OpenMP thread per rank: the ranks' CPU twins share the box with
    # the other test workers, and oversubscribed thread pools stall them.
    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen(
        [sys.executable, str(script), coord, str(pid), str(ports[0]), str(ports[1]),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=150)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    assert all(rc == 0 for rc, _, _ in outs), "\n".join(
        f"worker {pid} rc={rc}\nstdout:{out}\nstderr:{err[-3000:]}"
        for pid, (rc, out, err) in enumerate(outs))
    got = json.load(open(tmp_path / "answers.json"))
    assert 0 < len(got["owned"]) < N_SHARDS  # each rank counts a part

    jh = JHolder(None)
    jh.open()
    try:
        fill(jh, JFieldOptions, seeded_data())
        jex = JExecutor(jh, workers=0)
        want = {q: plain(jex.execute("ci", q)[0]) for q in QUERIES}
        jex.close()
    finally:
        jh.close()
    assert got["answers"] == want
    assert want["Max(field=v)"] == ["valcount", V_TOP, N_SHARDS]  # tied across ranks
    counters = got["counters"]
    assert counters.get("CollectiveFallback", 0) == 0, got["collective"]
    assert counters["CollectiveCount"] == 5
    assert counters["CollectiveTopN"] == 2
    assert counters["CollectiveValCount"] == 7
    return got
