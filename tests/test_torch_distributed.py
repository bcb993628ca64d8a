"""The port's multi-process job (pilosa_tpu_torch/parallel/distributed.py),
mirroring tests/test_distributed.py.

Two OS processes each own half the shards, join one torch.distributed
gloo job, and produce identical all-reduced counts from K1 over their
local blocks (its plain twin on the CPU) and one int64 all_reduce — the
counterpart of the reference's global-mesh counts. Run as subprocesses
because a process group binds one rank per OS process. Then the
collective-count endpoint through a real one-process server, the
single-process degenerate case, and the reference's variable names.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import urllib.request

import pytest
import torch

from pilosa_tpu_torch.parallel import distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


WORKER = textwrap.dedent("""
    import sys
    import torch

    coordinator, n_proc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    from pilosa_tpu_torch.parallel import distributed as dist

    assert dist.initialize(coordinator, n_proc, pid)
    assert dist.initialize(coordinator, n_proc, pid)  # joined already
    assert dist.process_count() == n_proc
    assert dist.process_index() == pid

    # 8 shards, 64 words per plane; shard s has popcount (s+1) in row 0 and
    # bit pattern overlapping row 1 only on even shards.
    n_shards, w = 8, 64
    padded, lo, hi = dist.process_shard_slots(n_shards)
    assert padded == -(-n_shards // n_proc) * n_proc  # 8, or 9 over 3 ranks
    a_local = torch.zeros((hi - lo, w), dtype=torch.int32)
    b_local = torch.zeros((hi - lo, w), dtype=torch.int32)
    for s in range(lo, min(hi, n_shards)):  # padding slots stay zero
        a_local[s - lo, 0] = (1 << (s + 1)) - 1     # popcount s+1
        b_local[s - lo, 0] = -1 if s % 2 == 0 else 0

    total = dist.global_count(a_local)
    want_total = sum(s + 1 for s in range(n_shards))
    assert total == want_total, (total, want_total)

    inter = dist.global_and_count(a_local, b_local)
    want_inter = sum(s + 1 for s in range(n_shards) if s % 2 == 0)
    assert inter == want_inter, (inter, want_inter)
    rows = dist.all_gather(torch.tensor([pid, 10 * pid], dtype=torch.int64))
    assert rows.tolist() == [[p, 10 * p] for p in range(n_proc)], rows
    assert dist.reduce_backend() == "gloo" and dist.group_error() is None
    # Leave the job before exit: a group left to the interpreter's exit
    # can abort the process after the work is done.
    dist.all_reduce_sum(torch.zeros(1, dtype=torch.int64))
    dist.shutdown()
    assert dist.process_count() == 1
    print(f"WORKER_OK pid={pid} total={total} inter={inter}")
""")


def run_workers(tmp_path, script, argv, timeout):
    """One worker per argv list, each waited on with a time limit and
    killed in a `finally` if it is still running; [(rc, out, err)]."""
    path = tmp_path / "worker.py"
    path.write_text(script)
    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, str(path)] + [str(a) for a in args],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env)
             for args in argv]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    return outs


@pytest.mark.parametrize("n_proc", [2, 3])
def test_two_process_global_mesh_counts(tmp_path, n_proc):
    coordinator = f"localhost:{free_port()}"
    outs = run_workers(tmp_path, WORKER,
                       [[coordinator, n_proc, pid] for pid in range(n_proc)],
                       timeout=120)
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err[-2000:]}"
        assert "WORKER_OK" in out
    # Every process materialized the same all-reduced scalars.
    totals = {line.split("total=")[1] for _, out, _ in outs
              for line in out.splitlines() if "WORKER_OK" in line}
    assert len(totals) == 1


# A job whose ranks each publish a card of their own: the rule picks
# NCCL, and on a machine where it cannot form, the job stays joined with
# no group and the error kept (never a gloo group in its place).
WORKER_NCCL_REFUSED = textwrap.dedent("""
    import sys
    import torch

    coordinator, n_proc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    from pilosa_tpu_torch.parallel import distributed as dist

    dist.device_identity = lambda device: f"cuda/card-{pid}"
    assert dist.initialize(coordinator, n_proc, pid, timeout_ms=2000)
    assert dist.reduce_backend() == "nccl", dist.reduce_backend()
    assert dist.reduce_group() is None
    assert "nccl reduce group of generation 0 did not form" in dist.group_error()
    try:
        dist.all_reduce_sum(torch.ones(1, dtype=torch.int64))
        raise AssertionError("reduced without a group")
    except dist.ReduceFailed as e:
        assert "no reduce group" in str(e), e
    dist.shutdown()
    print(f"WORKER_OK pid={pid}")
""")


@pytest.mark.parametrize("meshes,want", [
    ([["cuda:0"], ["cuda:1"], ["cuda:2"], ["cuda:3"]], "nccl"),
    ([["cuda:0"], ["cuda:0"]], "gloo"),
    ([["cuda:0"], ["cpu"]], "gloo"),
    ([["cuda:0", "cuda:1"], ["cuda:1", "cuda:0"]], "nccl"),
    ([["cuda:0", "cuda:1"], ["cuda:0", "cuda:1"]], "gloo"),
], ids=["distinct-cards", "two-ranks-one-card", "a-cpu-rank", "meshes-span-cards",
        "meshes-start-on-one-card"])
def test_the_backend_rule(meshes, want):
    """NCCL when every rank's reduce device (partition 0 of its mesh) is
    a card no other rank's is; gloo for a CPU rank or a shared card."""
    def identity(device):  # device_identity, with a card's index for its UUID
        return "cpu" if device == "cpu" else f"cuda/GPU-{device.split(':')[1]}"

    assert dist.pick_backend([identity(mesh[0]) for mesh in meshes]) == want
    assert dist.device_identity("cpu") == "cpu"


def test_a_job_sent_to_nccl_that_cannot_form_it_has_no_group(tmp_path):
    coordinator = f"localhost:{free_port()}"
    outs = run_workers(tmp_path, WORKER_NCCL_REFUSED,
                       [[coordinator, 2, pid] for pid in range(2)], timeout=120)
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err[-2000:]}"
        assert "WORKER_OK" in out


def test_a_reduce_group_fails_and_re_forms_in_one_process():
    """A one-rank gloo ReduceGroup on a store of its own: reduce and
    gather, a reduce whose wait fails advances the generation and aborts
    the group (it serves nothing more), the group of generation 1 forms
    in its place under its own store prefix, and a late reduce is
    discarded once the generation has moved past its group's."""
    store = torch.distributed.TCPStore("localhost", free_port(), 1, True)
    store.set(dist.GENERATION_KEY, "0")
    group = dist.ReduceGroup(store, "gloo", 0, 1, "cpu", 2000)
    x = torch.arange(4, dtype=torch.int64)
    assert group.all_reduce_sum(x.clone()).tolist() == [0, 1, 2, 3]
    assert group.all_gather(x).tolist() == [[0, 1, 2, 3]]

    def timed_out(work, timeout_ms=None):
        raise TimeoutError("the reduce did not complete within 2000 ms")

    group._complete = timed_out
    with pytest.raises(dist.ReduceFailed, match="generation 0 failed"):
        group.all_reduce_sum(x.clone())
    assert "did not complete" in group.failed
    assert store.get(dist.GENERATION_KEY) == b"1"  # advanced before the abort
    with pytest.raises(dist.ReduceFailed):
        group.all_gather(x)
    again = group.reform(1)
    assert again.generation == 1 and again.failed is None
    assert again.all_reduce_sum(x.clone()).tolist() == [0, 1, 2, 3]
    # A reduce completed late is kept while the generation is its group's,
    # and always before the timeout; past it, once a peer moved the
    # generation on, it is discarded and the group aborted.
    again.check_late(10.0)
    store.set(dist.GENERATION_KEY, "2")
    again.check_late(1.0)
    with pytest.raises(dist.ReduceFailed, match="after a peer had given up"):
        again.check_late(10.0)
    assert again.failed is not None


def _post(host, path, body):
    req = urllib.request.Request(f"http://{host}{path}",
                                 data=json.dumps(body).encode(), method="POST")
    return json.load(urllib.request.urlopen(req))


def test_collective_count_endpoint(tmp_path):
    """Leader-driven collective count through the real server and API on
    a one-process job (no peers to broadcast to; the rank's block holds
    every shard). Cross-checks against the PQL path."""
    from pilosa_tpu_torch.constants import SHARD_WIDTH
    from pilosa_tpu_torch.server.client import InternalClient
    from pilosa_tpu_torch.server.server import Server

    s = Server(data_dir=str(tmp_path / "n0"), cache_flush_interval=0, device="cpu")
    s.open()
    try:
        client = InternalClient()
        h = f"localhost:{s.port}"
        client.create_index(h, "cc")
        client.create_field(h, "cc", "f")
        for col in [1, 5, SHARD_WIDTH + 3]:
            client.query(h, "cc", f"Set({col}, f=7)")
            client.query(h, "cc", f"Set({col}, f=9)")
        client.query(h, "cc", "Set(2, f=9)")

        got = _post(h, "/internal/collective/count",
                    {"index": "cc", "field": "f", "rows": [7]})["count"]
        assert got == 3
        got = _post(h, "/internal/collective/count",
                    {"index": "cc", "field": "f", "rows": [7, 9]})["count"]
        assert got == 3
        want = client.query(h, "cc", "Count(Intersect(Row(f=7), Row(f=9)))")
        assert want["results"][0] == 3
        assert s.collective.counters["served_count"] == 2
        client.close()
    finally:
        s.close()


def test_collective_count_refused_without_a_spanning_job(tmp_path):
    """Two nodes and no job: a collective count would miss the peer's
    shards, so the endpoint refuses instead of answering."""
    from pilosa_tpu_torch.server.server import Server

    ports = [free_port(), free_port()]
    hosts = [f"localhost:{p}" for p in ports]
    s = Server(data_dir=None, port=ports[0], cluster_hosts=hosts, device="cpu",
               cache_flush_interval=0, anti_entropy_interval=0,
               member_monitor_interval=0)
    s.open()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(hosts[0], "/internal/collective/count",
                  {"index": "cc", "field": "f", "rows": [7]})
        assert "torch.distributed job" in ei.value.read().decode()
    finally:
        s.close()


def test_single_process_degenerates_to_local(monkeypatch):
    """initialize() without a coordinator is a no-op and the helpers work
    on the local block."""
    monkeypatch.delenv("PILOSA_JAX_COORDINATOR", raising=False)
    assert not dist.initialize()
    assert dist.process_count() == 1 and dist.process_index() == 0
    assert dist.connect_store() is None
    n_shards = 8
    padded, lo, hi = dist.process_shard_slots(n_shards)
    assert lo == 0 and hi == padded >= n_shards
    planes = torch.zeros((hi - lo, 16), dtype=torch.int32)
    planes[3, 0] = 0b1011
    assert dist.global_count(planes) == 3
    other = torch.zeros_like(planes)
    other[3, 0] = 0b0011
    assert dist.global_and_count(planes, other) == 2


@pytest.mark.parametrize("env", [
    {"PILOSA_JAX_NUM_PROCESSES": "4", "PILOSA_JAX_PROCESS_ID": "1"},
    {"PILOSA_JAX_COORDINATOR": "localhost:1", "PILOSA_JAX_NUM_PROCESSES": "1"},
], ids=["no-coordinator", "one-process"])
def test_initialize_reads_the_reference_variables(monkeypatch, env):
    """The job is described by pilosa_tpu's variable names; without a
    coordinator, or with one process, nothing is joined (and nothing is
    dialed: the coordinator above does not exist)."""
    for name in ("PILOSA_JAX_COORDINATOR", "PILOSA_JAX_NUM_PROCESSES",
                 "PILOSA_JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert not dist.initialize()
    assert dist.process_count() == 1


@pytest.mark.parametrize("n_shards", [1, 7, 8, 256])
def test_process_shard_slots_cover_the_shards(n_shards):
    padded, lo, hi = dist.process_shard_slots(n_shards)
    assert (padded, lo, hi) == (n_shards, 0, n_shards)


@pytest.mark.parametrize("n_shards,d_local,padded", [(5, 2, 6), (5, 3, 6), (8, 8, 8),
                                                     (9, 4, 12)])
def test_process_shard_slots_pad_to_the_partitions(n_shards, d_local, padded):
    """One process: the shard axis pads to a multiple of its partitions
    (world size x d_local), as the reference pads to its device count."""
    assert dist.process_shard_slots(n_shards, d_local) == (padded, 0, padded)


def test_make_global_planes_and_counts_over_blocks():
    """A rank's (k, W) block split over its partitions (slot s in block
    s // (k / d_local), on each partition's device), and the global counts
    over those Blocks equal the counts over the whole block."""
    import numpy as np

    from pilosa_tpu_torch.parallel.engine import Blocks

    rng = np.random.default_rng(3)
    a = rng.integers(0, 1 << 32, size=(6, 16), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, size=(6, 16), dtype=np.uint64).astype(np.uint32)
    mesh = dist.global_mesh(3, "cpu")
    assert mesh == [torch.device("cpu")] * 3
    ba, bb = dist.make_global_planes(a, mesh), dist.make_global_planes(b, mesh)
    assert isinstance(ba, Blocks) and [tuple(x.shape) for x in ba] == [(2, 16)] * 3
    assert np.array_equal(ba.joined().numpy().view(np.uint32), a)
    stack = dist.make_global_planes(np.stack([a, b]), mesh)
    assert [tuple(x.shape) for x in stack] == [(2, 2, 16)] * 3
    whole_a = torch.from_numpy(a.view(np.int32))
    whole_b = torch.from_numpy(b.view(np.int32))
    assert dist.global_count(ba) == dist.global_count(whole_a) == \
        int(np.unpackbits(a.view(np.uint8)).sum())
    assert dist.global_and_count(ba, bb) == dist.global_and_count(whole_a, whole_b) == \
        int(np.unpackbits((a & b).view(np.uint8)).sum())
    with pytest.raises(ValueError, match="partitions"):
        dist.make_global_planes(a, dist.global_mesh(4, "cpu"))
