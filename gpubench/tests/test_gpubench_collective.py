"""The `collective` deployment kind: four rank processes of the port, one
torch.distributed job. On the CPU (gloo) at 14 shards: the placement
hands every shard to exactly one node, each node's holder equals the
one-node load on its shards, a sound run is correct and reports the
collective plane's metrics, and a run with each fault the cell can have
planted in every rank comes out not correct. On the card (marked
`cuda`): the four ranks rehearsed on one card (gloo), and the control at
the cell's own size on four cards (NCCL). Run on a card:

    python -m pytest gpubench/tests/test_gpubench_collective.py -m cuda -s
"""

import gc
import json

import numpy as np
import pytest

from gpubench import datagen, harness, load, spec
from gpubench.tests.tiny import tiny_cluster_hooks

CELL = "taxi-1b-4node.groupby-live"
# The faults the cell can have: an answer altered where it is produced,
# half of each read left out, the exchange between the ranks left out,
# and the writes forwarded to the shard's owner acknowledged but lost.
FAULTS = ("alter_answers", "half_shards", "skip_reduce", "drop_forwarded_writes")
CONTROL_SEEDS = (2 ** 31 + 4101, 2 ** 31 + 4202, 2 ** 31 + 4303)


def _run(capsys, seed, trace, hooks, seconds=3):
    rc = harness.main(["--workload", CELL, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], hooks=hooks)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1]) if rc == 0 else None


def _planes(holder, columns, shard):
    """Every row of every loaded field of one shard, as the holder has it."""
    out = {}
    idx = holder.index(columns.cfg["index"])
    for name in columns.loaded:
        fld = idx.field(name)
        view = fld.view(fld.bsi_view_name() if fld.options.type == "int" else "standard")
        frag = view.fragment(shard)
        c = columns.field(name)["field"]
        rows = (columns.rows(name) if c["type"] == "set"
                else range(datagen.bit_depth(c["min"], c["max"]) + 1))
        out[name] = np.stack([frag.plane_np(r) for r in rows])
    return out


SPANS = {"collective_entry_ms": "collective.entry",
         "collective_barrier_ms": "collective.barrier",
         "collective_reduce_ms": "collective.reduce"}


def _rec(traces, calls=1):
    return {"read_traces": traces, "calls_of": lambda pql: calls}


@pytest.mark.parametrize("metric,span", sorted(SPANS.items()))
def test_each_span_of_the_plane_is_summed_per_read_call(metric, span):
    # A batch of two requests: the leader's trace holds the entry's spans.
    traces = [("Count(x)", 0.0, 1.0, [("batch.hold", 0.0, 0.1, {}), (span, 0.1, 0.008, {})]),
              ("Count(y)", 0.0, 1.0, [("batch.hold", 0.0, 0.1, {"role": "follower"})])]
    assert spec.metric(metric).read(_rec(traces)) == pytest.approx(4.0)
    assert spec.metric(metric).read(_rec(traces[1:])) is None


def test_the_served_share_counts_the_marked_calls():
    served = ("gpubench.collective_count", 0.5, 0.0, {})
    traces = [("Count(x)", 0.0, 1.0, [("collective.entry", 0.1, 0.01, {}), served]),
              ("Count(y)", 0.0, 1.0, [served]),
              ("Count(z)", 0.0, 1.0, [("executor.fanout", 0.1, 0.2, {})]),
              ("Count(w)", 0.0, 1.0, [("batch.hold", 0.1, 0.2, {}), served])]
    read = spec.metric("collective_served_pct").read
    assert read(_rec(traces)) == pytest.approx(75.0)
    # A deployment whose traces hold nothing of the plane: silent, not 0.
    assert read(_rec([traces[2]])) is None
    assert read(_rec([])) is None


def test_the_placement_loads_every_shard_once_as_the_one_node_load_does():
    from pilosa_tpu_torch.cluster.node import Cluster, Node
    from pilosa_tpu_torch.core.holder import Holder

    from gpubench.deployments.collective import OwnedLoader, owned_shards

    cfg = tiny_cluster_hooks().config(spec.config("taxi-1b-4node"))
    columns = datagen.Columns(cfg, 2 ** 31 + 77, "cpu", 2)
    whole = Holder(None, device="cpu")
    load.Loader(whole, columns).load()
    nodes = [Node(id=f"localhost:{30000 + r}") for r in range(cfg["nodes"])]
    owned = []
    for node in nodes:
        cluster = Cluster(node=node, nodes=list(nodes), replica_n=cfg["replicas"])
        mine = owned_shards(cluster, cfg["index"], columns.n_shards, node.id)
        holder = Holder(None, device="cpu")
        OwnedLoader(holder, columns, mine).load()
        for shard in range(columns.n_shards):
            frag = holder.index(cfg["index"]).field("pickup_year").view("standard").fragment(
                shard)
            assert (frag is not None) == (shard in mine), (node.id, shard)
        for shard in mine:
            got, want = _planes(holder, columns, shard), _planes(whole, columns, shard)
            for name in columns.loaded:
                assert np.array_equal(got[name], want[name]), (node.id, shard, name)
        owned += mine
    assert sorted(owned) == list(range(columns.n_shards))
    assert all(owned.count(s) == 1 for s in owned)


def test_a_sound_run_of_four_ranks_is_correct_and_reads_the_plane(capsys, tmpdir_env):
    rc, line = _run(capsys, 2 ** 31 + 4011, 1, tiny_cluster_hooks())
    assert rc == 0
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0
    m = line["metrics"]
    assert {"read_calls_per_s", "request_p95_ms", "collective_entry_ms",
            "collective_barrier_ms", "collective_reduce_ms",
            "collective_served_pct"} <= set(m), sorted(m)
    assert m["collective_served_pct"]["value"] >= 95.0
    # The metrics of the one-node engine path read nothing here, and the
    # cell does not list them.
    bench = spec.benchmark()
    listed = {x["name"] for x in spec.metrics_for(bench, CELL, "per_layer")}
    assert set(m) <= listed
    ranks = line["run"]["ranks"]
    assert [r["reduce_backend"] for r in ranks] == ["gloo"] * 4
    assert sum(r["shards"] for r in ranks) == 14
    assert all(not r["collective"]["fallbacks"] for r in ranks)


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_planted_in_every_rank_makes_the_run_not_correct(capsys, tmpdir_env, fault):
    rc, line = _run(capsys, 99, 0, tiny_cluster_hooks(rank_fault=fault))
    assert rc == 0
    assert line["correct"] is False, (fault, line["checks"])


@pytest.mark.cuda
def test_four_ranks_rehearsed_on_one_card(card, capsys, tmpdir_env):
    """The cell at its own size, its four ranks sharing cuda:0 (gloo)."""
    import torch

    hooks = harness.Hooks()
    hooks.device = "cuda:0"
    hooks.rank_devices = ["cuda:0"] * 4
    rc, line = _run(capsys, 2 ** 31 + 4021, 1, hooks, seconds=20)
    gc.collect()
    torch.cuda.empty_cache()
    assert rc == 0
    print(f"rehearsal on one card: {json.dumps(line)}")
    assert line["correct"] is True, line["checks"]
    assert [r["reduce_backend"] for r in line["run"]["ranks"]] == ["gloo"] * 4


@pytest.mark.cuda
@pytest.mark.parametrize("seed", CONTROL_SEEDS)
def test_the_control_is_not_correct_on_four_cards(card, capsys, tmpdir_env, seed):
    """The cell at its own size on four cards, every rank dropping the
    writes forwarded to it: the guarantee that an acknowledged write is
    seen by every later read at every node, broken."""
    import torch

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    hooks = harness.Hooks()
    hooks.rank_fault = "drop_forwarded_writes"
    rc, line = _run(capsys, seed, 0, hooks, seconds=5)
    assert rc == 0
    print(f"control {CELL} drop_forwarded_writes seed {seed}: checks "
          f"{json.dumps(line['checks'])}; ranks "
          f"{[r['reduce_backend'] for r in line['run']['ranks']]}")
    assert line["correct"] is False
