"""A port geo follower's device state across every way the tailer
changes its fragments (pilosa_tpu_torch/geo/tail.py): a tailed batch
(`Api.apply_hint_ops` -> `Fragment.apply_hint_positions`), a 410
re-bootstrap that installs the leader's base images
(`migrate_install` + `migrate_seal`), and the divergent clear that
installs an empty image over a fragment the leader did not ship. After
each, the follower's next Count, made once with no retry, must equal the
leader's and must not come from a stale resident stack or a stale memo:
the engine's memo misses and its stack is regathered or delta-refreshed.
Port servers on the CPU (the kernels' plain twins run)."""

import time

import pytest

from pilosa_tpu_torch import failpoints
from pilosa_tpu_torch.cdc import CdcConfig
from pilosa_tpu_torch.constants import SHARD_WIDTH
from pilosa_tpu_torch.geo import GeoConfig
from pilosa_tpu_torch.server.server import Server

Q = "Count(Intersect(Row(f=1), Row(f=2)))"


def make(tmp_path, name, **geo):
    s = Server(data_dir=str(tmp_path / name), cache_flush_interval=0,
               executor_workers=0, device="cpu",
               cdc_config=CdcConfig(enabled=True),
               geo_config=GeoConfig(**geo))
    s.open()
    return s


@pytest.fixture
def pair(tmp_path):
    leader = make(tmp_path, "leader", role="leader")
    leader.api.create_index("i")
    leader.api.create_field("i", "f")
    follower = make(tmp_path, "follower", role="follower",
                    leader=f"localhost:{leader.port}", backoff=0.05)
    try:
        yield leader, follower
    finally:
        failpoints.reset()
        follower.close()
        leader.close()


def storage_bytes(s, shard, field="f"):
    frag = s.holder.fragment("i", field, "standard", shard)
    return b"" if frag is None or frag.storage.count() == 0 \
        else frag.storage.to_bytes()


def converged(leader, follower, shards=(0, 1)):
    """Storage equal on every shard: every record the leader holds is
    applied on the follower (read below the engine, from the fragments)."""
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        if all(storage_bytes(leader, s) == storage_bytes(follower, s) for s in shards):
            return
        time.sleep(0.02)
    raise AssertionError("the follower never converged")


def count(s, q=Q):
    return s.api.query("i", q)[0]


def snap(s):
    return dict(s.executor.engine.snapshot())


def moved(before, after, *keys):
    return {k: after[k] - before[k] for k in keys}


def test_follower_counts_follow_tail_bootstrap_and_divergent_clear(pair):
    leader, follower = pair
    cols = {1: [1, 5, 9, SHARD_WIDTH + 3, SHARD_WIDTH + 7],
            2: [5, 9, 11, SHARD_WIDTH + 7]}
    for row, cs in cols.items():
        leader.api.query("i", " ".join(f"Set({c}, f={row})" for c in cs))
    converged(leader, follower)
    want = len(set(cols[1]) & set(cols[2]))
    assert count(follower) == count(follower) == count(leader) == want == 3
    before = snap(follower)

    # A tailed batch: Sets and a Clear applied through apply_hint_ops.
    leader.api.query("i", f"Set(13, f=1) Set(13, f=2) Clear({SHARD_WIDTH + 7}, f=2)")
    converged(leader, follower)
    after = snap(follower)
    assert count(follower) == count(leader) == 3
    tail = moved(after, snap(follower), "memo_misses", "stack_delta_hits",
                 "stack_misses", "count_dispatches")
    assert tail["memo_misses"] >= 1 and tail["count_dispatches"] >= 1, tail
    assert tail["stack_delta_hits"] + tail["stack_misses"] >= 1, tail
    assert moved(before, after, "memo_hits")["memo_hits"] == 0

    # A forced 410: the leader's index starts a new life with row 2 gone
    # and shard 1 empty, so the follower re-bootstraps (install) and
    # clears the fragments the leader did not ship (empty install).
    boots = follower.geo.tailer.counters["bootstraps"]
    leader.api.delete_index("i")
    leader.api.create_index("i")
    leader.api.create_field("i", "f")
    leader.api.query("i", "Set(1, f=1) Set(5, f=1)")
    deadline = time.monotonic() + 20
    while follower.geo.tailer.counters["bootstraps"] <= boots:
        assert time.monotonic() < deadline, "no re-bootstrap"
        time.sleep(0.02)
    converged(leader, follower)
    assert follower.geo.tailer.counters["bootstrap_cleared"] >= 1
    b0 = snap(follower)
    assert count(follower) == count(leader) == 0
    assert count(follower, "Count(Row(f=1))") == count(leader, "Count(Row(f=1))") == 2
    boot = moved(b0, snap(follower), "memo_misses", "stack_delta_hits",
                 "stack_misses", "count_dispatches")
    assert boot["memo_misses"] >= 2 and boot["count_dispatches"] >= 1, boot
    assert boot["stack_delta_hits"] + boot["stack_misses"] >= 1, boot
