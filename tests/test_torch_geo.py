"""The cases of tests/test_geo.py, run against the port on the CPU.

Geo replication: follower clusters tailing CDC, bounded-staleness
reads, fenced leader-loss promotion (docs/geo-replication.md).

The contract under test: a follower cluster converges to byte-identical
fragments through the idempotent anti-entropy merge; its cursor is
durable (apply-then-checkpoint — a kill between the two re-applies
idempotently, never loses an acked record); reads under
X-Pilosa-Max-Staleness are served locally within the lag bound and
409 with lag/bound/position beyond it (clean no-op on a non-geo node);
promotion bumps a fencing geo epoch whose handshake makes it
impossible for two clusters to accept writes under the same epoch, and
an aborted promotion fully reverts.
"""

import json
import random
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

from pilosa_tpu_torch import failpoints
from pilosa_tpu_torch.cdc import CdcConfig
from pilosa_tpu_torch.constants import SHARD_WIDTH
from pilosa_tpu_torch.errors import PilosaError, StaleGeoEpochError, StaleReadError
from pilosa_tpu_torch.failpoints import InjectedFault
from pilosa_tpu_torch.geo import GeoConfig
from pilosa_tpu_torch.server.server import Server as _Server


def Server(*args, **kw):
    """The port's server on the CPU."""
    kw.setdefault("device", "cpu")
    return _Server(*args, **kw)


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def make_leader(tmp_path, name="leader"):
    s = Server(data_dir=str(tmp_path / name), cache_flush_interval=0,
               executor_workers=0,
               cdc_config=CdcConfig(enabled=True),
               geo_config=GeoConfig(role="leader"))
    s.open()
    return s


def make_follower(tmp_path, leader_host, name="follower", **geo_kw):
    geo_kw.setdefault("backoff", 0.05)
    s = Server(data_dir=str(tmp_path / name), cache_flush_interval=0,
               executor_workers=0,
               cdc_config=CdcConfig(enabled=True),
               geo_config=GeoConfig(role="follower", leader=leader_host,
                                    **geo_kw))
    s.open()
    return s


def wait_until(fn, timeout=20.0, interval=0.02, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if fn():
                return
        except Exception:
            pass
        time.sleep(interval)
    assert fn(), f"timed out waiting for {msg}"


def frag_bytes(s, index="i", field="f", shard=0):
    frag = s.holder.fragment(index, field, "standard", shard)
    assert frag is not None
    frag.snapshot()  # quiesce background WAL splicing before comparing
    return frag.storage.to_bytes()


def count_row(s, row=1, index="i", field="f"):
    return s.api.query(index, f"Count(Row({field}={row}))")[0]


def _post_query(port, index, query, headers=None, timeout=30):
    req = urllib.request.Request(
        f"http://localhost:{port}/index/{index}/query",
        data=query.encode(), headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


@pytest.fixture
def pair(tmp_path):
    """A converging leader/follower pair with index `i`, field `f`
    created BEFORE the follower opens (its first schema sync links it)."""
    leader = make_leader(tmp_path)
    leader.api.create_index("i")
    leader.api.create_field("i", "f")
    follower = make_follower(tmp_path, f"localhost:{leader.port}")
    servers = [leader, follower]
    try:
        yield leader, follower
    finally:
        failpoints.reset()
        for s in reversed(servers):
            try:
                s.close()
            except Exception:
                pass


# ------------------------------------------------------------ convergence


def test_tail_apply_convergence_byte_identical(pair):
    """A Set/Clear mix across two shards converges byte-for-byte through
    the stream path alone — no bootstrap, cursor checkpoints on disk."""
    leader, follower = pair
    rng = random.Random(7)
    for _ in range(60):
        col = rng.randrange(40)
        shard = rng.randrange(2)
        col += shard * SHARD_WIDTH
        if rng.random() < 0.3:
            leader.api.query("i", f"Clear({col}, f=1)")
        else:
            leader.api.query("i", f"Set({col}, f=1)")
    want = count_row(leader)
    wait_until(lambda: count_row(follower) == want, msg="follower count")
    for shard in (0, 1):
        assert frag_bytes(follower, shard=shard) == \
            frag_bytes(leader, shard=shard)
    snap = follower.geo.tailer.snapshot()
    # Every CDC record the leader assigned was applied, exactly once per
    # position (no-op writes assign no position, so equality is exact).
    assert snap["records_applied"] == leader.cdc.log("i").last_pos
    assert snap["bootstraps"] == 0  # pure stream path
    assert snap["checkpoints"] >= 1
    assert follower.geo.lag() < 30.0  # finite: head reached, stamps flowed


def test_durable_cursor_across_restart(pair, tmp_path):
    """Close the follower, keep writing, reopen from the same data dir:
    it resumes from the checkpointed cursor (no 410 re-seed) and
    converges loss-free."""
    leader, follower = pair
    for col in range(20):
        leader.api.query("i", f"Set({col}, f=1)")
    wait_until(lambda: count_row(follower) == 20, msg="initial converge")
    follower.close()
    for col in range(20, 40):
        leader.api.query("i", f"Set({col}, f=1)")
    follower2 = make_follower(tmp_path, f"localhost:{leader.port}",
                              name="follower")
    try:
        wait_until(lambda: count_row(follower2) == 40, msg="re-converge")
        assert frag_bytes(follower2) == frag_bytes(leader)
        snap = follower2.geo.tailer.snapshot()
        # The cursor survived: this life streamed the tail, never 410'd
        # into a base re-pull, and never re-applied the first window.
        assert snap["bootstraps"] == 0
        assert snap["records_applied"] <= 20
    finally:
        follower2.close()


def test_apply_fault_cursor_holds_then_idempotent_replay(pair):
    """A mid-chunk apply fault leaves the cursor where it was (never
    advanced over un-applied state); the retry re-applies the window
    idempotently and still converges byte-identical — the SIGKILL-
    between-apply-and-checkpoint story, driven by the failpoint."""
    leader, follower = pair
    for col in range(10):
        leader.api.query("i", f"Set({col}, f=1)")
    wait_until(lambda: count_row(follower) == 10, msg="baseline")
    failpoints.configure("geo-apply", "error", count=1)
    leader.api.query("i", "Clear(3, f=1)")
    leader.api.query("i", "Set(11, f=1)")
    leader.api.query("i", "Set(12, f=1)")
    wait_until(lambda: failpoints.hits("geo-apply") >= 1, msg="fault fired")
    wait_until(lambda: count_row(follower) == 11, msg="post-fault converge")
    assert follower.geo.tailer.counters["apply_errors"] >= 1
    assert frag_bytes(follower) == frag_bytes(leader)


def test_bootstrap_on_incarnation_change(pair):
    """Recreating the index on the leader flips the CDC incarnation: the
    follower's stale-life cursor 410s into a base-image bootstrap and
    converges to the new life's bytes."""
    leader, follower = pair
    for col in range(8):
        leader.api.query("i", f"Set({col}, f=1)")
    wait_until(lambda: count_row(follower) == 8, msg="first life")
    leader.api.delete_index("i")
    leader.api.create_index("i")
    leader.api.create_field("i", "f")
    leader.api.query("i", "Set(99, f=1)")
    wait_until(lambda: follower.geo.tailer.counters["bootstraps"] >= 1,
               msg="bootstrap")
    wait_until(lambda: count_row(follower) == 1, msg="second life")
    assert frag_bytes(follower) == frag_bytes(leader)


def test_bootstrap_clears_divergent_fragments(pair):
    """Bootstrap REPLACES local state with the leader's view — including
    fragments the response does NOT carry. Data from the old index life
    that the new leader never wrote (here: a shard-1 fragment) must be
    cleared by the re-seed, not served forever."""
    leader, follower = pair
    leader.api.query("i", f"Set({SHARD_WIDTH + 2}, f=1)")  # shard 1
    leader.api.query("i", "Set(1, f=1)")                   # shard 0
    wait_until(lambda: count_row(follower) == 2, msg="first life")
    leader.api.delete_index("i")
    leader.api.create_index("i")
    leader.api.create_field("i", "f")
    leader.api.query("i", "Set(2, f=1)")  # shard 0 only in the new life
    wait_until(lambda: follower.geo.tailer.counters["bootstraps"] >= 1,
               msg="bootstrap")
    # Without divergence clearing the stale shard-1 bit lingers and the
    # count stays 2 forever.
    wait_until(lambda: count_row(follower) == 1, msg="second life")
    assert follower.geo.tailer.counters["bootstrap_cleared"] >= 1
    frag = follower.holder.fragment("i", "f", "standard", 1)
    assert frag is None or frag.storage.count() == 0
    assert frag_bytes(follower) == frag_bytes(leader)


def test_checkpoint_implies_synced_wal(pair):
    """The cursor checkpoint durably claims its chunk's positions, so
    the fragment WAL tails it covers must be fsynced first. Under the
    default fsync=batch policy the applied records would otherwise sit
    in the page cache (batch threshold not reached) while the cursor
    file is already durably replaced — a crash in that window loses a
    tail the cursor says was applied, a gap never re-fetched."""
    leader, follower = pair
    for col in range(10):
        leader.api.query("i", f"Set({col}, f=1)")
    wait_until(lambda: count_row(follower) == 10, msg="converge")

    def synced():
        frag = follower.holder.fragment("i", "f", "standard", 0)
        return frag is not None \
            and frag.storage_config.fsync == "batch" \
            and follower.geo.tailer.counters["checkpoints"] >= 1 \
            and frag._unsynced_ops == 0
    # 10 applied ops < fsync_batch_ops=64: without the pre-checkpoint
    # wal_sync the counter would sit at 10 indefinitely.
    wait_until(synced, msg="WAL synced before checkpoint")


# ------------------------------------------------------ staleness contract


def test_staleness_409_payload_and_local_serve(pair):
    leader, follower = pair
    leader.api.query("i", "Set(1, f=1)")
    wait_until(lambda: count_row(follower) == 1, msg="converge")
    # Within bound: answered locally.
    st, body = _post_query(follower.port, "i", "Count(Row(f=1))",
                           headers={"X-Pilosa-Max-Staleness": "30"})
    assert st == 200 and body["results"][0] == 1
    # A zero bound can never be satisfied (lag includes time since the
    # last leader contact): typed 409 carrying the current lag.
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post_query(follower.port, "i", "Count(Row(f=1))",
                    headers={"X-Pilosa-Max-Staleness": "0"})
    assert ei.value.code == 409
    body = json.loads(ei.value.read())
    assert body["bound"] == 0.0
    assert body["lag"] is None or body["lag"] >= 0.0
    assert isinstance(body["position"], int)
    assert "staleness" in body["error"]
    # Same contract through the in-process API.
    with pytest.raises(StaleReadError) as se:
        follower.api.query("i", "Count(Row(f=1))", max_staleness=0.0)
    assert se.value.bound == 0.0
    # Malformed header is a 400, not a silent fresh read.
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post_query(follower.port, "i", "Count(Row(f=1))",
                    headers={"X-Pilosa-Max-Staleness": "soon"})
    assert ei.value.code == 400


def test_max_staleness_noop_on_non_geo_node(tmp_path):
    """On a node with no geo role the header is a documented clean
    no-op: the read executes normally (it IS fresh here) even with a
    bound no follower could meet."""
    s = Server(data_dir=str(tmp_path / "plain"), cache_flush_interval=0,
               executor_workers=0)
    s.open()
    try:
        assert s.geo is None
        s.api.create_index("i")
        s.api.create_field("i", "f")
        s.api.query("i", "Set(1, f=1)")
        for bound in ("30", "0"):
            st, body = _post_query(s.port, "i", "Count(Row(f=1))",
                                   headers={"X-Pilosa-Max-Staleness": bound})
            assert st == 200 and body["results"][0] == 1
        assert s.api.query("i", "Count(Row(f=1))", max_staleness=0.0)[0] == 1
    finally:
        s.close()


# --------------------------------------------------- promotion and fencing


def test_follower_refuses_writes_typed_409(pair):
    leader, follower = pair
    wait_until(lambda: follower.holder.index("i") is not None, msg="schema")
    with pytest.raises(StaleGeoEpochError):
        follower.api.query("i", "Set(1, f=1)")
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post_query(follower.port, "i", "Set(2, f=1)")
    assert ei.value.code == 409
    body = json.loads(ei.value.read())
    assert body["current"] == 0 and "epoch" in body["error"]
    assert follower.geo.counters["writes_refused"] >= 2


def test_promote_abort_fully_reverts(pair):
    """A failure inside promotion (before the durable persist) reverts
    everything: role, epoch, and the tail loop — then a clean promote
    succeeds."""
    leader, follower = pair
    leader.api.query("i", "Set(1, f=1)")
    wait_until(lambda: count_row(follower) == 1, msg="converge")
    failpoints.configure("geo-promote", "error", count=1)
    with pytest.raises(InjectedFault):
        follower.geo.promote()
    st = follower.geo.status()
    assert st["role"] == "follower" and st["epoch"] == 0
    assert follower.geo.counters["promote_aborts"] == 1
    # Tailing resumed as if nothing happened.
    leader.api.query("i", "Set(2, f=1)")
    wait_until(lambda: count_row(follower) == 2, msg="tail resumed")
    st = follower.geo.promote()
    assert st["role"] == "leader" and st["epoch"] == 1


def test_promote_fence_demote_rejoin(pair):
    """Operator promotion over HTTP: the follower bumps the geo epoch,
    the fence demotes the old leader (which refuses writes with a typed
    409, adopts the epoch, and re-tails the new leader through a fresh
    bootstrap), and a stale demote is refused — authority flows only
    forward."""
    leader, follower = pair
    for col in range(10):
        leader.api.query("i", f"Set({col}, f=1)")
    wait_until(lambda: count_row(follower) == 10, msg="converge")
    req = urllib.request.Request(
        f"http://localhost:{follower.port}/geo/promote", data=b"")
    with urllib.request.urlopen(req, timeout=30) as r:
        st = json.loads(r.read())
    assert st["role"] == "leader" and st["epoch"] == 1
    # The fence lands: old leader demotes and adopts the epoch verbatim.
    wait_until(lambda: leader.geo.status()["role"] == "follower",
               msg="fence demotes old leader")
    assert leader.geo.status()["epoch"] == 1
    # Writes at the deposed leader: typed 409.
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post_query(leader.port, "i", "Set(50, f=1)")
    assert ei.value.code == 409
    assert json.loads(ei.value.read())["current"] == 1
    # New leader accepts; the old leader re-tails it (cursors were
    # wiped, so it replays the new leader's feed from position zero —
    # idempotent over the bits it already holds).
    follower.api.query("i", "Set(11, f=1)")
    wait_until(lambda: count_row(leader) == 11, msg="old leader re-tails")
    assert frag_bytes(leader) == frag_bytes(follower)
    assert leader.geo.tailer.counters["records_applied"] >= 11
    # Stale handshake refused: epoch must be strictly greater.
    with pytest.raises(StaleGeoEpochError):
        leader.geo.demote(leader=f"localhost:{follower.port}", epoch=1)
    assert leader.geo.counters["demotions_refused"] >= 1
    # /geo/status and the geo /debug/vars group carry the state.
    with urllib.request.urlopen(
            f"http://localhost:{leader.port}/geo/status", timeout=30) as r:
        assert json.loads(r.read())["role"] == "follower"
    with urllib.request.urlopen(
            f"http://localhost:{follower.port}/debug/vars", timeout=30) as r:
        dv = json.loads(r.read())["geo"]
    assert dv["role"] == "leader" and dv["epoch"] == 1
    assert dv["promotions"] == 1 and "tail" in dv


def test_probe_driven_promotion(tmp_path):
    """With probe-promote on, sustained leader-contact failure promotes
    the follower from the tail thread itself."""
    leader = make_leader(tmp_path)
    leader.api.create_index("i")
    leader.api.create_field("i", "f")
    follower = make_follower(tmp_path, f"localhost:{leader.port}",
                             backoff=0.05, backoff_max=0.1,
                             probe_promote=True, probe_failures=3)
    try:
        wait_until(lambda: follower.holder.index("i") is not None,
                   msg="schema")
        leader.close()
        wait_until(lambda: follower.geo.status()["role"] == "leader",
                   timeout=30, msg="probe promotion")
        assert follower.geo.status()["epoch"] == 1
        assert follower.geo.counters["probe_promotions"] == 1
    finally:
        try:
            follower.close()
        finally:
            try:
                leader.close()
            except Exception:
                pass


@pytest.mark.chaos
def test_geo_chaos_fencing_no_shared_epoch(pair):
    """Seed-pinned chaos: writers hammer BOTH clusters through a
    promotion + fence + rejoin while the tail path runs under a flaky
    failpoint. The fencing invariant: no write is ever accepted by two
    clusters under the same geo epoch (accepted-epoch sets stay
    disjoint), and every refused write is a typed 409 — correct answers
    and typed errors are the only outcomes."""
    leader, follower = pair
    wait_until(lambda: follower.holder.index("i") is not None, msg="schema")
    failpoints.seed(4242)
    failpoints.configure("geo-tail", "flaky", arg=0.3)
    stop = threading.Event()
    outcomes = {"ok": 0, "fenced": 0, "other": []}
    lock = threading.Lock()

    def writer(port, seed):
        rng = random.Random(seed)
        while not stop.is_set():
            col = rng.randrange(200)
            try:
                _post_query(port, "i", f"Set({col}, f=1)", timeout=10)
                with lock:
                    outcomes["ok"] += 1
            except urllib.error.HTTPError as e:
                with lock:
                    if e.code == 409:
                        outcomes["fenced"] += 1
                    else:
                        outcomes["other"].append(e.code)
            except Exception as e:  # noqa: BLE001 - tallied and asserted
                with lock:
                    outcomes["other"].append(repr(e))
            time.sleep(0.002)

    threads = [
        threading.Thread(target=writer, args=(leader.port, 1)),
        threading.Thread(target=writer, args=(follower.port, 2)),
    ]
    for t in threads:
        t.start()
    try:
        time.sleep(0.3)
        follower.geo.promote()
        wait_until(lambda: leader.geo.status()["role"] == "follower",
                   timeout=30, msg="fence lands")
        time.sleep(0.5)  # both sides keep taking traffic post-fence
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        failpoints.reset()
    assert outcomes["other"] == [], outcomes
    assert outcomes["ok"] > 0 and outcomes["fenced"] > 0, outcomes
    # THE invariant: the two clusters' accepted-write epochs are
    # disjoint — split-brain writes cannot hide under a shared epoch.
    a = {k for k, v in leader.geo.write_epochs.items() if v}
    b = {k for k, v in follower.geo.write_epochs.items() if v}
    assert a and b, (a, b)
    assert not (a & b), (a, b)
    assert a == {0} and b == {1}, (a, b)
    # Epoch-0 writes acked by the old leader inside the promotion window
    # (after the follower's tail paused, before the fence landed) never
    # reached the new leader's feed — that divergence is the documented
    # failover cost. The re-tailed old leader must still apply
    # EVERYTHING the new leader serves: its row converges to a superset.
    want = set(int(c) for c in
               follower.api.query("i", "Row(f=1)")[0].columns())
    wait_until(
        lambda: want <= set(int(c) for c in
                            leader.api.query("i", "Row(f=1)")[0].columns()),
        msg="post-chaos superset converge")


# ------------------------------------------------------------ config knobs


def test_geo_config_sources(tmp_path, monkeypatch):
    from pilosa_tpu_torch.config import Config

    toml = tmp_path / "c.toml"
    toml.write_text('[geo]\nrole = "follower"\nleader = "h:1"\n'
                    'backoff-max = 12.5\n')
    cfg = Config.load(str(toml))
    assert cfg.geo.role == "follower" and cfg.geo.leader == "h:1"
    assert cfg.geo.backoff_max == 12.5
    monkeypatch.setenv("PILOSA_TPU_GEO_BACKOFF", "0.25")
    cfg = Config.load(str(toml))
    assert cfg.geo.backoff == 0.25  # env beats file
    cfg = Config.load(str(toml), flags={"geo_probe_failures": 3,
                                        "geo_probe_promote": 1})
    assert cfg.geo.probe_failures == 3
    assert cfg.geo.validate().probe_promote is True  # coerced to bool
    assert "[geo]" in cfg.to_toml()
    with pytest.raises(ValueError):
        GeoConfig(role="follower").validate()  # leader required
    with pytest.raises(ValueError):
        GeoConfig(role="primary").validate()
    with pytest.raises(ValueError):
        GeoConfig(backoff=0.0).validate()


def test_geo_disabled_operator_surface(tmp_path):
    """Geo endpoints on a non-geo node: typed 400, not a crash."""
    s = Server(data_dir=str(tmp_path / "plain"), cache_flush_interval=0,
               executor_workers=0)
    s.open()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            req = urllib.request.Request(
                f"http://localhost:{s.port}/geo/promote", data=b"")
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 400
        assert "geo" in json.loads(ei.value.read())["error"]
    finally:
        s.close()
