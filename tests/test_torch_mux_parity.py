"""The mux transport across the two packages, on the CPU.

A two-node cluster of one pilosa_tpu node and one port node (replica_n =
1, so every answer crosses the packages) with `[transport] enabled` on
both: the pmux handshake succeeds both ways and each node serves the
other's shards over the mux. With the mux disabled on one side, the
other's handshake fails and it falls back to HTTP. In every case each
node answers Count, Row, TopN and Sum as one pilosa_tpu node holding all
the data does.
"""

import json
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from pilosa_tpu.cluster.hash import ModHasher as JModHasher
from pilosa_tpu.parallel import EngineConfig as JEngineConfig
from pilosa_tpu.server.mux import TransportConfig as JTransportConfig
from pilosa_tpu.server.server import Server as JServer
from pilosa_tpu_torch.cluster.hash import ModHasher as TModHasher
from pilosa_tpu_torch.server.mux import TransportConfig as TTransportConfig
from pilosa_tpu_torch.server.server import Server as TServer

W = 1 << 20  # SHARD_WIDTH
N_SHARDS = 4
MUX_OFF = 2000
READS = ["Count(Row(f=1))", "Count(Intersect(Row(f=1), Row(f=2)))", "Row(f=2)",
         "TopN(f, n=5)", "Sum(field=v)", "Sum(Row(f=1), field=v)"]


def free_port_pair():
    """A free HTTP port whose mux twin (port + MUX_OFF) is free too."""
    for _ in range(64):
        s = socket.socket()
        s.bind(("localhost", 0))
        p = s.getsockname()[1]
        s.close()
        if p + MUX_OFF > 65000:
            continue
        probe = socket.socket()
        try:
            probe.bind(("localhost", p + MUX_OFF))
        except OSError:
            continue
        finally:
            probe.close()
        return p
    raise RuntimeError("no free http+mux port pair")


def make(pkg, data_dir, port, hosts, mux):
    kw = dict(data_dir=str(data_dir), port=port, cluster_hosts=hosts, replica_n=1,
              cache_flush_interval=0, anti_entropy_interval=0,
              member_monitor_interval=0, executor_workers=0)
    if pkg == "jax":
        tc = JTransportConfig(enabled=True, port_offset=MUX_OFF) if mux else None
        return JServer(engine_config=JEngineConfig(gather_workers=1), hasher=JModHasher(),
                       transport_config=tc, **kw).open()
    tc = TTransportConfig(enabled=True, port_offset=MUX_OFF) if mux else None
    return TServer(device="cpu", hasher=TModHasher(), transport_config=tc, **kw).open()


def post(port, path, body):
    req = urllib.request.Request(f"http://localhost:{port}{path}", data=body.encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def load(port, rng):
    post(port, "/index/i", "{}")
    post(port, "/index/i/field/f", "{}")
    post(port, "/index/i/field/v", '{"options": {"type": "int", "min": 0, "max": 1000}}')
    for _ in range(80):
        col = int(rng.integers(N_SHARDS * W))
        if rng.integers(3):
            post(port, "/index/i/query", f"Set({col}, f={int(rng.integers(1, 4))})")
        else:
            post(port, "/index/i/query", f"Set({col}, v={int(rng.integers(0, 1000))})")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """One pilosa_tpu node holding all the data."""
    port = free_port_pair()
    srv = make("jax", tmp_path_factory.mktemp("one"), port, [f"localhost:{port}"], False)
    try:
        load(port, np.random.default_rng(5))
        yield [post(port, "/index/i/query", q) for q in READS]
    finally:
        srv.close()


@pytest.mark.parametrize("mux", ["both", "jax_only", "torch_only"])
def test_mixed_cluster_over_the_mux(tmp_path, reference, mux):
    ports = [free_port_pair() for _ in range(2)]
    hosts = [f"localhost:{p}" for p in ports]
    on = {"jax": mux in ("both", "jax_only"), "torch": mux in ("both", "torch_only")}
    servers = []
    try:
        for pkg, port in zip(("jax", "torch"), ports):
            servers.append(make(pkg, tmp_path / pkg, port, hosts, on[pkg]))
        load(ports[0], np.random.default_rng(5))
        for port in ports:
            assert [post(port, "/index/i/query", q) for q in READS] == reference
        for pkg, srv in zip(("jax", "torch"), servers):
            st = srv.transport_stats.snapshot()
            if mux == "both":
                assert st["requests_mux"] > 0 and st["handshake_fallbacks"] == 0, (pkg, st)
                assert st["requests_http"] == 0, (pkg, st)
            elif on[pkg]:
                # The peer has no mux listener: the handshake fails and
                # this node's requests to it go over HTTP.
                assert st["requests_mux"] == 0 and st["requests_http"] > 0, (pkg, st)
            else:
                assert srv.mux_transport is None and st["requests_mux"] == 0, (pkg, st)
    finally:
        for s in servers:
            s.close()


def test_closed_listener_ends_its_connections(tmp_path, reference):
    """A node's MuxServer.close() ends the connections it accepted, so a
    peer sees its connection end, redials, is refused and serves its next
    requests to that node over HTTP with the same answers. (The
    reference closes the sockets without shutting them down: a peer's
    connection stays open and its next request waits out the mux
    timeout.)"""
    ports = [free_port_pair() for _ in range(2)]
    hosts = [f"localhost:{p}" for p in ports]
    servers = []
    try:
        for i, port in enumerate(ports):
            servers.append(make("torch", tmp_path / f"n{i}", port, hosts, True))
        load(ports[0], np.random.default_rng(5))
        a, b = servers
        assert [post(a.port, "/index/i/query", q) for q in READS] == reference
        conn = a.mux_transport._conns[b.node.uri]
        assert not conn.closed
        before = a.transport_stats.snapshot()
        b.mux_server.close()
        assert _wait(lambda: conn.closed)
        assert [post(a.port, "/index/i/query", q) for q in READS] == reference
        after = a.transport_stats.snapshot()
        assert after["requests_http"] > before["requests_http"], after
        assert after["handshake_fallbacks"] > before["handshake_fallbacks"], after
    finally:
        for s in servers:
            s.close()


def test_closed_listener_mid_request_falls_back_to_http(tmp_path, reference):
    """A Count whose sub-query is inside node b's mux dispatch when b's
    MuxServer.close() runs is answered over HTTP with the reference's
    answer, and so are the reads after it: the closed connection is not
    taken for b being down, and a redial is refused, not accepted and
    dropped."""
    ports = [free_port_pair() for _ in range(2)]
    hosts = [f"localhost:{p}" for p in ports]
    servers = []
    try:
        for i, port in enumerate(ports):
            servers.append(make("torch", tmp_path / f"n{i}", port, hosts, True))
        load(ports[0], np.random.default_rng(5))
        a, b = servers
        assert [post(a.port, "/index/i/query", q) for q in READS] == reference
        conn = a.mux_transport._conns[b.node.uri]
        entered, release = threading.Event(), threading.Event()
        inner = b.mux_server.handler

        class Held:
            """b's handler, holding the first query it is given."""

            def dispatch(self, method, path, *args, **kwargs):
                if path.endswith("/query") and not entered.is_set():
                    entered.set()
                    release.wait(30.0)
                return inner.dispatch(method, path, *args, **kwargs)

        b.mux_server.handler = Held()
        before = a.transport_stats.snapshot()
        out = {}

        def ask():
            try:
                out["r"] = post(a.port, "/index/i/query", READS[0])
            except urllib.error.HTTPError as e:
                out["r"] = (e.code, e.read().decode(errors="replace"))

        asker = threading.Thread(target=ask, daemon=True)
        asker.start()
        assert entered.wait(30.0)
        closer = threading.Thread(target=b.mux_server.close, daemon=True)
        closer.start()
        assert _wait(lambda: conn.closed)
        release.set()
        closer.join(30.0)
        asker.join(60.0)
        assert out["r"] == reference[0]
        assert [post(a.port, "/index/i/query", q) for q in READS] == reference
        after = a.transport_stats.snapshot()
        assert after["requests_http"] > before["requests_http"], after
    finally:
        release.set()
        for s in servers:
            s.close()


def _wait(cond, timeout=10.0):
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()
