"""The cases of tests/test_transport.py, run against the port on the CPU.

InternalClient keep-alive pooling: reuse, idle eviction, retry policy,
and server-side connection severing on close."""

import threading
import time

import pytest

from pilosa_tpu_torch.server.client import ClientError, InternalClient
from pilosa_tpu_torch.server.server import Server as _Server


def Server(*args, **kw):
    """The port's server on the CPU."""
    kw.setdefault("device", "cpu")
    return _Server(*args, **kw)


@pytest.fixture
def server(tmp_path):
    s = Server(data_dir=str(tmp_path / "t"), cache_flush_interval=0,
               member_monitor_interval=0)
    s.open()
    yield s
    s.close()


def _pool(client):
    return getattr(client._local, "conns", {})


def test_connection_reused_within_idle_window(server):
    c = InternalClient()
    h = f"localhost:{server.port}"
    c.status(h)
    conn1 = next(iter(_pool(c).values()))[0]
    c.status(h)
    conn2 = next(iter(_pool(c).values()))[0]
    assert conn1 is conn2, "keep-alive connection was not reused"


def test_idle_connection_not_reused(server, monkeypatch):
    c = InternalClient()
    h = f"localhost:{server.port}"
    c.status(h)
    conn1 = next(iter(_pool(c).values()))[0]
    monkeypatch.setattr(InternalClient, "IDLE_REUSE_S", 0.0)
    c.status(h)
    conn2 = next(iter(_pool(c).values()))[0]
    assert conn1 is not conn2, "stale-idle connection was reused"


def test_pool_is_per_thread(server):
    c = InternalClient()
    h = f"localhost:{server.port}"
    c.status(h)
    main_conn = next(iter(_pool(c).values()))[0]
    seen = {}

    def worker():
        c.status(h)
        seen["conn"] = next(iter(_pool(c).values()))[0]

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert seen["conn"] is not main_conn


def test_stale_pooled_connection_recovers_for_get(server, tmp_path):
    """Server restart on the same port: the pooled connection is dead; a
    GET must silently retry on a fresh connection."""
    c = InternalClient()
    h = f"localhost:{server.port}"
    c.status(h)
    port = server.port
    server.close()
    s2 = Server(data_dir=str(tmp_path / "t2"), port=port,
                cache_flush_interval=0, member_monitor_interval=0)
    s2.open()
    try:
        # The pooled connection points at the dead server's socket; the
        # GET retries once on a fresh connection and succeeds.
        assert c.status(h)["state"]
    finally:
        s2.close()


def test_dead_server_errors_fast(server):
    c = InternalClient(timeout=2.0)
    h = f"localhost:{server.port}"
    c.status(h)
    server.close()
    with pytest.raises(ClientError):
        c.status(h)


def test_server_close_severs_keepalive_connections(server):
    """A closed node must stop answering pooled peers: without severing,
    zombie keep-alive handler threads keep serving after close()."""
    c = InternalClient(timeout=2.0)
    h = f"localhost:{server.port}"
    c.status(h)  # establish the pooled connection
    server.close()
    deadline = time.time() + 5
    while time.time() < deadline:
        try:
            c.status(h)
        except ClientError:
            break
        time.sleep(0.05)
    else:
        raise AssertionError("closed server still answers pooled connections")
