"""The ingest is open-loop: each ride goes out at its due time whatever
the rides in flight are doing, and the run's ingest checks read its
delivered rate and how far it fell behind."""

import http.server
import threading
import time

import pytest

from gpubench import clients, harness


class _Slow(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_POST(self):
        self.rfile.read(int(self.headers["Content-Length"]))
        time.sleep(0.5)
        body = b'{"results": [true]}'
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


@pytest.fixture
def slow_server():
    srv = http.server.ThreadingHTTPServer(("localhost", 0), _Slow)
    srv.daemon_threads = True
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield srv.server_address[1]
    srv.shutdown()
    srv.server_close()


def test_rides_go_out_on_time_while_earlier_ones_wait(slow_server):
    # 20 rides a second against a server that answers each in 0.5 s: a
    # pool of a few connections would fall behind; the ingest does not.
    t0 = time.monotonic() + 0.2
    rides = [[t0 + k / 20, k, "Set(1, f=1)"] for k in range(30)]
    out = clients.run({"port": slow_server, "index": "i", "t0": t0, "t_end": t0 + 10,
                       "readers": [], "rides": rides})
    writes = sorted(out["writes"])
    assert [w[0] for w in writes] == list(range(30))
    assert max(w[2] - w[1] for w in writes) < 0.1
    assert all(w[4] == 200 and 0.45 < w[3] - w[2] < 2.0 for w in writes)
    behind, delivered = harness._ingest(writes, t0, t0 + 10)
    assert 0.45 < behind < 2.0
    assert delivered == pytest.approx(3.0)


def test_the_ingest_checks_count_late_and_unanswered_rides():
    # [tag, due, sent, answered, status, body]
    writes = [[0, 0.0, 0.0, 0.2, 200, ""], [1, 1.0, 1.0, 7.5, 200, ""],
              [2, 2.0, 2.0, 2.1, 0, "ConnectionResetError"], [3, 9.5, 9.5, 10.5, 200, ""]]
    behind, delivered = harness._ingest(writes, 0.0, 10.0)
    assert behind == pytest.approx(6.5)
    assert delivered == pytest.approx(2 / 10)
    assert not harness._holds(behind, "<=", 5.0)
    assert harness._holds(delivered, ">=", 0.2)
