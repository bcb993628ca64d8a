"""The load generator's process: closed-loop readers, each on its own
keep-alive HTTP connection, and an open-loop ingest, standard library
only, so their JSON and socket work does not share the server's
interpreter lock.

    python3 gpubench/clients.py < plan.json > records.json

The plan: {"port", "index", "t0", "t_end", "readers": [[[tag, pql], ...]
per reader], "rides": [[due, tag, pql], ...]}. Times are CLOCK_MONOTONIC
seconds, which every process of the machine shares. Each reader waits
for t0, then sends its list in order, wrapping around, one request after
the other, until t_end. Each ride due before t_end is sent at its due
time by a thread of its own, on an idle keep-alive connection or a new
one, whatever the rides in flight are doing. The records:
{"reads": [[reader, tag, t_send, t_recv, status, body]], "writes": [[tag,
due, t_send, t_recv, status, body]]}; a request that raised has status 0
and the error as its body.
"""

import http.client
import json
import sys
import threading
import time


def _send(conn_box, port, path, pql):
    """(status, body) of one POST, on a fresh connection after an error."""
    try:
        if conn_box[0] is None:
            conn_box[0] = http.client.HTTPConnection("localhost", port, timeout=300)
        conn = conn_box[0]
        conn.request("POST", path, body=pql.encode())
        r = conn.getresponse()
        return r.status, r.read().decode()
    except (OSError, http.client.HTTPException) as e:
        if conn_box[0] is not None:
            conn_box[0].close()
        conn_box[0] = None
        return 0, f"{type(e).__name__}: {e}"


def _sleep_until(t):
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def run(plan):
    port = plan["port"]
    path = "/index/%s/query" % plan["index"]
    t0, t_end = plan["t0"], plan["t_end"]
    reads = [[] for _ in plan["readers"]]
    writes = []
    rides = plan.get("rides", [])
    idle = []  # the ingest's keep-alive connections not in use
    lock = threading.Lock()

    def reader(i):
        work = plan["readers"][i]
        box = [http.client.HTTPConnection("localhost", port, timeout=300)]
        out = reads[i]
        _sleep_until(t0)
        j = 0
        while work:
            t_send = time.monotonic()
            if t_send >= t_end:
                break
            tag, pql = work[j % len(work)]
            status, body = _send(box, port, path, pql)
            out.append([i, tag, t_send, time.monotonic(), status, body])
            j += 1
        if box[0] is not None:
            box[0].close()

    def ride(due, tag, pql):
        with lock:
            box = [idle.pop() if idle else None]
        t_send = time.monotonic()
        status, body = _send(box, port, path, pql)
        rec = [tag, due, t_send, time.monotonic(), status, body]
        with lock:
            writes.append(rec)
            if box[0] is not None:
                idle.append(box[0])

    def ingest():
        sent = []
        for due, tag, pql in rides:
            if due >= t_end:
                break
            _sleep_until(due)
            th = threading.Thread(target=ride, args=(due, tag, pql))
            th.start()
            sent.append(th)
        for th in sent:
            th.join()
        for conn in idle:
            conn.close()

    threads = [threading.Thread(target=reader, args=(i,)) for i in range(len(plan["readers"]))]
    if rides:
        threads.append(threading.Thread(target=ingest))
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return {"reads": [r for rs in reads for r in rs], "writes": writes}


if __name__ == "__main__":
    json.dump(run(json.load(sys.stdin)), sys.stdout)
