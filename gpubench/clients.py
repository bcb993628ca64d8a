"""The load generator's process: closed-loop readers, each on its own
keep-alive HTTP connection, and an open-loop ingest, standard library
only, so their JSON and socket work does not share the server's
interpreter lock.

    python3 gpubench/clients.py < plan.json > records.json

The plan: {"ports", "index", "t0", "t_end", "readers": [[[tag, pql],
...] per reader], "rides": [[due, tag, pql], ...]}; "ports" are the
nodes' ports (a plan of one node may give "port" instead). Times are
CLOCK_MONOTONIC seconds, which every process of the machine shares. Each
reader waits for t0, then sends its list in order, wrapping around, one
request after the other, until t_end; reader i sends to node i mod N.
Each ride due before t_end is sent at its due time by a thread of its
own, on an idle keep-alive connection to its node or a new one, whatever
the rides in flight are doing; ride k goes to node k mod N. The records:
{"reads": [[reader, tag, t_send, t_recv, status, body]], "writes": [[tag,
due, t_send, t_recv, status, body]]}; a request that raised has status 0
and the error as its body.

`query_all` is the harness's: it sends the warm-up and the read-back.
"""

import http.client
import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor


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
    ports = plan.get("ports") or [plan["port"]]
    path = "/index/%s/query" % plan["index"]
    t0, t_end = plan["t0"], plan["t_end"]
    reads = [[] for _ in plan["readers"]]
    writes = []
    rides = plan.get("rides", [])
    idle = {p: [] for p in ports}  # the ingest's keep-alive connections not in use
    lock = threading.Lock()

    def reader(i):
        work = plan["readers"][i]
        port = ports[i % len(ports)]
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
        port = ports[tag % len(ports)]
        with lock:
            box = [idle[port].pop() if idle[port] else None]
        t_send = time.monotonic()
        status, body = _send(box, port, path, pql)
        rec = [tag, due, t_send, time.monotonic(), status, body]
        with lock:
            writes.append(rec)
            if box[0] is not None:
                idle[port].append(box[0])

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
        for conns in idle.values():
            for conn in conns:
                conn.close()

    threads = [threading.Thread(target=reader, args=(i,)) for i in range(len(plan["readers"]))]
    if rides:
        threads.append(threading.Thread(target=ingest))
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return {"reads": [r for rs in reads for r in rs], "writes": writes}


def query_all(ports, index, pqls):
    """Each query's results (or None) over keep-alive connections, query
    j to the node of ports[j mod N]: every node in turn."""
    local = threading.local()

    def one(j, pql):
        conns = getattr(local, "conns", None)
        if conns is None:
            conns = local.conns = {}
        port = ports[j % len(ports)]
        conn = conns.get(port)
        if conn is None:
            conn = conns[port] = http.client.HTTPConnection("localhost", port, timeout=600)
        conn.request("POST", "/index/%s/query" % index, body=pql.encode())
        r = conn.getresponse()
        body = r.read().decode()
        if r.status != 200:
            return None
        return json.loads(body)["results"]

    with ThreadPoolExecutor(max_workers=8) as pool:
        return list(pool.map(one, range(len(pqls)), pqls))


if __name__ == "__main__":
    json.dump(run(json.load(sys.stdin)), sys.stdout)
