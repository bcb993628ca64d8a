"""The 95th percentile of the ingest's latency over the window, on the
clients' clock: each ride due in the window, from its due time to its
answer."""

import numpy as np


def read(rec):
    lat = [w[3] - w[1] for w in rec.get("writes", [])]
    return float(np.percentile(np.asarray(lat) * 1e3, 95)) if lat else None
