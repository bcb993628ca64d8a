"""The 95th percentile of the read requests' latency over the window, on
the clients' clock (send to answer), every read request counted."""

import numpy as np


def read(rec):
    lat = [r[3] - r[2] for r in rec["reads"]]
    return float(np.percentile(np.asarray(lat) * 1e3, 95)) if lat else None
