"""K1's share of its roofline: the bytes its launches of the window must
read (gpubench/bounds.py k1_bytes, from each launch's shape) at the
card's peak bandwidth, over the profiler's time of the kernels named
k1_staged_kernel and k1_streaming_kernel."""

from gpubench import bounds, devtrace


def read(rec):
    nbytes = rec["launch_bytes"].get("k1")
    dev = rec["device"]
    if not nbytes or dev is None:
        return None
    t = devtrace.kernel_s(dev["intervals"], r"k1_(staged|streaming)_kernel", dev["t0"], dev["t1"])
    return bounds.roofline_pct(nbytes, t)
