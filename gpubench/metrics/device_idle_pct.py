"""The device's idle share of the traced window: 100 x (1 - the union of
its busy intervals (kernels, copies, fills) / the window's length)."""


def read(rec):
    dev = rec["device"]
    if dev is None or dev["window_s"] <= 0 or dev["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
