"""The engine's time per read call that its spans do not explain: the
time inside the device rung's `device.dispatch` spans that no span
starting inside them covers (gpubench/spans.py)."""

from gpubench.spans import dispatch_self_ms


def read(rec):
    return dispatch_self_ms(rec)
