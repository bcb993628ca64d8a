"""The host's wait for the card per read call: the recorder's
`device.sync` spans (parallel/engine.py: the blocking read-backs of
count, count_batch, TopN and BSI values) of the window's read requests,
over their calls."""

from gpubench.spans import per_call_ms


def read(rec):
    return per_call_ms(rec, "device.sync")
