"""The collective plane's entry per read call: the recorder's
`collective.entry` spans (parallel/collective.py _enter: the descriptor's
checks, this rank's blocks of the batch's leaves, K1, the barrier and
the reduce) in the traces of the window's read requests, over their
calls. A batch's spans land in its leader's trace."""

from gpubench.spans import per_call_ms


def read(rec):
    return per_call_ms(rec, "collective.entry")
