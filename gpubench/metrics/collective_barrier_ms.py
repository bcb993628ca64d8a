"""The collective plane's barrier per read call: the recorder's
`collective.barrier` spans (parallel/collective.py _barrier: every rank
of the job arriving, decided in the job's store) in the traces of the
window's read requests, over their calls."""

from gpubench.spans import per_call_ms


def read(rec):
    return per_call_ms(rec, "collective.barrier")
