"""The collective plane's reduce per read call: the recorder's
`collective.reduce` spans (parallel/collective.py _settle: one all_reduce
of the entry's counts over the job's group, NCCL where every rank has a
card of its own, and the copy of the result to the host) in the traces
of the window's read requests, over their calls."""

from gpubench.spans import per_call_ms


def read(rec):
    return per_call_ms(rec, "collective.reduce")
