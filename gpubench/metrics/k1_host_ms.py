"""K1's host work per read call: the recorder's `k1.stage` spans
(ops/kernels.py gather_expr_count_blocks: checks, plan, staging buffer
and its copies, up to the last launch's return) of the window's read
requests, over their calls."""

from gpubench.spans import per_call_ms


def read(rec):
    return per_call_ms(rec, "k1.stage")
