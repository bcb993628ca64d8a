"""The engine's stack step per read call: the recorder's `engine.stack`
spans (parallel/engine.py _stacked_leaf_tensor: the probe, the build
gate's wait, a stack-delta or the leaf gathers and torch.stack; its
fingerprint walk and `gather` spans nest inside) of the window's read
requests, over their calls."""

from gpubench.spans import per_call_ms


def read(rec):
    return per_call_ms(rec, "engine.stack")
