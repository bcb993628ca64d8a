"""The engine's fingerprint walks per read call: the recorder's
`engine.fingerprint` spans (parallel/engine.py: one U x S walk of
fragment lookups each, at a memo probe, a stack's check or a leaf's
gather) of the window's read requests, over their calls."""

from gpubench.spans import per_call_ms


def read(rec):
    return per_call_ms(rec, "engine.fingerprint")
