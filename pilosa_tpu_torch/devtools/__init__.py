"""Development-time instrumentation (never imported by serving code).

lockcheck.py is the runtime half of the invariant tooling: pilint
(tools/pilint) proves lexical rules; lockcheck proves the dynamic ones —
lock-order inversions, blocking syscalls made while a lock is held, and
thread joins under a lock. See docs/static-analysis.md.
"""
