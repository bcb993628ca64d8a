"""Faults planted under a run's timed path, to see `correct` come out
false: each takes the open server and changes what its executor does,
in this process only. Used by the CPU tests at a few shards and by the
card test at the cells' own sizes."""

READS = ("Count", "Sum")


def alter_answers(srv):
    """An answer altered where it is produced: every read call's result
    is one more than the engine's (a Sum's value)."""
    ex = srv.executor
    orig = ex._execute_call

    def call(index, c, shards, opt):
        r = orig(index, c, shards, opt)
        if c.name == "Count" and isinstance(r, int):
            return r + 1
        if c.name == "Sum" and hasattr(r, "val"):
            return type(r)(r.val + 1, r.count)
        return r

    ex._execute_call = call


def drop_writes(srv):
    """Writes acknowledged and never applied: the taxi configuration's
    guarantee (an acknowledged write is visible to every later read)
    broken."""
    ex = srv.executor
    ex._execute_set_bit = lambda index, c, opt: True
    ex._execute_set_value = lambda index, c, opt: None


def _shards_cut(srv, keep):
    ex = srv.executor
    orig = ex._execute_call

    def call(index, c, shards, opt):
        if c.name in READS and shards:
            shards = keep(list(shards))
        return orig(index, c, shards, opt)

    ex._execute_call = call


def half_shards(srv):
    """Half of each read left out: the calls run over the first half of
    the shards."""
    _shards_cut(srv, lambda s: s[: len(s) // 2])


ALL = {"alter_answers": alter_answers, "drop_writes": drop_writes,
       "half_shards": half_shards}
