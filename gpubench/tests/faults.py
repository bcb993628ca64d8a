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


def drop_forwarded_writes(srv):
    """Writes forwarded from the node that received them to the shard's
    owner acknowledged there and never applied: the guarantee of a
    cluster's configuration (an acknowledged write is visible to every
    later read at every node) broken on the owner's side."""
    ex = srv.executor
    set_bit, set_value = ex._execute_set_bit, ex._execute_set_value
    ex._execute_set_bit = lambda index, c, opt: True if opt.remote else set_bit(index, c, opt)
    ex._execute_set_value = (lambda index, c, opt:
                             None if opt.remote else set_value(index, c, opt))


def skip_reduce(srv):
    """The exchange between the ranks left out: each rank's part of a
    collective entry stands for the whole job's (in this process)."""
    from pilosa_tpu_torch.parallel import distributed

    distributed.all_reduce_sum = lambda values: values


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
       "half_shards": half_shards, "drop_forwarded_writes": drop_forwarded_writes,
       "skip_reduce": skip_reduce}
