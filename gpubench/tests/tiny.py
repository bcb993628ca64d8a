"""A cell at a few shards on the CPU, for the tests."""


def tiny_hooks(device="cpu", after_server=None, seconds_warm=1):
    """Hooks that run a cell at a few shards on the CPU."""
    from gpubench import harness

    h = harness.Hooks()
    h.device = device
    h.shards_per_block = 2
    h.after_server = after_server

    def cfg(c):
        c["columns_total"] = (3 << 20) + 300000
        return c

    def cell(c):
        c["readers"] = 4
        c["requests_per_reader"] = 60
        c["warmup_s"] = seconds_warm
        if c.get("ingest"):
            c["ingest"]["first_column"] = (3 << 20) + 300000
        return c

    h.config, h.cell = cfg, cell
    return h


def tiny_cluster_hooks(rank_fault=None, seconds_warm=1):
    """Hooks that run a cell of several nodes on the CPU, every rank on
    the CPU (gloo), at 14 shards: the placement then gives every one of
    four nodes some shards, and the last one, which the rides append to,
    to node 1."""
    h = tiny_hooks(seconds_warm=seconds_warm)
    h.rank_fault = rank_fault
    total = (13 << 20) + 300000

    def cfg(c):
        c["columns_total"] = total
        return c

    cell = h.cell

    def cell4(c):
        c = cell(c)
        c["ingest"]["first_column"] = total
        return c

    h.config, h.cell = cfg, cell4
    return h
