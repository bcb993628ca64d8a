"""Seconds from the process's start to the window's: the kernels' build
where it is not cached, the server, the index made from the seed, its
planes made resident, and the warm-up of the cell's own traffic."""


def read(rec):
    return rec["setup_s"]
