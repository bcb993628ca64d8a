"""PQL read calls answered correctly in the window, over its length: a
call of a request of several counts once, a failed or wrong call not at
all, writes never. The closed-loop readers' rate, paced by the server's
host work, so it is read per layer: its runs spread wider than any
end-to-end bound allows."""


def read(rec):
    return rec["good_calls"] / rec["seconds"]
