"""The most device memory the node held while it served the window:
torch.cuda.max_memory_allocated() after a reset at its start, in GiB,
read by the benchmark from the card's allocator. The resident index,
the stack cache at its budget and what the window's launches add on top:
what a card has to hold to serve this index."""


def read(rec):
    peak = rec.get("peak_window_bytes")
    return peak / 2 ** 30 if peak else None
