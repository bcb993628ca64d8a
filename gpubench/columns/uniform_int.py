"""A column of whole numbers drawn uniformly from [lo, hi]."""

import torch


def rows(spec):
    return list(range(spec["lo"], spec["hi"] + 1))


def generate(spec, n, gen, device, cols):
    return torch.randint(spec["lo"], spec["hi"] + 1, (n,), generator=gen, device=device,
                         dtype=torch.int32)
