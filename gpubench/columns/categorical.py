"""A column drawn from a fixed list of values with given weights (a set
field's rows, with the source's skew)."""

import torch


def rows(spec):
    return list(spec["rows"])


def generate(spec, n, gen, device, cols):
    w = torch.tensor(spec["weights"], dtype=torch.float64, device=device)
    cum = torch.cumsum(w, 0) / w.sum()
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    idx = torch.searchsorted(cum, u, right=True).clamp_(max=len(spec["rows"]) - 1)
    return torch.tensor(spec["rows"], dtype=torch.int32, device=device)[idx]
