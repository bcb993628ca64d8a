"""A column drawn from a fixed list of values with weights that depend on
another column's value (`of`): `weights_by` maps each of its values to
the weights of `rows` (green cabs only from 2013)."""

import torch


def rows(spec):
    return list(spec["rows"])


def generate(spec, n, gen, device, cols):
    keys = sorted(int(k) for k in spec["weights_by"])
    w = torch.tensor([spec["weights_by"][str(k)] for k in keys], dtype=torch.float64,
                     device=device)
    cum = torch.cumsum(w, 1) / w.sum(1, keepdim=True)
    parent = torch.searchsorted(torch.tensor(keys, dtype=torch.int64, device=device),
                                cols[spec["of"]].to(torch.int64))
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    idx = (u.unsqueeze(1) >= cum[parent]).sum(1).clamp_(max=len(spec["rows"]) - 1)
    return torch.tensor(spec["rows"], dtype=torch.int32, device=device)[idx]
