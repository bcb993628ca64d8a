"""base + per x (another column) + a uniform draw from [0, noise), clipped
to [lo, hi]: a fare that grows with the distance."""

import torch


def generate(spec, n, gen, device, cols):
    noise = torch.randint(0, spec["noise"], (n,), generator=gen, device=device,
                          dtype=torch.int32)
    out = spec["base"] + spec["per"] * cols[spec["of"]] + noise
    return out.clamp_(spec["lo"], spec["hi"])
