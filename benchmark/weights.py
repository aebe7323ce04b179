"""Starting weights, made on the device from a run's seed.

One ``torch.Generator`` on the device draws every drawn leaf in one
truncated-normal call, which is then cut into leaves and scaled to each
leaf's standard deviation. A model kind (``benchmark/models/<model>.py``)
says which leaves are drawn, at what deviation, and sets the others; the
program and the reference both start from what it makes.
"""

from __future__ import annotations

import math

import torch

#: the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = .87962566103423978


def truncated_normal(drawn, seed, device):
    """``{name: float32 tensor}`` for ``drawn``, ``[(name, shape, std)]``:
    one draw of a unit normal truncated to [-2, 2], cut into the leaves in
    that order, each scaled to the standard deviation ``std``."""
    total = sum(math.prod(s) for _, s, _ in drawn)
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed) % (1 << 63))
    flat = torch.empty(total, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=generator)
    out, offset = {}, 0
    for name, shape, std in drawn:
        n = math.prod(shape)
        out[name] = flat[offset:offset + n].view(shape).mul_(std / _TRUNC_STD)
        offset += n
    return out
