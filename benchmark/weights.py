"""The model's starting weights, made on the device from a run's seed.

One ``torch.Generator`` on the device draws every weight matrix in one
truncated-normal call, which is then cut into leaves and scaled to each
leaf's LeCun standard deviation (the program's own initialisation, flax's
default); batch-norm scales start at one (a block's last at zero) and
biases at zero. The program and the reference both start from these.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.resnet import fan_in, leaves

#: the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = .87962566103423978


def make_weights(config, seed, device):
    """``{name: float32 tensor}`` for every parameter of ``config``'s model."""
    specs = leaves(config)
    drawn = [(n, s) for n, s, kind in specs if kind in ('conv', 'head_w')]
    total = sum(math.prod(s) for _, s in drawn)
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed) % (1 << 63))
    flat = torch.empty(total, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=generator)
    out, offset = {}, 0
    for name, shape in drawn:
        n = math.prod(shape)
        std = math.sqrt(1.0 / fan_in(shape)) / _TRUNC_STD
        out[name] = flat[offset:offset + n].view(shape).mul_(std)
        offset += n
    for name, shape, kind in specs:
        if kind == 'scale':
            out[name] = torch.ones(shape, device=device)
        elif kind in ('scale0', 'bias', 'head_b'):
            out[name] = torch.zeros(shape, device=device)
    return {name: out[name] for name, _, _ in specs}
