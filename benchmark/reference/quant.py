"""Lower precision for the plain references' controls, in plain PyTorch.

:func:`fp8` rounds a float32 tensor to float8 and back: e4m3 on the way
forward, and the gradient flowing back through it to e5m2, each at a
per-tensor scale that maps the tensor's largest magnitude to the type's.
"""

from __future__ import annotations

import torch


def _round(x, dtype, largest):
    """``x`` rounded to the float8 ``dtype`` at a per-tensor scale that maps
    its largest magnitude to the type's, back in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / largest
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    """e4m3 forward, e5m2 backward."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, 57344.0)


fp8 = _Fp8.apply
