"""Small MNIST convnet: twin of ``petastorm_tpu/models/mnist.py`` (flax).

Two 3x3 SAME convolutions (32 and 64 channels), each with ReLU and a 2x2
stride-2 average pool, then dense 128 with ReLU and a float32 dense head.
The public layout is NHWC (or ``(B, 28, 28)``), as in the JAX package; the
convolutions run in ``channels_last``. The body computes in ``dtype`` while
the parameters stay float32, and the head computes in float32, as flax's
``dtype=`` does. The flatten before ``Dense_0`` is in H, W, C order, flax's,
so the submodules ``Conv_0``, ``Conv_1``, ``Dense_0`` and ``Dense_1`` take
the flax tree through :func:`petastorm_tpu_torch.models.convert.flax_to_torch`
unchanged. Kernels start from flax's default init (LeCun normal, zero bias).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from petastorm_tpu_torch.models.resnet import _lecun_normal_


class _Conv(nn.Module):
    """flax ``nn.Conv(features, (3, 3))``: SAME padding, with bias, computing
    in ``dtype``."""

    def __init__(self, in_features, features, dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))
        _lecun_normal_(self.weight, in_features * 9)

    def forward(self, x):
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype),
                        padding=1)


class _Dense(nn.Module):
    """flax ``nn.Dense(features)`` computing in ``dtype``."""

    def __init__(self, in_features, features, dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))
        _lecun_normal_(self.weight, in_features)

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


class MnistCNN(nn.Module):
    """``(B, 28, 28)`` or ``(B, 28, 28, 1)`` images (any dtype) -> float32
    ``(B, num_classes)`` logits."""

    def __init__(self, num_classes=10, dtype=torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.Conv_0 = _Conv(1, 32, dtype)
        self.Conv_1 = _Conv(32, 64, dtype)
        self.Dense_0 = _Dense(7 * 7 * 64, 128, dtype)
        self.Dense_1 = _Dense(128, num_classes, torch.float32)

    def forward(self, x):
        x = x.to(self.dtype)
        if x.dim() == 3:
            x = x[..., None]  # HWC with a single channel
        x = x.permute(0, 3, 1, 2)  # NHWC memory read as NCHW: channels_last
        x = F.avg_pool2d(F.relu(self.Conv_0(x)), 2, 2)
        x = F.avg_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).flatten(1)  # flax's H, W, C order
        x = F.relu(self.Dense_0(x))
        return self.Dense_1(x)
