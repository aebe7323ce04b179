"""ResNet as ``torch.nn.Module`` s: twin of ``petastorm_tpu/models/resnet.py`` (flax).

The public layout is NHWC, as in the JAX package; inside, activations run in
``channels_last``. The body computes in ``dtype`` (bf16 by default) while the
parameters, the batch-norm statistics and the logits head stay float32.
Three behaviors of the flax model are reproduced on purpose:

* ``padding='SAME'`` pads asymmetrically where the stride requires it: a 3x3
  stride-2 conv on an even input pads (0, 1), not torch's symmetric (1, 1);
* batch norm updates its running variance with the BIASED batch variance,
  ``ra = 0.9 * ra + 0.1 * batch`` (flax ``momentum=0.9``), unlike
  ``nn.BatchNorm2d``'s unbiased update;
* the last batch norm of each block has its scale zero-initialised, and the
  stem max-pool pads (1, 1).

Parameter names mirror the flax tree (``stage1_block0.conv1.weight``,
``bn_init.scale``, ``bn_init.mean``...), which keeps
:func:`petastorm_tpu_torch.models.convert.flax_to_torch` a renaming.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from petastorm_tpu_torch.parallel.collectives import all_reduce_sum


def _lecun_normal_(weight, fan_in):
    """flax's default kernel init: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)


def _same_pads(size, kernel, stride):
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), (s, s), use_bias=False)`` computing in
    ``dtype``; ``padding`` is ``'SAME'`` or ``((top, bottom), (left, right))``."""

    def __init__(self, in_features, features, kernel, stride=1, padding='SAME',
                 dtype=torch.bfloat16):
        super().__init__()
        self.kernel, self.stride, self.padding, self.dtype = kernel, stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel, kernel))
        _lecun_normal_(self.weight, in_features * kernel * kernel)

    def forward(self, x):
        if self.padding == 'SAME':
            (top, bottom), (left, right) = (_same_pads(x.shape[2], self.kernel, self.stride),
                                            _same_pads(x.shape[3], self.kernel, self.stride))
        else:
            (top, bottom), (left, right) = self.padding
        x = x.to(self.dtype)
        if (top, left) != (bottom, right):
            x = F.pad(x, (left, right, top, bottom)).contiguous(memory_format=torch.channels_last)
            top = left = 0
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride, padding=(top, left))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW tensors:
    float32 ``scale``/``bias`` parameters and ``mean``/``var`` statistics,
    normalization computed in float32 and returned in the input's dtype.

    ``sync_group``: a process group of more than one rank makes training
    take its statistics over the group's global batch, as XLA does for a
    batch sharded over ``data``: the float32 per-channel sums, sums of
    squares and row counts are summed over the group (backward too), and
    the global mean and biased variance normalise and update ``mean``/
    ``var``. With ``None`` or a group of one the local statistics are the
    global ones, and the local code runs (no collective)."""

    def __init__(self, features, momentum=0.9, eps=1e-5, zero_scale=False, sync_group=None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.sync_group = sync_group
        self.scale = nn.Parameter(torch.zeros(features) if zero_scale else torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('mean', torch.zeros(features))
        self.register_buffer('var', torch.ones(features))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.mean, self.var, self.scale, self.bias, False, 0.0, self.eps)
        if self.sync_group is not None and dist.get_world_size(self.sync_group) > 1:
            return self._synced(x)
        # batch statistics without torch's running update (which would use
        # the unbiased variance); save_invstd = 1/sqrt(biased_var + eps)
        out, batch_mean, invstd = torch.native_batch_norm(
            x, self.scale, self.bias, None, None, True, 0.0, self.eps)
        self._update(batch_mean, invstd.float().pow(-2) - self.eps)
        return out

    def _update(self, batch_mean, batch_var):
        with torch.no_grad():
            m = self.momentum
            self.mean.mul_(m).add_(batch_mean.float(), alpha=1 - m)
            self.var.mul_(m).add_(batch_var.float(), alpha=1 - m)

    def _synced(self, x):
        c = x.shape[1]
        xf = x.float()
        count = torch.full((1,), x.numel() // c, dtype=torch.float32, device=x.device)
        stats = all_reduce_sum(torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), count]),
                               self.sync_group)
        mean = stats[:c] / stats[-1]
        # flax's fast variance: E[x^2] - E[x]^2, clipped at 0
        var = (stats[c:2 * c] / stats[-1] - mean * mean).clamp_min(0)
        mul = self.scale * torch.rsqrt(var + self.eps)
        out = (xf - mean[None, :, None, None]) * mul[None, :, None, None] + \
            self.bias[None, :, None, None]
        self._update(mean.detach(), var.detach())
        return out.to(x.dtype)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_features, filters, strides=1, dtype=torch.bfloat16):
        super().__init__()
        conv = functools.partial(Conv, dtype=dtype)
        self.conv1 = conv(in_features, filters, 1)
        self.bn1 = BatchNorm(filters)
        self.conv2 = conv(filters, filters, 3, strides)
        self.bn2 = BatchNorm(filters)
        self.conv3 = conv(filters, 4 * filters, 1)
        self.bn3 = BatchNorm(4 * filters, zero_scale=True)
        self.conv_proj = self.bn_proj = None
        if strides != 1 or in_features != 4 * filters:
            self.conv_proj = conv(in_features, 4 * filters, 1, strides)
            self.bn_proj = BatchNorm(4 * filters)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.conv_proj is None else self.bn_proj(self.conv_proj(x))
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_features, filters, strides=1, dtype=torch.bfloat16):
        super().__init__()
        conv = functools.partial(Conv, dtype=dtype)
        self.conv1 = conv(in_features, filters, 3, strides)
        self.bn1 = BatchNorm(filters)
        self.conv2 = conv(filters, filters, 3)
        self.bn2 = BatchNorm(filters, zero_scale=True)
        self.conv_proj = self.bn_proj = None
        if strides != 1 or in_features != filters:
            self.conv_proj = conv(in_features, filters, 1, strides)
            self.bn_proj = BatchNorm(filters)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.conv_proj is None else self.bn_proj(self.conv_proj(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """:param stage_sizes: blocks per stage, e.g. [3, 4, 6, 3] for ResNet-50
    :param block_cls: BottleneckBlock or BasicBlock
    :param num_classes: classifier width
    :param dtype: compute dtype of the body (bf16 by default)
    :param in_channels: channels of the NHWC input
    """

    def __init__(self, stage_sizes, block_cls, num_classes=1000, num_filters=64,
                 dtype=torch.bfloat16, in_channels=3):
        super().__init__()
        self.dtype = dtype
        self.conv_init = Conv(in_channels, num_filters, 7, 2, padding=((3, 3), (3, 3)), dtype=dtype)
        self.bn_init = BatchNorm(num_filters)
        self.block_names = []
        features = num_filters
        for i, block_count in enumerate(stage_sizes):
            for j in range(block_count):
                name = 'stage{}_block{}'.format(i + 1, j)
                filters = num_filters * 2 ** i
                setattr(self, name, block_cls(features, filters, 2 if i > 0 and j == 0 else 1,
                                              dtype=dtype))
                self.block_names.append(name)
                features = filters * block_cls.expansion
        self.head = nn.Linear(features, num_classes)
        _lecun_normal_(self.head.weight, features)
        nn.init.zeros_(self.head.bias)

    def forward(self, x):
        """``x``: ``(B, H, W, C)``; returns float32 ``(B, num_classes)`` logits."""
        x = x.permute(0, 3, 1, 2).to(self.dtype).contiguous(memory_format=torch.channels_last)
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        return self.head(x.float())


resnet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock)
resnet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BottleneckBlock)
resnet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3], block_cls=BottleneckBlock)
resnet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3], block_cls=BottleneckBlock)
