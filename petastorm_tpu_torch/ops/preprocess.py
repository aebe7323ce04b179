"""Fused on-device image normalization (uint8 -> bf16/f32, mean/std).

Twin of ``petastorm_tpu/ops/preprocess.py``. The reader ships uint8 and this
op casts, subtracts the mean and multiplies by ``1/std`` in one pass on the
card: on a CUDA tensor it launches the Triton kernel
(:mod:`petastorm_tpu_torch.ops.kernels.normalize`); on a CPU tensor it runs
the kernel's plain PyTorch version. There is no other fallback.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from petastorm_tpu_torch.ops.kernels.normalize import normalize_reference, normalize_triton


def _as_channel_row(values, channels, name):
    """Scalar or ``(C,)`` stats -> float32 ``(C,)``. The TPU kernel tiles this
    into a ``(1, W*C)`` row; the Hopper kernel indexes it by ``offset % C``."""
    arr = np.asarray(values, dtype=np.float32)
    if arr.ndim == 0:
        arr = np.full(channels, float(arr), np.float32)
    if arr.shape != (channels,):
        raise ValueError('{} must be a scalar or shape ({},), got {}'.format(
            name, channels, arr.shape))
    return arr


@functools.lru_cache(maxsize=64)
def _stats_on(device, mean_bytes, inv_std_bytes):
    """The float32 stats as tensors on ``device``, cached so a train loop
    does not pay a host->device copy per step."""
    return tuple(torch.from_numpy(np.frombuffer(b, np.float32).copy()).to(device)
                 for b in (mean_bytes, inv_std_bytes))


def normalize_images(images, mean, std, out_dtype=torch.bfloat16):
    """``(images - mean) / std`` with cast, fused on the device.

    :param images: ``(B, H, W, C)`` or ``(H, W, C)`` uint8/integer/float tensor
    :param mean/std: scalar or per-channel ``(C,)`` values, in the units of
        ``images`` (e.g. 0-255 for uint8 ImageNet stats)
    :param out_dtype: ``torch.bfloat16`` (default) or ``torch.float32``
    """
    if images.dim() not in (3, 4):
        raise ValueError('images must be (B, H, W, C) or (H, W, C), got shape {}'.format(
            tuple(images.shape)))
    c = images.shape[-1]
    mean_c = _as_channel_row(mean, c, 'mean')
    std_c = _as_channel_row(std, c, 'std')
    if np.any(std_c == 0):
        raise ValueError('std must be non-zero')
    inv_std_c = (1.0 / std_c).astype(np.float32)
    mean_t, inv_t = _stats_on(images.device, mean_c.tobytes(), inv_std_c.tobytes())
    if images.is_cuda:
        return normalize_triton(images.contiguous(), mean_t, inv_t, out_dtype)
    if images.device.type != 'cpu':
        raise ValueError('normalize_images runs on CUDA or CPU tensors, got {}'.format(
            images.device))
    return normalize_reference(images, mean_t, inv_t, out_dtype)
