"""Hopper kernel: fused image normalization ``(float32(x) - mean[c]) * inv_std[c]``.

Replaces the TPU kernel ``petastorm_tpu/ops/preprocess.py:_normalize_pallas``
(body ``_kernel``), which viewed the NHWC batch as a 2-D ``(N*H, W*C)`` array
in 256x512 VMEM blocks with the channel stats tiled into ``(1, W*C)`` rows.

The work is one elementwise pass with no reuse, so it is bound by memory:
for the main path's uint8 -> bf16 at 64x160x160x3 (4.9 M elements) it must
read 1 B and write 2 B per element, 14.7 MB, about 4.4 us at the H100's
3.35 TB/s. The design moves exactly those bytes once:

* a flat 1-D grid over all ``N*H*W*C`` elements with a masked tail, so any
  shape (ragged rows, odd widths, one channel) takes the same path;
* ``BLOCK`` contiguous elements per program, which Triton splits into wide
  per-thread chunks (16-byte vector loads of uint8, stores of bf16);
* the channel of an element is ``offset % C`` with ``C`` a compile-time
  constant, and the C means / inverse stds come from a tiny device tensor
  that stays in L1, instead of materialized ``(1, W*C)`` rows;
* integer input widens through int32 to float32 (as the TPU kernel does);
  float input converts straight to float32 and is never truncated;
* the output type (bf16 or f32) is the output pointer's, specialized at
  compile time.

``triton`` is imported inside the launching function only, so this module
imports on hosts without it. ``normalize_reference`` is the plain PyTorch
version of the same arithmetic: the CPU path and the yardstick the card run
compares the kernel with.
"""

from __future__ import annotations

import torch

#: launches of the Triton kernel since import (or since a caller reset it):
#: proof that a run went through the kernel and not the plain version
launches = 0

_BLOCK = 4096
_NUM_WARPS = 8

_INT_DTYPES = (torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64)
_FLOAT_DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64)
_OUT_DTYPES = (torch.bfloat16, torch.float32)

_kernel = None


def _build_kernel():
    """Import Triton and define the kernel on first launch."""
    global _kernel
    if _kernel is not None:
        return _kernel
    import triton
    import triton.language as tl

    @triton.jit
    def normalize_kernel(x_ptr, mean_ptr, inv_std_ptr, out_ptr, n_elements,
                         C: tl.constexpr, IS_INT: tl.constexpr, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n_elements
        x = tl.load(x_ptr + offs, mask=mask, other=0)
        if IS_INT:
            x = x.to(tl.int32)
        x = x.to(tl.float32)
        ch = offs % C
        mean = tl.load(mean_ptr + ch, mask=mask, other=0.0)
        inv_std = tl.load(inv_std_ptr + ch, mask=mask, other=1.0)
        y = (x - mean) * inv_std
        tl.store(out_ptr + offs, y.to(out_ptr.dtype.element_ty), mask=mask)

    _kernel = (triton, normalize_kernel)
    return _kernel


def normalize_triton(images, mean_c, inv_std_c, out_dtype=torch.bfloat16):
    """Launch the kernel on ``images`` (a contiguous 3-D/4-D CUDA tensor,
    channels last) with per-channel ``mean_c`` / ``inv_std_c`` float32 CUDA
    tensors of shape ``(C,)``. Returns a new tensor of ``out_dtype``."""
    global launches
    if not images.is_cuda:
        raise ValueError('normalize_triton needs a CUDA tensor, got one on {}'.format(images.device))
    if images.dim() not in (3, 4):
        raise ValueError('images must be 3-D or 4-D, got shape {}'.format(tuple(images.shape)))
    if not images.is_contiguous():
        raise ValueError('images must be contiguous (NHWC, channels last)')
    if images.dtype not in _INT_DTYPES + _FLOAT_DTYPES:
        raise ValueError('unsupported input dtype {}'.format(images.dtype))
    if out_dtype not in _OUT_DTYPES:
        raise ValueError('out_dtype must be torch.bfloat16 or torch.float32, got {}'.format(out_dtype))
    c = images.shape[-1]
    for name, t in (('mean_c', mean_c), ('inv_std_c', inv_std_c)):
        if t.device != images.device or t.dtype != torch.float32 or tuple(t.shape) != (c,):
            raise ValueError('{} must be a float32 ({},) tensor on {}'.format(name, c, images.device))
    n = images.numel()
    if n >= 2 ** 31:
        raise ValueError('normalize_triton takes fewer than 2**31 elements, got {}'.format(n))
    out = torch.empty(images.shape, dtype=out_dtype, device=images.device)
    if n == 0:
        return out
    triton, kernel = _build_kernel()
    kernel[(triton.cdiv(n, _BLOCK),)](
        images, mean_c, inv_std_c, out, n,
        C=c, IS_INT=images.dtype in _INT_DTYPES, BLOCK=_BLOCK, num_warps=_NUM_WARPS)
    launches += 1
    return out


def normalize_reference(images, mean_c, inv_std_c, out_dtype=torch.bfloat16):
    """Plain PyTorch version of the kernel's arithmetic, on any device."""
    x = images
    if not x.is_floating_point():
        x = x.to(torch.int32)
    x = x.to(torch.float32)
    return ((x - mean_c.to(x.device)) * inv_std_c.to(x.device)).to(out_dtype)
