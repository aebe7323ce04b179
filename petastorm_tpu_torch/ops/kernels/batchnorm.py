"""Hopper kernels: batch norm's training forward, with the ReLU and the
residual add of a ResNet block folded into its apply pass.

Replaces no TPU kernel: flax's ``nn.BatchNorm`` is plain ``jnp`` that XLA
fuses. These kernels were added because a traced ResNet-50 training step on
the H100 (224 px, batch 256, bf16, channels last) spends most of its device
time in memory-bound batch-norm and element-wise passes, with ATen's
statistics kernel at 19% of its bytes bound, and a separate ReLU and
residual add each reading and writing a whole activation again.

Every kernel here is bound by bytes at the card's 3.35 TB/s; the forward's
least traffic is one read of ``x`` for the statistics, then one read of
``x`` (and of the residual) and one write of ``y``. The design moves each
of those bytes once:

* a channels-last contiguous ``(N, C, H, W)`` activation is a row-major
  ``(M = N*H*W, C)`` matrix, so the statistics are a column reduction.
  ``bn_stats_kernel`` runs a grid of ``(C blocks, P slabs)``: each program
  walks its slab of rows in ``BLOCK_M x BLOCK_C`` tiles (16-byte loads
  along ``C``), keeps a float32 sum and sum of squares per lane, shifted by
  the slab's first row so a mean that is large against the spread loses no
  digits, and writes the slab's mean and sum of squared deviations to a
  ``[2, P, C]`` scratch. ``P`` follows from ``M``, ``C`` and the card's SM
  count by a fixed rule (:func:`stats_grid`), so a few programs per SM are
  in flight at every shape. No atomics: a replay gives the same bits;
* ``bn_finalize_kernel`` merges the ``P`` slabs per channel by Chan's
  parallel formula, in blocks of slabs, and writes ``save_mean`` and
  ``save_invstd = rsqrt(var + eps)`` (what ATen's backward takes), the
  per-channel ``a = scale * invstd`` and ``b = bias - mean * a``, and the
  running ``mean``/``var`` updated in place with the BIASED variance,
  ``r = momentum * r + (1 - momentum) * batch`` (flax's rule);
* ``bn_apply_kernel`` computes ``y = x * a[c] + b[c]`` in float32, adds the
  residual and takes ``max(., 0)`` where asked (``tl.constexpr`` flags, so
  three variants for a ResNet), and stores once in the input's dtype.

The backward stays ATen's (``threshold_backward`` where the ReLU is fused,
then ``native_batch_norm_backward``), fed the same tensors ATen's own
forward would have saved.

``triton`` is imported on the first launch only, so this module imports
on hosts without it. :func:`batch_norm_train_reference` is the plain
PyTorch version of the same arithmetic in float32: the yardstick the CPU
tests hold against flax and the card's tests hold the kernels against.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

#: launches of the three kernels since import (or since a caller reset it):
#: proof that a run went through the kernels
launches = 0

#: kernels each training forward launches: statistics, finalize, apply
KERNELS_PER_CALL = 3

# block sizes from a sweep on the H100 over ResNet-50's shapes at batch 256
# (the statistics pass with its finalize summed over the model's 53 calls)
_STATS_BLOCK_M = 32
_STATS_BLOCK_C = 64
_STATS_WARPS = 4
#: statistics programs wanted on each SM
_STATS_PROGRAMS_PER_SM = 8
_FINALIZE_BLOCK_P = 256
_FINALIZE_BLOCK_C = 8
_APPLY_BLOCK_M = 16
_APPLY_BLOCK_C = 64
_APPLY_WARPS = 4

_DTYPES = (torch.bfloat16, torch.float16, torch.float32)

_kernels = None


def _build_kernels():
    """Import Triton and define the kernels on first launch."""
    global _kernels
    if _kernels is not None:
        return _kernels
    import triton
    import triton.language as tl

    @triton.jit(do_not_specialize=['M', 'P', 'rows_per_program'])
    def bn_stats_kernel(x_ptr, part_ptr, M, C, P, rows_per_program,
                        BLOCK_M: tl.constexpr, BLOCK_C: tl.constexpr):
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        col_mask = cols < C
        slab = tl.program_id(1)
        row0 = slab * rows_per_program
        row_end = tl.minimum(row0 + rows_per_program, M)
        shift = tl.load(x_ptr + row0 * C + cols, mask=col_mask, other=0.0).to(tl.float32)
        acc = tl.zeros([BLOCK_M, BLOCK_C], dtype=tl.float32)
        acc_sq = tl.zeros([BLOCK_M, BLOCK_C], dtype=tl.float32)
        lanes = tl.arange(0, BLOCK_M)
        for start in range(row0, row_end, BLOCK_M):
            rows = start + lanes
            mask = (rows < row_end)[:, None] & col_mask[None, :]
            x = tl.load(x_ptr + rows[:, None] * C + cols[None, :], mask=mask, other=0.0)
            d = tl.where(mask, x.to(tl.float32) - shift[None, :], 0.0)
            acc += d
            acc_sq += d * d
        s1 = tl.sum(acc, axis=0)
        s2 = tl.sum(acc_sq, axis=0)
        n = (row_end - row0).to(tl.float32)
        tl.store(part_ptr + slab * C + cols, shift + s1 / n, mask=col_mask)
        tl.store(part_ptr + (P + slab) * C + cols, tl.maximum(s2 - s1 * s1 / n, 0.0),
                 mask=col_mask)

    @triton.jit(do_not_specialize=['M', 'P', 'rows_per_program'])
    def bn_finalize_kernel(part_ptr, scale_ptr, bias_ptr, run_mean_ptr, run_var_ptr, out_ptr,
                           M, C, P, rows_per_program, momentum, eps,
                           BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        col_mask = cols < C
        count = tl.zeros([BLOCK_C], dtype=tl.float32)
        mean = tl.zeros([BLOCK_C], dtype=tl.float32)
        m2 = tl.zeros([BLOCK_C], dtype=tl.float32)
        for p0 in range(0, P, BLOCK_P):
            slabs = p0 + tl.arange(0, BLOCK_P)
            slab_mask = slabs < P
            mask = slab_mask[:, None] & col_mask[None, :]
            n = tl.where(slab_mask,
                         tl.minimum(M - slabs * rows_per_program, rows_per_program), 0)
            n = n.to(tl.float32)
            part_mean = tl.load(part_ptr + slabs[:, None] * C + cols[None, :], mask=mask,
                                other=0.0)
            part_m2 = tl.load(part_ptr + (P + slabs)[:, None] * C + cols[None, :], mask=mask,
                              other=0.0)
            # the block's slabs merged at once, then merged into the total
            block_n = tl.sum(n, axis=0)
            block_mean = tl.sum(part_mean * n[:, None], axis=0) / block_n
            dev = part_mean - block_mean[None, :]
            block_m2 = tl.sum(part_m2 + dev * dev * n[:, None], axis=0)
            total = count + block_n
            delta = block_mean - mean
            mean += delta * (block_n / total)
            m2 += block_m2 + delta * delta * (count * block_n / total)
            count = total
        var = m2 / count
        invstd = 1.0 / tl.sqrt(var + eps)
        a = tl.load(scale_ptr + cols, mask=col_mask, other=0.0) * invstd
        b = tl.load(bias_ptr + cols, mask=col_mask, other=0.0) - mean * a
        tl.store(out_ptr + cols, mean, mask=col_mask)
        tl.store(out_ptr + C + cols, invstd, mask=col_mask)
        tl.store(out_ptr + 2 * C + cols, a, mask=col_mask)
        tl.store(out_ptr + 3 * C + cols, b, mask=col_mask)
        run_mean = tl.load(run_mean_ptr + cols, mask=col_mask, other=0.0)
        run_var = tl.load(run_var_ptr + cols, mask=col_mask, other=0.0)
        tl.store(run_mean_ptr + cols, run_mean * momentum + mean * (1.0 - momentum),
                 mask=col_mask)
        tl.store(run_var_ptr + cols, run_var * momentum + var * (1.0 - momentum), mask=col_mask)

    @triton.jit(do_not_specialize=['M'])
    def bn_apply_kernel(x_ptr, ab_ptr, res_ptr, y_ptr, M, C,
                        HAS_RESIDUAL: tl.constexpr, HAS_RELU: tl.constexpr,
                        BLOCK_M: tl.constexpr, BLOCK_C: tl.constexpr):
        col_blocks = tl.cdiv(C, BLOCK_C)
        pid = tl.program_id(0)
        cols = (pid % col_blocks) * BLOCK_C + tl.arange(0, BLOCK_C)
        rows = (pid // col_blocks) * BLOCK_M + tl.arange(0, BLOCK_M)
        col_mask = cols < C
        mask = (rows < M)[:, None] & col_mask[None, :]
        offs = rows[:, None] * C + cols[None, :]
        a = tl.load(ab_ptr + cols, mask=col_mask, other=0.0)
        b = tl.load(ab_ptr + C + cols, mask=col_mask, other=0.0)
        y = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32) * a[None, :] + b[None, :]
        if HAS_RESIDUAL:
            y += tl.load(res_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        if HAS_RELU:
            y = tl.maximum(y, 0.0)
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    _kernels = (bn_stats_kernel, bn_finalize_kernel, bn_apply_kernel)
    return _kernels


def _cdiv(a, b):
    return -(-a // b)


def stats_grid(m, c, sms):
    """``(column blocks, slabs P, rows a slab)`` of the statistics pass over
    an ``(m, c)`` matrix on a card of ``sms`` SMs: slabs of whole
    ``BLOCK_M`` tiles, as many as put about ``_STATS_PROGRAMS_PER_SM``
    programs on each SM, never more than there are tiles."""
    col_blocks = _cdiv(c, _STATS_BLOCK_C)
    wanted = max(1, _cdiv(_STATS_PROGRAMS_PER_SM * sms, col_blocks))
    rows = _cdiv(_cdiv(m, wanted), _STATS_BLOCK_M) * _STATS_BLOCK_M
    return col_blocks, _cdiv(m, rows), rows


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x, scale, bias, mean, var, residual):
    if x.dim() != 4:
        raise ValueError('batch norm kernels take a 4-D (N, C, H, W) tensor, got shape {}'.format(
            tuple(x.shape)))
    if x.dtype not in _DTYPES:
        raise ValueError('batch norm kernels take bfloat16, float16 or float32, got {}'.format(
            x.dtype))
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError('batch norm kernels take a channels-last contiguous tensor')
    if not x.is_cuda:
        raise ValueError('batch norm kernels need a CUDA tensor, got one on {}'.format(x.device))
    c = x.shape[1]
    for name, t in (('scale', scale), ('bias', bias), ('mean', mean), ('var', var)):
        if t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != (c,) \
                or not t.is_contiguous():
            raise ValueError('{} must be a contiguous float32 ({},) tensor on {}'.format(
                name, c, x.device))
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype
                                 or residual.device != x.device or not residual.is_contiguous(
                                     memory_format=torch.channels_last)):
        raise ValueError('the residual must be a channels-last contiguous tensor of the '
                         'input\'s shape, dtype and device')
    if x.numel() >= 2 ** 31:
        raise ValueError('batch norm kernels take fewer than 2**31 elements, got {}'.format(
            x.numel()))
    if x.numel() == 0:
        raise ValueError('batch norm needs at least one element per channel')


def _launch_stats(x, partials, rows):
    """``bn_stats_kernel``: the statistics of ``x``'s ``(M, C)`` matrix in
    slabs of ``rows`` rows, into ``partials`` (float32 ``[2, P, C]``)."""
    kernel = _build_kernels()[0]
    c = x.shape[1]
    slabs = partials.shape[1]
    kernel[(_cdiv(c, _STATS_BLOCK_C), slabs)](
        x, partials, x.numel() // c, c, slabs, rows,
        BLOCK_M=_STATS_BLOCK_M, BLOCK_C=_STATS_BLOCK_C, num_warps=_STATS_WARPS)


def _launch_finalize(partials, m, rows, scale, bias, mean, var, per_channel, momentum, eps):
    """``bn_finalize_kernel``: ``partials`` of an ``(m, C)`` matrix merged
    into ``per_channel`` (float32 ``[4, C]``: save_mean, save_invstd, a, b),
    ``mean`` and ``var`` updated in place."""
    kernel = _build_kernels()[1]
    slabs, c = partials.shape[1:]
    kernel[(_cdiv(c, _FINALIZE_BLOCK_C),)](
        partials, scale, bias, mean, var, per_channel, m, c, slabs, rows,
        float(momentum), float(eps), BLOCK_P=_FINALIZE_BLOCK_P, BLOCK_C=_FINALIZE_BLOCK_C)


def _launch_apply(x, ab, residual, y, relu):
    """``bn_apply_kernel``: ``y = [relu](x * a + b [+ residual])``, ``ab``
    the float32 ``[2, C]`` rows ``a`` and ``b``."""
    kernel = _build_kernels()[2]
    c = x.shape[1]
    m = x.numel() // c
    kernel[(_cdiv(c, _APPLY_BLOCK_C) * _cdiv(m, _APPLY_BLOCK_M),)](
        x, ab, x if residual is None else residual, y, m, c,
        HAS_RESIDUAL=residual is not None, HAS_RELU=bool(relu),
        BLOCK_M=_APPLY_BLOCK_M, BLOCK_C=_APPLY_BLOCK_C, num_warps=_APPLY_WARPS)


def batch_norm_train(x, scale, bias, mean, var, momentum=0.9, eps=1e-5, relu=False,
                     residual=None):
    """Launch the three kernels: the batch statistics of ``x`` (a
    channels-last contiguous CUDA ``(N, C, H, W)`` tensor of bf16, fp16 or
    float32), ``mean``/``var`` updated in place, and
    ``y = [relu](x * a + b [+ residual])`` in ``x``'s dtype. ``scale``,
    ``bias``, ``mean``, ``var``: float32 ``(C,)`` on the same card. Raises
    ``ValueError`` on a tensor the kernels do not take. Returns
    ``(y, save_mean, save_invstd)``, the last two float32 ``(C,)``."""
    global launches
    _check(x, scale, bias, mean, var, residual)
    c = x.shape[1]
    m = x.numel() // c
    _, slabs, rows = stats_grid(m, c, _sm_count(x.device.index))
    partials = torch.empty((2, slabs, c), dtype=torch.float32, device=x.device)
    # save_mean, save_invstd, a, b
    per_channel = torch.empty((4, c), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    _launch_stats(x, partials, rows)
    _launch_finalize(partials, m, rows, scale, bias, mean, var, per_channel, momentum, eps)
    _launch_apply(x, per_channel[2:], residual, y, relu)
    launches += KERNELS_PER_CALL
    return y, per_channel[0], per_channel[1]


class _BatchNormTrain(torch.autograd.Function):
    """The kernels' forward; ATen's batch-norm backward, fed what ATen's own
    forward would have saved. With ``relu`` the output is already past the
    ReLU, and :class:`_ReluMask` gives the gradient its mask first."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, mean, var, momentum, eps, relu):
        y, save_mean, save_invstd = batch_norm_train(x, scale, bias, mean, var, momentum, eps,
                                                     relu, residual)
        ctx.eps, ctx.has_residual = eps, residual is not None
        ctx.save_for_backward(x, scale, save_mean, save_invstd)
        return y

    @staticmethod
    def backward(ctx, grad):
        x, scale, save_mean, save_invstd = ctx.saved_tensors
        grad_x, grad_scale, grad_bias = torch.ops.aten.native_batch_norm_backward(
            grad, x, scale, None, None, save_mean, save_invstd, True, ctx.eps,
            list(ctx.needs_input_grad[:3]))
        return (grad_x, grad_scale, grad_bias, grad if ctx.has_residual else None,
                None, None, None, None, None)


class _ReluMask(torch.autograd.Function):
    """The fused ReLU's backward, ``F.relu``'s: the gradient where the
    output is positive. A node of its own, as ``F.relu`` was, so the autograd
    engine frees the incoming gradient before batch norm's backward runs
    (one node holding both would keep an activation's worth more memory
    alive through that backward)."""

    @staticmethod
    def forward(ctx, y):
        ctx.save_for_backward(y)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        y, = ctx.saved_tensors
        return torch.ops.aten.threshold_backward(grad, y, 0)


def batch_norm_train_fused(x, scale, bias, mean, var, momentum=0.9, eps=1e-5, relu=False,
                           residual=None):
    """Differentiable :func:`batch_norm_train`: returns ``y`` alone, with
    gradients to ``x``, ``scale``, ``bias`` and ``residual``."""
    y = _BatchNormTrain.apply(x, scale, bias, residual, mean, var, momentum, eps, relu)
    return _ReluMask.apply(y) if relu else y


def batch_norm_train_reference(x, scale, bias, mean, var, relu=False, residual=None,
                               momentum=0.9, eps=1e-5):
    """Plain PyTorch version of the kernels' arithmetic in float32, on any
    device: the batch mean and biased variance of ``x`` (``(N, C, H, W)``)
    per channel, ``y = [relu](x * a + b [+ residual])`` returned in ``x``'s
    dtype, and ``mean``/``var`` updated in place by ``momentum``.
    Differentiable in ``x``, ``scale``, ``bias`` and ``residual``. Returns
    ``(y, batch_mean, batch_var)``."""
    xf = x.float()
    dims = (0, 2, 3)
    batch_mean = xf.mean(dims)
    batch_var = (xf - batch_mean[None, :, None, None]).square().mean(dims)
    a = scale * torch.rsqrt(batch_var + eps)
    b = bias - batch_mean * a
    y = xf * a[None, :, None, None] + b[None, :, None, None]
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = F.relu(y)
    with torch.no_grad():
        mean.mul_(momentum).add_(batch_mean.detach(), alpha=1 - momentum)
        var.mul_(momentum).add_(batch_var.detach(), alpha=1 - momentum)
    return y.to(x.dtype), batch_mean, batch_var
