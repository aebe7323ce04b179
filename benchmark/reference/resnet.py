"""Plain float32 ResNet (v1.5: the stride on the 3x3 convolution) and its
SGD steps, in plain PyTorch. It imports nothing of the program under test.

It follows the published architecture as the program's configuration
states it: ``SAME`` padding (asymmetric where a stride needs it), batch
norm on the batch's statistics with the biased variance, the stem max-pool
padded by one, global mean pooling, a linear head, mean softmax cross
entropy, and SGD with momentum (``t = g + m t``, ``p -= lr t``).

``quant='fp8'`` computes in float8 where the configuration states bf16:
every convolution's and the head's inputs, weights and outputs are rounded
to e4m3, and the gradients flowing back through them to e5m2, each at a
per-tensor scale: the lower precision the benchmark's control computes in.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.quant import fp8

BN_EPS = 1e-5


def leaves(config):
    """``[(name, shape, kind)]`` of every parameter, in the program's naming;
    ``kind`` is ``conv``, ``head_w``, ``head_b``, ``scale``, ``scale0`` (a
    block's last batch norm, zero at start) or ``bias``."""
    out = []
    filters, c_in = config['num_filters'], config['in_channels']

    def conv(name, cin, cout, k):
        out.append((name + '.weight', (cout, cin, k, k), 'conv'))

    def bn(name, c, zero=False):
        out.append((name + '.scale', (c,), 'scale0' if zero else 'scale'))
        out.append((name + '.bias', (c,), 'bias'))

    conv('conv_init', c_in, filters, 7)
    bn('bn_init', filters)
    features = filters
    for i, blocks in enumerate(config['stage_sizes']):
        width = filters * 2 ** i
        for j in range(blocks):
            name = 'stage{}_block{}'.format(i + 1, j)
            conv(name + '.conv1', features, width, 1)
            bn(name + '.bn1', width)
            conv(name + '.conv2', width, width, 3)
            bn(name + '.bn2', width)
            conv(name + '.conv3', width, 4 * width, 1)
            bn(name + '.bn3', 4 * width, zero=True)
            if j == 0:
                conv(name + '.conv_proj', features, 4 * width, 1)
                bn(name + '.bn_proj', 4 * width)
            features = 4 * width
    out.append(('head.weight', (config['num_classes'], features), 'head_w'))
    out.append(('head.bias', (config['num_classes'],), 'head_b'))
    return out


def _same_pads(size, kernel, stride):
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride, quant, pads=None):
    k = w.shape[-1]
    if pads is None:
        pads = _same_pads(x.shape[2], k, stride) + _same_pads(x.shape[3], k, stride)
    top, bottom, left, right = pads
    x = F.pad(x, (left, right, top, bottom))
    if quant:
        return fp8(F.conv2d(fp8(x), fp8(w), stride=stride))
    return F.conv2d(x, w, stride=stride)


def _bn(x, scale, bias):
    """Batch norm on the batch's statistics (biased variance); no running
    statistics, which a training step's outputs do not read."""
    return F.batch_norm(x, None, None, scale, bias, training=True, eps=BN_EPS)


def forward(params, x, config, quant=None):
    """Logits of the NCHW float32 batch ``x`` under ``params`` (a dict by
    name)."""
    q = quant == 'fp8'
    p = params
    x = _conv(x, p['conv_init.weight'], 2, q, pads=(3, 3, 3, 3))
    x = F.relu(_bn(x, p['bn_init.scale'], p['bn_init.bias']))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for i, blocks in enumerate(config['stage_sizes']):
        for j in range(blocks):
            name = 'stage{}_block{}.'.format(i + 1, j)
            stride = 2 if i > 0 and j == 0 else 1
            y = F.relu(_bn(_conv(x, p[name + 'conv1.weight'], 1, q),
                           p[name + 'bn1.scale'], p[name + 'bn1.bias']))
            y = F.relu(_bn(_conv(y, p[name + 'conv2.weight'], stride, q),
                           p[name + 'bn2.scale'], p[name + 'bn2.bias']))
            y = _bn(_conv(y, p[name + 'conv3.weight'], 1, q), p[name + 'bn3.scale'],
                    p[name + 'bn3.bias'])
            if j == 0:
                x = _bn(_conv(x, p[name + 'conv_proj.weight'], stride, q),
                        p[name + 'bn_proj.scale'], p[name + 'bn_proj.bias'])
            x = F.relu(x + y)
    x = x.mean(dim=(2, 3))
    w = p['head.weight']
    if q:
        return fp8(fp8(x) @ fp8(w).t()) + p['head.bias']
    return x @ w.t() + p['head.bias']


def step_seed(preprocess_seed, step):
    """The seed of step ``step``'s draws, as the configuration states them:
    ``SeedSequence([seed, step])``'s first 32-bit word."""
    return int(np.random.SeedSequence([int(preprocess_seed), int(step)]).generate_state(1)[0])


def flip_mask(preprocess_seed, step, batch, device, prob=0.5):
    """Step ``step``'s flips: one uniform draw per image from a
    ``torch.Generator`` on ``device`` seeded with :func:`step_seed`, set
    below ``prob``."""
    generator = torch.Generator(device=device)
    generator.manual_seed(step_seed(preprocess_seed, step))
    return torch.rand(batch, generator=generator, device=device) < prob


def prepare(images, mask, mean, std):
    """uint8 NHWC images -> flipped where ``mask`` is set, normalized,
    float32 NCHW."""
    x = images.to(torch.float32)
    x = torch.where(mask[:, None, None, None], x.flip(2), x)
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2).contiguous()


def loss_and_grads(params, images, labels, config, preprocess_seed, step, quant=None):
    """The loss of step ``step`` on ``(images, labels)`` (uint8 NHWC, on
    one device) under ``params``, and each leaf's gradient, by name."""
    names = list(params)
    leaves_ = {n: params[n].detach().requires_grad_(True) for n in names}
    mask = flip_mask(preprocess_seed, step, images.shape[0], images.device, config['flip_prob'])
    x = prepare(images, mask, config['mean'], config['std'])
    loss = F.cross_entropy(forward(leaves_, x, config, quant), labels.long())
    grads = torch.autograd.grad(loss, [leaves_[n] for n in names])
    return float(loss.detach()), dict(zip(names, grads))


def train_steps(params0, batches, config, preprocess_seed, quant=None):
    """SGD steps over ``batches`` (``[(uint8 NHWC images, labels)]`` on one
    device) from ``params0``. Returns ``{'losses', 'first_grad', 'change',
    'grad_max'}``: each step's loss, each leaf's gradient at the first step
    and its ``p_end - p_0`` (tensors), and each leaf's largest gradient norm
    over the steps."""
    lr, momentum = config['learning_rate'], config['momentum']
    names = list(params0)
    params = {n: params0[n].detach().clone() for n in names}
    bufs, losses, first, gmax = {}, [], None, {n: 0.0 for n in names}
    for step, (images, labels) in enumerate(batches):
        loss, grads = loss_and_grads(params, images, labels, config, preprocess_seed, step, quant)
        losses.append(loss)
        if first is None:
            first = {n: g.detach().clone() for n, g in grads.items()}
        with torch.no_grad():
            for n, g in grads.items():
                gmax[n] = max(gmax[n], float(g.double().norm()))
                bufs[n] = g.clone() if n not in bufs else bufs[n].mul_(momentum).add_(g)
                params[n].sub_(lr * bufs[n])
        del grads
    change = {n: params[n] - params0[n] for n in names}
    return {'losses': losses, 'first_grad': first, 'change': change, 'grad_max': gmax}


def window_step(params, bufs, images, labels, config, preprocess_seed, step, quant=None):
    """One SGD step, step ``step`` of a run, from a state the program held
    in its window: ``params`` and the momentum ``bufs`` before the step.
    Returns ``{'loss', 'grad', 'change'}``: the step's loss, each leaf's
    gradient and its change ``-lr (m t + g)``."""
    lr, momentum = config['learning_rate'], config['momentum']
    loss, grads = loss_and_grads(params, images, labels, config, preprocess_seed, step, quant)
    with torch.no_grad():
        change = {n: -lr * (momentum * bufs[n] + g) for n, g in grads.items()}
    return {'loss': loss, 'grad': grads, 'change': change}


def fan_in(shape):
    """The fan-in of a conv ``(out, in, k, k)`` or linear ``(out, in)`` weight."""
    return int(math.prod(shape[1:]))
