"""Plain float32 reference of model kind ``tiny_lm`` (a fixture of the
benchmark's own tests) and its AdamW steps, in plain PyTorch. It imports
nothing of the program under test.

The model: an embedding, the running mean of the embeddings up to each
position, a tanh layer and a linear head; the loss is the mean cross
entropy of each next token. ``quant='fp8'`` rounds both linear layers'
inputs, weights and outputs to float8 (:mod:`benchmark.reference.quant`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.quant import fp8


def _linear(x, w, b, quant):
    if quant:
        return fp8(fp8(x) @ fp8(w).t()) + b
    return x @ w.t() + b


def _loss_and_grads(params, tokens, quant):
    leaves = {n: params[n].detach().requires_grad_(True) for n in params}
    inputs, targets = tokens[:, :-1].long(), tokens[:, 1:].long()
    x = leaves['embed.weight'][inputs]
    counts = torch.arange(1, x.shape[1] + 1, dtype=torch.float32, device=x.device)
    x = x.cumsum(1) / counts[:, None]
    h = torch.tanh(_linear(x, leaves['mix.weight'], leaves['mix.bias'], quant))
    logits = _linear(h, leaves['head.weight'], leaves['head.bias'], quant)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))
    grads = torch.autograd.grad(loss, [leaves[n] for n in params])
    return float(loss.detach()), dict(zip(params, grads))


def _adamw(p, m, v, g, config, step):
    """AdamW's update of one leaf at step ``step`` (from 1): the new
    parameter and moments."""
    lr, (b1, b2) = config['learning_rate'], config['betas']
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    denom = (v / (1 - b2 ** step)).sqrt() + config['eps']
    p = p * (1 - lr * config['weight_decay']) - lr / (1 - b1 ** step) * m / denom
    return p, m, v


def train_steps(params0, batches, config, draw_seed, quant=None):
    """AdamW steps over ``batches`` (``[(int32 tokens,)]``) from
    ``params0``: ``{'losses', 'first_grad', 'change', 'grad_max'}``."""
    params = {n: t.detach().clone() for n, t in params0.items()}
    m = {n: torch.zeros_like(t) for n, t in params.items()}
    v = {n: torch.zeros_like(t) for n, t in params.items()}
    losses, first, gmax = [], None, {n: 0.0 for n in params}
    for step, (tokens,) in enumerate(batches, 1):
        loss, grads = _loss_and_grads(params, tokens, quant)
        losses.append(loss)
        if first is None:
            first = grads
        for n, g in grads.items():
            gmax[n] = max(gmax[n], float(g.double().norm()))
            params[n], m[n], v[n] = _adamw(params[n], m[n], v[n], g, config, step)
    change = {n: params[n] - params0[n] for n in params}
    return {'losses': losses, 'first_grad': first, 'change': change, 'grad_max': gmax}


def window_step(params, opt_state, tokens, config, draw_seed, step, quant=None):
    """One AdamW step, step ``step`` of a run, from the parameters and
    moments the program held before it: ``{'loss', 'grad', 'change'}``."""
    loss, grads = _loss_and_grads(params, tokens, quant)
    change = {}
    for n, g in grads.items():
        p1, _, _ = _adamw(params[n], opt_state[n + '.exp_avg'], opt_state[n + '.exp_avg_sq'], g,
                          config, step + 1)
        change[n] = p1 - params[n]
    return {'loss': loss, 'grad': grads, 'change': change}
