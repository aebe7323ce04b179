"""Weight transfer from the JAX package's flax variables to this package's models.

``flax_to_torch(variables)`` takes ``{'params': ..., 'batch_stats': ...}`` as
nested dicts of numpy arrays (``jax.device_get`` of a flax tree) and returns a
``state_dict`` for the matching :mod:`petastorm_tpu_torch.models` module:
conv kernels HWIO -> OIHW, dense kernels transposed, batch-norm
scale/bias/mean/var renamed one to one.

``flax_sequence_to_torch(params)`` does the same for the flax
``SequenceTransformer``'s ``params``: ``block{i}`` becomes ``blocks.{i}``,
each ``LayerNorm_0`` the module's ``norm`` (``scale`` its ``weight``), dense
kernels are transposed and ``pos_embed`` is kept as it is.

``flax_moe_to_torch(params)`` does it for the flax ``MoESequenceTransformer``:
the blocks' unnamed LayerNorms ``LayerNorm_0 ... LayerNorm_{L-1}`` become
``norm0 ...``, the last one ``LayerNorm_{L}`` the final ``norm``; inside each
``attn{i}`` ``LayerNorm_0`` is the attention's ``norm``. Dense kernels
(``embed``, ``qkv``, ``attn_out``, ``gate``, ``head``) are transposed; the
experts' einsum parameters ``w1 [E, D, H]``, ``b1``, ``w2 [E, H, D]``,
``b2`` are kept as they are.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def flax_to_torch(variables):
    """flax ``{'params', 'batch_stats'}`` (numpy leaves) -> torch ``state_dict``."""
    state = OrderedDict()
    for collection in ('params', 'batch_stats'):
        for path, value in _flatten(variables.get(collection) or {}):
            name = path[-1]
            if name == 'kernel':
                name = 'weight'
                # conv HWIO -> OIHW; dense (in, out) -> (out, in)
                value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
            key = '.'.join(path[:-1] + (name,))
            state[key] = torch.from_numpy(np.array(value, dtype=np.float32, order='C'))
    return state


def flax_sequence_to_torch(params):
    """flax ``SequenceTransformer`` ``params`` (numpy leaves) -> the
    ``state_dict`` of :class:`~petastorm_tpu_torch.models.transformer.SequenceTransformer`."""
    state = OrderedDict()
    for path, value in _flatten(params):
        *modules, name = path
        modules = ['norm' if m == 'LayerNorm_0' else
                   'blocks.' + m[len('block'):] if m.startswith('block') else m for m in modules]
        if name == 'kernel':
            name, value = 'weight', value.T
        elif name == 'scale':
            name = 'weight'
        state['.'.join(modules + [name])] = torch.from_numpy(
            np.array(value, dtype=np.float32, order='C'))
    return state


def flax_moe_to_torch(params):
    """flax ``MoESequenceTransformer`` ``params`` (numpy leaves) -> the
    ``state_dict`` of :class:`~petastorm_tpu_torch.models.moe.MoESequenceTransformer`
    (all E experts; a model sharded over an expert axis loads its slice)."""
    final = 'LayerNorm_{}'.format(sum(1 for key in params if key.startswith('moe')))
    state = OrderedDict()
    for path, value in _flatten(params):
        *modules, name = path
        if modules and modules[0].startswith('LayerNorm_'):
            modules[0] = 'norm' if modules[0] == final else 'norm' + modules[0][len('LayerNorm_'):]
        elif modules and modules[0].startswith('attn') and modules[1:] == ['LayerNorm_0']:
            modules[1] = 'norm'
        if name == 'kernel':
            name, value = 'weight', value.T
        elif name == 'scale':
            name = 'weight'
        state['.'.join(modules + [name])] = torch.from_numpy(
            np.array(value, dtype=np.float32, order='C'))
    return state
