"""Model kind ``tiny_lm``, a fixture of the benchmark's own tests: a small
causal language model over int32 token rows, trained by AdamW through the
port's eager step, against its plain reference
``benchmark/reference/tiny_lm.py``. It exists to show that a kind the
harness has never seen runs from new files alone
(``benchmark/tests/test_bench_kinds.py``); it is no cell of the benchmark.

The model: an embedding, the running mean of the embeddings up to each
position, a tanh layer and a linear head; the loss is the mean cross
entropy of each next token.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark import faults, weights

FIELDS = ('tokens',)

#: the embedding's backward runs once a step
STEP_MARKER = 'embedding_backward'

#: the plain reference, ``benchmark/reference/tiny_lm.py``
REFERENCE = 'tiny_lm'

CONTROL = 'fp8'

_LEAVES = ('embed.weight', 'mix.weight', 'mix.bias', 'head.weight', 'head.bias')


def _shapes(config):
    v, h = config['vocab_size'], config['hidden_size']
    return {'embed.weight': (v, h), 'mix.weight': (h, h), 'mix.bias': (h,),
            'head.weight': (v, h), 'head.bias': (v,)}


def make_weights(config, seed, device):
    shapes = _shapes(config)
    drawn = [(n, shapes[n], config['init_std']) for n in _LEAVES if n.endswith('weight')]
    out = weights.truncated_normal(drawn, seed, device)
    for name in ('mix.bias', 'head.bias'):
        out[name] = torch.zeros(shapes[name], device=device)
    return {name: out[name] for name in _LEAVES}


class TinyLM(torch.nn.Module):
    def __init__(self, vocab_size, hidden_size):
        super().__init__()
        self.embed = torch.nn.Embedding(vocab_size, hidden_size)
        self.mix = torch.nn.Linear(hidden_size, hidden_size)
        self.head = torch.nn.Linear(hidden_size, vocab_size)

    def forward(self, tokens):
        x = self.embed(tokens)
        counts = torch.arange(1, x.shape[1] + 1, device=x.device, dtype=x.dtype)
        x = x.cumsum(1) / counts[:, None]
        return self.head(torch.tanh(self.mix(x)))

    def objective(self, logits, targets):
        return {'loss': F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                                        targets.reshape(-1).long())}


def train_state(config, device):
    from petastorm_tpu_torch.models.train import TrainState

    with torch.device(device):
        model = TinyLM(config['vocab_size'], config['hidden_size'])
    optimizer = torch.optim.AdamW(model.parameters(), lr=config['learning_rate'],
                                  betas=tuple(config['betas']), eps=config['eps'],
                                  weight_decay=config['weight_decay'])
    return TrainState(model, optimizer)


def train_step(config, draw_seed, graphed):
    from petastorm_tpu_torch.models.train import make_train_step

    return make_train_step(graphed=graphed)


def feed(batch):
    tokens = batch['tokens']
    return tokens[:, :-1], tokens[:, 1:]


def optimizer_state(state, params):
    """AdamW's first and second moments of each leaf; zeros where the
    optimizer keeps none."""
    opt = state.optimizer
    out = {}
    for n, p in params.items():
        kept = opt.state.get(p, {})
        for moment in ('exp_avg', 'exp_avg_sq'):
            value = kept.get(moment)
            out[n + '.' + moment] = value if value is not None else p.detach() * 0
    return out


def gradient(config, before, after):
    """What the first moment gained: ``(m1 - b1 m0) / (1 - b1)``."""
    b1 = config['betas'][0]
    out = {}
    for key, m1 in after.items():
        if key.endswith('.exp_avg'):
            m0 = 0.0 if before is None else before[key]
            out[key[:-len('.exp_avg')]] = (m1 - b1 * m0) / (1 - b1)
    return out


def data_numbers(staged, expected):
    mismatches = sum(int((tokens != ref).sum()) for (tokens,), (ref,) in zip(staged, expected))
    return {'token_mismatches': mismatches}


def step_flops(config):
    """Two per multiply-add of the two linear layers, three times the
    forward for forward and backward, over the batch's predicted tokens."""
    v, h = config['vocab_size'], config['hidden_size']
    tokens = config['batch_size'] * (config['seq_len'] - 1)
    return 2 * 3 * tokens * (h * h + h * v)


# -- faults ------------------------------------------------------------------

def _half_batch():
    objective = TinyLM.objective

    def half(self, logits, targets):
        keep = logits.shape[0] // 2
        return objective(self, logits[:keep], targets[:keep])

    return faults.patched(TinyLM, 'objective', half)


def _alter_first_token(tokens):
    flat = tokens.reshape(-1)
    flat[0] = (int(flat[0]) + 1) % 64  # the fixture's vocabulary


FAULTS = {
    'frozen_step': lambda: faults.patched(torch.optim.AdamW, 'step',
                                          lambda self, closure=None: None),
    'half_batch': _half_batch,
    'altered_token': lambda: faults.altered('tokens', _alter_first_token),
}
