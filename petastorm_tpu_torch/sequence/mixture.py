"""Dataset mixtures with live weights, epoch schedules and per-source counts.

Twin of ``petastorm_tpu/sequence/mixture.py``. :class:`MixtureReader` grows
:class:`~petastorm_tpu_torch.weighted_sampling_reader.WeightedSamplingReader`
into what curricula need:

* **live re-weighting**: ``set_weights([...])`` changes the sampling
  distribution between two ``next()`` calls;
* **epoch schedules**: a :class:`MixtureSchedule` maps epoch -> weights,
  applied at each :meth:`MixtureReader.reset`;
* **per-source counts**: rows, tokens (when ``token_field`` names the
  sequence column) and exhaustion per source, as the ``mixture_source_*``
  keys of :attr:`MixtureReader.diagnostics`, which the stall report renders.

Determinism (rule PT1400): every sampling decision draws from the stream
seeded in the constructor, so a seed reproduces the interleaving exactly,
across ``set_weights`` calls too (a weight swap changes the distribution,
not the stream). Not thread-safe: one thread calls ``next``, ``set_weights``
and ``reset``.
"""

from __future__ import annotations

import numpy as np

from petastorm_tpu_torch.errors import PetastormTpuError
from petastorm_tpu_torch.weighted_sampling_reader import WeightedSamplingReader


class MixtureSchedule(object):
    """Epoch-indexed weights: ``{epoch: weights}`` (or a list of
    ``(epoch, weights)``). Epoch E uses the entry with the largest key <= E,
    so ``{0: [9, 1], 3: [5, 5]}`` anneals at epoch 3 and holds after."""

    def __init__(self, entries):
        items = sorted(dict(entries).items())
        if not items:
            raise PetastormTpuError('MixtureSchedule needs at least one entry')
        if items[0][0] != 0:
            raise PetastormTpuError('MixtureSchedule must define epoch 0 '
                                    '(got first epoch {})'.format(items[0][0]))
        self._entries = [(int(e), tuple(float(w) for w in ws)) for e, ws in items]

    def weights_for(self, epoch):
        chosen = self._entries[0][1]
        for e, ws in self._entries:
            if e > epoch:
                break
            chosen = ws
        return chosen

    def __repr__(self):
        return 'MixtureSchedule({})'.format(dict(self._entries))


class MixtureReader(WeightedSamplingReader):
    """
    :param readers: sources to mix (the schema, batched-ness and NGram
        contract of :class:`WeightedSamplingReader`)
    :param weights: initial relative weights; ``None`` requires ``schedule``
    :param seed: seeds the sampling stream
    :param on_exhausted: ``'renormalize'`` (default) | ``'stop'``
    :param schedule: optional :class:`MixtureSchedule` (or its constructor
        argument), applied at construction (epoch 0) and at every
        :meth:`reset`
    :param token_field: field whose per-row length counts as tokens in the
        per-source counts (``None`` counts rows only)
    """

    def __init__(self, readers, weights=None, seed=None, on_exhausted='renormalize',
                 schedule=None, token_field=None):
        if schedule is not None and not isinstance(schedule, MixtureSchedule):
            schedule = MixtureSchedule(schedule)
        if weights is None:
            if schedule is None:
                raise PetastormTpuError('MixtureReader needs weights or a schedule')
            weights = schedule.weights_for(0)
        super(MixtureReader, self).__init__(readers, weights, seed=seed,
                                            on_exhausted=on_exhausted)
        self._schedule = schedule
        self._token_field = token_field
        self._epoch = 0
        self._weight_updates = 0
        self._source_rows = [0] * len(self._readers)
        self._source_tokens = [0] * len(self._readers)

    # -- live weight control ------------------------------------------------

    def set_weights(self, weights):
        """Swap the sampling weights between two ``next()`` calls. Dry
        sources stay dry (their new mass goes to the live ones); the RNG
        stream is untouched, so a seeded run stays reproducible across the
        swap."""
        if len(weights) != len(self._readers):
            raise PetastormTpuError('Expected {} weights, got {}'.format(
                len(self._readers), len(weights)))
        w = np.asarray(weights, dtype=np.float64)
        if (w < 0).any() or float(w.sum()) <= 0:
            raise PetastormTpuError('weights must be non-negative and sum to a '
                                    'positive value')
        self._weights = w / float(w.sum())
        self._rebuild_cum()
        self._weight_updates += 1

    @property
    def weights(self):
        """The current normalized weights (a dry source keeps its nominal
        mass: the live renormalization happens at draw time)."""
        return tuple(float(x) for x in self._weights)

    @property
    def epoch(self):
        return self._epoch

    def reset(self):
        """Epoch boundary: reset every finished source for another pass,
        revive the dry ones, and apply the schedule's weights for the new
        epoch. Endless sources (``num_epochs=None``) stream on across the
        boundary: for them an epoch is only a schedule step."""
        for r in self._readers:
            if getattr(r, 'last_row_consumed', False):
                r.reset()
        self._live = [True] * len(self._readers)
        self._epoch += 1
        if self._schedule is not None:
            self.set_weights(self._schedule.weights_for(self._epoch))
            self._weight_updates -= 1  # schedule steps are not user swaps
        else:
            self._rebuild_cum()
        self.last_row_consumed = False

    # -- per-source counts --------------------------------------------------

    def _on_row(self, choice, row):
        if self.batched_output:
            d = row._asdict() if hasattr(row, '_asdict') else row
            first = next(iter(d.values()))
            n = len(first)
            self._source_rows[choice] += n
            if self._token_field is not None:
                col = d[self._token_field]
                self._source_tokens[choice] += int(sum(len(c) for c in col))
        else:
            self._source_rows[choice] += 1
            if self._token_field is not None:
                cell = (row[self._token_field] if isinstance(row, dict)
                        else getattr(row, self._token_field))
                self._source_tokens[choice] += len(cell)

    @property
    def diagnostics(self):
        """Every source's diagnostics (a later source wins a key both
        have) and the ``mixture_source_*`` family the stall report renders:
        per-source rows, tokens and exhaustion, the weights, the count of
        live weight swaps and the epoch."""
        out = {}
        for r in self._readers:
            out.update(getattr(r, 'diagnostics', {}) or {})
        for i in range(len(self._readers)):
            out['mixture_source_{}_rows'.format(i)] = self._source_rows[i]
            out['mixture_source_{}_tokens'.format(i)] = self._source_tokens[i]
            out['mixture_source_{}_exhausted'.format(i)] = int(not self._live[i])
        out['mixture_weights'] = list(self.weights)
        out['mixture_weight_updates'] = self._weight_updates
        out['mixture_epoch'] = self._epoch
        return out
