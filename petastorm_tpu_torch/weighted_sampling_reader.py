"""Mix several readers with given sampling probabilities.

Twin of ``petastorm_tpu/weighted_sampling_reader.py``. Each ``__next__``
draws one of the underlying readers from the cumulative probability vector
over the live sources (one ``default_rng(seed)`` draw and a ``searchsorted``),
so a seed gives the JAX package's interleaving exactly. Schemas,
batched-ness and NGram specs must agree.

Sources usually have different lengths, so "one reader raised
StopIteration" and "the mixture is exhausted" are different events:
``on_exhausted='renormalize'`` (default) drops the dry source and shares its
probability mass over the live ones, so the mixture ends only when every
source is dry; ``'stop'`` ends it at the first dry source (the original
petastorm's behaviour, which keeps the proportions). Live re-weighting,
epoch schedules and per-source counts live in
:class:`petastorm_tpu_torch.sequence.mixture.MixtureReader`, built on this
class.
"""

from __future__ import annotations

import numpy as np

from petastorm_tpu_torch.errors import PetastormTpuError


class WeightedSamplingReader(object):
    """
    :param readers: readers to mix; schemas, batched-ness and NGram specs must
        agree
    :param probabilities: relative sampling weights (normalized here)
    :param seed: seeds the sampling stream; ``None`` = nondeterministic
    :param on_exhausted: ``'renormalize'`` (default): a dry source's mass
        goes to the live ones until all are dry; ``'stop'``: the first dry
        source ends the mixture
    """

    def __init__(self, readers, probabilities, seed=None, on_exhausted='renormalize'):
        if len(readers) != len(probabilities) or not readers:
            raise PetastormTpuError('readers and probabilities must be non-empty, same length')
        if on_exhausted not in ('stop', 'renormalize'):
            raise PetastormTpuError(
                "on_exhausted must be 'stop' or 'renormalize', got {!r}".format(on_exhausted))
        total = float(sum(probabilities))
        if total <= 0:
            raise PetastormTpuError('probabilities must sum to a positive value')
        self._readers = list(readers)
        self._weights = np.asarray(probabilities, dtype=np.float64) / total
        self._live = [True] * len(readers)
        self._cum = None
        self._live_indices = None
        self._rebuild_cum()
        self._rng = np.random.default_rng(seed)
        self._on_exhausted = on_exhausted

        first = self._readers[0]
        for other in self._readers[1:]:
            if other.batched_output != first.batched_output:
                raise PetastormTpuError('All mixed readers must agree on batched_output')
            if getattr(other, 'ngram', None) != getattr(first, 'ngram', None):
                raise PetastormTpuError('All mixed readers must use the same NGram spec')
            if list(other.transformed_schema.fields) != list(first.transformed_schema.fields):
                raise PetastormTpuError('All mixed readers must produce the same fields')
        self.batched_output = first.batched_output
        self.ngram = getattr(first, 'ngram', None)
        self.transformed_schema = first.transformed_schema
        self.last_row_consumed = False

    def _rebuild_cum(self):
        """The cumulative probability vector over the live sources only: a
        dry source's mass is shared out in proportion."""
        self._live_indices = [i for i, alive in enumerate(self._live) if alive]
        if not self._live_indices:
            self._cum = np.empty(0, dtype=np.float64)
            return
        live_w = self._weights[self._live_indices]
        total = float(live_w.sum())
        if total <= 0:  # every live weight is 0 (set_weights zeroed them): uniform
            live_w = np.ones(len(self._live_indices), dtype=np.float64)
            total = float(len(self._live_indices))
        self._cum = np.cumsum(live_w / total)

    def __iter__(self):
        return self

    def __next__(self):
        while self._live_indices:
            pos = int(np.searchsorted(self._cum, self._rng.random(), side='right'))
            pos = min(pos, len(self._live_indices) - 1)
            choice = self._live_indices[pos]
            try:
                row = next(self._readers[choice])
            except StopIteration:
                self._on_source_exhausted(choice)
                if self._on_exhausted == 'stop':
                    break
                continue
            self._on_row(choice, row)
            return row
        self.last_row_consumed = True
        raise StopIteration

    next = __next__

    # -- subclass hooks (MixtureReader's counts) ----------------------------

    def _on_row(self, choice, row):
        """Called after each row drawn; the base class does nothing."""

    def _on_source_exhausted(self, choice):
        """Mark a source dry and renormalize the live mass."""
        self._live[choice] = False
        self._rebuild_cum()

    def stop(self):
        for r in self._readers:
            r.stop()

    def join(self):
        for r in self._readers:
            r.join()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, tb):
        self.stop()
        self.join()
