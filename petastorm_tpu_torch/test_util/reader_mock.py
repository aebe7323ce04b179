"""A Reader stand-in with no store: schema-conformant random rows.

Twin of ``petastorm_tpu/test_util/reader_mock.py`` (the reference's public
mock), with ``batch_size`` for batched output and ``num_rows`` so an epoch
ends. Rows come from :func:`~petastorm_tpu_torch.generator.generate_datapoint`
on a generator seeded by ``seed``: equal seeds give the JAX mock's rows.
"""

from __future__ import annotations

import numpy as np

from petastorm_tpu_torch.generator import generate_datapoint


def schema_data_generator_example(schema, rng=None):
    """A random row dict for ``schema`` (random rather than zeros, so
    shuffling and correlation tests see distinct rows)."""
    return generate_datapoint(schema, rng=rng)


class ReaderMock(object):
    """Yields schema-conformant rows through the Reader interface (iteration,
    ``stop``/``join``, the context manager, ``batched_output``, ``reset``).

    :param schema: a Unischema
    :param schema_data_generator: ``f(schema) -> row dict`` (default: rows
        of :func:`generate_datapoint` from a generator seeded by ``seed``)
    :param num_rows: rows (batches with ``batch_size``) an epoch; None:
        endless, like the reference's mock
    :param batch_size: when set, each item is a namedtuple of stacked
        columns of this many rows (``batched_output=True``)
    """

    def __init__(self, schema, schema_data_generator=None, ngram=None, num_rows=None,
                 batch_size=None, seed=0):
        if ngram is not None:
            raise ValueError('NGram is not supported by ReaderMock')
        self.schema = schema
        self.ngram = None
        self._rng = np.random.default_rng(seed)
        self._generator = (schema_data_generator if schema_data_generator is not None
                           else (lambda s: schema_data_generator_example(s, rng=self._rng)))
        self._num_rows = num_rows
        self._batch_size = batch_size
        self._emitted = 0
        self.batched_output = batch_size is not None
        self.last_row_consumed = False

    def fetch(self):
        if self._batch_size is None:
            return self.schema.make_namedtuple(**self._generator(self.schema))
        rows = [self._generator(self.schema) for _ in range(self._batch_size)]
        return self.schema.make_namedtuple(**{name: np.stack([np.asarray(r[name]) for r in rows])
                                              for name in self.schema.fields})

    def __iter__(self):
        return self

    def __next__(self):
        if self._num_rows is not None and self._emitted >= self._num_rows:
            self.last_row_consumed = True
            raise StopIteration
        self._emitted += 1
        return self.fetch()

    next = __next__

    def reset(self):
        self._emitted = 0
        self.last_row_consumed = False

    def stop(self):
        pass

    def join(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.stop()
