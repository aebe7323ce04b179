"""Random rows that conform to a Unischema.

Twin of ``petastorm_tpu/generator.py``: the same draws, in the same order,
from the same ``numpy.random.Generator``, so equal seeds give equal rows in
both packages. Strings, bytes, Decimals, bools and datetimes are drawn as
their own types.
"""

from __future__ import annotations

import string
from decimal import Decimal

import numpy as np

#: the size given to ``None`` (wildcard) shape entries
LIST_SIZE = 13

_ALPHABET = np.array(list(string.ascii_lowercase))


def _word(rng):
    return ''.join(rng.choice(_ALPHABET, size=rng.integers(1, 12)))


def _random_value(field, rng, list_size):
    dtype = field.numpy_dtype
    shape = tuple(list_size if d is None else d for d in field.shape)
    if dtype is Decimal:
        return Decimal('{}.{:02d}'.format(int(rng.integers(0, 1000)), int(rng.integers(0, 100))))
    if dtype is np.str_ or dtype is str:
        if shape == ():
            return _word(rng)
        return np.asarray([_word(rng) for _ in range(int(np.prod(shape)))],
                          dtype=np.str_).reshape(shape)
    if dtype is np.bytes_ or dtype is bytes:
        if shape == ():
            return _word(rng).encode()
        return np.asarray([_word(rng).encode() for _ in range(int(np.prod(shape)))],
                          dtype=np.bytes_).reshape(shape)
    np_dtype = np.dtype(dtype)
    if np_dtype.kind == 'b':
        value = rng.integers(0, 2, size=shape).astype(np.bool_)
    elif np_dtype.kind in 'iu':
        info = np.iinfo(np_dtype)
        value = rng.integers(info.min, info.max, size=shape, dtype=np_dtype, endpoint=True)
    elif np_dtype.kind == 'f':
        value = rng.random(size=shape).astype(np_dtype)
    elif np_dtype.kind == 'M':
        value = (np.datetime64('2020-01-01') +
                 rng.integers(0, 10**6, size=shape).astype('timedelta64[s]')).astype(np_dtype)
    else:
        raise TypeError('generate_datapoint: unsupported dtype {} for field {}'.format(
            np_dtype, field.name))
    if shape == ():
        return value[()] if isinstance(value, np.ndarray) else value
    return value


def generate_datapoint(schema, rng=None, list_size=LIST_SIZE):
    """One random row dict conforming to ``schema``.

    :param schema: a :class:`~petastorm_tpu_torch.unischema.Unischema`
    :param rng: a ``numpy.random.Generator`` (None: a fresh, unseeded one)
    :param list_size: the size given to ``None`` shape entries
    """
    rng = rng if rng is not None else np.random.default_rng()
    return {name: _random_value(field, rng, list_size) for name, field in schema.fields.items()}
