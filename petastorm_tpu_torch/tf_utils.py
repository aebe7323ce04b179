"""TensorFlow adapter: twin of ``petastorm_tpu/tf_utils.py``.

numpy -> tf dtype promotion, value sanitizing (uint16 -> int32, uint32 ->
int64, ``Decimal`` -> string, datetime64 -> int64 ns), a reader as a
``tf.data.Dataset`` through ``from_generator``, NGram windows as dicts of
per-timestep namedtuples, and a client-side shuffle through the port's
seedable :class:`~petastorm_tpu_torch.shuffling_buffer.RandomShufflingBuffer`
(batched readers refuse it). Eager ``tf.data`` only: no TF1 queue pump.

TensorFlow is imported at first use, so the rest of the package works
without it.
"""

from __future__ import annotations

from decimal import Decimal

import numpy as np


def _tf():
    try:
        import tensorflow as tf
        return tf
    except ImportError:
        raise ImportError('make_petastorm_dataset requires tensorflow; it is not installed. '
                          'Use petastorm_tpu_torch.torch.TorchDataLoader (primary) or '
                          'petastorm_tpu_torch.torch_utils.DataLoader instead.')


def _sanitize_field_value(value):
    """uint16 -> int32, uint32 -> int64, Decimal -> string, datetime64 ->
    int64 ns."""
    if isinstance(value, Decimal):
        return str(value)
    if isinstance(value, np.datetime64):
        return value.astype('datetime64[ns]').astype(np.int64)
    if isinstance(value, np.ndarray):
        if value.dtype == np.uint16:
            return value.astype(np.int32)
        if value.dtype in (np.uint32,):
            return value.astype(np.int64)
        if np.issubdtype(value.dtype, np.datetime64):
            return value.astype('datetime64[ns]').astype(np.int64)
        if value.dtype == object and value.size and isinstance(value.flat[0], Decimal):
            return value.astype(str)
    if isinstance(value, np.generic):
        if value.dtype == np.uint16:
            return np.int32(value)
        if value.dtype == np.uint32:
            return np.int64(value)
    return value


def _tf_spec(tf, field, batched):
    """The TensorSpec of one field, with the dtype promotions."""
    if field.numpy_dtype is Decimal or field.numpy_dtype in (np.str_, np.bytes_):
        tf_dtype = tf.string
    elif field.numpy_dtype is np.datetime64:
        tf_dtype = tf.int64
    elif np.dtype(field.numpy_dtype) == np.uint16:
        tf_dtype = tf.int32
    elif np.dtype(field.numpy_dtype) == np.uint32:
        tf_dtype = tf.int64
    else:
        tf_dtype = tf.as_dtype(np.dtype(field.numpy_dtype))
    shape = field.shape
    if batched:
        shape = (None,) + tuple(shape or ())
    return tf.TensorSpec(shape=shape, dtype=tf_dtype)


def _shuffled(reader, shuffle_buffer_size, seed):
    """Iterate the reader through a seedable client-side shuffling buffer."""
    from petastorm_tpu_torch.shuffling_buffer import RandomShufflingBuffer

    if shuffle_buffer_size < 2:
        # a one-slot buffer decorrelates nothing: rows pass straight through
        yield from reader
        return
    buf = RandomShufflingBuffer(shuffle_buffer_size,
                                min_after_retrieve=max(1, shuffle_buffer_size // 2),
                                extra_capacity=max(1000, shuffle_buffer_size), seed=seed)
    for item in reader:
        buf.add_many([item])
        while buf.can_retrieve():
            yield buf.retrieve()
    buf.finish()
    while buf.can_retrieve():
        yield buf.retrieve()


def make_petastorm_dataset(reader, shuffle_buffer_size=0, seed=None):
    """A reader as a ``tf.data.Dataset``.

    Elements are row namedtuples; column-batch namedtuples for batched
    readers; for NGram readers, dicts of ``offset -> per-timestep
    namedtuple``.

    ``shuffle_buffer_size > 0`` decorrelates rows with the seedable
    shuffling buffer before they enter TF; batched readers refuse it, since
    whole row groups would shuffle as units.
    """
    tf = _tf()
    if reader.batched_output and getattr(reader, 'ngram', None) is not None:
        raise ValueError(
            'make_petastorm_dataset does not support columnar NGram readers (nested '
            "window blocks); use make_reader(output='rows', ngram=...) for the TF "
            'surface, or TorchDataLoader for the columnar window path.')
    ngram = getattr(reader, 'ngram', None)

    if shuffle_buffer_size and reader.batched_output:
        raise ValueError(
            'shuffle_buffer_size is not supported with batched readers: whole row-group '
            'batches would shuffle as units. Shuffle via make_reader '
            'shuffle_row_groups/shuffle_row_drop_partitions, or use '
            'dataset.unbatch().shuffle(...).')
    schema = reader.transformed_schema

    def rows():
        if shuffle_buffer_size:
            return _shuffled(reader, shuffle_buffer_size, seed)
        return iter(reader)

    if ngram is not None:
        offsets = sorted(ngram.fields)
        views = {off: ngram.get_schema_at_timestep(schema, off) for off in offsets}
        signature = {off: tuple(_tf_spec(tf, views[off].fields[n], False)
                                for n in views[off].fields)
                     for off in offsets}

        def generator():
            for window in rows():
                yield {off: tuple(_sanitize_field_value(v) for v in window[off])
                       for off in offsets}

        dataset = tf.data.Dataset.from_generator(generator, output_signature=signature)
        view_namedtuples = {off: views[off].namedtuple for off in offsets}
        return dataset.map(
            lambda window: {off: view_namedtuples[off](*window[off]) for off in offsets})

    signature = tuple(_tf_spec(tf, schema.fields[name], reader.batched_output)
                      for name in schema.fields)

    def generator():
        for item in rows():
            yield tuple(_sanitize_field_value(v) for v in item)

    dataset = tf.data.Dataset.from_generator(generator, output_signature=signature)
    namedtuple_type = schema.namedtuple
    return dataset.map(lambda *args: namedtuple_type(*args))


class make_tf_dataset_context(object):
    """Context manager: a fixed-``batch_size`` ``tf.data.Dataset`` over a
    batched reader, closing the reader on exit (the converter's
    ``make_tf_dataset``)."""

    def __init__(self, reader, batch_size=32, prefetch=None):
        self._reader = reader
        self._batch_size = batch_size
        self._prefetch = prefetch

    def __enter__(self):
        try:
            tf = _tf()
            dataset = make_petastorm_dataset(self._reader)
            if self._reader.batched_output:
                # row-group batches -> fixed-size batches
                dataset = dataset.unbatch()
            dataset = dataset.batch(self._batch_size)
            if self._prefetch != 0:
                dataset = dataset.prefetch(self._prefetch or tf.data.AUTOTUNE)
            return dataset
        except Exception:
            # __exit__ never runs when __enter__ raises: do not leak the pool
            self._reader.stop()
            self._reader.join()
            raise

    def __exit__(self, exc_type, exc_value, tb):
        self._reader.stop()
        self._reader.join()
