"""Store kind ``raw``: a petastorm store of pre-decoded uint8 images
(``RawTensorCodec``) at the model's input size, an int64 label and an int64
row id, read by ``make_reader(output='columnar')`` on the page-scan route."""

from __future__ import annotations

import functools

import numpy as np

from benchmark import corpus, storeutil

#: rows made at once while building
BUILD_CHUNK = 1024


def _side(config):
    return config['image_size']


def build(path, config, params):
    from petastorm_tpu_torch.codecs import RawTensorCodec, ScalarCodec
    from petastorm_tpu_torch.etl import materialize_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    side, classes = _side(config), config['num_classes']
    schema = Unischema('RawImagenet', [
        UnischemaField('image', np.uint8, (side, side, 3), RawTensorCodec(), False),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64), False),
        UnischemaField('row_id', np.int64, (), ScalarCodec(np.int64), False)])
    with materialize_dataset('file://' + path, schema,
                             rows_per_row_group=params['rows_per_row_group'],
                             compression=params['compression']) as writer:
        for first in range(0, config['rows'], BUILD_CHUNK):
            ids = range(first, min(first + BUILD_CHUNK, config['rows']))
            made = storeutil.process_map(functools.partial(corpus.source_image,
                                                           sides=(side, side)), ids)
            for i, image in zip(ids, made):
                writer.write({'image': image, 'row_id': np.int64(i),
                              'label': np.int64(corpus.label_of(corpus.noun_id(i, classes),
                                                                classes))})


def open_reader(url, config, params, seed, workers):
    from petastorm_tpu_torch import make_reader

    return make_reader(url, output='columnar', num_epochs=None, seed=seed,
                       shuffle_row_groups=True, reader_pool_type='thread',
                       workers_count=workers)


def expected(path, config, params, row_ids):
    """The reference's rows: each image's stored bytes, which must be the
    corpus image, and the label worked out from the row id."""
    side, classes = _side(config), config['num_classes']
    cells = storeutil.read_rows(path, row_ids, ['image'])['image']
    stored = [np.frombuffer(c, np.uint8).reshape(side, side, 3) for c in cells]
    made = storeutil.images(row_ids, (side, side))
    mismatches = sum(int(not np.array_equal(a, b)) for a, b in zip(stored, made))
    labels = np.array([corpus.label_of(corpus.noun_id(i, classes), classes) for i in row_ids],
                      np.int64)
    return storeutil.stack(made), labels, {'stored_cell_mismatches': mismatches}
