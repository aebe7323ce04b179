"""Store kind ``tokens``, a fixture of the benchmark's own tests: a
petastorm store of packed token rows (``seq_len`` int32 tokens a row,
``RawTensorCodec``) and an int64 row id, each row's tokens drawn from its
row id, read by ``make_reader(output='columnar')``."""

from __future__ import annotations

import numpy as np

from benchmark import storeutil


def _tokens(row_id, config):
    rng = np.random.default_rng([int(row_id), 17])
    return rng.integers(0, config['vocab_size'], config['seq_len'], dtype=np.int32)


def build(path, config, params):
    from petastorm_tpu_torch.codecs import RawTensorCodec, ScalarCodec
    from petastorm_tpu_torch.etl import materialize_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema('Tokens', [
        UnischemaField('tokens', np.int32, (config['seq_len'],), RawTensorCodec(), False),
        UnischemaField('row_id', np.int64, (), ScalarCodec(np.int64), False)])
    with materialize_dataset('file://' + path, schema,
                             rows_per_row_group=params['rows_per_row_group'],
                             compression=params['compression']) as writer:
        for i in range(config['rows']):
            writer.write({'tokens': _tokens(i, config), 'row_id': np.int64(i)})


def open_reader(url, config, params, seed, workers):
    from petastorm_tpu_torch import make_reader

    return make_reader(url, output='columnar', num_epochs=None, seed=seed,
                       shuffle_row_groups=True, reader_pool_type='thread',
                       workers_count=workers)


def expected(path, config, params, row_ids):
    """The reference's rows: each row's tokens drawn again from its row id,
    and how many stored rows differ from them."""
    cells = storeutil.read_rows(path, row_ids, ['tokens'])['tokens']
    made = [_tokens(i, config) for i in row_ids]
    mismatches = sum(int(not np.array_equal(np.frombuffer(c, np.int32), t))
                     for c, t in zip(cells, made))
    return np.stack(made), {'stored_cell_mismatches': mismatches}
