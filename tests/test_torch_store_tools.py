"""Port parity: the store tools of petastorm_tpu_torch (``copy_dataset``,
``generate_metadata``, ``metadata_util``) and the three routes of
``load_row_groups`` against the JAX package.

Each tool runs on the same store as its JAX twin: a copy (full, a column
subset, a not-null filter, the CLI) must be the JAX copy's store (the same
metadata, the same rows), a regenerated ``_common_metadata`` the JAX tool's,
the printed text the JAX tool's. ``load_row_groups`` must list the JAX
package's pieces by the stored counts, by a ``_metadata`` summary file
(and fall through a malformed one) and by the footers, on a partitioned
store. The stores are the suite's ``synthetic_dataset`` and
``scalar_dataset`` (read only; a tool that writes into a store gets a copy)
and stores under ``tmp_path``."""

import contextlib
import io
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pyarrow.parquet as pq
import pytest

from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu.etl import dataset_metadata as jax_dm
from petastorm_tpu.tools import copy_dataset as jax_copy
from petastorm_tpu.tools import generate_metadata as jax_generate
from petastorm_tpu.tools import metadata_util as jax_metadata_util
from petastorm_tpu_torch import make_reader
from petastorm_tpu_torch.etl import dataset_metadata as dm
from petastorm_tpu_torch.examples.hello_world.petastorm_dataset import (
    generate_petastorm_dataset as hello)
from petastorm_tpu_torch.test_util.stores import write_summary_metadata
from petastorm_tpu_torch.tools import copy_dataset, generate_metadata, metadata_util

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope='module')
def _leave_no_telemetry_state():
    """Both packages' readers arm a process-wide flight recorder and count
    into a process-wide registry: switch off what this module armed and
    clear what it counted, so later files in this process see neither, and
    hold the module to leaving no thread behind."""
    from petastorm_tpu import observability as jax_obs
    from petastorm_tpu.observability import blackbox as jax_blackbox
    from petastorm_tpu_torch import observability as obs
    from petastorm_tpu_torch.observability import blackbox

    armed = (jax_blackbox.get_recorder(), blackbox.get_recorder())
    threads = set(threading.enumerate())
    yield
    if armed[0] is None:
        jax_blackbox.disable()
    if armed[1] is None:
        blackbox.disable()
    for module in (jax_obs, obs):
        module.get_registry().reset()
        module.get_ring().clear()
    deadline = time.monotonic() + 10
    while {t for t in threading.enumerate() if t not in threads and t.is_alive()}:
        assert time.monotonic() < deadline, sorted(
            t.name for t in threading.enumerate() if t not in threads)
        time.sleep(0.05)


def _value_key(value):
    arr = np.asarray(value)
    if arr.dtype.hasobject:  # Decimals, None: by value, not by pointer
        return 'O', repr(value)
    return arr.dtype.str, arr.shape, arr.tobytes()


def _row_key(row):
    return tuple(sorted((k, _value_key(v)) for k, v in row._asdict().items()))


def _rows(url):
    with make_reader(url, reader_pool_type='dummy', shuffle_row_groups=False) as reader:
        ours = sorted(_row_key(r) for r in reader)
    with jax_make_reader(url, reader_pool_type='dummy', shuffle_row_groups=False) as reader:
        assert sorted(_row_key(r) for r in reader) == ours
    return ours


def _assert_same_store(ours, theirs):
    """Two stores hold the same metadata and the same rows (the copy's
    reader runs on threads, so rows are compared as multisets)."""
    assert dm.read_metadata_dict(ours) == jax_dm.read_metadata_dict(theirs)
    assert _rows(ours) == _rows(theirs)


# -- copy_dataset ---------------------------------------------------------------------

COPIES = {
    'full': (dict(rows_per_row_group=25), 100),
    'subset': (dict(field_regex=['id', 'matrix'], rows_per_row_group=50), 100),
    'not_null': (dict(field_regex=['id', 'matrix_nullable'], not_null_fields=['matrix_nullable'],
                      rows_per_row_group=50), 80),  # matrix_nullable is null when id % 5 == 0
}


@pytest.mark.parametrize('case', sorted(COPIES))
def test_copy_equals_the_jax_copy(synthetic_dataset, tmp_path, case):
    kwargs, count = COPIES[case]
    ours, theirs = ('file://' + str(tmp_path / name) for name in ('ours', 'theirs'))
    assert copy_dataset.copy_dataset(synthetic_dataset.url, ours, **kwargs) == count
    assert jax_copy.copy_dataset(synthetic_dataset.url, theirs, **kwargs) == count
    _assert_same_store(ours, theirs)
    schema = dm.get_schema(ours)
    if 'field_regex' in kwargs:
        assert set(schema.fields) == set(kwargs['field_regex'])
    assert len(_rows(ours)) == count


def test_copy_cli_equals_the_jax_cli(synthetic_dataset, tmp_path, capsys):
    ours, theirs = ('file://' + str(tmp_path / name) for name in ('ours', 'theirs'))
    args = ['--field-regex', 'id', 'id2', '--rows-per-row-group', '40', '--rows-per-file', '80',
            '-w', '2']
    assert copy_dataset.main([synthetic_dataset.url, ours] + args) == 0
    out = capsys.readouterr().out
    assert jax_copy.main([synthetic_dataset.url, theirs] + args) == 0
    assert out == capsys.readouterr().out == 'Copied 100 rows\n'
    _assert_same_store(ours, theirs)
    assert sorted(os.listdir(ours[len('file://'):])) == \
        ['_common_metadata', 'part-00000.parquet', 'part-00001.parquet']


def test_copy_tool_runs_as_a_module(synthetic_dataset, tmp_path):
    target = 'file://' + str(tmp_path / 'copy')
    out = subprocess.run([sys.executable, '-m', 'petastorm_tpu_torch.tools.copy_dataset',
                          synthetic_dataset.url, target, '--field-regex', 'id'],
                         cwd=REPO, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout == 'Copied 100 rows\n'
    assert 'jax' not in out.stderr.lower()


# -- generate_metadata ----------------------------------------------------------------

def _hello_store(path):
    url = 'file://' + str(path)
    dm.write_petastorm_dataset(url, hello.HelloWorldSchema,
                               (hello.row_generator(i) for i in range(6)), rows_per_row_group=2)
    return url


def test_generate_metadata_restores_a_lost_common_metadata(tmp_path):
    ours = _hello_store(tmp_path / 'ours')
    written = dm.read_metadata_dict(ours)
    shutil.copytree(tmp_path / 'ours', tmp_path / 'theirs')
    theirs = 'file://' + str(tmp_path / 'theirs')
    for path in (tmp_path / 'ours', tmp_path / 'theirs'):
        (path / '_common_metadata').unlink()
    schema, n_rg = generate_metadata.generate_metadata(
        ours, unischema_class='petastorm_tpu_torch.examples.hello_world.petastorm_dataset.'
                              'generate_petastorm_dataset.HelloWorldSchema')
    jax_schema, jax_n_rg = jax_generate.generate_metadata(
        theirs, unischema_class='examples.hello_world.petastorm_dataset.'
                                'generate_petastorm_dataset.HelloWorldSchema')
    assert (n_rg, schema.to_json()) == (jax_n_rg, jax_schema.to_json()) == \
        (3, hello.HelloWorldSchema.to_json())
    assert dm.read_metadata_dict(ours) == written == jax_dm.read_metadata_dict(theirs)
    with make_reader(ours, reader_pool_type='dummy', shuffle_row_groups=False) as reader:
        row = next(reader)
    np.testing.assert_array_equal(row.image1, hello.row_generator(0)['image1'])


@pytest.mark.parametrize('partition_by', [None, ['string2']])
def test_generate_metadata_infers_a_plain_store_as_jax(tmp_path, partition_by):
    from petastorm_tpu.test_util.dataset_utils import create_scalar_dataset

    # write_to_dataset names its files at random: one store, copied
    urls = {package: 'file://' + str(tmp_path / package) for package in ('torch', 'jax')}
    create_scalar_dataset(urls['torch'], num_rows=40, rows_per_row_group=10,
                          partition_by=partition_by)
    shutil.copytree(tmp_path / 'torch', tmp_path / 'jax')
    schema, n_rg = generate_metadata.generate_metadata(urls['torch'])
    jax_schema, jax_n_rg = jax_generate.generate_metadata(urls['jax'])
    assert n_rg == jax_n_rg and schema.to_json() == jax_schema.to_json()
    assert dm.read_metadata_dict(urls['torch']) == jax_dm.read_metadata_dict(urls['jax'])
    # a partition column is inferred from the path as a str field
    assert schema.fields['string2'].numpy_dtype is np.str_
    # the store now reads through make_reader, partition column included
    assert _rows(urls['torch']) == _rows(urls['jax'])
    assert len(_rows(urls['torch'])) == 40


def test_generate_metadata_counts_come_from_the_footers(tmp_path):
    """A stale stored inventory (a file it does not list) is replaced by
    what the footers say."""
    url = _hello_store(tmp_path / 's')
    shutil.copy(tmp_path / 's' / 'part-00000.parquet', tmp_path / 's' / 'part-00009.parquet')
    assert len(dm.load_row_groups(url)) == 3
    schema, n_rg = generate_metadata.generate_metadata(url)
    assert n_rg == 6 and len(dm.load_row_groups(url)) == 6
    assert schema.to_json() == hello.HelloWorldSchema.to_json()


def test_generate_metadata_refuses_bad_class_paths(scalar_dataset):
    with pytest.raises(ValueError, match='dotted path'):
        generate_metadata.generate_metadata(scalar_dataset.url, unischema_class='NotDotted')
    with pytest.raises(TypeError, match='is not a Unischema'):
        generate_metadata.generate_metadata(
            scalar_dataset.url, unischema_class='petastorm_tpu_torch.generator.LIST_SIZE')


def test_generate_metadata_cli(tmp_path, capsys):
    url = _hello_store(tmp_path / 's')
    assert generate_metadata.main([url]) == 0
    assert capsys.readouterr().out == 'Wrote metadata: schema=3 fields, 3 row groups\n'


# -- metadata_util --------------------------------------------------------------------

@pytest.mark.parametrize('args', [['--schema'], ['--index'], ['--index', '--skip-index-values'],
                                  ['--pieces'], ['--schema', '--index', '--pieces']])
def test_metadata_util_prints_the_jax_tools_text(synthetic_dataset, args):
    outs = []
    for main in (metadata_util.main, jax_metadata_util.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([synthetic_dataset.url] + args) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert outs[0]


def test_metadata_util_prints_partition_keys(tmp_path):
    url = 'file://' + str(tmp_path / 's')
    dm.write_petastorm_dataset(url, hello.HelloWorldSchema,
                               (hello.row_generator(i) for i in range(4)), rows_per_row_group=2,
                               partition_by=['id'])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        metadata_util.main([url, '--pieces'])
    lines = buf.getvalue().splitlines()
    assert len(lines) == 4 and all("partitions={'id': " in line for line in lines)


# -- load_row_groups: the three routes --------------------------------------------------

def _partitioned_store(path):
    url = 'file://' + str(path)
    dm.write_petastorm_dataset(url, hello.HelloWorldSchema,
                               (dict(hello.row_generator(i), id=i % 3) for i in range(12)),
                               rows_per_row_group=2, partition_by=['id'])
    return url


def _listing(pieces):
    return [(p.path, p.row_group, p.num_rows, p.partition_keys) for p in pieces]


def test_load_row_groups_lists_equal_pieces_by_every_route(tmp_path):
    url = _partitioned_store(tmp_path / 's')
    root = str(tmp_path / 's')
    counts = _listing(dm.load_row_groups(url))
    assert counts == _listing(jax_dm.load_row_groups(url))
    assert len(counts) == 6 and {p[3]['id'] for p in counts} == {0, 1, 2}
    # the footers, asked for
    footers = _listing(dm.load_row_groups(url, use_cached_metadata=False,
                                          max_footer_read_threads=2))
    assert footers == counts == _listing(jax_dm.load_row_groups(url, use_cached_metadata=False))
    # the summary file, with no counts stored: the schema passed types the keys
    write_summary_metadata(root)
    assert dm.ROW_GROUPS_PER_FILE_KEY not in dm.read_metadata_dict(url)
    summary = _listing(dm.load_row_groups(url, schema=hello.HelloWorldSchema))
    assert summary == counts == _listing(jax_dm.load_row_groups(url))
    # use_cached_metadata=False skips the summary too: equal all the same
    assert _listing(dm.load_row_groups(url, use_cached_metadata=False)) == counts


def test_a_malformed_summary_falls_through_to_the_footers(tmp_path):
    url = _partitioned_store(tmp_path / 's')
    root = str(tmp_path / 's')
    expected = _listing(dm.load_row_groups(url))
    write_summary_metadata(root)
    # a summary whose row groups name no file
    first = next(os.path.join(d, f) for d, _, fs in sorted(os.walk(root)) for f in sorted(fs)
                 if f.endswith('.parquet'))
    pq.ParquetFile(first).metadata.write_metadata_file(os.path.join(root, '_metadata'))
    assert _listing(dm.load_row_groups(url)) == expected == _listing(jax_dm.load_row_groups(url))


def test_plain_store_with_only_a_summary_file(tmp_path):
    """No ``_common_metadata`` at all: the summary lists the pieces, the keys
    typed as ints where they parse."""
    url = _partitioned_store(tmp_path / 's')
    root = str(tmp_path / 's')
    write_summary_metadata(root)
    os.unlink(os.path.join(root, '_common_metadata'))
    ours = _listing(dm.load_row_groups(url))
    assert ours == _listing(jax_dm.load_row_groups(url))
    assert len(ours) == 6 and all(isinstance(p[3]['id'], int) for p in ours)


def test_smoke_etl_checks_at_small_size(tmp_path, monkeypatch, capsys):
    """``chip_smoke.py``'s ``etl_checks`` on the CPU at a small size: 128
    rows of 32 px in 4 days of 32 rows (8 files), a fifth day appended, the
    process pool's in-place route with 2 workers, the legacy copy, its
    index and migration, the three listing routes and ``generate_metadata``
    under the stored schema and after ``_common_metadata`` is deleted."""
    import json

    import chip_smoke

    images = {}

    def image(i):
        if i not in images:
            images[i] = chip_smoke._photo(np.random.default_rng([7, i]), 32, 32)
        return images[i]

    for name, value in (('ROWS', 128), ('IMAGE_SIZE', 32), ('DAY_ROWS', 32), ('DAYS', 4),
                        ('ETL_WORKERS', 2), ('_image', image)):
        monkeypatch.setattr(chip_smoke, name, value)
    fixed = 'file://' + str(tmp_path / 'png_fixed')
    chip_smoke.build_png_fixed_store(fixed, 'numpy')
    chip_smoke.phase_etl_checks(fixed, str(tmp_path), 16 << 20)
    line = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                       if '"etl_checks"' in ln][-1])
    checks = line['checks']
    assert checks['append']['rows'] == 160 and checks['append']['inplace_batches'] == 10
    assert checks['append']['days'] == ['day={}'.format(d) for d in range(5)]
    assert checks['legacy']['copied_rows'] == 128
    assert checks['listing_routes']['files'] == checks['listing_routes']['pieces'] == 8
    assert {'generate_metadata', 'generate_metadata_inferred'} <= set(
        checks['listing_routes']['seconds'])
