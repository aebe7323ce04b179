"""The port's native Parquet read path (``petastorm_tpu_torch/native``: the
C++ row-group reader, the zero-copy page scan and the fused
read->decode->collate) against the JAX package's native reader, on stores
written by either package from a seed. Both libraries come from the same C++
(the port keeps its own copy), so blocks, tables, kernel statuses and
fallback reasons are held to exact equality. End to end, ``make_reader``
blocks and ``TorchDataLoader`` batches of the port on its native reader
equal those of the port on pyarrow and of the JAX package on its native
reader; each smoke path's read routes are checked on a small twin of its
store, and two train steps on the fixed-shape PNG store match the JAX
slice."""

import ctypes
import logging
import os
import pickle
import re
import subprocess
import sys
import threading
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.fs as pafs
import pyarrow.parquet as pq
import pytest
import torch

import chip_smoke
import petastorm_tpu.codecs as jax_codecs
import petastorm_tpu_torch.codecs as codecs
from petastorm_tpu import TransformSpec as JaxTransformSpec
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import native as jax_native
from petastorm_tpu.etl.dataset_metadata import materialize_dataset as jax_materialize_dataset
from petastorm_tpu.jax import JaxDataLoader
from petastorm_tpu.models.resnet import BottleneckBlock as JaxBottleneckBlock
from petastorm_tpu.models.resnet import ResNet as JaxResNet
from petastorm_tpu.models.train import create_train_state as jax_create_train_state
from petastorm_tpu.models.train import make_train_step as jax_make_train_step
from petastorm_tpu.native import fused as jax_fused
from petastorm_tpu.ops import normalize_images as jax_normalize_images
from petastorm_tpu.test_util import native_corpus
from petastorm_tpu.unischema import Unischema as JaxUnischema
from petastorm_tpu.unischema import UnischemaField as JaxField
from petastorm_tpu_torch import TransformSpec, make_reader, native
from petastorm_tpu_torch.etl import materialize_dataset
from petastorm_tpu_torch.models import BottleneckBlock, ResNet
from petastorm_tpu_torch.models.convert import flax_to_torch
from petastorm_tpu_torch.models.train import create_train_state, make_train_step
from petastorm_tpu_torch.native import build, fused, image_codec, pagescan
from petastorm_tpu_torch.ops import normalize_images
from petastorm_tpu_torch.tools.throughput import pipeline_duty_cycle
from petastorm_tpu_torch.torch import TorchDataLoader, stage_batch
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

import cv2  # noqa: E402  (both packages encode images through it)


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
    # every reader was closed: none of their threads is left running
    deadline = time.monotonic() + 10
    while {t for t in threading.enumerate() if t not in threads and t.is_alive()}:
        assert time.monotonic() < deadline, sorted(
            t.name for t in threading.enumerate() if t not in threads)
        time.sleep(0.05)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {'jax': (jax_materialize_dataset, JaxField, JaxUnischema, jax_codecs),
            'torch': (materialize_dataset, UnischemaField, Unischema, codecs)}
SIZE = 32
NUM_CLASSES = 5
BATCH = 8
MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope='module')
def _libraries_loaded():
    """Both readers built and loaded, the JAX package's first: a test that
    switches the port to pyarrow through the environment must find the JAX
    package's decision already taken."""
    assert jax_native.is_available() and native.is_available()


def _parquet_path(url):
    return os.path.join(url[len('file://'):], 'part-00000.parquet')


def _assert_block_equal(actual, expected):
    assert set(actual) == set(expected)
    for name in expected:
        a, e = np.asarray(actual[name]), np.asarray(expected[name])
        assert a.dtype == e.dtype and a.shape == e.shape, (name, a.dtype, e.dtype, a.shape,
                                                           e.shape)
        if e.dtype == object:
            for x, y in zip(a, e):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a, e, err_msg=name)


def _both(path):
    return native.NativeParquetFile(path), jax_native.NativeParquetFile(path)


def _fallbacks():
    return {k.split(':', 1)[1]: v for k, v in native.read_routes.snapshot().items()
            if k.startswith('fused_fallback_reason:') and v}


def _photo(rng, h, w):
    yy = np.linspace(0, 4 * np.pi, h)[:, None, None]
    xx = np.linspace(0, 4 * np.pi, w)[None, :, None]
    phase = rng.uniform(0, 2 * np.pi, 3)[None, None, :]
    base = np.sin(xx + phase) * 70 + np.cos(yy + phase * 0.5) * 60 + 128
    return np.clip(base + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)


# -- the library --------------------------------------------------------------------

def test_reader_builds_into_the_build_dir_and_reports_abi_4():
    assert os.path.dirname(build.OUTPUT) == os.path.join(REPO, '.torch_build', 'native')
    assert os.path.exists(build.OUTPUT)
    assert not any(f.endswith('.so') for f in os.listdir(os.path.dirname(native.__file__)))
    with open(build.SOURCE) as f:
        literal = re.search(r'int pstpu_abi_version\(\) \{ return (\d+); \}', f.read())
    assert native.abi_version() == fused.EXPECTED_ABI == int(literal.group(1)) == 4
    assert fused.EXPECTED_ABI == jax_fused.EXPECTED_ABI
    mtime = os.path.getmtime(build.OUTPUT)
    assert build.build() == build.OUTPUT  # fresh: not rebuilt
    assert os.path.getmtime(build.OUTPUT) == mtime
    # the C++ is the JAX package's, whole, below the port's header, but for
    # the map skip of the thrift reader (MAP_SKIP_FIX)
    with open(build.SOURCE) as ours, open(os.path.join(REPO, 'petastorm_tpu', 'native',
                                                       'rowgroup_reader.cpp')) as theirs:
        body = theirs.read()
        body = body[body.index('#include <arrow/api.h>'):]
        assert body.count(MAP_SKIP_FIX[0]) == 1
        assert ours.read().endswith(body.replace(*MAP_SKIP_FIX))


#: the port's one change to the JAX package's C++: a bool key or value of a
#: thrift map is one byte (the JAX skipper consumes none, so a corrupt map of
#: bools with a huge count never ends)
MAP_SKIP_FIX = ('''
      const uint8_t kv = byte();
      for (uint64_t i = 0; i < n && ok; i++) {
        skip_value(kv >> 4, depth + 1);
        skip_value(kv & 0x0F, depth + 1);
      }
''', '''
      const uint8_t kv = byte();
      // a bool key or value in a map is one byte, as in a list: skipped as
      // a bare field bool (no byte), a map of bools with a corrupt count of
      // up to 2^64 entries consumed nothing and never ended
      const int types[2] = {kv >> 4, kv & 0x0F};
      for (uint64_t i = 0; i < n && ok; i++) {
        for (const int t : types) {
          if (t == 1 || t == 2) skip_bytes(1);
          else skip_value(t, depth + 1);
        }
      }
''')

#: page-header statistics that spell a map of bools with a count near 2^62:
#: a random blob the JAX package's fuzz test can draw, on which its scanner
#: never returns
SPINNING_STATS = bytes.fromhex('2bb7a0899c4411889fbb63bd964af01d81a705a43b4b6ab40e2f8ba90d4391dceeda')


def test_page_scan_rejects_a_corrupt_map_of_bools():
    # in a child with a time limit: the defect hangs instead of failing
    code = '\n'.join([
        'import ctypes, numpy as np',
        'from petastorm_tpu_torch import native',
        'from petastorm_tpu.test_util import native_corpus',
        'lib = native._load_library()',
        'page = native_corpus.plain_page(4, stats={!r} + bytes(1))'.format(SPINNING_STATS),
        'chunk = np.frombuffer(page, np.uint8)',
        'out = [(ctypes.c_ulonglong * 16)(), (ctypes.c_longlong * 16)(),',
        '       (ctypes.c_ulonglong * 16)()]',
        'print([lib.pstpu_scan_plain_pages(chunk.ctypes.data_as(ctypes.c_void_p), chunk.size,',
        '                                  *out, 16, has_def) for has_def in (0, 1)])',
    ])
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         timeout=120, cwd=REPO, env=dict(os.environ, PSTPU_FLIGHT='0'))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == '[-1, -1]'


def test_ctypes_mirrors_match_the_cpp_under_the_jax_packages_abi_rules(tmp_path):
    """The JAX package's PT900-PT902 rules (struct layouts, extern "C"
    signatures against argtypes/restype, the ABI literal) hold for the
    port's bindings, and catch a widened field in a copy of them."""
    from petastorm_tpu.analysis import run_analysis

    port = os.path.join(REPO, 'petastorm_tpu_torch')
    assert run_analysis([port], select=['PT9']) == []
    mutant = tmp_path / 'native'
    mutant.mkdir()
    for name in ('__init__.py', 'fused.py', 'pagescan.py', 'rowgroup_reader.cpp'):
        with open(os.path.join(port, 'native', name)) as f:
            text = f.read()
        if name.endswith('.cpp'):
            text = text.replace('int32_t itemsize;', 'int64_t itemsize;', 1)
        (mutant / name).write_text(text)
    codes = {f.code for f in run_analysis([str(tmp_path)], select=['PT9'])}
    assert 'PT900' in codes


def _reset_loader(monkeypatch):
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_load_failed', False)


def test_a_library_of_another_abi_is_refused_loudly(monkeypatch, tmp_path, caplog):
    path = str(tmp_path / 'x.parquet')
    pq.write_table(pa.table({'x': np.arange(4)}), path)
    _reset_loader(monkeypatch)
    monkeypatch.setattr(fused, 'EXPECTED_ABI', 5)
    with caplog.at_level(logging.WARNING, logger='petastorm_tpu_torch.native'):
        assert not native.is_available()
    assert 'ABI version 4' in caplog.text and 'expects 5' in caplog.text
    assert isinstance(native.open_parquet(path), pq.ParquetFile)


def test_switches_and_remote_filesystems_take_pyarrow(monkeypatch, tmp_path):
    path = str(tmp_path / 'x.parquet')
    table = pa.table({'x': np.arange(4)})
    pq.write_table(table, path)
    assert isinstance(native.open_parquet(path, pafs.LocalFileSystem()), native.NativeParquetFile)
    other = pafs.SubTreeFileSystem(str(tmp_path), pafs.LocalFileSystem())
    pf = native.open_parquet('x.parquet', other)
    assert isinstance(pf, pq.ParquetFile) and pf.read_row_group(0).equals(table)
    pf.close()
    _reset_loader(monkeypatch)
    monkeypatch.setenv('PETASTORM_TPU_DISABLE_NATIVE', '1')
    assert isinstance(native.open_parquet(path), pq.ParquetFile)


# -- scalar columns: every numeric type x codec x encoding x page version --------------

_SCALAR_DTYPES = (np.int8, np.uint8, np.int16, np.uint16, np.int32, np.uint32, np.int64,
                  np.uint64, np.float32, np.float64, np.bool_)


def _scalar_table(n=200):
    cols = {}
    for k, dt in enumerate(_SCALAR_DTYPES):
        # alternate low-cardinality columns (long RLE runs) and unique-ish ones
        # (bit-packed index groups)
        values = (np.arange(n) * (k + 1)) % (5 if k % 2 else 97)
        cols['c_' + np.dtype(dt).name] = pa.array(values.astype(dt))
    return pa.table(cols)


@pytest.mark.parametrize('fields', ['unischema', 'plain'])
@pytest.mark.parametrize('page_version', ['1.0', '2.0'])
@pytest.mark.parametrize('dictionary', [True, False], ids=['dict', 'plain'])
@pytest.mark.parametrize('compression', ['none', 'snappy', 'zstd', 'lz4'])
def test_scalar_columns_match_the_jax_reader(tmp_path, compression, dictionary, page_version,
                                             fields):
    table = _scalar_table()
    path = str(tmp_path / 's.parquet')
    pq.write_table(table, path, row_group_size=50, data_page_size=256,
                   data_page_version=page_version, use_dictionary=dictionary,
                   compression=None if compression == 'none' else compression)
    names = list(table.column_names)

    def schema_fields(field_cls, codec_mod):
        if fields == 'plain':
            return None
        return {n: field_cls(n, np.dtype(dt).type, (), codec_mod.ScalarCodec(dt), False)
                for n, dt in zip(names, _SCALAR_DTYPES)}

    ours, theirs = _both(path)
    ours_fields, theirs_fields = schema_fields(UnischemaField, codecs), schema_fields(JaxField,
                                                                                     jax_codecs)
    native.read_routes.reset()
    fused_columns = rest_columns = 0
    for rg in range(4):
        plan = ours.fused_plan(rg, names, ours_fields)
        assert plan.reasons == theirs.fused_plan(rg, names, theirs_fields).reasons
        block, rest = ours.read_fused(rg, names, ours_fields)
        expected, expected_rest = theirs.read_fused(rg, names, theirs_fields)
        _assert_block_equal(block, expected)
        assert rest == expected_rest
        fused_columns += len(block)
        rest_columns += len(rest)
        for name in block:  # and the values as written
            np.testing.assert_array_equal(block[name],
                                          table.column(name).to_numpy()[rg * 50:(rg + 1) * 50])
        assert ours.read_row_group(rg, columns=rest).equals(
            theirs.read_row_group(rg, columns=rest))
    # bool is bit-packed: never fused; uncompressed PLAIN goes to the page scan
    assert plan.reasons['c_bool'] == 'physical-type'
    if compression != 'none' or dictionary:
        assert fused_columns == 4 * (len(names) - 1)
    counts = native.read_routes.snapshot()
    assert counts['fused_columns_total'] == fused_columns
    assert counts['fused_fallback_total'] == sum(_fallbacks().values())
    assert counts['pagescan_columns_total'] + counts['arrow_fallback_columns_total'] == rest_columns
    # the page scan takes v1 pages only: Arrow serves uncompressed PLAIN v2
    scanned = compression == 'none' and not dictionary and page_version == '1.0'
    assert counts['pagescan_columns_total'] == (4 * (len(names) - 1) if scanned else 0)


# -- raw tensors, npy cells, images --------------------------------------------------

@pytest.mark.parametrize('writer', ['jax', 'torch'])
@pytest.mark.parametrize('compression', ['snappy', 'none'])
def test_flba_raw_tensors_fused_or_page_scanned_like_jax(tmp_path, writer, compression):
    """Snappy FLBA chunks fuse; uncompressed PLAIN ones are served as views
    over the mmapped file, by the page scan."""
    materialize, field_cls, schema_cls, cm = PACKAGES[writer]
    schema = schema_cls('R', [field_cls('t', np.float32, (3, 4), cm.RawTensorCodec(), False),
                              field_cls('i', np.int64, (), cm.ScalarCodec(np.int64), False)])
    url = 'file://' + str(tmp_path)
    rng = np.random.default_rng(1)
    rows = [{'t': rng.random((3, 4)).astype(np.float32), 'i': np.int64(i)} for i in range(20)]
    with materialize(url, schema, rows_per_row_group=5,
                     compression={'t': compression, 'i': compression}) as w:
        for row in rows:
            w.write(row)
    ours, theirs = _both(_parquet_path(url))
    fields = Unischema('R', [UnischemaField('t', np.float32, (3, 4), codecs.RawTensorCodec(),
                                            False),
                             UnischemaField('i', np.int64, (), codecs.ScalarCodec(np.int64),
                                            False)]).fields
    jax_fields = schema.fields if writer == 'jax' else JaxUnischema('R', [
        JaxField('t', np.float32, (3, 4), jax_codecs.RawTensorCodec(), False),
        JaxField('i', np.int64, (), jax_codecs.ScalarCodec(np.int64), False)]).fields
    native.read_routes.reset()
    for rg in range(4):
        block, rest = ours.read_fused(rg, ['t', 'i'], fields)
        expected, expected_rest = theirs.read_fused(rg, ['t', 'i'], jax_fields)
        _assert_block_equal(block, expected)
        assert rest == expected_rest
        views = ours._zerocopy_columns(rg, ['t', 'i'])
        assert sorted(views) == sorted(theirs._zerocopy_columns(rg, ['t', 'i']))
        table = ours.read_row_group(rg, columns=['t', 'i'])
        assert table.equals(theirs.read_row_group(rg, columns=['t', 'i']))
        if compression == 'snappy':
            assert rest == [] and block['t'].flags.writeable and not views
            got = block['t']
        else:
            assert block == {} and sorted(views) == ['i', 't']
            got = codecs.RawTensorCodec().decode_column(fields['t'], table.column('t'))
            assert not got.flags.writeable  # a view over the mmapped file
        np.testing.assert_array_equal(got, np.stack([r['t'] for r in rows[rg * 5:rg * 5 + 5]]))
    counts = native.read_routes.snapshot()
    if compression == 'snappy':
        assert counts['fused_batches_total'] == 4 and counts['fused_columns_total'] == 8
        assert counts['pagescan_columns_total'] == 0
    else:
        assert counts['pagescan_columns_total'] == 8 and counts['fused_batches_total'] == 0
    assert counts['fused_fallback_total'] == 0
    # the whole-table reads above: snappy chunks decode on Arrow C++
    assert counts['arrow_fallback_columns_total'] == (8 if compression == 'snappy' else 0)


@pytest.mark.parametrize('writer', ['jax', 'torch'])
@pytest.mark.parametrize('cells', ['uniform', 'ragged'])
def test_ndarray_npy_cells_fuse_and_ragged_cells_fall_back(tmp_path, writer, cells):
    materialize, field_cls, schema_cls, cm = PACKAGES[writer]
    schema = schema_cls('A', [field_cls('a', np.uint8, (None, 6), cm.NdarrayCodec(), False),
                              field_cls('id', np.int64, (), cm.ScalarCodec(np.int64), False)])
    url = 'file://' + str(tmp_path)
    rng = np.random.default_rng(2)
    rows = [{'a': rng.integers(0, 255, ((5 if cells == 'uniform' else 1 + i % 3), 6),
                               dtype=np.uint8), 'id': np.int64(i)} for i in range(12)]
    with materialize(url, schema, rows_per_row_group=4) as w:
        for row in rows:
            w.write(row)
    ours, theirs = _both(_parquet_path(url))
    ours_fields = _fields_of(url)
    native.read_routes.reset()
    block, rest = ours.read_fused(0, ['a', 'id'], ours_fields)
    expected, expected_rest = theirs.read_fused(0, ['a', 'id'], _jax_fields_of(url))
    _assert_block_equal(block, expected)
    assert rest == expected_rest
    if cells == 'uniform':
        assert block['a'].shape == (4, 5, 6) and block['a'].flags.writeable
        np.testing.assert_array_equal(block['a'], np.stack([r['a'] for r in rows[:4]]))
        assert _fallbacks() == {}
    else:
        assert 'a' not in block and rest == ['a']
        assert _fallbacks() == {'nonuniform': 1}
    # either way the reader gives the rows as written, and as the JAX reader does
    with make_reader(url, reader_pool_type='dummy', shuffle_row_groups=False) as r:
        got = {int(row.id): row.a for row in r}
    with jax_make_reader(url, reader_pool_type='dummy', shuffle_row_groups=False) as r:
        theirs_rows = {int(row.id): row.a for row in r}
    for row in rows:
        np.testing.assert_array_equal(got[int(row['id'])], row['a'])
        np.testing.assert_array_equal(theirs_rows[int(row['id'])], row['a'])


def _fields_of(url):
    from petastorm_tpu_torch.etl import get_schema
    return get_schema(url).fields


def _jax_fields_of(url):
    from petastorm_tpu.etl.dataset_metadata import get_schema_from_dataset_url
    return get_schema_from_dataset_url(url).fields


@pytest.fixture(scope='module')
def reduced_lib(tmp_path_factory):
    """The port's image decoder built without libjpeg, libpng and libdeflate:
    the configuration of the card's host."""
    path = str(tmp_path_factory.mktemp('reduced') / 'libreduced.so')
    return image_codec.bind(ctypes.CDLL(build.build_img(output=path,
                                                        without=('jpeg', 'png', 'deflate'))))


@pytest.mark.parametrize('image_build', ['full', 'reduced'])
@pytest.mark.parametrize('fmt', ['png', 'jpeg'])
def test_fixed_shape_image_column_fused(tmp_path, fmt, image_build, reduced_lib, monkeypatch):
    """PNG fuses exactly on either build of the image decoder. JPEG fuses on
    the full build, as in the JAX package; the reduced build refuses it at
    probe time, so the column falls back (reason ``image-probe``) to the
    codec, which decodes through OpenCV: never wrong pixels."""
    if image_build == 'reduced':
        monkeypatch.setattr(image_codec, '_lib', reduced_lib)
    schema = Unischema('I', [
        UnischemaField('img', np.uint8, (8, 10, 3), codecs.CompressedImageCodec(fmt), False),
        UnischemaField('id', np.int32, (), codecs.ScalarCodec(), False)])
    url = 'file://' + str(tmp_path)
    rng = np.random.default_rng(3)
    rows = [{'img': _photo(rng, 8, 10), 'id': np.int32(i)} for i in range(10)]
    with materialize_dataset(url, schema, rows_per_row_group=5) as w:
        for row in rows:
            w.write(row)
    ours, theirs = _both(_parquet_path(url))
    native.read_routes.reset()
    block, rest = ours.read_fused(0, ['img', 'id'], schema.fields)
    expected, _ = theirs.read_fused(0, ['img', 'id'], _jax_fields_of(url))
    cells = pq.read_table(_parquet_path(url), columns=['img']).column('img').to_pylist()
    reference = [cv2.cvtColor(cv2.imdecode(np.frombuffer(c, np.uint8), cv2.IMREAD_COLOR),
                              cv2.COLOR_BGR2RGB) for c in cells]
    if fmt == 'jpeg' and image_build == 'reduced':
        assert 'img' not in block and rest == ['img'] and _fallbacks() == {'image-probe': 1}
        with make_reader(url, output='columnar', reader_pool_type='dummy',
                         shuffle_row_groups=False) as r:
            images = np.concatenate([b.img for b in r])
        np.testing.assert_array_equal(images, np.stack(reference))
        return
    assert rest == [] and _fallbacks() == {}
    _assert_block_equal(block, expected)
    assert block['img'].shape == (5, 8, 10, 3) and block['img'].flags.writeable
    truth = [r['img'] for r in rows[:5]] if fmt == 'png' else reference[:5]
    np.testing.assert_array_equal(block['img'], np.stack(truth))


def test_one_native_call_per_fused_batch(tmp_path, monkeypatch):
    table = _scalar_table().drop(['c_bool'])
    path = str(tmp_path / 's.parquet')
    pq.write_table(table, path, row_group_size=50, compression='snappy')
    ours = native.NativeParquetFile(path)
    calls, scans = [], []
    real = fused._invoke_read_fused
    monkeypatch.setattr(fused, '_invoke_read_fused', lambda *a: (calls.append(a), real(*a))[1])
    monkeypatch.setattr(pagescan, '_scan_chunk', lambda *a, **k: (scans.append(1), None)[1])
    block, rest = ours.read_fused(0, table.column_names, None)
    assert rest == [] and set(block) == set(table.column_names)
    assert len(calls) == 1 and not scans


# -- corrupt chunks and page caps: refused, with the JAX kernel's status ----------------

def _statuses(lib, fused_mod, chunk_bytes, rows=4):
    """Each mode x codec of the fused kernel on one chunk: (status, out bytes)."""
    chunk = np.frombuffer(chunk_bytes, dtype=np.uint8) if chunk_bytes else np.zeros(0, np.uint8)
    out = []
    for mode in (fused_mod.MODE_FIXED, fused_mod.MODE_BINARY_RAW):
        for codec in sorted(fused_mod.CODEC_BY_NAME.values()):
            plan = fused_mod.ColumnPlan('x')
            plan.mode, plan.codec, plan.itemsize = mode, codec, 8
            plan.strip_npy = mode == fused_mod.MODE_BINARY_RAW
            plan.phys_dtype = plan.out_dtype = np.dtype(np.int64)
            plan.out_shape = (rows,)
            plan.chunk_len = chunk.size
            plan.out_bound = rows * 8
            buf = np.zeros(rows * 8, np.uint8)
            (res,) = fused_mod.read_into(lib, [chunk], [plan], rows, buf, [0])
            out.append((res[:4], buf.tobytes()))
    return out


@pytest.mark.parametrize('case, status', [
    ('v2-with-nulls', 5), ('v2-overdeclared-levels', 5), ('v2-huge-rep-levels', 5),
    ('dict-count-overflow', 9), ('truncated-v2', None)])
def test_corrupt_chunks_refused_like_jax(case, status):
    chunk = {'v2-with-nulls': native_corpus.v2_page(4, num_nulls=1),
             'v2-overdeclared-levels': native_corpus.v2_overdeclared_levels_chunk(),
             'v2-huge-rep-levels': native_corpus.v2_page(4, rep_len=1 << 30),
             'dict-count-overflow': native_corpus.overflow_dict_chunk(),
             'truncated-v2': native_corpus.v2_page(4)[:20]}[case]
    ours = _statuses(native._load_library(), fused, chunk)
    assert ours == _statuses(jax_native._load_library(), jax_fused, chunk)
    plain_uncompressed = ours[0][0][0]
    if status is not None:
        assert plain_uncompressed == status, fused.REASON_BY_STATUS
    else:
        assert plain_uncompressed in (1, 5, 8)
    assert all(res[0] != 0 for res, _ in ours[:1])


def test_fuzzed_chunks_get_the_jax_kernels_answers():
    """The seeded fuzz corpus of the JAX package's tests (mutated,
    truncated and spliced v1/v2 pages, and garbage) through both kernels:
    the same statuses and bytes, never a crash."""
    ours_lib, theirs_lib = native._load_library(), jax_native._load_library()
    for data in native_corpus.fuzz_corpus():
        assert _statuses(ours_lib, fused, data) == _statuses(theirs_lib, jax_fused, data)


def test_page_cap_overflow_is_counted_and_refused(monkeypatch):
    lib = native._load_library()
    chunk = np.frombuffer(native_corpus.plain_page(2) * 3, dtype=np.uint8)
    meta = type('Meta', (), {'data_page_offset': 0, 'total_compressed_size': chunk.size,
                             'path_in_schema': 'x'})()
    native.read_routes.reset()
    monkeypatch.setattr(pagescan, '_MAX_PAGES', 2)
    monkeypatch.setattr(pagescan, '_page_cap_warned', False)
    assert pagescan._scan_chunk(lib, chunk, meta) is None
    assert native.read_routes.snapshot()['pagescan_fallback_reason:page-cap'] == 1
    two = np.frombuffer(native_corpus.plain_page(2) * 2, dtype=np.uint8)
    meta.total_compressed_size = two.size
    assert pagescan._scan_chunk(lib, two, meta) is not None
    # the fused kernel's cap: status 6, reason page-cap
    monkeypatch.setattr(fused, 'MAX_PAGES', 2)
    plan = fused.ColumnPlan('x')
    plan.itemsize, plan.out_dtype, plan.out_shape = 8, np.dtype(np.int64), (6,)
    plan.chunk_len, plan.out_bound = chunk.size, 48
    (res,) = fused.read_into(lib, [chunk], [plan], 6, np.zeros(48, np.uint8), [0])
    assert fused.REASON_BY_STATUS[res[0]] == 'page-cap'


@pytest.mark.parametrize('compression', ['snappy', 'zstd'])
def test_hello_world_shaped_store_fully_fused(tmp_path, compression):
    schema = Unischema('H', [
        UnischemaField('id', np.int32, (), codecs.ScalarCodec(), False),
        UnischemaField('image1', np.uint8, (16, 24, 3), codecs.CompressedImageCodec('png'), False),
        UnischemaField('array_4d', np.uint8, (None, 4, 5, None), codecs.NdarrayCodec(), False)])
    url = 'file://' + str(tmp_path)
    rng = np.random.default_rng(42)
    rows = [{'id': np.int32(i), 'image1': rng.integers(0, 255, (16, 24, 3), np.uint8),
             'array_4d': rng.integers(0, 255, (2, 4, 5, 3), np.uint8)} for i in range(30)]
    with materialize_dataset(url, schema, rows_per_row_group=10, compression=compression) as w:
        for row in rows:
            w.write(row)
    native.read_routes.reset()
    with make_reader(url, reader_pool_type='thread', workers_count=2, shuffle_row_groups=False,
                     num_epochs=1) as reader:
        got = {int(r.id): r for r in reader}
    with jax_make_reader(url, reader_pool_type='dummy', shuffle_row_groups=False) as reader:
        theirs = {int(r.id): r for r in reader}
    assert len(got) == 30
    for r in rows:
        for name in ('image1', 'array_4d'):
            np.testing.assert_array_equal(getattr(got[int(r['id'])], name), r[name])
            np.testing.assert_array_equal(getattr(theirs[int(r['id'])], name), r[name])
    counts = native.read_routes.snapshot()
    assert counts['fused_batches_total'] == 3 and counts['fused_columns_total'] == 9
    assert counts['fused_fallback_total'] == counts['arrow_fallback_columns_total'] == 0
    assert counts['pagescan_columns_total'] == 0


# -- end to end: the port on its native reader, on pyarrow, and the JAX reader ---------

class LabelFromNounId(object):
    """The ImageNet example's batched label transform (crc32 of the synset)."""

    def __call__(self, block):
        labels = np.fromiter((zlib.crc32(str(n).encode()) % NUM_CLASSES for n in block['noun_id']),
                             dtype=np.int64, count=len(block['noun_id']))
        return {'image': block['image'], 'label': labels}


class MarkCorner(object):
    """A batched transform that writes into the page-scan image column."""

    def __call__(self, block):
        block['image'][:, 0, 0] = 255
        return block


def _write_store(url, kind, package):
    materialize, field_cls, schema_cls, cm = PACKAGES[package]
    rng = np.random.default_rng(5)
    if kind == 'png':
        schema = schema_cls('ImagenetSchema', [
            field_cls('noun_id', np.str_, (), cm.ScalarCodec(), False),
            field_cls('text', np.str_, (), cm.ScalarCodec(), False),
            field_cls('image', np.uint8, (None, None, 3), cm.CompressedImageCodec('png'), False)])
        with materialize(url, schema, rows_per_row_group=8) as w:
            for i in range(48):
                w.write({'noun_id': 'n{:08d}'.format(i // 16), 'text': 'synset {}'.format(i // 16),
                         'image': _photo(rng, int(rng.integers(20, 64)), int(rng.integers(20, 64)))})
        return
    codec = cm.RawTensorCodec() if kind == 'raw' else cm.CompressedImageCodec('png')
    schema = schema_cls('Fixed', [field_cls('image', np.uint8, (SIZE, SIZE, 3), codec, False),
                                  field_cls('label', np.int64, (), cm.ScalarCodec(np.int64),
                                            False)])
    with materialize(url, schema, rows_per_row_group=16,
                     **({'compression': 'none'} if kind == 'raw' else {})) as w:
        for i in range(64):
            w.write({'image': _photo(rng, SIZE, SIZE), 'label': np.int64(i % NUM_CLASSES)})


@pytest.fixture(scope='module')
def stores(tmp_path_factory):
    urls = {}
    for kind, package in (('raw', 'torch'), ('png', 'jax'), ('png_fixed', 'torch'),
                          ('png_fixed_jax', 'jax')):
        url = 'file://' + str(tmp_path_factory.mktemp(kind))
        _write_store(url, kind.replace('_jax', ''), package)
        urls[kind] = url
    return urls


def _transforms(kind):
    """``(port spec, JAX spec)`` for a store's end-to-end read."""
    if kind == 'raw':
        return TransformSpec(MarkCorner(), batched=True), JaxTransformSpec(MarkCorner(),
                                                                           batched=True)
    if kind == 'png':
        def spec(spec_cls, field_cls):
            return spec_cls(LabelFromNounId(),
                            edit_fields=[field_cls('image', np.uint8, (SIZE, SIZE, 3), None, False),
                                         field_cls('label', np.int64, (), None, False)],
                            removed_fields=['noun_id', 'text'], batched=True,
                            image_resize={'image': (SIZE, SIZE)})
        return spec(TransformSpec, UnischemaField), spec(JaxTransformSpec, JaxField)
    return None, None


def _blocks_and_batches(factory, loader_cls, url, **kwargs):
    with factory(url, output='columnar', reader_pool_type='dummy', seed=7, **kwargs) as reader:
        blocks = [dict(b._asdict()) for b in reader]
    with factory(url, output='columnar', reader_pool_type='dummy', seed=7, **kwargs) as reader:
        batches = [{k: np.asarray(v) for k, v in b.items()}
                   for b in loader_cls(reader, BATCH, shuffling_queue_capacity=16, seed=7)]
    return blocks, batches


def _assert_runs_equal(actual, expected):
    for a, e in zip(actual, expected):
        assert len(a) == len(e) > 0
        for x, y in zip(a, e):
            _assert_block_equal(x, y)


@pytest.mark.parametrize('kind', ['raw', 'png', 'png_fixed', 'png_fixed_jax'])
def test_reader_and_loader_match_across_routes_and_packages(stores, kind, monkeypatch,
                                                           tmp_path):
    url = stores[kind]
    spec, jax_spec = _transforms(kind)
    expected = _blocks_and_batches(jax_make_reader, JaxDataLoader, url, transform_spec=jax_spec)
    native.read_routes.reset()
    on_native = _blocks_and_batches(make_reader, TorchDataLoader, url, transform_spec=spec)
    routes = native.read_routes.snapshot()
    _assert_runs_equal(on_native, expected)
    # the local-disk cache pickles the blocks (page-scan views among them)
    cache = dict(cache_type='local-disk', cache_location=str(tmp_path / 'cache'),
                 cache_size_limit=1 << 30, cache_row_size_estimate=4096)
    for _ in range(2):  # fill, then read back
        _assert_runs_equal(_blocks_and_batches(make_reader, TorchDataLoader, url,
                                               transform_spec=spec, **cache), expected)
    with make_reader(url, reader_pool_type='dummy', transform_spec=spec, **cache) as reader:
        list(reader)
        assert reader.cache.stats()['misses'] == 0
    _reset_loader(monkeypatch)
    monkeypatch.setenv('PETASTORM_TPU_DISABLE_NATIVE', '1')
    native.read_routes.reset()
    _assert_runs_equal(_blocks_and_batches(make_reader, TorchDataLoader, url,
                                           transform_spec=spec), expected)
    assert not any(native.read_routes.snapshot().values())  # pyarrow: no native route
    if kind == 'raw':
        assert routes['pagescan_columns_total'] == 2 * 2 * 4  # two readers, 4 row groups
        assert expected[0][0]['image'][:, 0, 0].min() == 255
    elif kind == 'png':
        assert routes['arrow_fallback_columns_total'] == 3 * 2 * 6
        assert routes['fused_fallback_reason:image-hints'] == 2 * 6
    else:
        assert routes['fused_batches_total'] == 2 * 4 and routes['fused_columns_total'] == 16
        assert routes['arrow_fallback_columns_total'] == routes['fused_fallback_total'] == 0


def test_page_scan_views_are_read_only_and_survive_infeed_cache_and_transforms(stores):
    url = stores['raw']
    pf = native.open_parquet(_parquet_path(url))
    table = pf.read_row_group(0, columns=['image', 'label'])
    fields = _fields_of(url)
    image = codecs.RawTensorCodec().decode_column(fields['image'], table.column('image'))
    label = codecs.ScalarCodec(np.int64).decode_column(fields['label'], table.column('label'))
    assert not image.flags.writeable and not label.flags.writeable
    staged = stage_batch({'image': image, 'label': label}, 'cpu')
    assert torch.equal(staged['image'], torch.from_numpy(image.copy()))
    restored = pickle.loads(pickle.dumps({'image': image}))
    np.testing.assert_array_equal(restored['image'], image)
    with make_reader(url, output='columnar', reader_pool_type='dummy', seed=7,
                     transform_spec=TransformSpec(MarkCorner(), batched=True)) as reader:
        marked = next(reader).image
    assert marked[:, 0, 0].min() == 255 and marked.flags.writeable
    pf.close()


# -- each smoke path's read routes, on a small twin of its store -----------------------

@pytest.fixture(scope='module')
def smoke_stores(tmp_path_factory):
    urls = {}
    for name in ('raw', 'png', 'jpeg', 'png_fixed'):
        url = 'file://' + str(tmp_path_factory.mktemp('smoke_' + name))
        if name == 'raw':
            _write_store(url, 'raw', 'torch')
        elif name == 'png_fixed':
            _write_store(url, 'png_fixed', 'torch')
        else:
            schema = Unischema('ImagenetSchema', [
                UnischemaField('noun_id', np.str_, (), codecs.ScalarCodec(), False),
                UnischemaField('text', np.str_, (), codecs.ScalarCodec(), False),
                UnischemaField('image', np.uint8, (None, None, 3),
                               codecs.CompressedImageCodec(name), False)])
            rng = np.random.default_rng(6)
            with materialize_dataset(url, schema, rows_per_row_group=8) as w:
                for i in range(32):
                    w.write({'noun_id': 'n{:08d}'.format(i // 8), 'text': 't',
                             'image': _photo(rng, int(rng.integers(20, 48)),
                                             int(rng.integers(20, 48)))})
        urls[name] = url
    return urls


@pytest.mark.parametrize('path', ['raw', 'png', 'png_cached', 'jpeg', 'png_fixed'])
def test_smoke_paths_read_through_their_routes(smoke_stores, path, tmp_path):
    url = smoke_stores['png' if path == 'png_cached' else path]
    kwargs = {'seed': 7, 'workers_count': 2}
    if path in ('png', 'png_cached', 'jpeg'):
        kwargs['transform_spec'] = chip_smoke.image_transform()
    if path == 'png_cached':
        kwargs.update(cache_type='local-disk', cache_location=str(tmp_path))
        with make_reader(url, num_epochs=1, **kwargs) as reader:
            list(reader)
    result = pipeline_duty_cycle(url, lambda images, labels: None,
                                 lambda b: (b['image'], b['label']), batch_size=BATCH, steps=3,
                                 warmup_steps=1, device='cpu', reader_kwargs=kwargs,
                                 loader_kwargs={'shuffling_queue_capacity': 16, 'seed': 7})
    chip_smoke.check_read_routes(path, result.extra['read_routes'])
    # and the check refuses another path's routes
    other = {'raw': 'png_fixed', 'png_fixed': 'raw', 'png_cached': 'raw'}.get(path, 'png_cached')
    with pytest.raises(AssertionError, match='unexpected routes'):
        chip_smoke.check_read_routes(other, result.extra['read_routes'])


# -- the png_fixed slice: two train steps against the JAX slice ------------------------

def _jax_losses(url, variables, steps):
    model = JaxResNet(stage_sizes=[1, 1, 1, 1], block_cls=JaxBottleneckBlock,
                      num_classes=NUM_CLASSES, num_filters=8, dtype=jnp.float32)
    state = jax_create_train_state(model, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    state = state.replace(params=variables['params'], batch_stats=variables['batch_stats'])
    step = jax_make_train_step(donate=False, preprocess_fn=lambda x, rng: jax_normalize_images(
        x, MEAN, STD, out_dtype=jnp.float32))
    losses = []
    with jax_make_reader(url, output='columnar', reader_pool_type='dummy', seed=7) as reader:
        batches = iter(JaxDataLoader(reader, BATCH, shuffling_queue_capacity=16, seed=7))
        for _ in range(steps):
            batch = next(batches)
            state, metrics = step(state, batch['image'], batch['label'])
            losses.append(float(metrics['loss']))
    return losses


def _torch_losses(url, variables, steps):
    model = ResNet([1, 1, 1, 1], BottleneckBlock, num_classes=NUM_CLASSES, num_filters=8,
                   dtype=torch.float32)
    model.load_state_dict(flax_to_torch(variables))
    state = create_train_state(model, device='cpu')
    step = make_train_step(preprocess_fn=lambda x, generator: normalize_images(
        x, MEAN, STD, out_dtype=torch.float32))
    losses = []
    with make_reader(url, output='columnar', reader_pool_type='dummy', seed=7) as reader:
        batches = iter(TorchDataLoader(reader, BATCH, shuffling_queue_capacity=16, seed=7))
        for _ in range(steps):
            batch = next(batches)
            state, metrics = step(state, torch.from_numpy(batch['image']),
                                  torch.from_numpy(batch['label']))
            losses.append(metrics['loss'].item())
    return losses


def test_two_train_steps_match_jax_png_fixed_slice(stores):
    # the fixed-shape PNG store read by the fused native call in both
    # packages; 1e-3 covers float32 sums in another order through a forward,
    # a backward and one SGD update
    model = JaxResNet(stage_sizes=[1, 1, 1, 1], block_cls=JaxBottleneckBlock,
                      num_classes=NUM_CLASSES, num_filters=8, dtype=jnp.float32)
    variables = jax.device_get(model.init(jax.random.PRNGKey(1), jnp.zeros((1, SIZE, SIZE, 3)),
                                          train=False))
    variables = {k: dict(v) for k, v in variables.items()}
    url = stores['png_fixed']
    expected = _jax_losses(url, variables, steps=2)
    native.read_routes.reset()
    actual = _torch_losses(url, variables, steps=2)
    assert native.read_routes.snapshot()['fused_batches_total'] > 0
    assert all(np.isfinite(actual)) and actual[0] != actual[1]
    np.testing.assert_allclose(actual, expected, atol=1e-3, rtol=1e-3)


def test_route_counts_lose_no_update_under_thread_switches():
    """``read_routes`` is added to from every worker thread at once."""
    import sys
    import threading

    counts = native.RouteCounts(('a',))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda k=k: [counts.add('a') or counts.add(
            'reason:{}'.format(k % 3), 2) for _ in range(2000)]) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    snapshot = counts.snapshot()
    assert snapshot['a'] == 16 * 2000
    assert sum(v for k, v in snapshot.items() if k.startswith('reason:')) == 2 * 16 * 2000
    counts.reset()
    assert counts.snapshot() == {'a': 0}
