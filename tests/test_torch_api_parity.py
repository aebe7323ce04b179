"""Port parity: the public names of the JAX package's modules, and the last
ones the port's twin modules took over.

``test_twin_modules_have_every_public_name`` is the guard: for every JAX
module with a twin in the port (the same path under ``petastorm_tpu_torch``),
each public function and class the JAX module defines, and each public
member of those classes, must exist in the twin. The few differences that
are by design stand in ``BY_DESIGN``, each with its reason.

The other tests hold each name the port took over last against the JAX
function on the same inputs. Every reader is closed through ``with``; the
module leaves no flight recorder, telemetry state or thread behind."""

import ast
import dataclasses
import importlib
import inspect
import os
import shutil
import textwrap
import threading
import time

import cv2
import numpy as np
import pyarrow as pa
import pyarrow.fs as pafs
import pyarrow.parquet as pq
import pytest

import petastorm_tpu
import petastorm_tpu_torch
from petastorm_tpu import columnar as jax_columnar
from petastorm_tpu import errors as jax_errors
from petastorm_tpu import make_reader as jax_make_reader
from petastorm_tpu import native as jax_native
from petastorm_tpu import observability as jax_obs
from petastorm_tpu import shuffling_buffer as jax_shuffling_buffer
from petastorm_tpu import unischema as jax_unischema
from petastorm_tpu.codecs import ScalarCodec as JaxScalarCodec
from petastorm_tpu.elastic.coordinator import ElasticVentilator as JaxElasticVentilator
from petastorm_tpu.etl import dataset_metadata as jax_dataset_metadata
from petastorm_tpu.native import build as jax_build
from petastorm_tpu.native import fused as jax_fused
from petastorm_tpu.native import image_codec as jax_image_codec
from petastorm_tpu.native import shm_ring as jax_shm_ring
from petastorm_tpu.serve.client import ServedReader as JaxServedReader
from petastorm_tpu.workers import protocol as jax_protocol
from petastorm_tpu.workers import thread_pool as jax_thread_pool
from petastorm_tpu.workers import ventilator as jax_ventilator
from petastorm_tpu.workers.worker_base import WorkerBase as JaxWorkerBase
from petastorm_tpu_torch import columnar, errors, make_reader, native
from petastorm_tpu_torch import observability as obs
from petastorm_tpu_torch import shuffling_buffer, unischema
from petastorm_tpu_torch.codecs import ScalarCodec
from petastorm_tpu_torch.elastic.coordinator import ElasticVentilator
from petastorm_tpu_torch.etl import dataset_metadata
from petastorm_tpu_torch.native import build, fused, image_codec, shm_ring
from petastorm_tpu_torch.reader import Reader
from petastorm_tpu_torch.serve.client import ServedReader
from petastorm_tpu_torch.workers import ThreadPool, protocol, ventilator
from petastorm_tpu_torch.workers.worker_base import WorkerBase

#: the JAX package's public names the port leaves out by design:
#: (module, class or function, member or None) -> the reason
BY_DESIGN = {
    ('spark.dataset_converter', 'DatasetConverter', 'make_jax_loader'):
        'the converter hands out torch loaders (make_torch_loader)',
    ('spark.dataset_converter', 'SparkDatasetConverter', 'make_jax_loader'):
        'the converter hands out torch loaders (make_torch_loader)',
    ('models.train', 'TrainState', 'apply_fn'):
        "a flax struct field: the port's state holds the torch model and optimizer",
    ('models.train', 'TrainState', 'params'):
        "a flax struct field: the port's state holds the torch model and optimizer",
    ('models.train', 'TrainState', 'tx'):
        "a flax struct field: the port's state holds the torch model and optimizer",
    ('models.train', 'TrainState', 'opt_state'):
        "a flax struct field: the port's state holds the torch model and optimizer",
    ('models.train', 'TrainState', 'batch_stats'):
        'a flax struct field: batch norm keeps its statistics in the torch model',
    ('models.train', 'TrainState', 'replace'):
        "flax's functional update: the torch state is updated in place",
}
BY_DESIGN.update({
    ('test_util.stub_workers', name, None): 'a helper of the JAX tests only'
    for name in ('ArrowTableWorker', 'BlobWorker', 'DoubleOutputWorker', 'EnvEchoWorker',
                 'ProtocolEchoWorker', 'SetupArgsEchoWorker', 'SleepyIdentityWorker',
                 'ZeroOutputWorker')})
#: flax modules' dataclass fields and ``parent``/``name``/``scope`` are
#: flax's configuration; a torch module takes its configuration in
#: ``__init__`` and keeps what it needs under its own names
FLAX_MODULE_MEMBERS = ('parent', 'name', 'scope')


@pytest.fixture(autouse=True, scope='module')
def _leave_no_telemetry_state():
    """Both packages' readers arm a process-wide flight recorder and count
    into a process-wide registry: switch off what this module armed and
    clear what it counted, so later files in this process see neither, and
    hold the module to leaving no thread behind."""
    from petastorm_tpu.observability import blackbox as jax_blackbox
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


# -- the guard ------------------------------------------------------------------------

def _module_names(package):
    root = os.path.dirname(package.__file__)
    names = set()
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith('.py') or f == '__main__.py':
                continue
            parts = os.path.relpath(os.path.join(dirpath, f), root)[:-3].split(os.sep)
            if parts[-1] == '__init__':
                parts = parts[:-1]
            names.add('.'.join(parts))
    return names


def _is_flax_module(cls):
    import flax.linen as nn
    return issubclass(cls, nn.Module)


def _members(cls, package):
    """The public members a class of ``package`` defines along its MRO:
    attributes, annotations and dataclass fields."""
    names = set()
    for klass in cls.__mro__:
        if klass.__module__.split('.')[0] != package:
            continue
        names.update(vars(klass))
        names.update(getattr(klass, '__annotations__', {}))
    if dataclasses.is_dataclass(cls):
        names.update(f.name for f in dataclasses.fields(cls))
    return {n for n in names if not n.startswith('_')}


def _instance_attributes(cls, package):
    """The ``self.<name> = ...`` targets in the methods of ``cls`` and its
    bases in ``package``: the members an instance has."""
    names = set()
    for klass in cls.__mro__:
        if klass.__module__.split('.')[0] != package:
            continue
        try:
            source = textwrap.dedent(inspect.getsource(klass))
        except (OSError, TypeError):
            continue
        for node in ast.walk(ast.parse(source)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target] if isinstance(node, (ast.AnnAssign, ast.AugAssign))
                       else [])
            for target in targets:
                for sub in ast.walk(target):
                    if (isinstance(sub, ast.Attribute) and isinstance(sub.value, ast.Name)
                            and sub.value.id == 'self'):
                        names.add(sub.attr)
    return names


def _missing_names():
    """(module, name, member) of every public JAX name a twin lacks."""
    missing = set()
    for rel in sorted(_module_names(petastorm_tpu) & _module_names(petastorm_tpu_torch)):
        suffix = '.' + rel if rel else ''
        jax_module = importlib.import_module('petastorm_tpu' + suffix)
        twin = importlib.import_module('petastorm_tpu_torch' + suffix)
        for name, obj in vars(jax_module).items():
            if name.startswith('_') or not (inspect.isfunction(obj) or inspect.isclass(obj)):
                continue
            if obj.__module__ != jax_module.__name__:
                continue  # imported, not defined there
            if not hasattr(twin, name):
                missing.add((rel, name, None))
                continue
            twin_obj = getattr(twin, name)
            if not (inspect.isclass(obj) and inspect.isclass(twin_obj)):
                continue
            have = (set(dir(twin_obj)) | _members(twin_obj, 'petastorm_tpu_torch')
                    | _instance_attributes(twin_obj, 'petastorm_tpu_torch'))
            flax_fields = set()
            if _is_flax_module(obj):
                flax_fields = {f.name for f in dataclasses.fields(obj)} | set(FLAX_MODULE_MEMBERS)
            for member in _members(obj, 'petastorm_tpu') - have - flax_fields:
                missing.add((rel, name, member))
    return missing


def test_twin_modules_have_every_public_name():
    missing = _missing_names()
    assert sorted(missing - set(BY_DESIGN)) == []
    # and the allowance stays no wider than what it allows
    assert sorted(set(BY_DESIGN) - missing) == []


# -- the names the port took over last ------------------------------------------------

def _schemas():
    def fields(package_field, codec):
        return [package_field('a', np.int32, (), codec(), False),
                package_field('b', np.int32, (), codec(), True),
                package_field('c', np.float64, (), codec(), True)]
    return (jax_unischema.Unischema('S', fields(jax_unischema.UnischemaField, JaxScalarCodec)),
            unischema.Unischema('S', fields(unischema.UnischemaField, ScalarCodec)))


@pytest.mark.parametrize('row', [{'a': 1}, {'a': 1, 'b': 2}, {'a': 1, 'b': None, 'c': 0.5}])
def test_insert_explicit_nulls_matches_jax(row):
    jax_schema, schema = _schemas()
    ours, theirs = dict(row), dict(row)
    unischema.insert_explicit_nulls(schema, ours)
    jax_unischema.insert_explicit_nulls(jax_schema, theirs)
    assert ours == theirs and list(ours) == list(theirs)
    assert set(ours) == {'a', 'b', 'c'}


def test_insert_explicit_nulls_refuses_a_missing_required_field():
    jax_schema, schema = _schemas()
    with pytest.raises(jax_errors.SchemaError) as jax_exc:
        jax_unischema.insert_explicit_nulls(jax_schema, {'b': 2})
    with pytest.raises(errors.SchemaError, match=str(jax_exc.value)):
        unischema.insert_explicit_nulls(schema, {'b': 2})


def test_make_namedtuple_from_dict_matches_jax():
    jax_schema, schema = _schemas()
    row = {'c': 2.5, 'b': None, 'a': 7, 'ignored': 'x'}
    ours = schema.make_namedtuple_from_dict(row)
    theirs = jax_schema.make_namedtuple_from_dict(row)
    assert tuple(ours) == tuple(theirs) == (7, None, 2.5)
    assert ours._fields == theirs._fields
    assert ours == schema.make_namedtuple(a=7, b=None, c=2.5)
    with pytest.raises(KeyError):
        schema.make_namedtuple_from_dict({'a': 1})


def test_read_metadata_value_matches_jax(synthetic_dataset):
    url = synthetic_dataset.url
    keys = list(jax_dataset_metadata.read_metadata_dict(url))
    assert keys
    for key in keys + [b'no-such-key']:
        assert (dataset_metadata.read_metadata_value(url, key)
                == jax_dataset_metadata.read_metadata_value(url, key))
    assert dataset_metadata.read_metadata_value(url, b'no-such-key') is None


def test_list_parquet_files_matches_jax(synthetic_dataset, tmp_path):
    root = tmp_path / 'store'
    shutil.copytree(synthetic_dataset.path, str(root))
    os.makedirs(str(root / 'nested'))
    for extra in ('_SUCCESS', '.hidden.parquet', 'part.parquet.crc', 'nested/deep.parquet',
                  'nested/_temporary'):
        (root / extra).write_bytes(b'')
    fs = pafs.LocalFileSystem()
    ours = dataset_metadata.list_parquet_files(fs, str(root))
    assert ours == jax_dataset_metadata.list_parquet_files(fs, str(root))
    assert ours == sorted(ours) and str(root / 'nested/deep.parquet') in ours
    assert not any(os.path.basename(p).startswith(('_', '.')) or p.endswith('.crc')
                   for p in ours)


def test_next_is_the_iterator_step(synthetic_dataset):
    assert Reader.next is Reader.__next__ and ServedReader.next is ServedReader.__next__
    assert JaxServedReader.next is JaxServedReader.__next__
    kwargs = dict(schema_fields=['id'], reader_pool_type='dummy', shuffle_row_groups=False,
                  num_epochs=1)
    with make_reader(synthetic_dataset.url, **kwargs) as ours, \
            jax_make_reader(synthetic_dataset.url, **kwargs) as theirs:
        assert [int(ours.next().id) for _ in range(15)] == \
            [int(theirs.next().id) for _ in range(15)]


def _flood_worker(base, seen):
    class FloodWorker(base):
        """Publishes until its pool stops, and records what publish raised."""

        def process(self, value):
            try:
                for i in range(10 ** 6):
                    self.publish(i)
            except Exception as exc:  # noqa: BLE001 - recorded, then re-raised
                seen.append(type(exc))
                raise
    return FloodWorker


@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_a_publish_into_a_stopping_pool_raises_worker_termination(package):
    pool_cls, base, expected = {
        'jax': (jax_thread_pool.ThreadPool, JaxWorkerBase, jax_errors.WorkerTerminationRequested),
        'torch': (ThreadPool, WorkerBase, errors.WorkerTerminationRequested)}[package]
    seen = []
    pool = pool_cls(1, 2)
    pool.start(_flood_worker(base, seen))
    pool.ventilate(0)
    deadline = time.monotonic() + 20
    while pool.results_qsize < 2:  # the worker now waits on the full queue
        assert time.monotonic() < deadline
        time.sleep(0.01)
    pool.stop()
    pool.join()
    assert seen == [expected]
    assert issubclass(errors.WorkerTerminationRequested, errors.PetastormTpuError)
    assert issubclass(jax_errors.WorkerTerminationRequested, jax_errors.PetastormTpuError)


def _block():
    return {'a': np.arange(4), 'b': np.array(['w', 'x', 'y', 'z'], dtype=object),
            'c': np.arange(8, dtype=np.float32).reshape(4, 2)}


def _same_rows(ours, theirs):
    assert len(ours) == len(theirs)
    for r, t in zip(ours, theirs):
        assert list(r) == list(t)
        for name in r:
            np.testing.assert_array_equal(r[name], t[name])


@pytest.mark.parametrize('order', [None, ['c', 'a'], ['b', 'c', 'a']])
def test_block_to_rows_and_back_match_jax(order):
    ours = columnar.block_to_rows(_block(), order)
    theirs = jax_columnar.block_to_rows(_block(), order)
    _same_rows(ours, theirs)
    assert list(ours[0]) == (order or ['a', 'b', 'c'])
    back_order = list(reversed(order)) if order else None
    ours_block = columnar.rows_to_block(ours, back_order)
    theirs_block = jax_columnar.rows_to_block(theirs, back_order)
    assert list(ours_block) == list(theirs_block)
    for name in ours_block:
        assert ours_block[name].dtype == theirs_block[name].dtype
        np.testing.assert_array_equal(ours_block[name], theirs_block[name])


@pytest.fixture(scope='module')
def parquet_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('native_file') / 'part.parquet')
    table = pa.table({'x': np.arange(23, dtype=np.int64), 'y': np.arange(23) * 0.5})
    pq.write_table(table, path, row_group_size=10)  # row groups of 10, 10 and 3
    return path


@pytest.mark.parametrize('use_threads,buffer_size', [(True, 0), (False, 0), (False, 1 << 16)])
def test_native_parquet_file_row_group_num_rows_matches_jax(parquet_file, use_threads,
                                                            buffer_size):
    assert native.is_available() and jax_native.is_available()
    ours = native.NativeParquetFile(parquet_file, use_threads, buffer_size)
    theirs = jax_native.NativeParquetFile(parquet_file, use_threads=use_threads,
                                          buffer_size=buffer_size)
    counts = [ours.row_group_num_rows(i) for i in range(3)]
    assert counts == [theirs.row_group_num_rows(i) for i in range(3)] == [10, 10, 3]
    with pytest.raises(IndexError):
        ours.row_group_num_rows(3)
    with pytest.raises(IndexError):
        theirs.row_group_num_rows(3)
    assert ours.read_row_group(2, columns=['x']).column('x').to_pylist() == [20, 21, 22]


def test_column_plan_carries_field_shape():
    assert set(fused.ColumnPlan.__slots__) == set(jax_fused.ColumnPlan.__slots__)
    ours, theirs = fused.ColumnPlan('image'), jax_fused.ColumnPlan('image')
    assert ours.field_shape is None and theirs.field_shape is None
    for slot in fused.ColumnPlan.__slots__:
        assert getattr(ours, slot) == getattr(theirs, slot), slot


def _pngs(shapes):
    """Random images and their PNG cells (cv2 writes colour from BGR)."""
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, shape, dtype=np.uint8) for shape in shapes]
    return images, [cv2.imencode('.png', img[..., ::-1] if img.ndim == 3 else img)[1].tobytes()
                    for img in images]


@pytest.mark.parametrize('shapes,min_size', [
    ([(6, 8, 3)] * 4, None),
    ([(6, 8, 3)] * 3, (6, 8)),
    ([(5, 7)] * 2, None),
    ([(6, 8, 3), (7, 8, 3)], None),
    ([], None),
])
def test_decode_images_block_matches_jax(shapes, min_size):
    images, buffers = _pngs(shapes)
    ours = image_codec.decode_images_block(buffers, threads=2, min_size=min_size)
    theirs = jax_image_codec.decode_images_block(buffers, threads=2, min_size=min_size)
    if len(set(shapes)) != 1:
        assert ours is None and theirs is None
        return
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    assert ours.shape == (len(shapes),) + shapes[0]
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, np.stack(images))


def test_add_seconds_matches_jax():
    saved = (jax_obs.current_config(), obs.current_config())
    try:
        for module in (jax_obs, obs):
            module.configure('counters')
            module.add_seconds('parity_wait_s', 0.25)
            module.add_seconds('parity_wait_s', 0.5)
            module.configure('off')
            module.add_seconds('parity_wait_s', 4.0)  # a no-op at 'off'
        values = [module.get_registry().counter('parity_wait_s').value
                  for module in (jax_obs, obs)]
        assert values == [0.75, 0.75]
    finally:
        jax_obs.configure(saved[0])
        obs.configure(saved[1])
    assert 'add_seconds' in obs.__all__


def _buffer_script(module):
    """``can_add`` (and what comes out) along one script of adds and
    retrieves on each buffer of ``module``."""
    out = []
    random = module.RandomShufflingBuffer(5, 2, extra_capacity=10, seed=3)
    noop = module.NoopShufflingBuffer()
    for buf in (random, noop):
        out.append(buf.can_add())
        buf.add_many([0, 1, 2, 3])
        out.append(buf.can_add())
        buf.add_many([4, 5])
        out.append(buf.can_add())
        out.append(buf.retrieve())
        out.append(buf.retrieve())
        out.append(buf.can_add())
        buf.finish()
        out.append(buf.can_add())
        while buf.can_retrieve():
            out.append(buf.retrieve())
    return out


def test_shuffling_buffers_can_add_as_jax():
    assert _buffer_script(shuffling_buffer) == _buffer_script(jax_shuffling_buffer)
    for module in (shuffling_buffer, jax_shuffling_buffer):
        for cls in (module.RandomShufflingBuffer, module.NoopShufflingBuffer):
            assert issubclass(cls, module.ShufflingBufferBase)
    _abstract_as_jax(shuffling_buffer.ShufflingBufferBase, jax_shuffling_buffer.ShufflingBufferBase)


def _abstract_as_jax(ours, theirs):
    """Every public method of the two base classes raises NotImplementedError,
    and the two have the same ones."""
    names = sorted(n for n in vars(theirs) if not n.startswith('_'))
    assert names == sorted(n for n in vars(ours) if not n.startswith('_'))
    for cls in (ours, theirs):
        instance = cls()
        for name in names:
            with pytest.raises(NotImplementedError):
                attr = getattr(instance, name)  # a property raises here
                attr([]) if name == 'add_many' else attr()


def test_ventilators_derive_from_the_base():
    for base, classes in (
            (ventilator.VentilatorBase, (ventilator.ConcurrentVentilator,
                                         ventilator.FairShareVentilator, ElasticVentilator)),
            (jax_ventilator.VentilatorBase, (jax_ventilator.ConcurrentVentilator,
                                             jax_ventilator.FairShareVentilator,
                                             JaxElasticVentilator))):
        assert all(issubclass(cls, base) for cls in classes)
    _abstract_as_jax(ventilator.VentilatorBase, jax_ventilator.VentilatorBase)


@pytest.mark.parametrize('start,taken', [(0, 0), (0, 3), (5, 4)])
def test_dispatch_ids_issued_matches_jax(start, taken):
    ours, theirs = protocol.DispatchIds(start), jax_protocol.DispatchIds(start)
    got = [(ours.next(), theirs.next()) for _ in range(taken)]
    assert all(a == b for a, b in got)
    assert ours.issued == theirs.issued == start + taken


_names = iter(range(1 << 30))


def _ring_script(package):
    """The same writes and reads on a fresh ring of ``package``."""
    ring_cls = {'jax': jax_shm_ring.ShmRing, 'torch': shm_ring.ShmRing}[package]
    ring = ring_cls.create('/pstpu_tap_{}_{}_{}'.format(os.getpid(), package, next(_names)),
                           1 << 14)
    out = []
    try:
        out.append(ring.write(b'abc'))
        out.append(ring.try_writev([b'hd', np.arange(4, dtype=np.uint8), b'']))
        out.append(ring.try_read())
        out.append(ring.try_read())
        out.append(ring.try_read())
        part = np.zeros(1000, np.uint8)
        written = 0
        while ring.try_writev([b'x', part]):
            written += 1
        out.append(written)
        out.append(ring.write(b'y' * 1000, stop_check=lambda: True))  # full: gives up
        out.append(len(ring.try_read()))
        out.append(ring.write(b'z' * 10))
        with pytest.raises(ValueError):
            ring.try_writev([np.zeros(1 << 15, np.uint8)])
    finally:
        ring.close()
    return out


def test_shm_ring_write_try_read_try_writev_match_jax():
    ours = _ring_script('torch')
    assert ours == _ring_script('jax')
    assert ours[:5] == [True, True, b'abc', b'hd\x00\x01\x02\x03', None]


def test_build_shm_is_the_ring_build_under_the_jax_name():
    jax_params = inspect.signature(jax_build.build_shm).parameters
    params = inspect.signature(build.build_shm).parameters
    assert [(p.name, p.default) for p in params.values()] == \
        [(p.name, p.default) for p in jax_params.values()] == [('force', False), ('quiet', False)]
    assert build.build_shm() == build.build_ring()
