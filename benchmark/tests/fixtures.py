"""Fixtures of the benchmark's own tests (imported by the test modules): a
copy of the benchmark at a size the CPU holds. Each configuration takes the
sizes, and each of its cells the limits, that ``tiny/<model>.json`` beside
these tests gives for its model kind: ResNet-50 at its published widths on
32 px images, batch 8, 96 rows, with limits set from CPU readings at that
size (sound runs on six seeds against the control and the faults).
"""

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def make_tiny(root, extra=None):
    """A copy of the benchmark under ``root`` at the CPU's size; returns the
    copy's benchmark directory. ``extra(root)``, where given, adds files and
    ``BENCHMARK.json`` entries to the copy before it is cut to size."""
    bench = os.path.join(root, 'benchmark')
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns('.cache', '__pycache__'))
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), root)
    if extra is not None:
        extra(root)
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        spec = json.load(f)
    tiny = {}
    for entry in spec['configs']:
        path = os.path.join(root, entry['file'])
        with open(path) as f:
            config = json.load(f)
        with open(os.path.join(bench, 'tests', 'tiny', config['model'] + '.json')) as f:
            tiny[entry['name']] = cut = json.load(f)
        config.update(cut['sizes'])
        with open(path, 'w') as f:
            json.dump(config, f)
    for name in os.listdir(os.path.join(bench, 'traffic')):
        path = os.path.join(bench, 'traffic', name)
        with open(path) as f:
            traffic = json.load(f)
        params = traffic['store_params']
        if 'rows_per_row_group' in params:
            params['rows_per_row_group'] = 8
        # one worker: the tiny copy reads its rows in the seed's order alone
        traffic.update(workers=1, warmup_steps=1)
        with open(path, 'w') as f:
            json.dump(traffic, f)
    for cell in spec['workloads']:
        with open(os.path.join(bench, 'workloads', cell['name'] + '.json'), 'w') as f:
            json.dump(tiny[cell['config']]['checks'], f)
    return bench


def check_cell_files(cell):
    """What a cell needs before it runs: its configuration, store, model
    kind, reference and metric readers found by name, and every number its
    checks give either held to a limit or named as not compared (the data's
    and the rows' always held: they are exact)."""
    from benchmark import checks

    assert cell.config['batch_size'] > 0
    assert cell.store_module().open_reader
    kind = cell.model_module()
    assert set(dir(kind)) >= set(harness.KIND_NAMES)
    assert set(dir(cell.reference_module())) >= set(harness.REFERENCE_NAMES)
    exact = set(kind.data_numbers([], [])) | set(checks.row_numbers([], 1))
    assert exact <= set(cell.limits), sorted(exact - set(cell.limits))
    given = exact | set(checks.MODEL_NUMBERS) | set(checks.WINDOW_NUMBERS)
    held = set(cell.limits) | set(cell.not_compared)
    assert given <= held, sorted(given - held)
    for metric in cell.end_to_end + cell.per_layer:
        assert callable(cell.metric_reader(metric))
    assert 'setup_s' in cell.end_to_end and len(cell.end_to_end) >= 2
    assert cell.per_layer


@pytest.fixture(scope='session')
def tiny(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('tiny'))
    return root, make_tiny(root)


@pytest.fixture
def cuda():
    """The card, or a skip: decided inside the test, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (CUDA is not available)')
    return harness.require_chips(torch, 1)
