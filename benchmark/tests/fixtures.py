"""Fixtures of the benchmark's own tests (imported by the test modules): a
copy of the benchmark at a size the CPU holds (ResNet-50 at its published
widths on 32 px images, batch 8, 96 rows), with limits of its own set from
CPU readings at that size."""

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

#: the tiny copy's limits, from CPU readings at that size: sound runs on six
#: seeds against the control and the faults (``PERF.md`` section 6)
TINY_CHECKS = {
    'limits': {'pixel_max_err': 0, 'label_mismatches': 0, 'unknown_rows': 0,
               'row_count_spread': 4, 'stored_cell_mismatches': 0, 'grad1_leaf_gap': 0.07,
               'change_leaf_gap': 0.6, 'window_grad_leaf_gap': 0.06,
               'window_change_leaf_gap': 0.2},
    'not_compared': ['loss1_gap', 'loss_gap', 'window_loss_gap'],
}


def make_tiny(root):
    """A copy of the benchmark under ``root`` at the CPU's size; returns the
    copy's benchmark directory."""
    bench = os.path.join(root, 'benchmark')
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns('.cache', '__pycache__'))
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        spec = json.load(f)
    for entry in spec['configs']:
        path = os.path.join(root, entry['file'])
        with open(path) as f:
            config = json.load(f)
        config.update(image_size=32, batch_size=8, rows=96, shuffling_queue_capacity=32)
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
    for name in os.listdir(os.path.join(bench, 'workloads')):
        with open(os.path.join(bench, 'workloads', name), 'w') as f:
            json.dump(TINY_CHECKS, f)
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as f:
        json.dump(spec, f)
    return bench


@pytest.fixture(scope='session')
def tiny(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('tiny'))
    return root, make_tiny(root)


@pytest.fixture
def cuda():
    """The card, or a skip: decided inside the test, never at import."""
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (CUDA is not available)')
    return harness.require_chips(torch, 1)
