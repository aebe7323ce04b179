"""A cell, a configuration, a traffic mix and a metric are found by name:
a later change adds them as files and ``BENCHMARK.json`` entries alone."""

import json
import os
import shutil

import pytest

from benchmark import harness

from .fixtures import check_cell_files

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _spec():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


@pytest.mark.parametrize('cell', [w['name'] for w in _spec()['workloads']])
def test_every_cell_finds_its_files(cell):
    check_cell_files(harness.Cell(cell))


def test_an_added_cell_config_and_metric_need_no_edit(tmp_path):
    root = str(tmp_path)
    bench = os.path.join(root, 'benchmark')
    shutil.copytree(os.path.join(ROOT, 'benchmark'), bench,
                    ignore=shutil.ignore_patterns('.cache', '__pycache__'))
    spec = _spec()
    with open(os.path.join(ROOT, 'benchmark', 'configs', 'rn50_petastorm.json')) as f:
        config = json.load(f)
    config['rows'] = 8192
    with open(os.path.join(bench, 'configs', 'rn50_big.json'), 'w') as f:
        json.dump(config, f)
    with open(os.path.join(bench, 'traffic', 'raw_small_groups.json'), 'w') as f:
        json.dump({'store': 'raw', 'store_params': {'rows_per_row_group': 16,
                                                    'compression': 'none'},
                   'warmup_steps': 5, 'trace_seconds': 3}, f)
    with open(os.path.join(bench, 'workloads', 'rn50_big.raw_small_groups.json'), 'w') as f:
        json.dump({'limits': {'loss_gap': 1}}, f)
    with open(os.path.join(bench, 'metrics', 'steps_per_s.py'), 'w') as f:
        f.write('def read(ctx):\n    return ctx.window["steps"] / ctx.window["window_s"]\n')
    spec['configs'].append(dict(spec['configs'][0], name='rn50_big',
                                file='benchmark/configs/rn50_big.json'))
    spec['workloads'].append({'name': 'rn50_big.raw_small_groups', 'config': 'rn50_big',
                              'traffic': 'raw_small_groups', 'chips': 1, 'why': 'test'})
    spec['per_layer'].append({'name': 'steps_per_s', 'unit': 'steps/s', 'better': 'higher',
                              'source': 'host_clock', 'layer': 'model step',
                              'moves': 'examples_per_s',
                              'workloads': ['rn50_big.raw_small_groups']})
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as f:
        json.dump(spec, f)
    cell = harness.Cell('rn50_big.raw_small_groups', root=root, bench_dir=bench)
    assert cell.config['rows'] == 8192
    assert cell.traffic['store_params']['rows_per_row_group'] == 16
    assert cell.limits == {'loss_gap': 1}
    assert 'steps_per_s' in cell.per_layer
    ctx = harness.Context(window={'steps': 30, 'window_s': 3.0})
    assert cell.metric_reader('steps_per_s')(ctx) == 10.0
    # a cell the metric does not list does not report it
    other = harness.Cell('rn50_petastorm.raw', root=root, bench_dir=bench)
    assert 'steps_per_s' not in other.per_layer


def test_an_unknown_cell_is_refused():
    with pytest.raises(harness.BenchmarkError):
        harness.Cell('no_such.cell')
