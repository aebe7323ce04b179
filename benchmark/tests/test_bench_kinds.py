"""The model is a kind the harness finds by name
(``benchmark/models/<model>.py``).

- The ResNet-50 kind reads as the harness read before its code moved into
  the kind: at two fixed seeds, on the tiny CPU copy, every number compared
  and every number of the control equals, to the last bit, what the
  harness gave before the move.
- A kind the harness has never seen (``lm_kind/``: a causal language model
  over int32 tokens, trained by AdamW, with its own store, traffic,
  limits, CPU sizes, reference, control, FLOPs and step marker) runs through
  ``run_cell`` from new files alone: correct on a sound run, not correct
  for its control and under each of its faults.
"""

import json
import os
import shutil
import time

import pytest

from benchmark import checks, duty, faults, harness, trace
from benchmark.duty import HostClock

from .fixtures import check_cell_files, make_tiny

HERE = os.path.dirname(os.path.abspath(__file__))
LM_FILES = os.path.join(HERE, 'lm_kind')
LM_CELL = 'tiny_lm.tokens'
SEED = 2 ** 31 + 4321


class StepClock(object):
    """The harness's and the window loop's ``time``, with a
    ``perf_counter`` that moves ``tick`` seconds a call: the window's steps,
    and the step the reference follows in it, no longer hang on the CPU's
    speed."""

    def __init__(self, tick):
        self.now, self.tick = 0.0, tick

    def perf_counter(self):
        self.now += self.tick
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


#: the CPU capability (``torch.backends.cpu.get_cpu_capability()``)
#: :data:`BEFORE` was read at: PyTorch picks its CPU kernels by it, and
#: another's kernels may round differently
BEFORE_CAPABILITY = 'AVX512'

#: ``{seed: {'checks': [[name, value]], 'control': {name: value}}}`` of the
#: ResNet-50 cell on the tiny copy, one intra-op thread, a 1 s window under
#: ``StepClock(0.015)`` (14 steps), as the harness gave them before the
#: model moved into its kind, read on an x86-64 CPU
BEFORE = {
    2 ** 31 + 777: {
        'checks': [
            ['pixel_max_err', 0],
            ['label_mismatches', 0],
            ['unknown_rows', 0],
            ['row_count_spread', 1],
            ['stored_cell_mismatches', 0],
            ['loss1_gap', 0.0002691627473279222],
            ['loss_gap', 0.08569806059445975],
            ['grad1_leaf_gap', 0.049404476884414315],
            ['change_leaf_gap', 0.12562943635148943],
            ['window_loss_gap', 1.919170126074e-05],
            ['window_grad_leaf_gap', 0.022324511859740985],
            ['window_change_leaf_gap', 0.009734677911848785],
        ],
        'control': {
            'loss1_gap': 0.01688961999007222,
            'loss_gap': 0.0993154077573217,
            'grad1_leaf_gap': 0.14749294973469643,
            'change_leaf_gap': 0.2005683261217849,
            'window_loss_gap': 0.0008186395580790923,
            'window_grad_leaf_gap': 0.1662715631096952,
            'window_change_leaf_gap': 0.0479336933821658,
        },
    },
    2 ** 40 + 31337: {
        'checks': [
            ['pixel_max_err', 0],
            ['label_mismatches', 0],
            ['unknown_rows', 0],
            ['row_count_spread', 1],
            ['stored_cell_mismatches', 0],
            ['loss1_gap', 0.0005601173160354343],
            ['loss_gap', 0.06000406359680399],
            ['grad1_leaf_gap', 0.030291196190128242],
            ['change_leaf_gap', 0.14332324653211578],
            ['window_loss_gap', 0.00011589417248072569],
            ['window_grad_leaf_gap', 0.02015633321611554],
            ['window_change_leaf_gap', 0.015429216777362288],
        ],
        'control': {
            'loss1_gap': 0.00618208461652162,
            'loss_gap': 0.04029683030365242,
            'grad1_leaf_gap': 0.1074748582112482,
            'change_leaf_gap': 0.24339563616208074,
            'window_loss_gap': 0.0051611954655702156,
            'window_grad_leaf_gap': 0.1169204946212757,
            'window_change_leaf_gap': 0.10025567655409114,
        },
    },
}


@pytest.fixture(scope='module')
def resnet_tiny(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('tiny_resnet'))
    return root, make_tiny(root)


@pytest.mark.parametrize('seed', sorted(BEFORE))
def test_the_resnet_kind_reads_as_before(resnet_tiny, monkeypatch, seed):
    import torch

    if torch.backends.cpu.get_cpu_capability() != BEFORE_CAPABILITY:
        pytest.skip('the readings were taken with {} kernels, this CPU runs {}'.format(
            BEFORE_CAPABILITY, torch.backends.cpu.get_cpu_capability()))
    clock = StepClock(0.015)
    monkeypatch.setattr(harness, 'time', clock)
    monkeypatch.setattr(duty, 'time', clock)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cell = harness.Cell('rn50_petastorm.raw', *resnet_tiny)
        result, rows = harness.run_cell(cell, seed, 1.0, False, torch.device('cpu'), HostClock(),
                                        time.time(), control=True)
    finally:
        torch.set_num_threads(threads)
    assert [[name, value] for name, value, _ in rows] == BEFORE[seed]['checks']
    assert result['control'] == BEFORE[seed]['control']
    assert result['correct'] and result['attempted'] == 14
    assert list(result) == ['correct', 'attempted', 'failed', 'metrics', 'device', 'losses',
                            'control', 'checks']
    assert list(result['metrics']) == ['examples_per_s', 'step_period_ms_p95',
                                       'peak_device_mem_gb', 'setup_s']


def add_lm_kind(root):
    """The language-model kind's files laid into a copy of the benchmark,
    each one new there, and its entries in the copy's ``BENCHMARK.json``."""
    bench = os.path.join(root, 'benchmark')
    for dirpath, _, files in os.walk(LM_FILES):
        folder = os.path.join(bench, os.path.relpath(dirpath, LM_FILES))
        for name in files:
            target = os.path.join(folder, name)
            assert not os.path.exists(target), target
            shutil.copy(os.path.join(dirpath, name), target)
    path = os.path.join(root, 'BENCHMARK.json')
    with open(path) as f:
        spec = json.load(f)
    spec['configs'].append({'name': 'tiny_lm', 'source': 'a fixture of the tests',
                            'file': 'benchmark/configs/tiny_lm.json', 'reduced': [],
                            'why': 'a model kind the harness has never seen'})
    spec['workloads'].append({'name': LM_CELL, 'config': 'tiny_lm', 'traffic': 'tokens',
                              'chips': 1, 'why': 'int32 token rows, AdamW'})
    for metric in spec['end_to_end'] + spec['per_layer']:
        if metric['name'] in ('examples_per_s', 'step_mfu'):
            metric['workloads'].append(LM_CELL)
    with open(path, 'w') as f:
        json.dump(spec, f)


@pytest.fixture(scope='module')
def lm_tiny(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('tiny_lm'))
    bench = make_tiny(root, extra=add_lm_kind)
    return root, bench


def _lm_run(lm_tiny, control=False, trace_run=False):
    import torch

    cell = harness.Cell(LM_CELL, *lm_tiny)
    return harness.run_cell(cell, SEED, 1.0, trace_run, torch.device('cpu'), HostClock(),
                            time.time(), control=control)


def test_the_new_cell_passes_the_checks_every_cell_passes(lm_tiny):
    """The checks ``test_bench_discovery.py`` makes of every cell of
    ``BENCHMARK.json`` hold for a cell of the new kind; its reference is
    the copy's ``reference/tiny_lm.py``, which the repository lacks."""
    cell = harness.Cell(LM_CELL, *lm_tiny)
    check_cell_files(cell)
    assert cell.reference_module().__file__ == os.path.join(lm_tiny[1], 'reference', 'tiny_lm.py')
    assert not os.path.exists(os.path.join(harness.HERE, 'reference', 'tiny_lm.py'))


def test_a_new_kind_runs_correct_and_its_control_does_not(lm_tiny):
    result, rows = _lm_run(lm_tiny, control=True)
    cell = harness.Cell(LM_CELL, *lm_tiny)
    assert result['correct'], result['checks']
    assert set(result['metrics']) == set(cell.end_to_end) >= {'examples_per_s', 'setup_s'}
    assert [name for name, _, _ in rows][:4] == ['token_mismatches', 'unknown_rows',
                                                 'row_count_spread', 'stored_cell_mismatches']
    control_ok, _ = checks.judge(result['control'], cell.limits, cell.not_compared)
    assert not control_ok, result['control']


def test_a_new_kind_gives_the_trace_its_marker_and_the_mfu_its_flops(lm_tiny, monkeypatch):
    markers = []

    def reduce(path, step_kernel):
        markers.append(step_kernel)
        return {'window_s': 1.0, 'busy_s': 0.5, 'kernel_mean_s': {},
                'kernel_busy_per_step_s': 1e-3, 'device_ops': [], 'idle_gaps': []}

    monkeypatch.setattr(trace, 'reduce_trace', reduce)
    result, _ = _lm_run(lm_tiny, trace_run=True)
    assert markers == ['embedding_backward']
    assert result['correct'], result['checks']
    cell = harness.Cell(LM_CELL, *lm_tiny)
    kind = cell.model_module()
    ctx = harness.Context(kind=kind, config=cell.config, trace={'kernel_busy_per_step_s': 1e-3},
                          peak=(989e12, 3.35e12))
    assert cell.metric_reader('step_mfu')(ctx) == pytest.approx(
        kind.step_flops(cell.config) / 1e-3 / 989e12 * 100)


LM_FAULTS = ('altered_token', 'dropped_rows', 'frozen_step', 'half_batch')


def test_the_new_kind_brings_its_own_faults(lm_tiny):
    kind = harness.Cell(LM_CELL, *lm_tiny).model_module()
    assert faults.names(kind) == list(LM_FAULTS)


@pytest.mark.parametrize('fault', LM_FAULTS)
def test_a_fault_of_the_new_kind_makes_its_run_incorrect(lm_tiny, fault):
    with faults.planted(fault, harness.Cell(LM_CELL, *lm_tiny).model_module()):
        result, _ = _lm_run(lm_tiny)
    assert not result['correct'], result['checks']
