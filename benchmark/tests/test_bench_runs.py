"""Whole runs of the tiny copy on the CPU (the chip check skipped, the
eager step for the graphed one): the result line's keys, and ``correct``
true on sound runs, false with each fault planted underneath and for the
control, the reference in float8 in the program's place."""

import json
import time

import pytest

from benchmark import checks, faults, harness
from benchmark.duty import HostClock

from .fixtures import tiny  # noqa: F401  (a fixture)

CELLS = ('rn50_petastorm.raw',)
#: each cell's faults: those of its model kind and those every kind can have
FAULTS = [(name, fault) for name in CELLS
          for fault in faults.names(harness.Cell(name).model_module())]
SEED = 2 ** 31 + 12345


def _run(tiny, name, seed=SEED, control=False):
    import torch

    root, bench = tiny
    cell = harness.Cell(name, root=root, bench_dir=bench)
    return harness.run_cell(cell, seed, 1.0, False, torch.device('cpu'), HostClock(), time.time(),
                            control=control)


@pytest.mark.parametrize('name', CELLS)
def test_a_sound_run_is_correct_and_its_line_has_the_keys(tiny, name, capsys):
    result, rows = _run(tiny, name, control=True)
    keys = list(result)
    assert keys[:5] == ['correct', 'attempted', 'failed', 'metrics', 'device']
    assert keys[-1] == 'checks'
    assert set(result['metrics']) == set(harness.Cell(name, *tiny).end_to_end)
    assert {'setup_s', 'peak_device_mem_gb'} < set(result['metrics'])
    assert all(set(m) == {'value', 'unit'} for m in result['metrics'].values())
    assert result['attempted'] >= 1 and result['failed'] == 0
    assert result['correct'], result['checks']
    harness.emit(result, rows)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == 'checks'
    assert [r.split(' ')[1] for r in err.strip().splitlines()[-len(rows):]] == \
        [name for name, _, _ in rows]
    # the control fails one of the cell's numbers
    cell = harness.Cell(name, *tiny)
    control_ok, _ = checks.judge(result['control'], cell.limits, cell.not_compared)
    assert not control_ok, result['control']


@pytest.mark.parametrize('name, fault', FAULTS)
def test_a_planted_fault_makes_the_run_incorrect(tiny, name, fault):
    with faults.planted(fault, harness.Cell(name, *tiny).model_module()):
        result, _ = _run(tiny, name)
    assert not result['correct'], result['checks']
