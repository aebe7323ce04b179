"""On the card, at each cell's own size: a run is correct, and the control
(the reference in float8 in the program's place) fails one of the cell's
numbers. Skips without a card; run there with
``python -m pytest benchmark/tests/test_bench_chip.py``."""

import time

import pytest

from benchmark import checks, harness
from benchmark.duty import CudaClock

from .fixtures import cuda  # noqa: F401  (a fixture)

CELLS = ('rn50_petastorm.raw',)


@pytest.mark.gpu
@pytest.mark.parametrize('name', CELLS)
def test_a_run_on_the_card_is_correct_and_its_control_is_not(cuda, name):
    import torch

    cell = harness.Cell(name)
    harness.set_environment()
    result, _ = harness.run_cell(cell, 2 ** 31 + 4242, 2.0, False, cuda, CudaClock(torch),
                                 time.time(), control=True)
    assert result['correct'], result['checks']
    control_ok, _ = checks.judge(result['control'], cell.limits, cell.not_compared)
    assert not control_ok, result['control']
