"""Run one cell of the benchmark of petastorm_tpu_torch once, on the card of
the machine it starts on, and print the result as the last line of standard
output (the numbers compared, beside their limits, as the last lines of
standard error).

    python3 benchmark/run.py --workload rn50_petastorm.raw --seed 12345 \\
        --seconds 30 --trace 0

``--trace 1`` reports the cell's per-layer metrics, read from the
program's stage timers and a profiler trace of the window's last seconds,
instead of its end-to-end metrics. Exits non-zero, printing no result,
without a card, without the program, or when the run loaded JAX.
"""

import time

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark import harness  # noqa: E402


def main(argv=None):
    t_start = harness.process_start()
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        cell = harness.Cell(args.workload)
        harness.set_environment()
        import torch

        device = harness.require_chips(torch, cell.chips)
        import petastorm_tpu_torch  # noqa: F401  (the program; absent, the run fails here)
        from benchmark.duty import CudaClock

        result, rows = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                                        CudaClock(torch), t_start)
    except (harness.BenchmarkError, ImportError, OSError, KeyError) as e:
        print('benchmark: {}: {}'.format(type(e).__name__, e), file=sys.stderr)
        return 2
    loaded = harness.forbidden_modules()
    if loaded:  # pulled in after the window, by the checks or a metric's reader
        print('benchmark: the run loaded {}'.format(', '.join(loaded)), file=sys.stderr)
        return 2
    harness.emit(result, rows)
    return 0


if __name__ == '__main__':
    sys.exit(main())
