"""The readings the limits of ``correct`` are set from (a benchmark run does
not run this). In one process, on the card, at the cell's own size:

- sound runs of the program on ``--seeds`` seeds (``--seconds`` windows), each with
  the control beside it: the reference computed in float8 in the program's
  place;
- runs with each fault of ``--faults`` planted (:mod:`benchmark.faults`) on
  ``--fault-seeds`` seeds.

Prints one JSON line per run, with the control judged by the cell's limits
(``control_correct``), then the lower reading of every number (the largest
over the sound runs), the control's and each fault's smallest, and each of
those over the lower reading.

    python3 benchmark/calibrate.py --workload rn50_petastorm.raw --seeds 12 \\
        --seconds 30 --faults half_batch,frozen_step --fault-seeds 3 --fault-seconds 3
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from benchmark import harness  # noqa: E402


def seeds(base, count):
    """``count`` distinct large seeds from ``base``."""
    return [base + 7919 * k + (1 << 31) for k in range(count)]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', type=int, default=12)
    parser.add_argument('--base-seed', type=int, default=1000)
    parser.add_argument('--seconds', type=float, default=2.0)
    parser.add_argument('--faults', default='')
    parser.add_argument('--fault-seeds', type=int, default=3)
    parser.add_argument('--fault-seconds', type=float, default=None,
                        help='the faulted runs\' window (default: --seconds)')
    args = parser.parse_args(argv)
    cell = harness.Cell(args.workload)
    harness.set_environment()
    import torch

    from benchmark import checks, faults
    from benchmark.duty import CudaClock

    device = harness.require_chips(torch, cell.chips)
    clock = CudaClock(torch)
    sound, control, planted = [], [], {}
    plan = [(None, s) for s in seeds(args.base_seed, args.seeds)]
    for name in filter(None, args.faults.split(',')):
        plan += [(name, s) for s in seeds(args.base_seed + 1, args.fault_seeds)]
    for fault, seed in plan:
        t0 = time.time()
        if fault is None:
            result, _ = harness.run_cell(cell, seed, args.seconds, False, device, clock, t0,
                                         control=True)
        else:
            with faults.planted(fault, cell.model_module()):
                result, _ = harness.run_cell(cell, seed, args.fault_seconds or args.seconds,
                                             False, device, clock, t0)
        numbers = {k: v['value'] for k, v in result['checks'].items()}
        line = {'fault': fault, 'seed': seed, 'correct': result['correct'], 'numbers': numbers,
                'losses': result['losses'], 'seconds': time.time() - t0}
        if fault is None:
            sound.append(numbers)
            control.append(result['control'])
            line['control'] = result['control']
            line['control_correct'], _ = checks.judge(result['control'], cell.limits,
                                                      cell.not_compared)
        else:
            planted.setdefault(fault, []).append(numbers)
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    lower = {k: max(n[k] for n in sound) for k in sound[0]} if sound else {}

    def least(runs):
        found = {k: min(n[k] for n in runs) for k in runs[0]}
        return {k: {'min': v, 'over_lower': v / lower[k] if lower.get(k) else None}
                for k, v in found.items()}

    summary = {'lower': lower, 'control_min': least(control) if control else None,
               'faults_min': {f: least(runs) for f, runs in planted.items()}}
    print(json.dumps({'summary': summary}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
