"""One elastic pod host as a subprocess: the target of the churn tests.

Twin of ``petastorm_tpu/elastic/_hostproc.py``, with the same flags and
events. ``python -m petastorm_tpu_torch.elastic._hostproc --url ... --coord
... --host h0 --out h0.jsonl`` opens an elastic reader on the dummy pool,
consumes rows, and appends a ``start`` line, a ``done`` line (rows, values,
generation, members) and a final ``exit`` line to ``--out``. A churn test
(``tests/test_torch_elastic.py``, ``chip_smoke.py``'s ``raw_elastic`` path)
SIGKILLs one of these mid-epoch and starts another to exercise the handoff
with real process death: the coordination directory's commit logs and done
markers are the ground truth it asserts over. The host reads only: it
imports no torch and touches no device.

``--sleep-per-row`` throttles consumption so an epoch stays open long enough
for the churn test to kill/join deterministically. SIGTERM ends the host
gracefully: it stops reading after the current row, writes its ``done`` and
``exit`` lines and leaves the pod (its lease is removed), so a churn test can
stop a host that runs more epochs than it needs. With the elastic monitor
armed (``PSTPU_ELASTIC_MONITOR=1``) the ``done`` line also carries its
snapshot.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time


def _parse_args(argv):
    parser = argparse.ArgumentParser(prog='pstpu-torch-elastic-host')
    parser.add_argument('--url', required=True)
    parser.add_argument('--coord', required=True)
    parser.add_argument('--host', required=True)
    parser.add_argument('--out', required=True)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--lease-s', type=float, default=1.0)
    parser.add_argument('--poll-s', type=float, default=None)
    parser.add_argument('--num-epochs', type=int, default=1)
    parser.add_argument('--sleep-per-row', type=float, default=0.0)
    parser.add_argument('--field', default='id')
    parser.add_argument('--no-shuffle', action='store_true')
    parser.add_argument('--ready-file', default=None,
                        help='touched once the reader is up and iterating')
    return parser.parse_args(argv)


def main(argv=None):
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.elastic import ElasticConfig
    from petastorm_tpu_torch.observability import blackbox

    # label flight files by host id so a post-mortem over the run directory
    # can name WHICH elastic host died (a churn test SIGKILLs one)
    blackbox.maybe_enable('elastic-host-' + args.host)
    cfg = ElasticConfig(coord_dir=args.coord, host_id=args.host,
                        lease_s=args.lease_s, poll_s=args.poll_s)
    out = open(args.out, 'a')

    def emit(record):
        out.write(json.dumps(record) + '\n')
        out.flush()

    stop = threading.Event()
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, lambda signum, frame: stop.set())
    emit({'event': 'start', 'host': args.host, 'pid': os.getpid()})
    reader = make_reader(args.url, schema_fields=[args.field],
                         reader_pool_type='dummy', seed=args.seed,
                         shuffle_row_groups=not args.no_shuffle,
                         num_epochs=args.num_epochs, elastic=cfg)
    if args.ready_file:
        with open(args.ready_file, 'w') as fh:
            fh.write(str(os.getpid()))
    try:
        values = []
        for row in reader:
            values.append(getattr(row, args.field))
            if args.sleep_per_row:
                time.sleep(args.sleep_per_row)
            if stop.is_set():
                break
        status = reader.elastic_coordinator.status()
        done = {'event': 'done', 'host': args.host, 'rows': len(values),
                'values': [int(v) for v in values],
                'generation': status['generation'],
                'members': list(status['members'])}
        monitor = reader.elastic_coordinator.monitor
        if monitor is not None:
            # the host's elastic monitor (PSTPU_ELASTIC_MONITOR): a violation
            # would have ended the host with an error before this line
            snap = monitor.snapshot
            done['monitor'] = dict({k: v for k, v in snap.items() if k != 'claims'},
                                   claims_open=len(snap['claims']))
        emit(done)
    finally:
        reader.stop()
        reader.join()
    emit({'event': 'exit', 'host': args.host})
    out.close()
    return 0


if __name__ == '__main__':
    sys.exit(main())
