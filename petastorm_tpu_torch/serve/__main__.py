"""``python -m petastorm_tpu_torch.serve``: run the per-host shared reader
daemon in the foreground.

Consumers usually spawn the daemon themselves through
``make_reader(serve='auto' | <dir>)``; this entry point is for explicit
deployments (CI fixtures, systemd units, containers) and for debugging with
the daemon's log on a terminal. The daemon decodes on the host only: it
imports no ``torch`` and touches no GPU.
"""

from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m petastorm_tpu_torch.serve',
        description='Per-host shared reader daemon: decode once, serve many local consumers '
                    'over broadcast shm rings.')
    parser.add_argument('--service-dir', required=True,
                        help='service directory (control socket, stream specs, spawn lock); '
                             'consumers pass the same path as make_reader(serve=...)')
    parser.add_argument('--pool-type', choices=('thread', 'process', 'dummy'), default='thread')
    parser.add_argument('--workers-count', type=int, default=4)
    parser.add_argument('--ring-bytes', type=int, default=None,
                        help='per-stream broadcast ring capacity (default 64 MiB)')
    parser.add_argument('--idle-timeout', type=float, default=None,
                        help='exit after this many seconds with no attached tenant '
                             '(default 60; <= 0 disables)')
    parser.add_argument('--evict-block', type=float, default=None,
                        help='evict the slowest consumer after a publish stays blocked this '
                             'long (default 10 s)')
    parser.add_argument('--telemetry', choices=('off', 'counters', 'spans'), default=None,
                        help="the daemon's telemetry level; 'spans' records the span tree "
                             "clients fetch with the 'trace' op (default: the process's)")
    parser.add_argument('-v', '--verbose', action='store_true')
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format='%(asctime)s %(levelname)s %(name)s: %(message)s')

    from petastorm_tpu_torch.serve.service import (DEFAULT_EVICT_BLOCK_S,
                                                   DEFAULT_IDLE_TIMEOUT_S,
                                                   DEFAULT_SERVE_RING_BYTES, ReaderService)
    idle = args.idle_timeout if args.idle_timeout is not None else DEFAULT_IDLE_TIMEOUT_S
    service = ReaderService(
        args.service_dir,
        pool_type=args.pool_type,
        workers_count=args.workers_count,
        ring_bytes=args.ring_bytes or DEFAULT_SERVE_RING_BYTES,
        idle_timeout_s=None if idle <= 0 else idle,
        evict_block_s=args.evict_block if args.evict_block is not None else DEFAULT_EVICT_BLOCK_S,
        telemetry=args.telemetry)
    service.start()
    try:
        service.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        service.shutdown()
    return 0


if __name__ == '__main__':
    sys.exit(main())
