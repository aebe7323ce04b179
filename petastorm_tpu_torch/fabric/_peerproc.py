"""One fabric peer as a subprocess: a host to serve from, or to SIGKILL.

Twin of ``petastorm_tpu/fabric/_peerproc.py``, with its arguments::

    python -m petastorm_tpu_torch.fabric._peerproc --url URL --coord DIR \\
        --host pA --cache-root DIR [--lease-s 2.0 --stall-s S \\
        --request-marker FILE --ready-file FILE]

It warms its chunk mirror by reading the store once, then joins the pod
(publishing its fabric endpoint as a lease annotation) and serves chunks
until it is killed or terminated (SIGTERM: it leaves the pod). A chaos drill
sets ``--stall-s`` so every payload send sleeps first, waits for
``--request-marker`` to appear (a transfer is in flight) and SIGKILLs this
process mid-transfer. It imports no torch.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading


def _parse_args(argv):
    parser = argparse.ArgumentParser(prog='python -m petastorm_tpu_torch.fabric._peerproc')
    parser.add_argument('--url', required=True)
    parser.add_argument('--coord', required=True)
    parser.add_argument('--host', required=True)
    parser.add_argument('--cache-root', required=True)
    parser.add_argument('--lease-s', type=float, default=2.0)
    parser.add_argument('--stall-s', type=float, default=0.0,
                        help='stall every payload send this long (the SIGKILL window of a '
                             'chaos drill)')
    parser.add_argument('--request-marker', default=None,
                        help='file written when the first request arrives')
    parser.add_argument('--ready-file', default=None,
                        help='written once warmed, joined and serving')
    return parser.parse_args(argv)


def _write_atomically(path, text):
    tmp = path + '.tmp'
    with open(tmp, 'w') as f:
        f.write(text)
    os.replace(tmp, path)


def main(argv=None):
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    from petastorm_tpu_torch import fabric, faults, make_reader
    from petastorm_tpu_torch.chunkstore import ChunkCacheConfig
    from petastorm_tpu_torch.observability import blackbox

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    blackbox.maybe_enable('fabric-peer-' + args.host)
    cache = ChunkCacheConfig(args.cache_root)
    # one full epoch mirrors every chunk the reader mirrors
    with make_reader(args.url, reader_pool_type='dummy', shuffle_row_groups=False,
                     chunk_cache=cache) as reader:
        for _ in reader:
            pass

    if args.stall_s:
        faults.install_net(faults.NetFaultPlan(stall_payloads=1_000_000, stall_s=args.stall_s))

    def on_request(key):
        if args.request_marker:
            _write_atomically(args.request_marker, key)

    node = fabric.start_node(
        fabric.FabricConfig(args.coord, args.host, cache, serve=True, join=True,
                            lease_s=args.lease_s),
        on_request=on_request)
    try:
        if args.ready_file:
            _write_atomically(args.ready_file, str(os.getpid()))
        while not stop.wait(0.2):
            pass
    finally:
        node.stop()
    return 0


if __name__ == '__main__':
    sys.exit(main())
