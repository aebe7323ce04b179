"""PT704 clean twin: the handler cone only stamps a preallocated buffer
(``pack_into``) and re-raises; code OUTSIDE the cone may freely lock, log
and serialize — the rule constrains handler-reachable code only."""

import json
import logging
import os
import signal
import struct
import threading

logger = logging.getLogger(__name__)
_state_lock = threading.Lock()
_FMT = struct.Struct('<id')
_BUF = bytearray(_FMT.size)


def _stamp_crash(signum):
    _FMT.pack_into(_BUF, 0, signum, 0.0)


def _marker(signum, frame):
    _stamp_crash(signum)
    signal.signal(signum, signal.SIG_DFL)
    os.kill(os.getpid(), signum)


def install():
    signal.signal(signal.SIGTERM, _marker)


def ordinary_path(payload):
    """Not handler-reachable: locks, logging and serialization are fine."""
    with _state_lock:
        line = json.dumps(payload)
    logger.info('recorded %d bytes', len(line))
    return _FMT.pack(0, 0.0)
