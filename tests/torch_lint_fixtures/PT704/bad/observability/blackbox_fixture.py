"""PT704 bad fixture: a signal handler whose reachable cone locks, logs,
imports, opens files and allocates — every violation class the rule names."""

import json
import logging
import signal
import struct
import threading

logger = logging.getLogger(__name__)
_state_lock = threading.Lock()
_FMT = struct.Struct('<id')


def _stamp_crash(signum):
    with _state_lock:  # PT704: lock acquire inside the handler cone
        pass
    logger.warning('crash signal %s', signum)  # PT704: logging locks/allocates
    import os  # PT704: import machinery inside the handler cone
    open('/tmp/crash-{}'.format(os.getpid()), 'w')  # PT704: open() allocates
    json.dumps({'signal': signum})  # PT704: serializer allocates
    return _FMT.pack(signum, 0.0)  # PT704: Struct.pack allocates fresh bytes


def _marker(signum, frame):
    _stamp_crash(signum)


def install():
    signal.signal(signal.SIGTERM, _marker)
