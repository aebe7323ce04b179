"""Framework-level exceptions (twin of ``petastorm_tpu/errors.py``).

Only the classes the ported read path raises are kept; the taxonomy still
roots at :class:`PetastormTpuError` so a consumer catches one base class.
"""


class PetastormTpuError(Exception):
    """Base class for all framework errors."""


class NoDataAvailableError(PetastormTpuError):
    """Raised when a reader configuration selects zero row groups, for example
    when ``shard_count`` exceeds the number of row groups."""


class SchemaError(PetastormTpuError):
    """Raised for schema definition / encoding / decoding violations."""


class EmptyResultError(PetastormTpuError):
    """Raised by ``pool.get_results()`` when all ventilated work has been
    processed and no further results will arrive."""


class TimeoutWaitingForResultError(PetastormTpuError):
    """Raised when a pool produced no result within its timeout (the message
    lists every worker's liveness and the item it holds)."""


class PoisonItemError(PetastormTpuError):
    """Raised when one item keeps killing worker processes past its retry
    budget under ``on_error='raise'`` or ``'retry'``."""


class WorkerPoolDepletedError(PetastormTpuError):
    """Raised when every worker slot of a process pool was shed because
    respawning it kept failing."""


class ProtocolViolation(PetastormTpuError):
    """An observed worker-pool, serve or elastic event sequence the protocol
    spec rejects (``petastorm_tpu_torch/analysis/protocol/``): a reused
    dispatch id, a message for a never-issued id, a live/stale
    misclassification, a second completion for one item, or diverged
    accounting at epoch drain. Raised by the opt-in runtime conformance
    monitor (``docs/protocol.md``)."""


class ServeError(PetastormTpuError):
    """Base class for errors of the shared reader service (``serve/``)."""


class ConsumerEvictedError(ServeError):
    """This consumer lagged beyond the serve daemon's bound and was evicted
    from the broadcast ring so the other consumers keep flowing. Re-attach
    with ``make_reader(serve=...)``, consume faster, or raise the daemon's
    ``ring_bytes``. Carries ``tenant_id`` when known."""

    def __init__(self, message, tenant_id=None):
        super().__init__(message)
        self.tenant_id = tenant_id


class ServeDaemonDiedError(ServeError):
    """The serve daemon this consumer was attached to is gone; raised
    instead of waiting on a quiet ring. A fresh ``make_reader(serve=...)``
    spawns a replacement daemon."""
