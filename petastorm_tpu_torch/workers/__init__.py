"""Worker pools and the ventilator (trimmed twin of ``petastorm_tpu.workers``):
the thread, dummy and process pools, the item-failure policy they share and
the process pool's wire protocol."""

from petastorm_tpu_torch.workers.dummy_pool import DummyPool  # noqa: F401
from petastorm_tpu_torch.workers.process_pool import (ProcessPool,  # noqa: F401
                                                      ProcessPoolOptions)
from petastorm_tpu_torch.workers.supervision import ErrorPolicy  # noqa: F401
from petastorm_tpu_torch.workers.thread_pool import ThreadPool  # noqa: F401
from petastorm_tpu_torch.workers.ventilator import (ConcurrentVentilator,  # noqa: F401
                                                    FairShareVentilator)
from petastorm_tpu_torch.workers.worker_base import WorkerBase  # noqa: F401
