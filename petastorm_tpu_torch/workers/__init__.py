"""Worker pools and the ventilator (trimmed twin of ``petastorm_tpu.workers``):
the thread pool and the dummy pool. The process pool is not ported yet."""

from petastorm_tpu_torch.workers.dummy_pool import DummyPool  # noqa: F401
from petastorm_tpu_torch.workers.thread_pool import ThreadPool  # noqa: F401
from petastorm_tpu_torch.workers.ventilator import ConcurrentVentilator  # noqa: F401
from petastorm_tpu_torch.workers.worker_base import WorkerBase  # noqa: F401
