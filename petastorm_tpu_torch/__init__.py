"""petastorm_tpu_torch: the PyTorch/CUDA port of petastorm_tpu.

A second package beside the JAX one, for NVIDIA GPUs (Hopper first). It reads
and writes the same Parquet stores (same metadata keys and codec ids), keeps
its own trimmed copies of the host modules it needs, and imports nothing of
JAX or of ``petastorm_tpu``. Every TPU kernel of the JAX package is a
hand-written Hopper kernel here (``ops/kernels``), beside a plain PyTorch
version. Entry points that touch a device default to CUDA and raise without
it unless the caller passes ``device='cpu'``.

Top-level API: ``make_reader``, ``make_batch_reader``,
``merge_resume_states``, ``TransformSpec``, ``NoDataAvailableError``,
``AutotuneConfig`` and the mesh helpers of :mod:`petastorm_tpu_torch.parallel`
(``make_mesh``, ``data_sharding``, ``reader_shard_for_process``,
``process_local_batch_size``, ``make_global_batch``), imported at first
use: a process pool's spawned workers import this package, and must not
import torch.
"""

from petastorm_tpu_torch.autotune import AutotuneConfig  # noqa: F401
from petastorm_tpu_torch.errors import NoDataAvailableError  # noqa: F401
from petastorm_tpu_torch.reader import (make_batch_reader, make_reader,  # noqa: F401
                                        merge_resume_states)
from petastorm_tpu_torch.transform import TransformSpec  # noqa: F401

__version__ = '0.1.0'

#: the names of :mod:`petastorm_tpu_torch.parallel` exported here
_PARALLEL_NAMES = ('make_mesh', 'data_sharding', 'reader_shard_for_process',
                   'process_local_batch_size', 'make_global_batch')


def __getattr__(name):
    if name in _PARALLEL_NAMES:
        from petastorm_tpu_torch import parallel
        return getattr(parallel, name)
    raise AttributeError('module {!r} has no attribute {!r}'.format(__name__, name))
