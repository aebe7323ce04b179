"""Mesh and sharding helpers (twin of ``petastorm_tpu.parallel``): map the
share-nothing reader topology onto a ``torch.distributed`` device mesh, and
GPipe pipeline parallelism over a mesh axis."""

from petastorm_tpu_torch.parallel.mesh import (  # noqa: F401
    DataSharding, data_sharding, make_global_batch, make_mesh, process_local_batch_size,
    reader_shard_for_process,
)
from petastorm_tpu_torch.parallel.pipeline import (  # noqa: F401
    make_pipelined_apply, pipeline_spmd,
)
