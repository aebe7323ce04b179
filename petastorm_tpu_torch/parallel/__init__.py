"""Mesh and sharding helpers (twin of ``petastorm_tpu.parallel``): map the
share-nothing reader topology onto a ``torch.distributed`` device mesh.
Pipeline parallelism (``make_pipelined_apply``, ``pipeline_spmd``) is not
ported yet (ROADMAP.md, "Pipeline parallelism")."""

from petastorm_tpu_torch.parallel.mesh import (  # noqa: F401
    DataSharding, data_sharding, make_global_batch, make_mesh, process_local_batch_size,
    reader_shard_for_process,
)
