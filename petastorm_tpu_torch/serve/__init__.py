"""The shared reader service: one per-host daemon decodes each dataset once
and serves the decoded batches to many local consumer processes over
broadcast shm rings (twin of ``petastorm_tpu/serve``).

* ``make_reader(..., serve='auto' | <service dir>)`` (and
  ``make_batch_reader``): the consumer path; spawns or joins the daemon and
  returns a :class:`ServedReader`;
* ``python -m petastorm_tpu_torch.serve``: run the daemon explicitly;
* :class:`ReaderService`: the embeddable broker, for tests and bespoke
  deployments.

On a GPU host the collocated trainers (one per card) attach to one daemon,
which decodes on the host and imports no ``torch``.
"""

from __future__ import annotations

from petastorm_tpu_torch.serve.client import (ServedReader, connect_service,
                                              default_service_dir, make_served_reader)
from petastorm_tpu_torch.serve.plan import ReadPlan, build_read_plan
from petastorm_tpu_torch.serve.service import ReaderService, canonical_stream_id

__all__ = [
    'ReadPlan', 'ReaderService', 'ServedReader', 'build_read_plan', 'canonical_stream_id',
    'connect_service', 'default_service_dir', 'make_served_reader',
]
