"""PyTorch device feed: the loader and the infeed (twin of ``petastorm_tpu.jax``)."""

from petastorm_tpu_torch.torch.infeed import prefetch_to_device, stage_batch  # noqa: F401
from petastorm_tpu_torch.torch.loader import (TorchDataLoader, collate_rows,  # noqa: F401
                                              make_torch_dataset, stack_ngram_time_axis)
