"""Models (twin of ``petastorm_tpu.models``): the ResNet family, the sequence
transformer, the MoE sequence transformer and their train step."""

from petastorm_tpu_torch.models.moe import (MoEMlp, MoESequenceTransformer,  # noqa: F401
                                            expert_capacity, moe_loss)
from petastorm_tpu_torch.models.resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                                               resnet18, resnet50, resnet101, resnet152)
from petastorm_tpu_torch.models.transformer import (SequenceTransformer,  # noqa: F401
                                                    make_sequence_transformer)
