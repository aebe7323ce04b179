"""Models (twin of ``petastorm_tpu.models``): the ResNet family and its train step."""

from petastorm_tpu_torch.models.resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                                               resnet18, resnet50, resnet101, resnet152)
