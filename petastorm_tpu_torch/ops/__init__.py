"""Device-side ops (twin of ``petastorm_tpu.ops``): normalize, the batch
augmentations (flip, crop, mixup, cutmix) and the context-parallel
attention ops (ring and Ulysses)."""

from petastorm_tpu_torch.ops.augment import (RandomCropFlip, cutmix, flip_mask,  # noqa: F401
                                             flip_with_mask, mixup, random_crop, random_flip)
from petastorm_tpu_torch.ops.preprocess import normalize_images  # noqa: F401
from petastorm_tpu_torch.ops.ring_attention import make_ring_attention, ring_attention  # noqa: F401
from petastorm_tpu_torch.ops.ulysses_attention import (make_ulysses_attention,  # noqa: F401
                                                       ulysses_attention)
