"""Device-side input ops (twin of ``petastorm_tpu.ops``): normalize and flip."""

from petastorm_tpu_torch.ops.augment import flip_mask, flip_with_mask, random_flip  # noqa: F401
from petastorm_tpu_torch.ops.preprocess import normalize_images  # noqa: F401
