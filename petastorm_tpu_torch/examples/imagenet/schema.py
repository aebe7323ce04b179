"""ImageNet dataset schema (twin of ``examples/imagenet/schema.py``): the
WordNet noun id, the synset text and a variable-size RGB image, compressed
with a selectable codec (PNG by default, as the reference's schema)."""

from __future__ import annotations

import numpy as np

from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
from petastorm_tpu_torch.unischema import Unischema, UnischemaField


def make_imagenet_schema(image_codec='png', quality=80):
    """The ImageNet schema with ``image_codec`` ('png' or 'jpeg') images."""
    return Unischema('ImagenetSchema', [
        UnischemaField('noun_id', np.str_, (), ScalarCodec(), False),
        UnischemaField('text', np.str_, (), ScalarCodec(), False),
        UnischemaField('image', np.uint8, (None, None, 3),
                       CompressedImageCodec(image_codec, quality=quality), False),
    ])


ImagenetSchema = make_imagenet_schema('png')
