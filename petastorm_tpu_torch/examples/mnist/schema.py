"""MNIST dataset schema (twin of ``examples/mnist/schema.py``): a 28x28
uint8 image stored through ``NdarrayCodec``, its int64 digit and an int64
row index."""

from __future__ import annotations

import numpy as np

from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.unischema import Unischema, UnischemaField

MnistSchema = Unischema('MnistSchema', [
    UnischemaField('idx', np.int64, (), ScalarCodec(), False),
    UnischemaField('digit', np.int64, (), ScalarCodec(), False),
    UnischemaField('image', np.uint8, (28, 28), NdarrayCodec(), False),
])
