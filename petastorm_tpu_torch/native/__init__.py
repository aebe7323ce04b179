"""Native host code of the port: the batched PNG/JPEG decoder.

``image_codec.cpp`` is the port's own copy of the JAX package's decoder,
built with g++ at first use into ``.torch_build/native/`` of the checkout
(:mod:`~petastorm_tpu_torch.native.build`) and bound with ctypes
(:mod:`~petastorm_tpu_torch.native.image_codec`). The JAX package's fused
row-group reader, page scan and shared-memory ring are not ported yet.
"""
