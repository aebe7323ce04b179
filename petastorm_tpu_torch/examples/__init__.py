"""Torch twins of the repository's ``examples/`` (MNIST, ImageNet, sequence,
hello world), each runnable as ``python -m petastorm_tpu_torch.examples.<...>``.

They keep the JAX examples' arguments and defaults, run on the card unless
the caller passes ``device='cpu'``, and build their train steps graphed
(``graphed=True``, the counterpart of the jitted step) unless told not to.
Importing a module only defines its functions.
"""
