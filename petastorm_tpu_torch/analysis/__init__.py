"""Analysis tools of the port: the worker-pool protocol verifier
(:mod:`petastorm_tpu_torch.analysis.protocol`) and the interleaving explorer
(:mod:`petastorm_tpu_torch.analysis.schedule`). The JAX package's linter is
not ported; it runs over this package from the JAX side
(``python -m petastorm_tpu.analysis petastorm_tpu_torch``)."""
