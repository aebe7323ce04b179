"""Tools (twin of ``petastorm_tpu.tools``): the pipeline duty cycle, and the
store tools, each run as a module: ``python -m
petastorm_tpu_torch.tools.copy_dataset``, ``.generate_metadata``,
``.metadata_util``."""
