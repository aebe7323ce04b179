"""Measurement tools (twin of ``petastorm_tpu.tools``): the pipeline duty cycle."""
