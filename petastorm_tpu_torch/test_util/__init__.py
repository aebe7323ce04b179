"""Helpers for the port's tests (twin of ``petastorm_tpu.test_util``)."""
