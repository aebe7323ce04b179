"""Sequence: the telemetry schema, its generator and the NGram sequence-model example (torch twins)."""
