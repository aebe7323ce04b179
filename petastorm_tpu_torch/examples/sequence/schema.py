"""Timestamped telemetry schema (twin of ``examples/sequence/schema.py``):
sensor rows ordered by timestamp, the shape NGram windows are built for."""

from __future__ import annotations

import numpy as np

from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
from petastorm_tpu_torch.unischema import Unischema, UnischemaField


def make_telemetry_schema(feature_dim=64):
    """``timestamp`` (int64), ``features`` (float32 x ``feature_dim``) and
    ``sensor_id`` (int32)."""
    return Unischema('TelemetrySchema', [
        UnischemaField('timestamp', np.int64, (), ScalarCodec(), False),
        UnischemaField('features', np.float32, (feature_dim,), NdarrayCodec(), False),
        UnischemaField('sensor_id', np.int32, (), ScalarCodec(), False),
    ])


TelemetrySchema = make_telemetry_schema()
