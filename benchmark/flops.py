"""Bytes the kernels' rooflines divide by, and the chip's published peaks.
A step's FLOPs are its model kind's (``step_flops`` in
``benchmark/models/<model>.py``)."""

from __future__ import annotations

#: published dense peaks (NVIDIA data sheets, without sparsity); a card the
#: table does not name has no peak, and the metrics that need one read nothing
PEAKS = (
    # (name contains, bf16 FLOP/s, HBM bytes/s)
    ('H100 PCIe', 756e12, 2.0e12),
    ('H100 NVL', 835e12, 3.9e12),
    ('H100', 989e12, 3.35e12),
)


def peak(kind):
    """``(bf16 FLOP/s, HBM bytes/s)`` of the card named ``kind``, or None."""
    for name, flops, bandwidth in PEAKS:
        if name in kind:
            return flops, bandwidth
    return None


def normalize_bytes(elements):
    """Bytes the normalize kernel has to move: each uint8 element read once
    and its bf16 result written once."""
    return 3 * elements
