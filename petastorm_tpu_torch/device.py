"""Device resolution shared by every entry point that touches a device."""

from __future__ import annotations

import torch


def resolve_device(device=None):
    """``None`` means ``torch.device('cuda')``: the port runs on the card. When
    CUDA is absent this raises rather than falling back to the CPU; the CPU
    is used only when the caller asks for it (``device='cpu'``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('CUDA is not available. petastorm_tpu_torch runs on an NVIDIA '
                               "GPU by default; pass device='cpu' to run on the CPU.")
        return torch.device('cuda')
    return torch.device(device)
