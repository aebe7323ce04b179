"""Operations and bytes the benchmark's metrics divide by, and the chip's
published peaks.

FLOPs count the model's convolutions and its head: 2 per multiply-add, and
3 times the forward for forward and backward (the backward computes the
input's and the weights' gradients, each as costly as the forward). Batch
norm, ReLU, pooling and the loss are left out, as MFU conventionally does.
"""

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


def _out(size, stride):
    return -(-size // stride)


def resnet_macs(config, image_size):
    """Multiply-adds of one forward pass of ``config``'s ResNet (bottleneck
    blocks, stride on the 3x3) on one ``image_size`` square image."""
    filters, c_in = config['num_filters'], config['in_channels']
    side = _out(image_size, 2)
    macs = side * side * 7 * 7 * c_in * filters
    side = _out(side, 2)  # the stem's max-pool
    features = filters
    for i, blocks in enumerate(config['stage_sizes']):
        width = filters * 2 ** i
        for j in range(blocks):
            stride = 2 if i > 0 and j == 0 else 1
            out = _out(side, stride)
            macs += side * side * features * width          # conv1, 1x1
            macs += out * out * 9 * width * width            # conv2, 3x3, strided
            macs += out * out * width * 4 * width            # conv3, 1x1
            if j == 0:
                macs += out * out * features * 4 * width     # projection, 1x1, strided
            side, features = out, 4 * width
    return macs + features * config['num_classes']


def train_step_flops(config):
    """FLOPs of one training step of ``config`` at its batch and size."""
    return 2 * 3 * config['batch_size'] * resnet_macs(config, config['image_size'])


def normalize_bytes(elements):
    """Bytes the normalize kernel has to move: each uint8 element read once
    and its bf16 result written once."""
    return 3 * elements
