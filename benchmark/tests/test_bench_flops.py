"""The operation and byte counts the per-layer metrics divide by."""

import json
import os

from benchmark import flops, harness

CONFIG = os.path.join(os.path.dirname(os.path.dirname(__file__)), 'configs', 'rn50_petastorm.json')
RESNET50 = harness.Cell('rn50_petastorm.raw').model_module()


def _config():
    with open(CONFIG) as f:
        return json.load(f)


def _stage(side_in, c_in, width, blocks, stride):
    """Multiply-adds of one stage, by hand: the first block's strided 3x3
    and projection, then the identical blocks."""
    out = side_in // stride
    first = (side_in * side_in * c_in * width + out * out * 9 * width * width
             + out * out * width * 4 * width + out * out * c_in * 4 * width)
    rest = out * out * (4 * width * width + 9 * width * width + width * 4 * width)
    return first + (blocks - 1) * rest


def test_resnet50_macs_at_224_match_a_hand_count():
    stem = 112 * 112 * 7 * 7 * 3 * 64
    body = (_stage(56, 64, 64, 3, 1) + _stage(56, 256, 128, 4, 2) + _stage(28, 512, 256, 6, 2)
            + _stage(14, 1024, 512, 3, 2))
    head = 2048 * 1000
    assert RESNET50.macs(_config(), 224) == stem + body + head == 4089184256


def test_train_step_flops_count_forward_and_backward_of_the_batch():
    config = _config()
    assert RESNET50.step_flops(config) == 2 * 3 * 256 * 4089184256


def test_normalize_bytes_read_one_and_write_two_per_element():
    elements = 256 * 224 * 224 * 3
    assert flops.normalize_bytes(elements) == 115605504
    # the kernel's bound at the H100's published bandwidth: 34.5 us
    bandwidth = flops.peak('NVIDIA H100 80GB HBM3')[1]
    assert abs(flops.normalize_bytes(elements) / bandwidth - 34.509e-6) < 1e-8


def test_peaks_name_the_h100_parts_and_nothing_else():
    assert flops.peak('NVIDIA H100 80GB HBM3') == (989e12, 3.35e12)
    assert flops.peak('NVIDIA H100 PCIe') == (756e12, 2.0e12)
    assert flops.peak('NVIDIA A100-SXM4-80GB') is None
