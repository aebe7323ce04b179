"""The port's hand-written kernels against their plain PyTorch versions.

This file imports nothing of JAX, so it also runs on a host that has only
PyTorch and a card, without the repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

Tests that need the card carry the ``gpu`` marker and skip without CUDA.
"""

import numpy as np
import pytest
import torch

from petastorm_tpu_torch.ops import normalize_images
from petastorm_tpu_torch.ops.kernels import normalize as normalize_kernel

MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)

SHAPES = [
    (64, 160, 160, 3),  # the main path's batch
    (4, 32, 32, 3),
    (2, 17, 224, 3),    # odd rows, a masked tail
    (1, 8, 128, 1),     # single channel
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU with CUDA')
    return torch.device('cuda')


def _images(shape, dtype, device, seed=0):
    host = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    return torch.from_numpy(host).to(device, dtype)


def _stats(c, device):
    return (torch.from_numpy(MEAN[:c]).to(device),
            torch.from_numpy((1.0 / STD[:c]).astype(np.float32)).to(device))


def test_kernel_wrapper_refuses_cpu_tensor():
    # on the CPU the op runs the plain version; the kernel wrapper itself
    # never does: it launches or raises
    images = _images((1, 4, 4, 3), torch.uint8, 'cpu')
    mean, inv_std = _stats(3, 'cpu')
    with pytest.raises(ValueError, match='CUDA'):
        normalize_kernel.normalize_triton(images, mean, inv_std)


@pytest.mark.parametrize('out_dtype', [torch.bfloat16, torch.float32])
def test_plain_version_widens_integers_and_keeps_floats(out_dtype):
    mean, inv_std = _stats(3, 'cpu')
    ints = _images((2, 4, 4, 3), torch.uint8, 'cpu')
    out = normalize_kernel.normalize_reference(ints, mean, inv_std, out_dtype)
    expected = (ints.numpy().astype(np.float32) - MEAN) * (1.0 / STD).astype(np.float32)
    assert out.dtype == out_dtype
    np.testing.assert_allclose(out.float().numpy(), expected, rtol=1e-2 if out_dtype ==
                               torch.bfloat16 else 1e-6, atol=1e-5)
    floats = ints.float() + 0.25  # a truncating cast would drop the quarter
    out = normalize_kernel.normalize_reference(floats, mean, inv_std, torch.float32)
    np.testing.assert_allclose(out.numpy(), expected + 0.25 / STD, rtol=1e-6, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('dtype', [torch.uint8, torch.int16, torch.float32])
@pytest.mark.parametrize('out_dtype', [torch.bfloat16, torch.float32])
def test_triton_kernel_matches_plain_version(cuda, shape, dtype, out_dtype):
    images = _images(shape, dtype, cuda)
    if dtype == torch.float32:
        images = images + 0.5
    mean, inv_std = _stats(shape[-1], cuda)
    before = normalize_kernel.launches
    out = normalize_kernel.normalize_triton(images, mean, inv_std, out_dtype)
    torch.cuda.synchronize()
    assert normalize_kernel.launches == before + 1
    assert out.dtype == out_dtype and out.shape == images.shape
    ref = normalize_kernel.normalize_reference(images, mean, inv_std, out_dtype)
    # the same float32 arithmetic, rounded once: at most one bf16 ulp
    tol = (2.0 ** -7 * ref.float().abs() if out_dtype == torch.bfloat16
           else 1e-5 * ref.float().abs() + 1e-5)
    assert ((out.float() - ref.float()).abs() <= tol + 1e-6).all()


@pytest.mark.gpu
def test_normalize_images_launches_kernel_on_cuda(cuda):
    images = _images((2, 17, 224, 3), torch.uint8, cuda)
    before = normalize_kernel.launches
    out = normalize_images(images, MEAN, STD, out_dtype=torch.float32)
    assert normalize_kernel.launches == before + 1
    expected = normalize_images(images.cpu(), MEAN, STD, out_dtype=torch.float32)
    np.testing.assert_allclose(out.cpu().numpy(), expected.numpy(), rtol=1e-5, atol=1e-5)
    single = normalize_images(images[0], MEAN, STD)  # one (H, W, C) image
    assert normalize_kernel.launches == before + 2 and single.shape == images[0].shape


@pytest.mark.gpu
def test_kernel_wrapper_checks_its_inputs(cuda):
    mean, inv_std = _stats(3, cuda)
    images = _images((2, 8, 8, 3), torch.uint8, cuda)
    with pytest.raises(ValueError, match='contiguous'):
        normalize_kernel.normalize_triton(images.transpose(1, 2), mean, inv_std)
    with pytest.raises(ValueError, match='3-D or 4-D'):
        normalize_kernel.normalize_triton(images[0, 0], mean, inv_std)
    with pytest.raises(ValueError, match='mean_c'):
        normalize_kernel.normalize_triton(images, mean[:2], inv_std)
    with pytest.raises(ValueError, match='out_dtype'):
        normalize_kernel.normalize_triton(images, mean, inv_std, torch.float16)


@pytest.mark.gpu
def test_graphed_step_losses_equal_the_eager_steps(cuda):
    # five steps of a small ResNet from one seed on the same batches: the
    # graphed step (two eager warm-up steps, then capture and replays) gives
    # the eager step's losses within 1e-3 (the same kernels; float32 sums of
    # the backward may come in another order), counts the normalize kernel
    # once per replay, and its metrics survive the later replays
    from petastorm_tpu_torch.models import BottleneckBlock, ResNet
    from petastorm_tpu_torch.models.train import (GRAPH_WARMUP_STEPS, create_train_state,
                                                  make_train_step)
    from petastorm_tpu_torch.ops.augment import flip_with_mask

    steps = 5
    gen = np.random.default_rng(2)
    batches = [(_images((8, 32, 32, 3), torch.uint8, cuda, seed=s),
                torch.from_numpy(gen.integers(0, 10, 8)).to(cuda)) for s in range(steps)]

    def preprocess(images, mask):
        return normalize_images(flip_with_mask(images, mask), MEAN, STD, out_dtype=torch.float32)

    def run(graphed):
        torch.manual_seed(0)
        model = ResNet([1, 1, 1, 1], BottleneckBlock, num_classes=10, num_filters=8,
                       dtype=torch.float32)
        state = create_train_state(model, cuda)
        step = make_train_step(preprocess_fn=preprocess, preprocess_seed=3, graphed=graphed)
        before = normalize_kernel.launches
        losses = [step(state, images, labels)[1]['loss'] for images, labels in batches]
        torch.cuda.synchronize()
        assert state.step == steps
        return [float(x) for x in losses], normalize_kernel.launches - before, step

    eager, eager_launches, _ = run(False)
    graphed, graphed_launches, step = run(True)
    assert steps > GRAPH_WARMUP_STEPS + 1
    np.testing.assert_allclose(graphed, eager, atol=1e-3, rtol=0)
    assert len(set(graphed)) == steps
    assert eager_launches == graphed_launches == steps
    with pytest.raises(ValueError, match='captured for images'):
        model = ResNet([1, 1, 1, 1], BottleneckBlock, num_classes=10, num_filters=8,
                       dtype=torch.float32)
        step(create_train_state(model, cuda), batches[0][0][:4], batches[0][1][:4])


@pytest.mark.gpu
@pytest.mark.parametrize('context', ['plain', 'ring'])
def test_graphed_sequence_step_equals_the_eager_step(cuda, context, monkeypatch):
    # the sequence transformer's plain step (no preprocess, no mask): five
    # steps from one seed on the same [B, T, F] batches, graphed against
    # eager; 'ring' runs the ring attention op with a seq group of one. The
    # graph replays the eager step's float32 kernels, so the losses agree
    # within 1e-5 (float32 sums of the backward may come in another order)
    from petastorm_tpu_torch.models import make_sequence_transformer
    from petastorm_tpu_torch.models.transformer import SequenceTransformer
    from petastorm_tpu_torch.models.train import create_train_state, make_train_step
    from petastorm_tpu_torch.ops.ring_attention import ring_attention

    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    steps = 5
    gen = np.random.default_rng(4)
    batches = [(torch.from_numpy(gen.standard_normal((16, 8, 64)).astype(np.float32)).to(cuda),
                torch.from_numpy(gen.integers(0, 8, 16)).to(cuda)) for _ in range(steps)]

    def run(graphed):
        torch.manual_seed(0)
        if context == 'plain':
            model = make_sequence_transformer(8, 8, 64)
        else:
            model = SequenceTransformer(8, 8, 64, attention_fn=ring_attention)
        state = create_train_state(model, cuda)
        step = make_train_step(graphed=graphed)
        losses = [step(state, x, y)[1]['loss'] for x, y in batches]
        torch.cuda.synchronize()
        assert state.step == steps
        return [float(x) for x in losses]

    eager, graphed = run(False), run(True)
    np.testing.assert_allclose(graphed, eager, atol=1e-5, rtol=0)
    assert len(set(graphed)) == steps


@pytest.mark.gpu
def test_graphed_moe_step_equals_the_eager_step(cuda, monkeypatch):
    # the MoE sequence transformer (8 experts, the smoke's widths) stepped
    # on moe_loss: five steps from one seed on the same [B, T, F] batches,
    # graphed against eager. Routing builds its one-hots by comparison and
    # reads nothing back to the host, so the step captures; the losses and
    # aux losses agree within 1e-5
    from petastorm_tpu_torch.models import MoESequenceTransformer
    from petastorm_tpu_torch.models.train import create_train_state, make_train_step

    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', False)
    steps = 5
    gen = np.random.default_rng(5)
    batches = [(torch.from_numpy(gen.standard_normal((16, 8, 64)).astype(np.float32)).to(cuda),
                torch.from_numpy(gen.integers(0, 8, 16)).to(cuda)) for _ in range(steps)]

    def run(graphed):
        torch.manual_seed(0)
        state = create_train_state(MoESequenceTransformer(8, 8, seq_len=8, feature_dim=64), cuda)
        step = make_train_step(graphed=graphed)
        metrics = [step(state, x, y)[1] for x, y in batches]
        torch.cuda.synchronize()
        assert state.step == steps
        return [[float(m[k]) for m in metrics] for k in ('loss', 'aux')]

    eager, graphed = run(False), run(True)
    np.testing.assert_allclose(graphed, eager, atol=1e-5, rtol=0)
    assert len(set(graphed[0])) == steps
