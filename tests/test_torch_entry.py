"""Port parity: ``petastorm_tpu_torch.entry`` against the repository's
``__graft_entry__.py``. ``entry()``'s ResNet-50 bf16 forward with the JAX
entry's weights (moved by ``flax_to_torch``) on the JAX entry's batch,
within 5% of the largest logit: the tolerance ``chip_smoke.py`` holds the
bf16 model to (each of ~50 layers rounds at 2**-9 relative). The dry run
on four gloo ranks of the CPU, all five legs of the JAX dry run, and the
refusals without CUDA."""

import tempfile

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft_entry
from petastorm_tpu_torch.entry import LEGS_NOT_PORTED, dryrun_multichip, entry
from petastorm_tpu_torch.models.convert import flax_to_torch


def test_entry_forward_matches_jax_entry():
    jax_fn, (variables, jax_images) = graft_entry.entry()
    expected = np.asarray(jax.jit(jax_fn)(variables, jax_images), dtype=np.float32)
    fn, (model, images) = entry(device='cpu')
    assert tuple(images.shape) == (8, 64, 64, 3) and images.dtype == torch.float32
    np.testing.assert_array_equal(images.numpy(), np.asarray(jax_images))
    model.load_state_dict(flax_to_torch(jax.device_get(
        {k: dict(v) for k, v in variables.items()})))
    out = fn(model, images)
    assert tuple(out.shape) == (8, 1000) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    tolerance = 0.05 * float(np.abs(expected).max())
    np.testing.assert_allclose(out.numpy(), expected, atol=tolerance, rtol=0)


def test_dryrun_multichip_on_four_cpu_ranks(capsys, monkeypatch, tmp_path):
    # the dry run's stores and its ranks' file store go under tmp_path
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    result = dryrun_multichip(4, device='cpu')
    assert result['mesh'] == (2, 2) and result['batch'] == 4 and result['head_rows'] == 8
    assert np.isfinite(result['loss']) and np.isfinite(result['process_loss'])
    # the sp leg: a (2, 2) ('data', 'seq') mesh, as the JAX dry run's on 4 devices
    assert result['seq_mesh'] == (2, 2) and np.isfinite(result['seq_loss'])
    # the ep leg: a (2, 2) ('data', 'expert') mesh; the pp leg: 4 stages,
    # exact against sequential execution
    assert result['ep_mesh'] == (2, 2) and np.isfinite(result['ep_loss'])
    assert result['pp_stages'] == 4 and result['pp_err'] < 1e-4
    assert result['legs_run'] == ['dp/tp', 'process pool', 'sp', 'ep', 'pp']
    assert result['legs_not_ported'] == {} and LEGS_NOT_PORTED == {}
    out = capsys.readouterr().out
    assert 'dryrun_multichip OK: mesh=(2x2)' in out and 'seq_mesh=(2x2)' in out
    assert 'ep_mesh=(2x2), ep_loss={:.4f}'.format(result['ep_loss']) in out
    assert 'pp_stages=4, pp_err={:.3g}'.format(result['pp_err']) in out
    assert 'legs run: dp/tp, process pool, sp, ep, pp; not yet ported: none' in out


def test_entry_points_refuse_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(1)
    # with CUDA but too few cards, NCCL's one rank per card is refused
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(RuntimeError, match='one NCCL rank per card'):
        dryrun_multichip(2)
