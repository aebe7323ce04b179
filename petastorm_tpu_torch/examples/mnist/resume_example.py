"""Crash-safe MNIST training, the model and the read position checkpointed
together: twin of ``examples/mnist/resume_example.py``.

A checkpoint is a directory ``step_<8 digits>`` holding ``train_state.pt``
(``torch.save`` of the model's and the optimizer's ``state_dict`` and the
step) and ``loader_state.pkl`` (:meth:`TorchDataLoader.state_dict`: the
reader's position, the rows buffered client-side and the shuffle RNG). A
``DONE`` marker, written last, makes it visible: a crash inside a save
leaves no half checkpoint to resume from, and the next save of that step
sweeps the leftover first. A restart resumes both, so no row is read twice
or skipped; with a fixed seed and a pool that delivers in a fixed order
(``reader_pool_type='dummy'``) the resumed stream replays the
uninterrupted one row for row.

    python -m petastorm_tpu_torch.examples.mnist.resume_example \\
        --dataset-url file:///tmp/mnist_dataset --checkpoint-dir /tmp/mnist_ckpt \\
        --total-steps 200

Kill it anywhere; the same command continues where it stopped.
"""

from __future__ import annotations

import argparse
import os
import pickle
import shutil

import torch

from petastorm_tpu_torch import make_reader
from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.examples.mnist.torch_example import TRANSFORM, new_mnist_state
from petastorm_tpu_torch.models.train import make_train_step
from petastorm_tpu_torch.torch import TorchDataLoader

TRAIN_STATE_FILE = 'train_state.pt'
LOADER_STATE_FILE = 'loader_state.pkl'


def _save(checkpoint_dir, step, state, loader_state):
    path = os.path.join(checkpoint_dir, 'step_{:08d}'.format(step))
    if os.path.isdir(path) and not os.path.exists(os.path.join(path, 'DONE')):
        # a crash inside an earlier save of this very step left it
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)
    torch.save({'model': state.module.state_dict(), 'optimizer': state.optimizer.state_dict(),
                'step': state.step}, os.path.join(path, TRAIN_STATE_FILE))
    with open(os.path.join(path, LOADER_STATE_FILE), 'wb') as f:
        pickle.dump(loader_state, f)
    with open(os.path.join(path, 'DONE'), 'w') as f:
        f.write(str(step))


def _latest(checkpoint_dir):
    if not os.path.isdir(checkpoint_dir):
        return None
    done = [d for d in os.listdir(checkpoint_dir)
            if d.startswith('step_') and os.path.exists(os.path.join(checkpoint_dir, d, 'DONE'))]
    return os.path.join(checkpoint_dir, max(done)) if done else None


def _restore(path, state, device):
    saved = torch.load(os.path.join(path, TRAIN_STATE_FILE), map_location=device,
                       weights_only=True)
    state.module.load_state_dict(saved['model'])
    state.optimizer.load_state_dict(saved['optimizer'])
    state.step = int(saved['step'])
    with open(os.path.join(path, LOADER_STATE_FILE), 'rb') as f:
        loader_state = pickle.load(f)
    return state, loader_state


def train_with_checkpointing(dataset_url, checkpoint_dir, total_steps=100, checkpoint_every=25,
                             batch_size=32, lr=0.05, seed=0, reader_pool_type='thread',
                             device=None, graphed=True, on_step=None):
    """Train to ``total_steps``, checkpointing every ``checkpoint_every``
    steps and at the end; resume from the latest complete checkpoint in
    ``checkpoint_dir``. ``on_step(step, batch, metrics)`` is called after
    each step. Returns the train state.

    Replay: a resume never loses or repeats a delivered row (the loader
    state carries the buffered rows). Replaying the stream row for row also
    needs a fixed delivery order: ``reader_pool_type='dummy'`` (or one
    worker); a pool of several workers orders row groups as they finish."""
    device = resolve_device(device)
    state = new_mnist_state(seed, lr, device)
    train_step = make_train_step(graphed=graphed)
    loader_state = None
    latest = _latest(checkpoint_dir)
    if latest is not None:
        state, loader_state = _restore(latest, state, device)
        print('resumed from {} (step {})'.format(latest, state.step))
    if state.step >= total_steps:
        return state

    reader = make_reader(dataset_url + '/train', num_epochs=None, seed=seed,
                         transform_spec=TRANSFORM, reader_pool_type=reader_pool_type,
                         resume_state=None if loader_state is None else loader_state['reader'])
    with TorchDataLoader(reader, batch_size, shuffling_queue_capacity=256, seed=seed,
                         to_device=device, resume_state=loader_state) as loader:
        for batch in loader:
            state, metrics = train_step(state, batch['image'], batch['digit'])
            step = state.step
            if on_step is not None:
                on_step(step, batch, metrics)
            if step % checkpoint_every == 0 or step >= total_steps:
                # the state before the next batch is drawn: everything up to
                # and including this step's batch
                _save(checkpoint_dir, step, state, loader.state_dict())
                print('step {}: loss={:.4f} (checkpointed)'.format(step, float(metrics['loss'])))
            if step >= total_steps:
                break
    return state


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--dataset-url', default='file:///tmp/mnist_dataset')
    parser.add_argument('--checkpoint-dir', default='/tmp/mnist_ckpt')
    parser.add_argument('--total-steps', type=int, default=100)
    parser.add_argument('--checkpoint-every', type=int, default=25)
    parser.add_argument('--batch-size', type=int, default=32)
    parser.add_argument('--lr', type=float, default=0.05)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', default=None, help="default: the card; 'cpu' to run there")
    parser.add_argument('--eager', action='store_true', help='the eager step, not the graphed one')
    args = parser.parse_args()
    train_with_checkpointing(args.dataset_url, args.checkpoint_dir, args.total_steps,
                             args.checkpoint_every, args.batch_size, lr=args.lr, seed=args.seed,
                             device=args.device, graphed=not args.eager)


if __name__ == '__main__':
    main()
