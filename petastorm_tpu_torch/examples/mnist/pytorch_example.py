"""Train a torch model on an MNIST dataset through the reference's
``petastorm.pytorch`` API: twin of ``examples/mnist/pytorch_example.py``.

The port's :class:`~petastorm_tpu_torch.torch_utils.DataLoader` yields host
tensors, as the reference's does; this loop moves each batch to the card
and trains the reference example's network there.

    python -m petastorm_tpu_torch.examples.mnist.pytorch_example \\
        --dataset-url file:///tmp/mnist_dataset
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F
from torch import nn

from petastorm_tpu_torch import make_reader
from petastorm_tpu_torch.device import resolve_device
from petastorm_tpu_torch.examples.mnist.torch_example import TRANSFORM
from petastorm_tpu_torch.torch_utils import DataLoader


class Net(nn.Module):
    """The reference example's network: two 5x5 convolutions with max
    pooling, two dense layers, log-softmax output."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 10, kernel_size=5)
        self.conv2 = nn.Conv2d(10, 20, kernel_size=5)
        self.fc1 = nn.Linear(320, 50)
        self.fc2 = nn.Linear(50, 10)

    def forward(self, x):
        x = F.relu(F.max_pool2d(self.conv1(x), 2))
        x = F.relu(F.max_pool2d(self.conv2(x), 2))
        x = x.view(-1, 320)
        x = F.relu(self.fc1(x))
        return F.log_softmax(self.fc2(x), dim=1)


def train_and_test(dataset_url, batch_size=32, epochs=1, lr=0.01, seed=0, device=None):
    """Train for ``epochs`` epochs on ``device`` (``None``: the card),
    testing after each. Returns the model, every step's loss and the last
    epoch's test accuracy."""
    device = resolve_device(device)
    torch.manual_seed(seed)
    model = Net().to(device)
    optimizer = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.5)
    losses, accuracy = [], None
    for epoch in range(epochs):
        model.train()
        with DataLoader(make_reader(dataset_url + '/train', num_epochs=1, seed=seed,
                                    transform_spec=TRANSFORM),
                        batch_size=batch_size) as train_loader:
            for step, batch in enumerate(train_loader):
                data = batch['image'].unsqueeze(1).to(device)
                optimizer.zero_grad()
                loss = F.nll_loss(model(data), batch['digit'].to(device))
                loss.backward()
                optimizer.step()
                losses.append(loss.detach())
                if step % 20 == 0:
                    print('epoch {} step {}: loss={:.4f}'.format(epoch, step, loss.item()))
        model.eval()
        correct = total = 0
        with DataLoader(make_reader(dataset_url + '/test', num_epochs=1,
                                    transform_spec=TRANSFORM),
                        batch_size=batch_size) as test_loader:
            with torch.no_grad():
                for batch in test_loader:
                    pred = model(batch['image'].unsqueeze(1).to(device)).argmax(dim=1)
                    correct += int((pred.cpu() == batch['digit']).sum())
                    total += int(batch['digit'].shape[0])
        accuracy = correct / max(total, 1)
        print('epoch {}: test accuracy {}/{} = {:.3f}'.format(epoch, correct, total, accuracy))
    return model, torch.stack(losses).tolist() if losses else [], accuracy


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--dataset-url', default='file:///tmp/mnist_dataset')
    parser.add_argument('--batch-size', type=int, default=32)
    parser.add_argument('--epochs', type=int, default=1)
    parser.add_argument('--lr', type=float, default=0.01)
    parser.add_argument('--device', default=None, help="default: the card; 'cpu' to run there")
    args = parser.parse_args()
    train_and_test(args.dataset_url, args.batch_size, args.epochs, args.lr, device=args.device)


if __name__ == '__main__':
    main()
