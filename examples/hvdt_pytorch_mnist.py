"""Distributed PyTorch MNIST training with horovod_tpu_torch, the
PyTorch/CUDA port.

examples/pytorch_mnist.py on the port: the five-step Horovod recipe (init,
pin the card by local_rank, scale the LR by size, wrap the optimizer in
DistributedOptimizer, broadcast rank 0's parameters and optimizer state),
with ``import horovod_tpu_torch.torch as hvd``.  ``--device cuda`` (the
default) pins ``cuda:local_rank()``; ``--device cpu`` runs on the CPU.

Run:  python -m horovod_tpu_torch.runner -np 4 -- \
          python examples/hvdt_pytorch_mnist.py
By default trains on a synthetic MNIST-like dataset so the script works with
no network access; pass --data-dir to use torchvision's real MNIST.
"""

import argparse

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.optim as optim
import torch.utils.data
import torch.utils.data.distributed

import horovod_tpu_torch.torch as hvd

parser = argparse.ArgumentParser(description="PyTorch MNIST Example")
parser.add_argument("--batch-size", type=int, default=64)
parser.add_argument("--test-batch-size", type=int, default=1000)
parser.add_argument("--epochs", type=int, default=10)
parser.add_argument("--lr", type=float, default=0.01)
parser.add_argument("--momentum", type=float, default=0.5)
parser.add_argument("--seed", type=int, default=42)
parser.add_argument("--log-interval", type=int, default=10)
parser.add_argument("--data-dir", default=None,
                    help="directory with real MNIST (torchvision); "
                         "synthetic data when unset")
parser.add_argument("--train-samples", type=int, default=2048,
                    help="synthetic train set size")
parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the card of local_rank(); cpu: the CPU")
args = parser.parse_args()

# Pin the card by local_rank (hvd.init's default on a GPU machine).
hvd.init(device=None if args.device == "cuda" else "cpu")
device = (torch.device("cuda", hvd.local_rank()) if args.device == "cuda"
          else torch.device("cpu"))
torch.manual_seed(args.seed)


def synthetic_mnist(n, seed):
    """Learnable synthetic stand-in: label = brightest image quadrant-pair.

    Deterministic across ranks (the DistributedSampler shards it), and a
    small CNN reaches high accuracy in one epoch.
    """
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, n)
    images = rng.rand(n, 1, 28, 28).astype(np.float32) * 0.25
    for i, y in enumerate(labels):
        r, c = divmod(int(y), 5)
        images[i, 0, r * 14:(r + 1) * 14, c * 5:(c + 1) * 5] += 0.75
    return torch.from_numpy(images), torch.from_numpy(labels).long()


if args.data_dir:
    from torchvision import datasets, transforms

    tfm = transforms.Compose([
        transforms.ToTensor(),
        transforms.Normalize((0.1307,), (0.3081,)),
    ])
    train_dataset = datasets.MNIST(args.data_dir, train=True, download=True,
                                   transform=tfm)
    test_dataset = datasets.MNIST(args.data_dir, train=False, transform=tfm)
else:
    train_dataset = torch.utils.data.TensorDataset(
        *synthetic_mnist(args.train_samples, seed=args.seed))
    test_dataset = torch.utils.data.TensorDataset(
        *synthetic_mnist(max(args.train_samples // 4, 64), seed=args.seed + 1))

# Partition the dataset among workers.
train_sampler = torch.utils.data.distributed.DistributedSampler(
    train_dataset, num_replicas=hvd.size(), rank=hvd.rank())
train_loader = torch.utils.data.DataLoader(
    train_dataset, batch_size=args.batch_size, sampler=train_sampler)
test_sampler = torch.utils.data.distributed.DistributedSampler(
    test_dataset, num_replicas=hvd.size(), rank=hvd.rank())
test_loader = torch.utils.data.DataLoader(
    test_dataset, batch_size=args.test_batch_size, sampler=test_sampler)


class Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 10, kernel_size=5)
        self.conv2 = nn.Conv2d(10, 20, kernel_size=5)
        self.conv2_drop = nn.Dropout2d()
        self.fc1 = nn.Linear(320, 50)
        self.fc2 = nn.Linear(50, 10)

    def forward(self, x):
        x = F.relu(F.max_pool2d(self.conv1(x), 2))
        x = F.relu(F.max_pool2d(self.conv2_drop(self.conv2(x)), 2))
        x = x.view(-1, 320)
        x = F.relu(self.fc1(x))
        x = F.dropout(x, training=self.training)
        return F.log_softmax(self.fc2(x), dim=1)


model = Net().to(device)

# Scale learning rate by the number of workers.
optimizer = optim.SGD(model.parameters(), lr=args.lr * hvd.size(),
                      momentum=args.momentum)
optimizer = hvd.DistributedOptimizer(
    optimizer, named_parameters=model.named_parameters())

# Replicate rank 0's initial state everywhere.
hvd.broadcast_parameters(model.state_dict(), root_rank=0)
hvd.broadcast_optimizer_state(optimizer, root_rank=0)


def train(epoch):
    model.train()
    train_sampler.set_epoch(epoch)
    for batch_idx, (data, target) in enumerate(train_loader):
        data, target = data.to(device), target.to(device)
        optimizer.zero_grad()
        loss = F.nll_loss(model(data), target)
        loss.backward()
        optimizer.step()
        if batch_idx % args.log_interval == 0 and hvd.rank() == 0:
            print(f"Train Epoch: {epoch} "
                  f"[{batch_idx * len(data)}/{len(train_sampler)}]"
                  f"\tLoss: {loss.item():.6f}")


def metric_average(val, name):
    return float(hvd.allreduce(torch.tensor(val), name=name))


def test():
    model.eval()
    test_loss, test_accuracy = 0.0, 0.0
    with torch.no_grad():
        for data, target in test_loader:
            data, target = data.to(device), target.to(device)
            output = model(data)
            test_loss += F.nll_loss(output, target, reduction="sum").item()
            pred = output.max(1)[1]
            test_accuracy += pred.eq(target).float().sum().item()
    test_loss /= len(test_sampler)
    test_accuracy /= len(test_sampler)
    # Average metrics across workers.
    test_loss = metric_average(test_loss, "avg_loss")
    test_accuracy = metric_average(test_accuracy, "avg_accuracy")
    if hvd.rank() == 0:
        print(f"Test set: Average loss: {test_loss:.4f}, "
              f"Accuracy: {100.0 * test_accuracy:.2f}%")


for epoch in range(1, args.epochs + 1):
    train(epoch)
    test()
