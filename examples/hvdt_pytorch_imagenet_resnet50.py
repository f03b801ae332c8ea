"""Distributed PyTorch ResNet-50 ImageNet training with horovod_tpu_torch,
the PyTorch/CUDA port.

examples/pytorch_imagenet_resnet50.py on the port, with ``import
horovod_tpu_torch.torch as hvd`` and the port's own ResNet-50
(``horovod_tpu_torch.models.ResNet50``): LR scaled by size with gradual
warmup + 30/60/80 staircase, cross-worker metric averaging via allreduce,
rank-0 checkpointing, resume-from-epoch broadcast, and parameter (buffers
included) and optimizer-state broadcast on (re)start.  ``--device cuda``
(the default) pins ``cuda:local_rank()``; ``--device cpu`` runs on the
CPU.

Run:  python -m horovod_tpu_torch.runner -np 4 -- \
          python examples/hvdt_pytorch_imagenet_resnet50.py \
          --synthetic-batches 4
"""

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.data
import torch.utils.data.distributed

import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch.models import ResNet50



def make_resnet50():
    """The port's ResNet-50 (v1.5, flax-semantics BN, float32 compute)."""
    return ResNet50(num_classes=1000, dtype=torch.float32,
                    generator=torch.Generator().manual_seed(args.seed))


parser = argparse.ArgumentParser(description="PyTorch ImageNet ResNet-50")
parser.add_argument("--train-dir", default=None,
                    help="ImageNet train directory (synthetic data if unset)")
parser.add_argument("--val-dir", default=None)
parser.add_argument("--checkpoint-format",
                    default=os.path.join(tempfile.gettempdir(),
                                         "hvdt_pt_resnet50",
                                         "checkpoint-{epoch}.pth.tar"))
parser.add_argument("--batch-size", type=int, default=32)
parser.add_argument("--val-batch-size", type=int, default=32)
parser.add_argument("--epochs", type=int, default=90)
parser.add_argument("--base-lr", type=float, default=0.0125)
parser.add_argument("--warmup-epochs", type=float, default=5)
parser.add_argument("--momentum", type=float, default=0.9)
parser.add_argument("--wd", type=float, default=5e-5)
parser.add_argument("--seed", type=int, default=42)
parser.add_argument("--synthetic-batches", type=int, default=16,
                    help="per-epoch per-worker batches of synthetic data")
parser.add_argument("--image-size", type=int, default=224)
parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the card of local_rank(); cpu: the CPU")
args = parser.parse_args()

# Pin the card by local_rank (hvd.init's default on a GPU machine).
hvd.init(device=None if args.device == "cuda" else "cpu")
device = (torch.device("cuda", hvd.local_rank()) if args.device == "cuda"
          else torch.device("cpu"))
torch.manual_seed(args.seed)

# Restore from the latest checkpoint rank 0 can see; broadcast the decision
# so every worker resumes from the same epoch.
resume_from_epoch = 0
for try_epoch in range(args.epochs, 0, -1):
    if os.path.exists(args.checkpoint_format.format(epoch=try_epoch)):
        resume_from_epoch = try_epoch
        break
resume_from_epoch = int(hvd.broadcast(
    torch.tensor(resume_from_epoch), root_rank=0, name="resume_from_epoch"))

verbose = 1 if hvd.rank() == 0 else 0


def make_dataset(train, seed):
    if args.train_dir:
        import torchvision.transforms as transforms
        from torchvision import datasets

        tfm = transforms.Compose([
            transforms.RandomResizedCrop(args.image_size) if train
            else transforms.CenterCrop(args.image_size),
            transforms.ToTensor(),
            transforms.Normalize(mean=[0.485, 0.456, 0.406],
                                 std=[0.229, 0.224, 0.225]),
        ])
        return datasets.ImageFolder(
            args.train_dir if train else args.val_dir, tfm)
    rng = np.random.RandomState(seed)
    n = args.synthetic_batches * args.batch_size * hvd.size()
    images = torch.from_numpy(
        rng.rand(n, 3, args.image_size, args.image_size).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 1000, n)).long()
    return torch.utils.data.TensorDataset(images, labels)


train_dataset = make_dataset(train=True, seed=1234)
val_dataset = make_dataset(train=False, seed=4321)

train_sampler = torch.utils.data.distributed.DistributedSampler(
    train_dataset, num_replicas=hvd.size(), rank=hvd.rank())
train_loader = torch.utils.data.DataLoader(
    train_dataset, batch_size=args.batch_size, sampler=train_sampler)
val_sampler = torch.utils.data.distributed.DistributedSampler(
    val_dataset, num_replicas=hvd.size(), rank=hvd.rank())
val_loader = torch.utils.data.DataLoader(
    val_dataset, batch_size=args.val_batch_size, sampler=val_sampler)

model = make_resnet50().to(device)

optimizer = torch.optim.SGD(model.parameters(),
                            lr=args.base_lr * hvd.size(),
                            momentum=args.momentum, weight_decay=args.wd)
optimizer = hvd.DistributedOptimizer(
    optimizer, named_parameters=model.named_parameters())

if resume_from_epoch > 0 and hvd.rank() == 0:
    checkpoint = torch.load(
        args.checkpoint_format.format(epoch=resume_from_epoch),
        map_location=device)
    model.load_state_dict(checkpoint["model"])
    optimizer.load_state_dict(checkpoint["optimizer"])

# Replicate rank 0's (possibly restored) state on every worker.
hvd.broadcast_parameters(model.state_dict(), root_rank=0)
hvd.broadcast_optimizer_state(optimizer, root_rank=0)


def adjust_learning_rate(epoch, batch_idx):
    """Warmup from base_lr to base_lr*size, then 30/60/80 staircase."""
    if epoch < args.warmup_epochs:
        epoch_f = epoch + float(batch_idx + 1) / len(train_loader)
        lr_adj = (1.0 / hvd.size()
                  * (epoch_f * (hvd.size() - 1) / args.warmup_epochs + 1))
    elif epoch < 30:
        lr_adj = 1.0
    elif epoch < 60:
        lr_adj = 1e-1
    elif epoch < 80:
        lr_adj = 1e-2
    else:
        lr_adj = 1e-3
    for param_group in optimizer.param_groups:
        param_group["lr"] = args.base_lr * hvd.size() * lr_adj


def accuracy(output, target):
    pred = output.max(1, keepdim=True)[1]
    return pred.eq(target.view_as(pred)).float().mean()


class Metric:
    """Running cross-worker average of a scalar (reference's Metric pattern,
    /root/reference/examples/pytorch_imagenet_resnet50.py:227-239)."""

    def __init__(self, name):
        self.name = name
        self.sum = torch.tensor(0.0)
        self.n = torch.tensor(0.0)

    def update(self, val):
        self.sum += hvd.allreduce(val.detach().cpu(), name=self.name)
        self.n += 1

    @property
    def avg(self):
        return (self.sum / max(self.n, torch.tensor(1.0))).item()


def train(epoch):
    model.train()
    train_sampler.set_epoch(epoch)
    train_loss = Metric("train_loss")
    train_accuracy = Metric("train_accuracy")
    for batch_idx, (data, target) in enumerate(train_loader):
        data, target = data.to(device), target.to(device)
        adjust_learning_rate(epoch, batch_idx)
        optimizer.zero_grad()
        output = model(data)
        loss = F.cross_entropy(output, target)
        loss.backward()
        optimizer.step()
        train_loss.update(loss)
        train_accuracy.update(accuracy(output, target))
        if verbose and batch_idx % 10 == 0:
            print(f"Epoch {epoch} [{batch_idx}/{len(train_loader)}] "
                  f"loss {train_loss.avg:.4f} acc {train_accuracy.avg:.4f}")


def validate(epoch):
    model.eval()
    val_loss = Metric("val_loss")
    val_accuracy = Metric("val_accuracy")
    with torch.no_grad():
        for data, target in val_loader:
            data, target = data.to(device), target.to(device)
            output = model(data)
            val_loss.update(F.cross_entropy(output, target))
            val_accuracy.update(accuracy(output, target))
    if verbose:
        print(f"Epoch {epoch} validation: loss {val_loss.avg:.4f} "
              f"acc {val_accuracy.avg:.4f}")


def save_checkpoint(epoch):
    if hvd.rank() == 0:
        os.makedirs(os.path.dirname(args.checkpoint_format) or ".",
                    exist_ok=True)
        torch.save({"model": model.state_dict(),
                    "optimizer": optimizer.state_dict()},
                   args.checkpoint_format.format(epoch=epoch + 1))


for epoch in range(resume_from_epoch, args.epochs):
    train(epoch)
    validate(epoch)
    save_checkpoint(epoch)
