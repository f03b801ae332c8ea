"""Long-context LM training with horovod_tpu_torch: data-parallel ranks,
each running a sequence-parallel ring (dp x sp).

examples/jax_transformer_lm.py on the PyTorch/CUDA port, with the same
flags and defaults.  Token batches split over the ranks (``--dp``, the
engine's ranks) and each rank's sequence over the ``--sp`` members of its
own ring (``RingMesh``), where ring attention rotates K/V shards between
the members.  The masked loss normalises over both axes
(``next_token_loss(..., axis_name=("dp", mesh))``) and
``DistributedOptimizer`` averages the members' summed gradients over the
ranks: the reference's ``("dp", "sp")`` mesh.  The members of a ring share
their rank's card.  ``--device cuda`` (the default) pins
``cuda:local_rank()``; ``--device cuda:N`` puts every rank on card N
(ranks may share it); ``--device cpu`` runs on the CPU.

Run 2 ranks x a ring of 4 on two cards:

    python -m horovod_tpu_torch.runner -np 2 -- \\
        python examples/hvdt_pytorch_transformer_lm.py --sp 4 \\
        --seq-len 4096 --ring-impl fused --steps 10
"""

import argparse
import time

import numpy as np
import torch

import horovod_tpu_torch.torch as hvd
from horovod_tpu_torch.models import TransformerLM, next_token_loss
from horovod_tpu_torch.parallel import RingMesh
from horovod_tpu_torch.torch.train import build_train_step

parser = argparse.ArgumentParser(description="Sequence-parallel LM example")
parser.add_argument("--dp", type=int, default=0,
                    help="data-parallel ranks (0 = the job's size)")
parser.add_argument("--sp", type=int, default=4,
                    help="sequence-parallel ring members per rank")
parser.add_argument("--batch", type=int, default=4, help="global batch")
parser.add_argument("--seq-len", type=int, default=2048)
parser.add_argument("--vocab", type=int, default=1024)
parser.add_argument("--d-model", type=int, default=256)
parser.add_argument("--n-layers", type=int, default=4)
parser.add_argument("--n-heads", type=int, default=8)
parser.add_argument("--ring-impl", default="ppermute",
                    choices=["ppermute", "rdma", "fused"],
                    help="K/V rotation: plain rotation, the K6 permute "
                         "kernel, or the fused ring-flash kernels (K4/K5/"
                         "K7, the copy inside the attention kernel)")
parser.add_argument("--steps", type=int, default=30)
parser.add_argument("--lr", type=float, default=3e-4)
parser.add_argument("--device", default="cuda",
                    help="cuda: the card of local_rank(); cuda:N: card N; "
                         "cpu: the CPU")
args = parser.parse_args()


def main():
    hvd.init(device=None if args.device == "cuda" else args.device)
    device = (torch.device("cuda", torch.cuda.current_device())
              if args.device.startswith("cuda") else torch.device("cpu"))
    sp, dp = args.sp, args.dp or hvd.size()
    if dp != hvd.size():
        raise SystemExit(f"--dp {dp} must equal the job's size "
                         f"{hvd.size()} (or be 0)")
    if args.batch % dp:
        raise SystemExit(f"--batch {args.batch} does not split over "
                         f"{dp} ranks")
    if hvd.rank() == 0:
        print(f"mesh: dp={dp} x sp={sp}, seq/device = {args.seq_len // sp}",
              flush=True)

    mesh = RingMesh(sp, device)
    model = TransformerLM(vocab_size=args.vocab, d_model=args.d_model,
                          n_layers=args.n_layers, n_heads=args.n_heads,
                          generator=torch.Generator().manual_seed(0),
                          device=device, seq_axis=mesh,
                          ring_impl=args.ring_impl)

    # A tiny synthetic corpus with learnable structure (token t+1 depends
    # on token t), the same on every rank; each takes its rows.
    rng = np.random.RandomState(0)
    mat = rng.permutation(args.vocab)
    tokens = np.zeros((args.batch, args.seq_len + 1), np.int64)
    tokens[:, 0] = rng.randint(0, args.vocab, args.batch)
    for t in range(args.seq_len):
        tokens[:, t + 1] = mat[tokens[:, t]]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    pad = (-inputs.shape[1]) % sp
    inputs = np.pad(inputs, ((0, 0), (0, pad)))
    targets = np.pad(targets, ((0, 0), (0, pad)))
    mask = np.pad(np.ones((args.batch, args.seq_len), np.float32),
                  ((0, 0), (0, pad)))
    rows = slice(hvd.rank() * args.batch // dp,
                 (hvd.rank() + 1) * args.batch // dp)
    batch = tuple(torch.from_numpy(x[rows]).to(device)
                  for x in (inputs, targets, mask))

    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=1e-4),
        named_parameters=model.named_parameters())
    # One seed gives every rank the same weights; the broadcast is the
    # recipe's guard.  The optimizer starts empty everywhere, so its state
    # needs none (broadcasting it would take a zero step first and start
    # AdamW's count at 1, not optax's 0).
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

    def loss_fn(m, b):
        inp, tgt, msk = b
        return next_token_loss(m(inp), tgt, msk, axis_name=("dp", mesh))

    step = build_train_step(loss_fn, opt, model)
    t0 = None
    for i in range(args.steps):
        loss = step(batch).item()
        if i == 0:
            t0 = time.perf_counter()  # exclude the first step's set-up
        if hvd.rank() == 0 and (i % 10 == 0 or i == args.steps - 1):
            print(f"step {i:4d}  loss {loss:.4f}", flush=True)
    if args.steps > 1 and hvd.rank() == 0:
        dt = time.perf_counter() - t0
        toks = args.batch * args.seq_len * (args.steps - 1) / dt
        print(f"{toks:.0f} tokens/sec on {dp * sp} devices")
    hvd.shutdown()


if __name__ == "__main__":
    main()
