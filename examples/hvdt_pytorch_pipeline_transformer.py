"""Pipeline-parallel LM training with horovod_tpu_torch: 1F1B over the
engine's point-to-point plane.

examples/jax_pipeline_transformer.py on the PyTorch/CUDA port, with the
same flags and defaults.  The world is a ``stages x data-parallel`` grid
(docs/pipeline.md): each stage holds a contiguous layer range of the
transformer, activations and their gradients cross stage boundaries as
``send``/``recv`` micro-batch buckets, and gradients are averaged inside
each stage's ``stage_group``.  After the first step the fixed-shape
bucket cycle replays through the engine's response cache.  ``--device
cuda`` (the default) pins ``cuda:local_rank()``, one card per local rank;
``--device cpu`` runs on the CPU.

Run 2 stages x 2 DP on one host:

    python -m horovod_tpu_torch.runner -np 4 -- \\
        python examples/hvdt_pytorch_pipeline_transformer.py \\
        --stages 2 --microbatches 4 --steps 20
"""

import argparse
import time

import numpy as np
import torch

import horovod_tpu_torch.common as hvd
from horovod_tpu_torch.models import TransformerLM, next_token_loss
from horovod_tpu_torch.parallel import (PipelineGrid, bubble_fraction,
                                        partition_params,
                                        partition_transformer)
from horovod_tpu_torch.torch.train import run_pipeline

parser = argparse.ArgumentParser(description="Pipeline-parallel LM example")
parser.add_argument("--stages", type=int, default=2,
                    help="pipeline stages (world must divide evenly)")
parser.add_argument("--chunks", type=int, default=1,
                    help="model chunks per rank (interleaved 1F1B)")
parser.add_argument("--microbatches", type=int, default=4)
parser.add_argument("--batch", type=int, default=8,
                    help="per-DP-rank batch (micro-batch = batch/microbatches)")
parser.add_argument("--seq-len", type=int, default=64)
parser.add_argument("--vocab", type=int, default=256)
parser.add_argument("--d-model", type=int, default=64)
parser.add_argument("--n-layers", type=int, default=4)
parser.add_argument("--n-heads", type=int, default=4)
parser.add_argument("--steps", type=int, default=20)
parser.add_argument("--lr", type=float, default=1e-3)
parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the card of local_rank(); cpu: the CPU")
args = parser.parse_args()


def main():
    hvd.init(device=None if args.device == "cuda" else "cpu")
    device = (torch.device("cuda", hvd.local_rank())
              if args.device == "cuda" else torch.device("cpu"))
    grid = PipelineGrid(args.stages, hvd.size(), hvd.rank())
    if hvd.rank() == 0:
        print(f"grid: {args.stages} stages x {grid.dp} DP "
              f"(x{args.chunks} chunks), micro-batches "
              f"{args.microbatches}, bubble "
              f"{bubble_fraction(args.stages, args.microbatches, args.chunks):.0%}")

    # The same weights on every rank (one seed): each keeps its stage's
    # slice, so no broadcast is needed.
    full = TransformerLM(
        vocab_size=args.vocab, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads, dtype=torch.float32,
        use_flash=False, generator=torch.Generator().manual_seed(0),
        device="cpu").state_dict()
    modules = partition_transformer(
        args.vocab, args.d_model, args.n_layers, args.n_heads,
        n_stages=args.stages, n_chunks=args.chunks, dtype=torch.float32,
        use_flash=False, device="meta")[grid.stage]
    parts = partition_params(full, args.n_layers, args.stages,
                             n_chunks=args.chunks)[grid.stage]
    for module, part in zip(modules, parts):
        module.to_empty(device=device).load_state_dict(part, strict=True)

    # Synthetic corpus with learnable structure (token t+1 = P[token t]),
    # DP-sharded by this rank's dp_index.
    rng = np.random.RandomState(1234 + grid.dp_index)
    mat = np.random.RandomState(0).permutation(args.vocab)
    tokens = np.zeros((args.batch, args.seq_len + 1), np.int32)
    tokens[:, 0] = rng.randint(0, args.vocab, args.batch)
    for t in range(args.seq_len):
        tokens[:, t + 1] = mat[tokens[:, t]]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]

    t0 = time.perf_counter()
    modules, _, losses = run_pipeline(
        modules, lambda ps: torch.optim.AdamW(ps, lr=args.lr,
                                              weight_decay=1e-4),
        [(inputs, targets)] * args.steps,
        n_stages=args.stages, n_microbatches=args.microbatches,
        loss_fn=next_token_loss)
    dt = time.perf_counter() - t0

    if losses[-1] is not None:  # last-stage ranks see the loss
        toks = args.batch * grid.dp * args.seq_len * args.steps / dt
        print(f"rank {hvd.rank()} (stage {grid.stage}): "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
              f"{toks:.0f} tokens/sec")
        snap = hvd.metrics_snapshot()["p2p"]
        print(f"p2p: {snap['sends']} sends / {snap['recvs']} recvs, "
              f"{snap['bytes']['out']} B out")
    hvd.shutdown()


if __name__ == "__main__":
    main()
