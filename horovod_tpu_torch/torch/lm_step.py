"""The port's training paths in one place: the LM headline trained by
``DistributedOptimizer(AdamW)`` through ``build_train_step``, on one
shard or sequence-parallel over a ring of members on the card.

``chip_smoke.py`` drives and times both; ``tools/torch_step_profile.py``
traces the first.  They build them here, so what is profiled is what is
checked.  The widths are the repo's LM headline
(``bench.py::bench_transformer``): vocab 32768, d_model 512, 8 layers, 8
heads, d_ff 2048, bf16 compute and logits, AdamW(1e-3) with optax's
default weight decay 1e-4; the main path takes batch 16 x seq 1024
(``HEADLINE``), the ring path batch 4 x seq 4096 over 4 members
(``RING_HEADLINE``: the same 16,384 tokens a step, a 4x longer context).

Across processes the main path is data-parallel, Horovod's weak scaling
as in the reference's examples: every rank takes a batch of ``batch``
rows (``HEADLINE``'s 16 x 1024 per rank), its weights from
``torch.Generator().manual_seed(seed + rank)`` and its tokens from
``np.random.RandomState(seed + rank)``, and rank 0's parameters and
optimizer state are broadcast before the first step.  At size 1 that is
the single-process path with seed ``seed``.  The ring path runs the same
way across processes (dp x sp, the reference's ``("dp", "sp")`` mesh):
every rank holds its own ring of ``members`` on its card and takes
``batch`` rows of the job's batch; the loss normalises over ``("dp",
mesh)`` and ``DistributedOptimizer`` averages the members' summed
gradients over the ranks.  ``RING_HEADLINE`` is what one rank runs.

``SERVE_HEADLINE`` is the served configuration (``python -m
horovod_tpu_torch.serving``): the same widths in bf16 with float32 logits
(d_ff is the model's default 4 x d_model = 2048), 8 decode slots,
16-token prefill chunks and KV blocks, 512 blocks in the pool, a
1024-token context per request (64 blocks), and bulk prefill from 256
prompt tokens.  Its page buffer is 8 x 2 x 513 x 16 x 8 x 64 bf16 values,
134 MB.

``PIPE_HEADLINE`` is the pipeline path (``torch/train.py::run_pipeline``):
the same widths split over 2 stages of 4 layers, 4 micro-batches of a
16 x 1024 batch per data-parallel rank, float32 logits on the last stage;
:func:`build_pipeline_stages` gives a rank its stage from the weights
:func:`build_lm_step` draws at size 1 from the same seed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from horovod_tpu_torch import common as hvd
from horovod_tpu_torch.models import TransformerLM, next_token_loss
from horovod_tpu_torch.parallel import (PipelineGrid, RingMesh,
                                        partition_params,
                                        partition_transformer)
from horovod_tpu_torch.serving.engine import ModelSpec
from horovod_tpu_torch.serving.scheduler import ServeConfig
from horovod_tpu_torch.torch import (DistributedOptimizer,
                                     broadcast_optimizer_state,
                                     broadcast_parameters)
from horovod_tpu_torch.torch.train import build_train_step

HEADLINE = dict(vocab_size=32768, d_model=512, n_layers=8, n_heads=8,
                d_ff=2048, batch=16, seq=1024)
RING_HEADLINE = dict(HEADLINE, batch=4, seq=4096, members=4,
                     ring_impl="fused")
PIPE_HEADLINE = dict(HEADLINE, stages=2, microbatches=4)
SERVE_HEADLINE = dict(
    spec=ModelSpec(vocab=HEADLINE["vocab_size"], d_model=HEADLINE["d_model"],
                   n_layers=HEADLINE["n_layers"], n_heads=HEADLINE["n_heads"],
                   dtype="bfloat16"),
    cfg=ServeConfig(max_batch=8, prefill_chunk=16, block_tokens=16,
                    num_blocks=512, max_blocks_per_seq=64,
                    ring_min_tokens=256))


def build_lm_step(device=None, *, vocab_size, d_model, n_layers, n_heads,
                  d_ff, batch, seq, dtype=torch.bfloat16,
                  logits_dtype=torch.bfloat16, seed=0,
                  members: Optional[int] = None, ring_impl="fused",
                  fused_loss: bool = False):
    """``(model, step, data)``: ``step(data)`` is one training step on the
    fixed batch ``data = (inputs, targets)`` of this rank, shape (batch,
    seq); ``step`` also takes ``(inputs, targets, mask)``, a float or bool
    mask of the valid targets.  ``hvd.init()`` comes first.
    ``device=None`` means the CUDA device (see ``resolve_device``).  With
    ``members``, the model is sequence-parallel over a ring of that many
    members on this rank's device (``model.seq_axis``, a ``RingMesh``),
    K/V travelling as ``ring_impl`` says, and the step is the
    sequence-parallel one, at any number of processes (dp x sp).  The loss
    is ``next_token_loss`` over ``("dp", mesh)``; with ``fused_loss`` it is
    the model's fused head and loss (``model(inputs, targets=targets)``),
    which takes neither a ring nor a mask."""
    rank, size = hvd.rank(), hvd.size()
    if fused_loss and members is not None:
        raise ValueError("the fused loss does not run under sequence "
                         "parallelism")
    mesh = None if members is None else RingMesh(members, device)
    model = TransformerLM(vocab_size=vocab_size, d_model=d_model,
                          n_layers=n_layers, n_heads=n_heads, d_ff=d_ff,
                          dtype=dtype, logits_dtype=logits_dtype,
                          generator=torch.Generator().manual_seed(
                              seed + rank),
                          device=device, seq_axis=mesh, ring_impl=ring_impl)
    opt = DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4),
        named_parameters=model.named_parameters())
    if size > 1:
        broadcast_parameters(model.state_dict(), root_rank=0)
        broadcast_optimizer_state(opt, root_rank=0)

    axes = "dp" if mesh is None else ("dp", mesh)

    def loss_fn(m, b):
        if fused_loss:
            if len(b) > 2:
                raise ValueError("the fused loss takes no mask")
            return m(b[0], targets=b[1])
        return next_token_loss(m(b[0]), b[1], b[2] if len(b) > 2 else None,
                               axis_name=axes)

    step = build_train_step(loss_fn, opt, model)
    tokens = torch.from_numpy(np.random.RandomState(seed + rank).randint(
        0, vocab_size, (batch, seq + 1)))
    tokens = tokens.to(model.embed.weight.device)
    return model, step, (tokens[:, :-1], tokens[:, 1:])


def adamw(params):
    """The LM paths' optimizer, AdamW(1e-3) with optax's weight decay 1e-4,
    as the per-chunk factory ``run_pipeline`` takes."""
    return torch.optim.AdamW(params, lr=1e-3, weight_decay=1e-4)


def build_pipeline_stages(device=None, *, vocab_size, d_model, n_layers,
                          n_heads, d_ff, batch, seq, stages, microbatches,
                          dtype=torch.bfloat16, seed=0):
    """``(modules, grid, data)`` of this rank in a ``stages x dp``
    pipeline (``hvd.init()`` first): its chunk of the LM, whose weights
    are the ones :func:`build_lm_step` draws at size 1 from ``seed`` (the
    whole model is drawn on the CPU and this stage's slice loaded), the
    :class:`PipelineGrid`, and this DP rank's batch ``(inputs,
    targets)``, ``batch`` rows from ``np.random.RandomState(seed +
    dp_index)``: at one DP rank, the size-1 step's batch.  ``microbatches``
    is ``run_pipeline``'s ``n_microbatches``, checked here against the
    batch."""
    grid = PipelineGrid(stages, hvd.size(), hvd.rank())
    if batch % microbatches:
        raise ValueError(f"batch {batch} does not split into "
                         f"{microbatches} micro-batches")
    full = TransformerLM(vocab_size=vocab_size, d_model=d_model,
                         n_layers=n_layers, n_heads=n_heads, d_ff=d_ff,
                         dtype=dtype, generator=torch.Generator().manual_seed(
                             seed), device="cpu")
    part = partition_params(full.state_dict(), n_layers, stages)[grid.stage]
    del full
    modules = partition_transformer(
        vocab_size, d_model, n_layers, n_heads, stages, d_ff=d_ff,
        dtype=dtype, device="meta")[grid.stage]
    device = hvd.resolve_device(device)
    for m, p in zip(modules, part):
        m.to_empty(device=device).load_state_dict(p, strict=True)
    tokens = torch.from_numpy(np.random.RandomState(
        seed + grid.dp_index).randint(0, vocab_size, (batch, seq + 1)))
    tokens = tokens.to(device)
    return modules, grid, (tokens[:, :-1], tokens[:, 1:])
