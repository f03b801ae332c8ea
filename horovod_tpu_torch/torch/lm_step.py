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
the single-process path with seed ``seed``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from horovod_tpu_torch import common as hvd
from horovod_tpu_torch.models import TransformerLM, next_token_loss
from horovod_tpu_torch.parallel import RingMesh
from horovod_tpu_torch.torch import (DistributedOptimizer,
                                     broadcast_optimizer_state,
                                     broadcast_parameters)
from horovod_tpu_torch.torch.train import build_train_step

HEADLINE = dict(vocab_size=32768, d_model=512, n_layers=8, n_heads=8,
                d_ff=2048, batch=16, seq=1024)
RING_HEADLINE = dict(HEADLINE, batch=4, seq=4096, members=4,
                     ring_impl="fused")


def build_lm_step(device=None, *, vocab_size, d_model, n_layers, n_heads,
                  d_ff, batch, seq, dtype=torch.bfloat16,
                  logits_dtype=torch.bfloat16, seed=0,
                  members: Optional[int] = None, ring_impl="fused"):
    """``(model, step, data)``: ``step(data)`` is one training step on the
    fixed batch ``data = (inputs, targets)`` of this rank, shape (batch,
    seq); ``hvd.init()`` comes first.  ``device=None`` means the CUDA
    device (see ``resolve_device``).  With ``members``, the model is
    sequence-parallel over a ring of that many members (``model.seq_axis``,
    a ``RingMesh``), K/V travelling as ``ring_impl`` says, and the step is
    the sequence-parallel one (one process only)."""
    rank, size = hvd.rank(), hvd.size()
    if members is not None and size > 1:
        raise ValueError("the ring path runs in one process")
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

    def loss_fn(m, b):
        return next_token_loss(m(b[0]), b[1], axis_name=mesh)

    step = build_train_step(loss_fn, opt, model)
    tokens = torch.from_numpy(np.random.RandomState(seed + rank).randint(
        0, vocab_size, (batch, seq + 1)))
    tokens = tokens.to(model.embed.weight.device)
    return model, step, (tokens[:, :-1], tokens[:, 1:])
