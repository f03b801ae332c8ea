"""Bulk prefill of long prompts.

Own copy of ``horovod_tpu/serving/prefill.py``.  Chunked prefill (the
default) walks a prompt through the decode step ``prefill_chunk`` tokens
at a time.  For prompts of at least ``ring_min_tokens`` the serving plane
instead runs one full forward of the whole prompt with the model's K/V
capture and writes the captured per-layer K/V straight into the pages.
The reference shards that forward over the sequence axis of its local
devices (ring attention); the port runs it on one card, where the
forward's attention is the flash forward kernel (K1).  With more than one
card visible the sequence-sharded forward would apply, which needs ring
members on separate cards: that raises :class:`PrefillMeshError`.

The prompt cannot ride the fixed-size batch plan, so it travels in a side
broadcast padded to a bucketed length: only a handful of extra negotiation
cache signatures ever exist, and steady-state decode stays on the single
``serve.plan`` signature.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from horovod_tpu_torch.torch import mpi_ops

# Prompt-buffer bucket: multiples of 256 keep the side broadcast's
# signatures few.
PROMPT_BUCKET = 256


class PrefillMeshError(NotImplementedError):
    """Bulk prefill over more than one card: the sequence-sharded forward
    needs ring members on separate cards (ROADMAP A.10)."""


def bucket_len(n: int) -> int:
    return max(PROMPT_BUCKET, math.ceil(n / PROMPT_BUCKET) * PROMPT_BUCKET)


def broadcast_prompt(feed: List[int], real_len: int) -> Tuple[np.ndarray,
                                                              int]:
    """Root-broadcast a bulk-prefill prompt in a bucketed buffer (rank 0
    passes the tokens; workers pass an empty feed and receive)."""
    buf = np.zeros(bucket_len(real_len), np.int32)
    if feed:
        buf[:real_len] = feed[:real_len]
    mpi_ops.broadcast_(torch.from_numpy(buf), 0,
                       name=f"serve.prompt.{len(buf)}")
    return buf, real_len


def scatter_bulk(pages: torch.Tensor, k_all, v_all, table, real_len: int,
                 trash: int) -> torch.Tensor:
    """Write a whole prompt's captured K/V into ``pages`` in place.

    ``k_all``/``v_all``: ``(L, 1, heads, padded_len, head_dim)``;
    positions past ``real_len`` (bucket padding) go to the trash block."""
    bt = pages.shape[3]
    padded = k_all.shape[3]
    pos = torch.arange(padded, device=pages.device)
    table = torch.as_tensor(np.asarray(table), device=pages.device)
    slots = torch.clamp(pos // bt, max=len(table) - 1)
    blocks = torch.where(pos < real_len, table[slots],
                         torch.full_like(slots, trash))
    new_kv = torch.stack([k_all[:, 0], v_all[:, 0]], dim=1)  # (L,2,h,P,hd)
    pages[:, :, blocks, pos % bt] = new_kv.transpose(2, 3).to(pages.dtype)
    return pages


class RingPrefill:
    """Whole-prompt prefill: ``n_sp``, the largest power of two not above
    the visible cards (one on the CPU), must be 1 here (see the module
    docstring)."""

    def __init__(self, model, n_devices=None):
        self.model = model
        device = model.embed.weight.device
        if n_devices is None:
            n_devices = (torch.cuda.device_count() if device.type == "cuda"
                         else 1)
        self.n_sp = 1 << (max(n_devices, 1).bit_length() - 1)
        if self.n_sp > 1:
            raise PrefillMeshError(
                f"bulk prefill would shard the prompt over {self.n_sp} "
                "cards, which needs ring members on separate cards "
                "(ROADMAP A.10); serve with one visible card or "
                "HVD_TPU_SERVE_RING_MIN_TOKENS=0 (chunked prefill)")

    @torch.no_grad()
    def __call__(self, buf: np.ndarray, real_len: int):
        """``(k_all, v_all, sampled)``: the captured K/V of the whole padded
        prompt and the greedy token after its last real position."""
        device = self.model.embed.weight.device
        tokens = torch.from_numpy(buf).to(device=device,
                                          dtype=torch.long)[None]
        logits, (k_all, v_all) = self.model(tokens, capture_kv=True)
        return k_all, v_all, int(logits[0, real_len - 1].argmax())
