"""Block-granular KV cache of the serving plane.

Own copy of ``horovod_tpu/serving/kv_cache.py``, in two halves:

* :class:`BlockPool`: host-side bookkeeping of a fixed population of
  fixed-size token blocks, allocated all-or-nothing per request growth and
  freed on retirement.  Pool exhaustion is a scheduling signal (requests
  stay queued, running requests are preempted), never a crash.

* The paged device store: one packed tensor for every layer's K and V,
  ``(n_layers, 2, num_blocks + 1, block_tokens, heads, head_dim)``,
  gathered per step by block table (:func:`gather_context`) and written
  by (block, offset) in place (:func:`scatter_new`, the counterpart of the
  JAX step's donated buffer).  The last block is the trash block: masked
  lanes of a scatter and table padding land there, so the decode step
  keeps one shape whichever slots are live.  Duplicate write indices occur
  only in the trash block, whose contents are never read as context.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch


class BlockPool:
    """Fixed pool of KV blocks, ``block_tokens`` tokens each.

    Allocation is all-or-nothing (a partial grant would leave a request
    unable to run but holding memory) and LIFO on the free list, so block
    ids stay deterministic across ranks replaying the same admission
    sequence — the scheduler's block tables travel in the broadcast batch
    plan, so determinism here is convenience (debuggability), not
    correctness.
    """

    def __init__(self, num_blocks: int, block_tokens: int):
        if num_blocks < 1 or block_tokens < 1:
            raise ValueError(
                f"need num_blocks >= 1 and block_tokens >= 1, got "
                f"{num_blocks}/{block_tokens}")
        self.num_blocks = num_blocks
        self.block_tokens = block_tokens
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._in_use = 0
        self.peak_in_use = 0

    @property
    def blocks_in_use(self) -> int:
        return self._in_use

    @property
    def blocks_free(self) -> int:
        return len(self._free)

    def blocks_for_tokens(self, tokens: int) -> int:
        """Blocks needed to hold `tokens` cache entries."""
        return max(0, math.ceil(tokens / self.block_tokens))

    def alloc(self, n: int) -> Optional[List[int]]:
        """`n` fresh block ids, or None when the pool cannot satisfy all
        of them (all-or-nothing; the caller queues or preempts)."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            return None
        taken = [self._free.pop() for _ in range(n)]
        self._in_use += n
        self.peak_in_use = max(self.peak_in_use, self._in_use)
        return taken

    def free(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            if not (0 <= b < self.num_blocks):
                raise ValueError(f"block id {b} out of range")
            self._free.append(b)
        self._in_use -= len(blocks)
        assert self._in_use >= 0, "double free"


def init_pages(n_layers: int, n_heads: int, head_dim: int, num_blocks: int,
               block_tokens: int, dtype, device=None) -> torch.Tensor:
    """The packed page buffer, zeros: ``(L, 2, num_blocks + 1, bt, h,
    hd)``; index 0 of axis 1 is K, index 1 is V; block ``num_blocks`` is
    the trash block."""
    return torch.zeros((n_layers, 2, num_blocks + 1, block_tokens, n_heads,
                        head_dim), dtype=dtype, device=device)


def gather_context(pages: torch.Tensor, tables: torch.Tensor):
    """Per-layer K/V context of a decode batch.

    ``tables``: ``(B, max_blocks)`` integer block ids, padded with the
    trash block.  Returns ``(k_ctx, v_ctx)``, each ``(L, B, heads,
    max_blocks * block_tokens, head_dim)``: position ``p`` of the
    flattened axis is token ``p`` of that row's cache (tables are in token
    order), so the caller's validity mask is ``p < length``."""
    n_layers, _, _, bt, h, hd = pages.shape
    batch, nb = tables.shape
    ctx = pages[:, :, tables]                       # (L, 2, B, nb, bt, h, hd)
    ctx = ctx.reshape(n_layers, 2, batch, nb * bt, h, hd).transpose(3, 4)
    return ctx[:, 0], ctx[:, 1]


def scatter_new(pages: torch.Tensor, k_new, v_new, tables, lengths,
                n_new) -> torch.Tensor:
    """Write a step's fresh K/V into ``pages`` in place; returns it.

    ``k_new``/``v_new``: ``(L, B, heads, chunk, head_dim)`` (the decode
    forward's output).  Row ``b``'s token ``j`` lands at cache position
    ``lengths[b] + j``; lanes with ``j >= n_new[b]`` (padding, idle slots)
    go to the trash block, so the write has one shape."""
    bt = pages.shape[3]
    trash = pages.shape[2] - 1
    chunk = k_new.shape[3]
    lanes = torch.arange(chunk, device=pages.device)
    pos = lengths[:, None] + lanes[None, :]                   # (B, chunk)
    # Clip before the lookup: an idle slot's position may lie past its
    # table; its write goes to the trash block below anyway.
    block_slot = torch.clamp(pos // bt, 0, tables.shape[1] - 1)
    block = torch.take_along_dim(tables, block_slot, dim=1)
    valid = lanes[None, :] < n_new[:, None]
    block = torch.where(valid, block, torch.full_like(block, trash))
    # (L, 2, B, chunk, h, hd): the shape of pages[:, :, block, pos % bt].
    new_kv = torch.stack([k_new, v_new], dim=1).transpose(3, 4)
    pages[:, :, block, pos % bt] = new_kv.to(pages.dtype)
    return pages
