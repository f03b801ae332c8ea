"""Decoder-only Transformer LM in PyTorch.

Counterpart of ``horovod_tpu/models/transformer.py`` (``TransformerLM``,
``Block``, ``Attention``, ``rope``, ``_qkv_project``, ``next_token_loss``).
Under sequence parallelism (``seq_axis=`` a
:class:`~horovod_tpu_torch.parallel.RingMesh`, the counterpart of the
mapped mesh axis) the model takes the global ``(batch, seq)`` tokens,
splits them into one shard per member, runs every layer on every shard
(rope at the shard's absolute positions) and lets the shards meet only in
:func:`~horovod_tpu_torch.ops.ring_attention`, K/V travelling as
``ring_impl`` says; it returns the global logits.  The parameters are one
set shared by the members, so autograd sums the members' gradient
contributions: the ``psum`` over the sequence axis that the JAX step gets
from ``shard_map``.  The port has no ``targets=`` or ``decode_ctx=``
arguments, so the reference's refusals of them under sequence parallelism
have nothing to refuse.  Parameters keep the flax
shapes and layouts (``qkv_kernel`` (d, 3, h, e), ``o_kernel`` (h, e, d),
``lm_head_kernel`` (d, V)), so :mod:`.convert` carries weights across by
renaming and transposing the two MLP kernels.  Matched semantics: flax
``nn.gelu``'s tanh approximation, RMSNorm with epsilon 1e-6 reduced in
float32 without mean subtraction, the adjacent-pair rope with float32
angles, and a head matmul that accumulates in float32 before the cast to
``logits_dtype``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.layers import lecun_normal
from horovod_tpu_torch.ops import (blockwise_attention, flash_attention,
                                   ring_attention)


class _QKVProject(torch.autograd.Function):
    """Fused qkv projection returning the unstacked (q, k, v) triple, each
    (b, h, s, e), from ``einsum('bsd,djhe->jbhse')``.  The backward sums
    three per-slot products for dx and stacks only the three weight-sized
    grads for dw, so no activation-sized stack of cotangents is built."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        q, k, v = torch.einsum("bsd,djhe->jbhse", x, w).unbind(0)
        return q, k, v

    @staticmethod
    def backward(ctx, *cots):
        x, w = ctx.saved_tensors
        dx = sum(torch.einsum("bhse,dhe->bsd", c, w[:, j])
                 for j, c in enumerate(cots))
        dw = torch.stack([torch.einsum("bsd,bhse->dhe", x, c) for c in cots],
                         dim=1)  # (d, 3, h, e): params-sized, cheap to stack
        return dx, dw


def qkv_project(x, w):
    return _QKVProject.apply(x, w)


def rope(x, positions, base: float = 10000.0):
    """Rotary position embedding, adjacent-pair formulation: component
    pairs ``(x[2i], x[2i+1])`` rotate by the i-th frequency.  Angles in
    float32; the result is cast back to ``x``'s dtype.  ``x``:
    (..., seq, head_dim); ``positions``: (seq,) token positions."""
    d = x.shape[-1]
    half = d // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs
    shape = [1] * x.ndim
    shape[-2] = x.shape[-2]
    shape[-1] = half
    cos = torch.cos(angles).reshape(shape)[..., None]
    sin = torch.sin(angles).reshape(shape)[..., None]
    xp = x.reshape(x.shape[:-1] + (half, 2))
    a, b = xp[..., :1], xp[..., 1:]
    rotated = torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)
    return rotated.reshape(x.shape).to(x.dtype)


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm``: float32 statistics, epsilon 1e-6, no mean
    subtraction, float32 ``weight`` (flax ``scale``), output in
    ``dtype``."""

    def __init__(self, dim: int, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.dtype = dtype

    def forward(self, x):
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        return (x32 * (torch.rsqrt(var + 1e-6) * self.weight)).to(
            self.dtype)


class Attention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, dtype=torch.bfloat16,
                 use_flash: bool = True, generator=None, device=None,
                 seq_axis=None, ring_impl: str = "ppermute"):
        super().__init__()
        head_dim = d_model // n_heads
        self.n_heads, self.dtype, self.use_flash = n_heads, dtype, use_flash
        self.seq_axis, self.ring_impl = seq_axis, ring_impl
        self.qkv_kernel = nn.Parameter(lecun_normal(
            (d_model, 3, n_heads, head_dim), d_model, generator, device))
        self.o_kernel = nn.Parameter(lecun_normal(
            (n_heads, head_dim, d_model), d_model, generator, device))

    def forward(self, x):
        if self.seq_axis is not None:
            return self._ring_forward(x)
        s = x.shape[1]
        q, k, v = qkv_project(x.to(self.dtype),
                              self.qkv_kernel.to(self.dtype))
        positions = torch.arange(s, device=x.device)
        q, k = rope(q, positions), rope(k, positions)
        out = (flash_attention(q, k, v, causal=True) if self.use_flash
               else blockwise_attention(q, k, v, causal=True))
        return torch.einsum("bhse,hed->bsd", out,
                            self.o_kernel.to(self.dtype))

    def _ring_forward(self, xs):
        """``xs``: the members' (batch, seq_local, d) shards, in ring order."""
        w = self.qkv_kernel.to(self.dtype)
        qs, ks, vs = [], [], []
        for i, x in enumerate(xs):
            s = x.shape[1]
            q, k, v = qkv_project(x.to(self.dtype), w)
            positions = i * s + torch.arange(s, device=x.device)
            qs.append(rope(q, positions))
            ks.append(rope(k, positions))
            vs.append(v)
        outs = ring_attention(qs, ks, vs, self.seq_axis, causal=True,
                              rotate_impl=self.ring_impl)
        w_o = self.o_kernel.to(self.dtype)
        return [torch.einsum("bhse,hed->bsd", o, w_o) for o in outs]


class Block(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 dtype=torch.bfloat16, use_flash: bool = True,
                 generator=None, device=None, seq_axis=None,
                 ring_impl: str = "ppermute"):
        super().__init__()
        self.dtype = dtype
        self.attn_norm = RMSNorm(d_model, dtype, device=device)
        self.attn = Attention(d_model, n_heads, dtype, use_flash, generator,
                              device, seq_axis, ring_impl)
        self.mlp_norm = RMSNorm(d_model, dtype, device=device)
        self.up = nn.Linear(d_model, d_ff, bias=False, device=device)
        self.down = nn.Linear(d_ff, d_model, bias=False, device=device)
        with torch.no_grad():
            self.up.weight.copy_(lecun_normal(
                (d_model, d_ff), d_model, generator, device).T)
            self.down.weight.copy_(lecun_normal(
                (d_ff, d_model), d_ff, generator, device).T)

    def _mlp(self, x, w_up, w_down):
        h = F.linear(self.mlp_norm(x), w_up)
        h = F.gelu(h, approximate="tanh")  # flax nn.gelu default
        return x + F.linear(h, w_down)

    def forward(self, x):
        """``x``: (batch, seq, d), or the members' shards as a list."""
        w_up = self.up.weight.to(self.dtype)
        w_down = self.down.weight.to(self.dtype)
        if isinstance(x, list):
            attn = self.attn([self.attn_norm(xi) for xi in x])
            return [self._mlp(xi + a, w_up, w_down)
                    for xi, a in zip(x, attn)]
        return self._mlp(x + self.attn(self.attn_norm(x)), w_up, w_down)


class TransformerLM(nn.Module):
    """Causal LM over token ids ``(batch, seq)``, returning logits
    ``(batch, seq, vocab)`` in ``logits_dtype``.

    ``device=None`` means the CUDA device (which must exist); pass
    ``device="cpu"`` to build on the CPU.  Weights are drawn from
    ``generator`` (a ``torch.Generator``; default: a fresh one seeded
    with 0) with flax's initializer scales."""

    def __init__(self, vocab_size: int, d_model: int = 512,
                 n_layers: int = 6, n_heads: int = 8,
                 d_ff: Optional[int] = None, dtype=torch.bfloat16,
                 use_flash: bool = True, logits_dtype=torch.float32,
                 generator: Optional[torch.Generator] = None, device=None,
                 seq_axis=None, ring_impl: str = "ppermute"):
        super().__init__()
        from horovod_tpu_torch.common import resolve_device

        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if ring_impl not in ("ppermute", "rdma", "fused"):
            raise ValueError(f"unknown ring_impl {ring_impl!r}")
        d_ff = d_ff or 4 * d_model
        self.dtype, self.logits_dtype = dtype, logits_dtype
        self.seq_axis = seq_axis
        self.embed = nn.Embedding(vocab_size, d_model, device=device)
        with torch.no_grad():  # flax Embed: normal, variance 1 / d_model
            self.embed.weight.copy_(torch.randn(
                vocab_size, d_model, generator=generator).mul_(
                    d_model ** -0.5).to(device))
        self.layers = nn.ModuleList(
            Block(d_model, n_heads, d_ff, dtype, use_flash, generator,
                  device, seq_axis, ring_impl)
            for _ in range(n_layers))
        self.final_norm = RMSNorm(d_model, dtype, device=device)
        self.lm_head_kernel = nn.Parameter(lecun_normal(
            (d_model, vocab_size), d_model, generator, device))

    def _head(self, x, w):
        xw = self.final_norm(x).to(self.dtype)
        if self.dtype == self.logits_dtype or self.dtype == torch.float32:
            # A matmul in the compute dtype already accumulates in f32
            # and rounds once, to the storage dtype.
            return torch.matmul(xw, w).to(self.logits_dtype)
        # Wider logits than the compute dtype: multiply the rounded
        # operands in f32 (the reference's preferred_element_type=f32).
        return torch.matmul(xw.float(), w.float()).to(self.logits_dtype)

    def forward(self, tokens):
        emb = self.embed.weight.to(self.dtype)
        w = self.lm_head_kernel.to(self.dtype)
        if self.seq_axis is None:
            x = F.embedding(tokens, emb)
            for layer in self.layers:
                x = layer(x)
            return self._head(x, w)
        n = self.seq_axis.size
        if tokens.shape[1] % n:
            raise ValueError(f"sequence {tokens.shape[1]} does not split "
                             f"into {n} equal shards")
        xs = [F.embedding(t, emb) for t in tokens.chunk(n, dim=1)]
        for layer in self.layers:
            xs = layer(xs)
        return torch.cat([self._head(x, w) for x in xs], dim=1)


def next_token_loss(logits, targets, mask=None, axis_name=None):
    """Mean cross-entropy of ``logits`` against aligned ``targets``, with
    float32 internals whatever the logits' storage dtype.  With a
    ``mask``, padding is weighted out: sum(loss * mask) / max(count, 1).

    ``axis_name`` (a :class:`~horovod_tpu_torch.parallel.RingMesh`) gives
    the reference's semantics over the members' sequence shards: each
    shard's loss is normalised by the global mean count of valid tokens
    per shard (the ``psum`` of the counts over ``n``), and the shards'
    losses are averaged (the step's ``pmean``).  Unmasked, that is the
    mean over all tokens."""
    loss = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           targets.reshape(-1), reduction="none")
    loss = loss.reshape(targets.shape)
    if axis_name is None:
        if mask is None:
            return loss.mean()
        mask = mask.to(loss.dtype)
        return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    n = axis_name.size
    shards = loss.chunk(n, dim=1)
    if mask is None:
        return torch.stack([x.mean() for x in shards]).mean()
    mask = mask.to(loss.dtype)
    count = torch.clamp(mask.sum() / n, min=1.0)
    return torch.stack([(x * m).sum() / count for x, m in
                        zip(shards, mask.chunk(n, dim=1))]).mean()
