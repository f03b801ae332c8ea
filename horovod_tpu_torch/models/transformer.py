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
from ``shard_map``.  The cached-KV decode mode (``forward(tokens,
decode_ctx=...)``, :class:`DecodeContext`) and the K/V capture of the full
forward (``capture_kv=True``) serve the serving plane; both refuse sequence
parallelism, as the reference's decode mode does.  ``forward(tokens,
targets=...)`` returns the mean next-token loss through
:func:`fused_next_token_loss`, the head and the loss fused chunk by chunk
so no ``(tokens, vocab)`` logits outlive a chunk; it refuses sequence
parallelism, decode and K/V capture.  :func:`next_token_loss` normalises a
masked loss over the ring's members and the engine's ranks (``axis_name=
("dp", mesh)``), as the reference's over ``("dp", "sp")``.  Parameters keep the flax
shapes and layouts (``qkv_kernel`` (d, 3, h, e), ``o_kernel`` (h, e, d),
``lm_head_kernel`` (d, V)), so :mod:`.convert` carries weights across by
renaming and transposing the two MLP kernels.  Matched semantics: flax
``nn.gelu``'s tanh approximation, RMSNorm with epsilon 1e-6 reduced in
float32 without mean subtraction, the adjacent-pair rope with float32
angles, and a head matmul that accumulates in float32 before the cast to
``logits_dtype``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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
    (batch, heads, seq, head_dim); ``positions``: (seq,) token positions,
    or (batch, seq) when every batch row sits at its own offset (the
    serving plane's decode batch, where row b's tokens start at its cache
    length)."""
    d = x.shape[-1]
    half = d // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].to(torch.float32) * freqs
    shape = [1] * x.ndim
    if positions.dim() == 2:  # per-row offsets, broadcast over heads
        shape[0] = positions.shape[0]
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


class DecodeContext(NamedTuple):
    """Per-step context of the cached-KV decode mode.

    ``k``/``v``: ``(n_layers, batch, heads, ctx_len, head_dim)``, every
    layer's cached keys and values (post-rope, as the layers produced
    them).  ``mask``: ``(batch, ctx_len)`` bool, the valid context
    positions of each row.  ``positions``: ``(batch, new_len)`` integer
    positions of the new tokens (the row's cache length + arange)."""

    k: torch.Tensor
    v: torch.Tensor
    mask: torch.Tensor
    positions: torch.Tensor

    def layer(self, i: int):
        return self.k[i], self.v[i], self.mask, self.positions


def _decode_attention(q, k, v, mask, sm_scale):
    """Masked attention of the decode mode: ``q`` (b, h, s, hd) against
    ``k``/``v`` (b, h, S, hd) under ``mask`` (b, s, S), float32 inside
    whatever the storage dtype.  Every query row admits at least itself,
    so no softmax row is empty."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    logits = logits.masked_fill(~mask[:, None], -1e30)
    w = torch.softmax(logits, dim=-1)
    return torch.matmul(w, v.float()).to(q.dtype)


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

    def forward(self, x, decode_ctx=None, capture_kv: bool = False):
        """The attention block's output; with ``decode_ctx`` (one layer's
        ``DecodeContext.layer``) or ``capture_kv`` also this chunk's
        post-rope ``(k, v)``."""
        if self.seq_axis is not None:
            return self._ring_forward(x)
        b, s, _ = x.shape
        q, k, v = qkv_project(x.to(self.dtype),
                              self.qkv_kernel.to(self.dtype))
        if decode_ctx is not None:
            k_ctx, v_ctx, ctx_mask, positions = decode_ctx
            q, k = rope(q, positions), rope(k, positions)
            # The context precedes the chunk, whose positions are
            # consecutive: causality inside it is a lower triangle.
            mask = torch.cat([
                ctx_mask[:, None, :].expand(b, s, ctx_mask.shape[-1]),
                torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
                .expand(b, s, s)], dim=-1)
            keys = torch.cat([k_ctx.to(k.dtype), k], dim=-2)
            vals = torch.cat([v_ctx.to(v.dtype), v], dim=-2)
            out = _decode_attention(q, keys, vals, mask, q.shape[-1] ** -0.5)
        else:
            positions = torch.arange(s, device=x.device)
            q, k = rope(q, positions), rope(k, positions)
            out = (flash_attention(q, k, v, causal=True) if self.use_flash
                   else blockwise_attention(q, k, v, causal=True))
        proj = torch.einsum("bhse,hed->bsd", out,
                            self.o_kernel.to(self.dtype))
        if decode_ctx is None and not capture_kv:
            return proj
        return proj, (k, v)

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

    def forward(self, x, decode_ctx=None, capture_kv: bool = False):
        """``x``: (batch, seq, d), or the members' shards as a list.  With
        ``decode_ctx`` or ``capture_kv``: ``(x, (k, v))``."""
        w_up = self.up.weight.to(self.dtype)
        w_down = self.down.weight.to(self.dtype)
        if isinstance(x, list):
            attn = self.attn([self.attn_norm(xi) for xi in x])
            return [self._mlp(xi + a, w_up, w_down)
                    for xi, a in zip(x, attn)]
        if decode_ctx is None and not capture_kv:
            return self._mlp(x + self.attn(self.attn_norm(x)), w_up, w_down)
        a, kv = self.attn(self.attn_norm(x), decode_ctx, capture_kv)
        return self._mlp(x + a, w_up, w_down), kv


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

    def forward(self, tokens, targets=None,
                decode_ctx: Optional[DecodeContext] = None,
                capture_kv: bool = False):
        """Logits ``(batch, seq, vocab)``.  With ``targets`` (token ids
        aligned with ``tokens``): the mean next-token loss, through
        :func:`fused_next_token_loss`.  With ``decode_ctx`` (the
        cached-KV decode mode: ``tokens`` are each row's new chunk) or
        ``capture_kv`` (the full forward): ``(logits, (k, v))``, the
        chunk's post-rope keys and values stacked over layers,
        ``(n_layers, batch, heads, seq, head_dim)`` each."""
        if targets is not None and self.seq_axis is not None:
            raise ValueError(
                "targets= (fused head+loss) is unsupported under sequence "
                "parallelism: it has no axis_name-aware normalization; "
                "compute logits and use next_token_loss(..., axis_name=...) "
                "instead.")
        if targets is not None and (decode_ctx is not None or capture_kv):
            raise ValueError(
                "decode_ctx= (cached KV decode) and capture_kv= do not "
                "compose with targets=: decode is an inference-only path")
        emb = self.embed.weight.to(self.dtype)
        if targets is not None:
            x = F.embedding(tokens, emb)
            for layer in self.layers:
                x = layer(x)
            return fused_next_token_loss(self.final_norm(x),
                                         self.lm_head_kernel, targets,
                                         dtype=self.dtype)
        w = self.lm_head_kernel.to(self.dtype)
        if (decode_ctx is not None or capture_kv) and \
                self.seq_axis is not None:
            raise ValueError(
                "decode_ctx= (cached KV decode) and capture_kv= do not "
                "compose with sequence parallelism: decode is an "
                "inference-only, single-shard path")
        if decode_ctx is not None or capture_kv:
            x = F.embedding(tokens, emb)
            ks, vs = [], []
            for i, layer in enumerate(self.layers):
                x, (k, v) = layer(x, None if decode_ctx is None
                                  else decode_ctx.layer(i), capture_kv)
                ks.append(k)
                vs.append(v)
            return self._head(x, w), (torch.stack(ks), torch.stack(vs))
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


class _FusedHeadLoss(torch.autograd.Function):
    """The head and the mean cross-entropy, chunk by chunk over the
    flattened tokens: the reference's ``lax.scan`` of a
    ``jax.checkpoint``-ed chunk.  The forward keeps the loss, what the
    backward reads (``hidden``, ``w``, ``targets``) and each token's
    log-sum-exp; the backward recomputes one chunk's logits at a time.

    Each chunk's logits are float32 from operands rounded to ``dtype``
    (the reference's ``preferred_element_type=f32``); the cotangents take
    the reference's dtypes: a chunk's d-hidden and d-head are float32
    products rounded to ``dtype``, the d-head summed over the chunks in
    ``dtype`` (last chunk first, as the scan's transpose runs) and cast to
    ``w``'s dtype at the end."""

    @staticmethod
    def forward(ctx, hidden, w, targets, dtype, n_chunks):
        x, t = hidden.flatten(0, 1), targets.flatten()
        m = x.shape[0] // n_chunks
        wf = w.to(dtype).float()
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        lses = []
        for xc, tc in zip(x.split(m), t.split(m)):
            logits = xc.to(dtype).float() @ wf
            lse = torch.logsumexp(logits, dim=-1)
            total = total + (lse - logits.gather(1, tc[:, None])[:, 0]).sum()
            lses.append(lse)
            del logits  # before the next chunk's are made
        ctx.save_for_backward(hidden, w, targets, torch.cat(lses))
        ctx.dtype, ctx.m = dtype, m
        return total / x.shape[0]

    @staticmethod
    def backward(ctx, g):
        hidden, w, targets, lse = ctx.saved_tensors
        dtype, m = ctx.dtype, ctx.m
        x, t = hidden.flatten(0, 1), targets.flatten()
        wf = w.to(dtype).float()
        s = g.float() / x.shape[0]
        rows = torch.arange(m, device=x.device)
        dx = torch.empty_like(x)
        dw = torch.zeros(w.shape, dtype=dtype, device=w.device)
        chunks = list(zip(x.split(m), t.split(m), lse.split(m), dx.split(m)))
        for xc, tc, lc, dxc in reversed(chunks):
            xc = xc.to(dtype).float()
            # d(lse - correct) / d logits = (softmax - onehot) * s
            p = (xc @ wf).sub_(lc[:, None]).exp_().mul_(s)
            p[rows, tc] -= s
            dxc.copy_((p @ wf.T).to(dtype))
            dw += (xc.T @ p).to(dtype)
            del p
        return dx.view_as(hidden), dw.to(w.dtype), None, None, None


def fused_next_token_loss(hidden, w, targets, dtype=torch.bfloat16,
                          n_chunks: int = 8):
    """Mean cross-entropy over all ``batch * seq`` tokens of the head
    ``hidden @ w`` (``hidden`` (batch, seq, d), ``w`` (d, vocab)) against
    ``targets`` (batch, seq), computed head-chunk by head-chunk.

    The flattened tokens split into ``n_chunks`` chunks (one chunk when
    ``n_chunks`` does not divide their count, as the reference falls
    back); each chunk's logits are float32 from operands rounded to
    ``dtype`` and live only while that chunk is computed, in the forward
    and again in the backward, which recomputes them.  Peak memory is
    one chunk's ``(tokens / n_chunks, vocab)`` float32 logits in place of
    the whole logits tensor and its float32 upcasts, at the cost of one
    more head product.  The counterpart of
    ``horovod_tpu.models.fused_next_token_loss``; no ``(tokens, vocab)``
    tensor is saved for the backward."""
    tokens = hidden.shape[0] * hidden.shape[1]
    if tokens % n_chunks:
        n_chunks = 1
    return _FusedHeadLoss.apply(hidden, w, targets, dtype, n_chunks)


DP_AXIS = "dp"  # next_token_loss's name for the engine's ranks


def _loss_axes(axis_name):
    """``(ring mesh or None, whether the engine's ranks are an axis)`` of
    ``next_token_loss``'s ``axis_name``."""
    from horovod_tpu_torch.parallel import RingMesh

    if axis_name is None:
        return None, False
    axes = axis_name if isinstance(axis_name, tuple) else (axis_name,)
    mesh, dp = None, False
    for a in axes:
        if isinstance(a, RingMesh) and mesh is None:
            mesh = a
        elif isinstance(a, str) and a == DP_AXIS and not dp:
            dp = True
        else:
            raise ValueError(
                f"next_token_loss: unknown axis {a!r} in {axis_name!r}; "
                f"axes are a RingMesh (the sequence shards) and "
                f"{DP_AXIS!r} (the engine's ranks), each at most once")
    return mesh, dp


def _ranks_mean(count):
    """``count`` averaged over the engine's ranks (itself at size 1)."""
    from horovod_tpu_torch import common
    from horovod_tpu_torch.torch.mpi_ops import allreduce

    if common.size() == 1:
        return count
    return allreduce(count.detach(), average=True,
                     name="next_token_loss.count")


def next_token_loss(logits, targets, mask=None, axis_name=None):
    """Mean cross-entropy of ``logits`` against aligned ``targets``, with
    float32 internals whatever the logits' storage dtype.  With a
    ``mask``, padding is weighted out: sum(loss * mask) / max(count, 1).

    ``axis_name`` names the axes the reference's loss reduces its count
    over: a :class:`~horovod_tpu_torch.parallel.RingMesh` (the members'
    sequence shards, its ``"sp"``), the string ``"dp"`` (the engine's
    ranks, data-parallel), or a tuple of both, ``("dp", mesh)`` for the
    reference's ``("dp", "sp")``.  Under a mesh each shard's loss is
    normalised by the mean count of valid tokens per shard and the
    shards' losses are averaged (the step's ``pmean`` over ``sp``); with
    ``"dp"`` that count is averaged across ranks too (one allreduce named
    ``next_token_loss.count``, no gradient through it), so the step's
    average over ranks is the global weighted mean however the ranks'
    masks differ.  Unmasked, nothing crosses processes: the mean over
    this rank's tokens."""
    mesh, dp = _loss_axes(axis_name)
    loss = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           targets.reshape(-1), reduction="none")
    loss = loss.reshape(targets.shape)
    if mesh is None and mask is None:
        return loss.mean()
    n = 1 if mesh is None else mesh.size
    shards = loss.chunk(n, dim=1)
    if mask is None:
        return torch.stack([x.mean() for x in shards]).mean()
    mask = mask.to(loss.dtype)
    count = mask.sum() / n
    if dp:
        count = _ranks_mean(count)
    count = torch.clamp(count, min=1.0)
    return torch.stack([(x * m).sum() / count for x, m in
                        zip(shards, mask.chunk(n, dim=1))]).mean()
