"""Attention: hand-written CUDA flash kernels and their plain PyTorch versions.

Counterpart of ``horovod_tpu/ops/attention.py``.  Layout convention:
``(batch, heads, seq, head_dim)`` throughout.

* :func:`mha_reference` — dense O(seq^2) attention, for tests.
* :func:`blockwise_attention` — the online-softmax scan over key blocks
  with the flash backward (a ``torch.autograd.Function``).  It is the
  plain version of the three kernels below and the path CPU tensors take.
* :func:`flash_attention` — on a CUDA tensor, the kernels:

  - K1 ``flash_fwd`` (``csrc/flash_fwd.cu``), replacing ``_flash_kernel``;
  - the backward in the mode the reference's ``_bwd_plan`` picks
    (:func:`bwd_mode`): ``combined`` runs B2 ``flash_bwd``
    (``csrc/flash_bwd.cu`` on ``csrc/flash_b2_sm90.cuh``, B2's own body;
    K5 runs ``csrc/flash_bwd_sm90.cuh``'s, with the same math, on the
    ring), replacing ``_combined_bwd_kernel`` — one recompute of P per
    tile pair for dK, dV and dQ; ``split`` (long sequences, more than 1024
    heads at short ones) runs K2 ``flash_bwd_dkdv`` (K5's body with its dQ
    product compiled out) and K3 ``flash_bwd_dq``
    (``csrc/flash_dq_sm90.cuh``, a query-stationary body), both in
    ``csrc/flash_bwd_split.cu``, replacing
    ``_flash_bwd_dkdv_kernel``/``_flash_bwd_dq_kernel``.

  A head dim no body takes runs zero-padded to the next body's
  (:func:`padded_head_dim`: 32, 64, 96, 128, and 256 for K1, K2, K3);
  above 256 K1, K2 and K3 run their wide bodies (``csrc/flash_wide.cu``,
  O's and the gradients' columns split across blocks) on the head dim
  zero-padded to a multiple of 32: in fp16 and bf16 on wgmma and TMA
  (``csrc/flash_wide_sm90.cuh``), in f32 on 3xTF32 wgmma and TMA
  (``csrc/flash_wide_f32_sm90.cuh``; K3's column blocks of a query
  tile one thread block cluster up to head dim 1024, sharing S and dP).
  In f32 at every head dim up to 256 K1, K2 and K3 run 3xTF32 bodies of that
  header too (their window the whole head dim up to 128, two column
  blocks at 256), and so does B2 up to 128 (K2's body with dQ = dS K
  added, its window the whole head dim up to 64, two column blocks of
  64 columns at 96 and 128).  Any other CUDA input the kernels cannot
  take raises; nothing falls back.

The plain versions multiply in float32 on operands rounded to the storage
dtype — the reference's ``preferred_element_type=float32`` — so f32 matmul
precision matters: with TF32 enabled the card would keep ~3 digits.  The
package turns TF32 off for matmuls and convolutions when it is imported
(``horovod_tpu_torch/__init__.py``), so the plain versions never see it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

NEG_INF = -1e30  # big-negative instead of -inf: exp() stays NaN-free when a
# whole row is masked
POS_BIG = 1e30   # logsumexp sentinel for rows with no mass: exp(s - POS_BIG)
# underflows to exactly 0 for any finite s

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# Head dims of every kernel body (K1-K5, B2).
HEAD_DIMS = (32, 64, 96, 128)
# The one wider body, of K1, K2 and K3 alone: the reference sends every
# head dim above 128 to the split backward (``_bwd_plan``, "d to 256"),
# and its fused ring to the separable ring, so B2, K4 and K5 never see it.
WIDE_HEAD_DIM = 256
# Head dims of the bodies of K1, K2 and K3.
_SPLIT_HEAD_DIMS = HEAD_DIMS + (WIDE_HEAD_DIM,)
# Above 256, K1, K2 and K3 run their wide bodies (csrc/flash_wide.cu) on
# any head dim that is a multiple of their head-dim chunk (the panel,
# PANEL, of the 16-bit bodies in csrc/flash_wide_sm90.cuh, F32_PANEL of
# the f32 ones in csrc/flash_wide_f32_sm90.cuh).  Key tiles by dtype
# class: the forward's is the 16-bit K1 body's FWD_KEYS and the f32 one's
# F32_FWD_KEYS; the split mode's is K3's, the one its dq sums over (the
# 16-bit body's DQ_KEYS and the f32 one's F32_DQ_KEYS; K2's keys per CTA
# do not change any sum).
WIDE_CHUNK = 32
_WIDE_KEY_TILE = {"fwd": {"16-bit": 128, "f32": 64},
                  "split": {"16-bit": 64, "f32": 32}}
# The wide tensor-core bodies' windows, in panels of WIDE_CHUNK output
# columns per column CTA (16 bits: FWD_NP, DKDV_NP, DQ_NP; f32:
# F32_FWD_NP, F32_DKDV_NP, F32_DQ_NP), and the panels per chunk that the
# 16-bit ones stream S (and dP) in (CHUNK_PANELS; the f32 ones one panel):
# every column CTA of a tile recomputes the score products over the whole
# head dim for its window (:func:`wide_tensor_core_flops`), but the f32
# K3's, which up to WIDE_F32_DQ_CLUSTER (F32_DQ_CLUSTER_MAX) column CTAs
# form one thread block cluster and each sums them over its own panels.
WIDE_CHUNK_PANELS = 2
_WIDE_WINDOW_PANELS = {"flash_fwd": 4, "flash_bwd_dkdv": 3,
                       "flash_bwd_dq": 4}
_WIDE_F32_WINDOW_PANELS = {"flash_fwd": 4, "flash_bwd_dkdv": 4,
                           "flash_bwd_dq": 4}
WIDE_F32_DQ_CLUSTER = 8
# Key tile of each forward body per head dim, as in the CUDA sources: the
# 16-bit wgmma body (csrc/flash_fwd_sm90.cuh, key_tile) and in f32 K1's
# 3xTF32 body (csrc/flash_wide_f32_sm90.cuh, F32_FWD_KEYS), which K4 runs
# too up to 128, the head dims K4 takes.  The online softmax advances its
# running max one key tile at a time and p is rounded against it, so the
# plain side that holds a kernel scans keys in the same blocks.
_FWD_KEY_TILE = {d: {"16-bit": 128 if d <= 64 else 64, "f32": 64}
                 for d in _SPLIT_HEAD_DIMS}


# Key tile of each backward body per head dim and mode: B2's and K5's
# 16-bit bodies (csrc/flash_b2_sm90.cuh, csrc/flash_bwd_sm90.cuh: both
# sm90::BWD_BN), K3's (csrc/flash_dq_sm90.cuh,
# dq_key_tile: 64, and DQ256_KEYS, 32, at head dim 256), and in f32 the
# one B2 and K5 share, 64 (their 3xTF32 body
# sums each query step's dQ over its CTA's F32_DKDV_KEYS), and K3's 3xTF32
# body's 32 (csrc/flash_wide_f32_sm90.cuh, F32_DQ_KEYS; K2's 64 keys a CTA
# change no sum).  The combined mode has no body at the wide head dim.
_BWD_KEY_TILE = {d: {"combined": {"16-bit": 128, "f32": 64},
                     "split": {"16-bit": 64, "f32": 32}}
                 for d in HEAD_DIMS}
_BWD_KEY_TILE[WIDE_HEAD_DIM] = {"split": {"16-bit": 32, "f32": 32}}


def padded_head_dim(d: int) -> int:
    """The head dim of the kernel body that computes attention at head dim
    ``d``: ``d`` itself if a body takes it, else the next one up (16 -> 32,
    80 -> 96, 200 -> 256; above 256, the next multiple of ``WIDE_CHUNK``,
    300 -> 320, for the wide bodies).  Zero columns add nothing to q k^T,
    so the callers zero-pad q, k, v and dO to it and slice the padded
    columns of the outputs off.  Below 1 raises."""
    if d > WIDE_HEAD_DIM:
        return -(-d // WIDE_CHUNK) * WIDE_CHUNK
    for body in _SPLIT_HEAD_DIMS:
        if 1 <= d <= body:
            return body
    raise ValueError(f"head_dim {d} unsupported: the kernels take 1 and "
                     "above")


def wide_tensor_core_flops(name: str, d: int, dtype=torch.bfloat16) -> int:
    """Tensor-core FLOP per computed (query, key) pair of the wide body of
    kernel ``name`` (``flash_fwd``, ``flash_bwd_dkdv``, ``flash_bwd_dq``)
    that takes ``dtype`` at head dim ``d``, padded as the callers pad it:
    each of its ceil(d / (32 NP)) column CTAs runs the score products over
    the whole head dim (S: 2 d FLOP; K2 and K3 dP too: 4 d) and the
    output products over its window of W = 32 NP columns (K1's P V: 2 W;
    K2's dV and dK: 4 W; K3's dQ: 2 W).  Against the caller's 4 d (K1), 8 d
    (K2) and 6 d (K3) it is the recompute the column split costs.  In
    float32 every product is three TF32 products (3xTF32), K1's P V four
    (V's rest too: o = v exactly where p is one key's 1), and K3's column
    CTAs, one thread block cluster up to ``WIDE_F32_DQ_CLUSTER`` of them,
    share the score products (each over its own panels: 3 x 4 d in all;
    the exchange of partials is not counted)."""
    body = padded_head_dim(d)
    if body <= WIDE_HEAD_DIM:
        raise ValueError(f"head_dim {d}: no wide body at or below "
                         f"{WIDE_HEAD_DIM}")
    f32 = dtype == torch.float32
    windows = _WIDE_F32_WINDOW_PANELS if f32 else _WIDE_WINDOW_PANELS
    if name not in windows:
        raise ValueError(f"{name}: no tensor-core wide body in {dtype}")
    panels = windows[name]
    score, out = {"flash_fwd": (2, 2), "flash_bwd_dkdv": (4, 4),
                  "flash_bwd_dq": (4, 2)}[name]
    column_ctas = -(-(body // WIDE_CHUNK) // panels)
    if not f32:
        return column_ctas * (score * body + out * panels * WIDE_CHUNK)
    pv = 4 if name == "flash_fwd" else 3
    output = column_ctas * pv * out * panels * WIDE_CHUNK
    if name == "flash_bwd_dq" and column_ctas <= WIDE_F32_DQ_CLUSTER:
        return 3 * score * body + output
    return column_ctas * 3 * score * body + output


def _key_tiles(d: int) -> dict:
    """``{"fwd": ..., "combined": ..., "split": ...}`` key tiles by dtype
    class of the bodies that run head dim ``d`` (padded); the wide bodies
    have no combined mode."""
    body = padded_head_dim(d)
    if body > WIDE_HEAD_DIM:
        return dict(_WIDE_KEY_TILE)
    return {"fwd": _FWD_KEY_TILE[body], **_BWD_KEY_TILE[body]}


def fwd_key_tile(dtype, d: int) -> int:
    """Key tile of the forward body (K1 and K4) that takes ``dtype`` at
    head dim ``d``, padded as the callers pad it (:func:`padded_head_dim`)."""
    return _key_tiles(d)["fwd"]["f32" if dtype == torch.float32
                                 else "16-bit"]


def bwd_key_tile(mode: str, dtype, d: int) -> int:
    """Key tile of the backward body that ``mode`` (:func:`bwd_mode`) runs
    on ``dtype`` at head dim ``d``, padded as the callers pad it
    (:func:`padded_head_dim`), as in the CUDA sources (``_BWD_KEY_TILE``):
    in 16 bits, 128 for the combined bodies of B2 and K5
    (csrc/flash_b2_sm90.cuh, csrc/flash_bwd_sm90.cuh: sm90::BWD_BN) and,
    for the split pair, K3's key tile, the one its dq sums over
    (csrc/flash_dq_sm90.cuh,
    ``dq_key_tile``: 64, and 32 at head dim 256); in f32 64 for the
    combined mode (the 64 keys a CTA of B2's and K5's 3xTF32 body,
    csrc/flash_wide_f32_sm90.cuh, F32_DKDV_KEYS) and 32 for the split
    pair (K3's 3xTF32 bodies,
    F32_DQ_KEYS, at every head dim); 64 above 256 in 16 bits, K3's wide
    body's (csrc/flash_wide_sm90.cuh, DQ_KEYS).  A plain side that holds
    a kernel walks the keys in the kernel's key tiles, so dq sums in the
    same blocks.  The combined mode stops at head dim 128, as :func:`bwd_mode`
    does."""
    if mode not in ("combined", "split"):
        raise ValueError(f"unknown backward mode {mode!r}")
    tiles = _key_tiles(d)
    if mode not in tiles:
        raise ValueError(f"head_dim {d}: no combined backward body above "
                         f"{HEAD_DIMS[-1]}")
    return tiles[mode]["f32" if dtype == torch.float32 else "16-bit"]


def bwd_mode(q_len: int, d: int, bh: int) -> str:
    """``"combined"`` or ``"split"``: the flash backward's mode, as the
    reference's ``_bwd_plan`` (``horovod_tpu/ops/attention.py``) decides
    it for ``q_len`` query rows at head dim ``d`` over ``bh`` batch-heads.

    The port's own copy of the decision alone: the calibrated bands of
    ``rows128 = q_len * max(d, 128) // 128`` with their ``bh`` gates, head
    dims up to 128, split for everything else.  It leaves out the TPU
    block sizes, ``_clamp_blocks`` and the scoped-VMEM budget
    (``_vmem_budget_bytes``, ``HVD_TPU_VMEM_LIMIT_MB``): at the default
    16 MiB budget the clamp never demotes a band's plan to split (the
    combined estimate at 128-blocks and seq 8192 is about 13.4 MB), so the
    bands alone give the same mode.  The mode is decided by ``q_len`` also
    where the reference leaves Pallas for its scan (ragged lengths,
    ``q_len != k_len``): the port's kernels mask any length."""
    rows128 = q_len * max(d, 128) // 128
    if d <= 128 and ((rows128 <= 2048 and bh <= 1024)
                     or (rows128 <= 4096 and bh <= 512)
                     or (rows128 <= 8192 and bh <= 32)):
        return "combined"
    return "split"


# Kernel launches per wrapper, counted only where the kernel is launched.
launches = {"flash_fwd": 0, "flash_bwd": 0, "flash_bwd_dkdv": 0,
            "flash_bwd_dq": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _mm(a, b):
    """f32 product of operands already rounded to their storage dtype."""
    return torch.matmul(a.float(), b.float())


def mha_reference(q, k, v, causal: bool = False,
                  sm_scale: Optional[float] = None):
    """O(seq^2)-memory reference attention (for tests and tiny shapes)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    s = _mm(q, k.transpose(-1, -2)) * sm_scale
    if causal:
        q_pos = torch.arange(q.shape[-2], device=q.device)[:, None]
        k_pos = torch.arange(k.shape[-2], device=q.device)[None, :]
        s = torch.where(q_pos >= k_pos, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _mm(p.to(v.dtype), v).to(v.dtype)


# ---------------------------------------------------------------------------
# Blockwise attention: the online-softmax scan, the kernels' plain version.
# ---------------------------------------------------------------------------


def _finalize(m, l, acc, dtype):
    # Rows with no mass have l == 0; emit zeros, not NaN.
    safe_l = torch.where(l == 0.0, 1.0, l)
    return (acc / safe_l[..., None]).to(dtype)


def _lse_of(m, l):
    """Per-row logsumexp; POS_BIG for rows with no mass (l == 0) so the
    backward's exp(s - lse) is exactly 0 there."""
    return torch.where(l == 0.0, POS_BIG,
                       m + torch.log(torch.clamp(l, min=1e-37)))


def _block_mask(start, n, q_len, causal, device, q_offset=0, k_offset=0):
    """Causal mask of one key block over absolute positions: queries start
    at ``q_offset``, the block's keys at ``k_offset + start``."""
    if not causal:
        return None
    q_pos = q_offset + torch.arange(q_len, device=device)
    k_pos = k_offset + start + torch.arange(n, device=device)
    return q_pos[:, None] >= k_pos[None, :]


def _block_attend(q, k, v, m, l, acc, mask, sm_scale):
    """One online-softmax update of the float32 (m, l, acc) state with a
    (q_len, k_len) block; ``mask`` is True where attention is allowed (or
    None for dense).  Shared by the blockwise scan and the separable
    ring's per-step attend."""
    s = _mm(q, k.transpose(-1, -2)) * sm_scale
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + _mm(p.to(v.dtype), v)
    return m_new, l_new, acc_new


def _init_state(q, d_v):
    m = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32,
                   device=q.device)
    return (m, torch.zeros_like(m),
            torch.zeros(q.shape[:-1] + (d_v,), dtype=torch.float32,
                        device=q.device))


def _blockwise_fwd_impl(q, k, v, causal, sm_scale, block_size=512,
                        q_offset=0, k_offset=0):
    """Forward scan; returns (out, lse) with lse the per-row logsumexp
    (float32; POS_BIG on rows with no mass, whose out is 0).
    ``q_offset``/``k_offset`` are the absolute positions of the first
    query and key row, for the causal mask across ring shards."""
    q_len, k_len = q.shape[-2], k.shape[-2]
    block = min(block_size, k_len)
    m, l, acc = _init_state(q, v.shape[-1])
    for start in range(0, k_len, block):
        kb = k[..., start:start + block, :]
        vb = v[..., start:start + block, :]
        mask = _block_mask(start, kb.shape[-2], q_len, causal, q.device,
                           q_offset, k_offset)
        m, l, acc = _block_attend(q, kb, vb, m, l, acc, mask, sm_scale)
    return _finalize(m, l, acc, q.dtype), _lse_of(m, l)


def _attention_bwd_impl(q, k, v, lse, delta, g, causal, sm_scale,
                        block_size=512, dq_scale=1.0, round_pds=False,
                        q_offset=0, k_offset=0, grad_dtype=None,
                        dq_noise=False):
    """Flash-attention backward: recompute each key block's probabilities
    from (q, k, lse); ``delta`` = rowsum(g * out) in float32.  Returns
    (dq * dq_scale, dk, dv) in the input dtypes (or all three in
    ``grad_dtype``), the scale applied in float32 before the cast.
    ``q_offset``/``k_offset`` place the causal mask as in the forward.

    ``round_pds`` rounds p and ds to the storage dtype before the products
    that take them, where the kernels (and the reference's Pallas
    ``_bwd_block_math``) round them; by default they stay float32, as in
    the reference's blockwise backward.  It changes nothing in float32.

    ``dq_noise`` (the kernel check's, ``ops/kernel_check.py``; no caller
    of the backward sets it) appends a fourth tensor: per dq element the
    rounding noise that dP = g v^T's float32 sum over the head dim passes
    on to dq, sqrt(d) eps32 |sm_scale dq_scale| sqrt(sum_j (p_ij a_ij)^2
    k_jc^2) with a = |g| |v|^T, from this side's own p, two products a
    key block."""
    q_len, k_len = q.shape[-2], k.shape[-2]
    block = min(block_size, k_len)
    g32 = g.float()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    noise2 = torch.zeros_like(dq) if dq_noise else None
    dks, dvs = [], []
    for start in range(0, k_len, block):
        kb = k[..., start:start + block, :]
        vb = v[..., start:start + block, :]
        mask = _block_mask(start, kb.shape[-2], q_len, causal, q.device,
                           q_offset, k_offset)
        s = _mm(q, kb.transpose(-1, -2)) * sm_scale
        if mask is not None:
            s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - lse[..., None])
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        pm = p.to(v.dtype) if round_pds else p
        dvs.append(_mm(pm.transpose(-1, -2), g32))
        dp = _mm(g32, vb.transpose(-1, -2))
        ds = p * (dp - delta[..., None]) * sm_scale
        if round_pds:
            ds = ds.to(q.dtype)
        dq = dq + _mm(ds, kb)
        dks.append(_mm(ds.transpose(-1, -2), q))
        if dq_noise:
            a = torch.matmul(g32.abs(), vb.float().abs().transpose(-1, -2))
            noise2 = noise2 + torch.matmul((p * a).square(),
                                           kb.float().square())
    dk = torch.cat(dks, dim=-2)
    dv = torch.cat(dvs, dim=-2)
    dts = (q.dtype, k.dtype, v.dtype) if grad_dtype is None else \
        (grad_dtype,) * 3
    out = ((dq * dq_scale).to(dts[0]), dk.to(dts[1]), dv.to(dts[2]))
    if not dq_noise:
        return out
    unit = (math.sqrt(q.shape[-1]) * torch.finfo(torch.float32).eps
            * abs(sm_scale * dq_scale))
    return out + (noise2.sqrt() * unit,)


def _delta(out, g):
    """delta_i = sum_d g_id * out_id in float32 (the softmax-Jacobian
    diagonal term), computed outside the kernels as the reference does."""
    return (g.float() * out.float()).sum(dim=-1)


class _BlockwiseFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, block_size, q_offset,
                k_offset):
        out, lse = _blockwise_fwd_impl(q, k, v, causal, sm_scale,
                                       block_size, q_offset, k_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, sm_scale, block_size, q_offset, k_offset)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        causal, sm_scale, block_size, q_offset, k_offset = ctx.args
        dq, dk, dv = _attention_bwd_impl(
            q, k, v, lse, _delta(out, g), g, causal, sm_scale, block_size,
            q_offset=q_offset, k_offset=k_offset)
        return dq, dk, dv, None, None, None, None, None


def blockwise_attention(q, k, v, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        block_size: int = 512,
                        q_offset: int = 0, k_offset: int = 0):
    """Memory-efficient attention as a scan over key/value blocks, with
    O(seq) residual memory in both directions (flash backward).
    ``q_offset``/``k_offset`` are the absolute positions of the first
    query and key row: the causal mask compares absolute positions, which
    is what lets a ring step mask a rotated K/V shard."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _BlockwiseFn.apply(q, k, v, causal, float(sm_scale),
                              int(block_size), int(q_offset), int(k_offset))


def _split_scale(sm_scale: float):
    """Split ``sm_scale`` into an exact power-of-two factor (applied to q
    in the storage dtype — exact even in bf16) and a float32 residual in
    [1, 2) applied to the logits inside the kernel.  For head dims that
    are powers of 4 (64, 256, ...) the residual is exactly 1.0."""
    m, e = math.frexp(sm_scale)  # sm_scale = m * 2**e, m in [0.5, 1)
    return 2.0 ** (e - 1), m * 2.0


# ---------------------------------------------------------------------------
# The CUDA kernels' wrappers.  Each takes (bh, s, d) tensors; a CPU tensor
# runs the plain version, a CUDA tensor launches the kernel or raises.
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    "hvdt_flash_fwd": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "hvdt_flash_bwd": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                       _I, _I, _F, _F, _I, _P],
    "hvdt_flash_bwd_dkdv": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                            _I, _F, _I, _P],
    "hvdt_flash_bwd_dq": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _F, _F, _I, _P],
}
for _name in ("hvdt_flash_fwd", "hvdt_flash_bwd_dkdv", "hvdt_flash_bwd_dq"):
    _ARGTYPES[_name + "_wide"] = _ARGTYPES[_name]


def _kernel_fn(stem: str, symbol: str):
    from horovod_tpu_torch.ops import _build

    fn = getattr(_build.load(stem), symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(name, tensors, stats=(), head_dims=HEAD_DIMS, wide=False):
    """Refuse what the kernels do not take: raise, never fall back.
    ``head_dims``: the head dims the kernel has a body for; ``wide``: it
    also has a wide body (every multiple of ``WIDE_CHUNK`` above 256)."""
    q = tensors[0]
    if q.dim() != 3:
        raise ValueError(f"{name}: expected (bh, seq, head_dim) tensors, got "
                         f"shape {tuple(q.shape)}")
    bh, _, d = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {q.dtype} unsupported "
                        "(float32, float16, bfloat16)")
    if d not in head_dims and not (wide and d > WIDE_HEAD_DIM
                                   and d % WIDE_CHUNK == 0):
        raise ValueError(f"{name}: head_dim {d} unsupported {head_dims}"
                         + (f" or multiples of {WIDE_CHUNK} above "
                            f"{WIDE_HEAD_DIM}" if wide else ""))
    for t in tensors:
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: all operands must share q's device "
                             f"and dtype ({q.device}, {q.dtype})")
        if t.dim() != 3 or t.shape[0] != bh or t.shape[2] != d:
            raise ValueError(f"{name}: operand shape {tuple(t.shape)} does "
                             f"not match q {tuple(q.shape)}")
    for t in stats:
        if (t.device != q.device or t.dtype != torch.float32
                or t.shape != q.shape[:2]):
            raise ValueError(f"{name}: lse/delta must be float32 "
                             f"{tuple(q.shape[:2])} on {q.device}")
    for t in tuple(tensors) + tuple(stats):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and "
                             "16-byte aligned")


def _split_body(stem: str, symbol: str, d: int):
    """K1's, K2's or K3's C function for head dim ``d``: the wide body's
    (csrc/flash_wide.cu) above 256."""
    if d > WIDE_HEAD_DIM:
        return _kernel_fn("flash_wide", symbol + "_wide")
    return _kernel_fn(stem, symbol)


def _launch(fn, *args):
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__}: kernel launch failed "
                           f"(cudaError {rc})")


def flash_fwd(qr, k, v, scale_r: float, causal: bool):
    """K1: ``(o, lse)`` of attention over pre-scaled ``qr`` (q times the
    pow2 part of sm_scale) with f32 logit residual ``scale_r``.  o is in
    the input dtype, lse float32 ``(bh, sq)``."""
    if qr.device.type == "cpu":
        return _blockwise_fwd_impl(qr, k, v, causal, scale_r)
    _check_cuda("flash_fwd", (qr, k, v), head_dims=_SPLIT_HEAD_DIMS,
                wide=True)
    if k.shape != v.shape:
        raise ValueError("flash_fwd: k and v shapes differ")
    bh, sq, d = qr.shape
    o = torch.empty_like(qr)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=qr.device)
    with torch.cuda.device(qr.device):
        _launch(_split_body("flash_fwd", "hvdt_flash_fwd", d),
                _DTYPE_CODE[qr.dtype], d, qr.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, sq,
                k.shape[1], float(scale_r), int(causal))
    launches["flash_fwd"] += 1
    return o, lse


def flash_bwd(qr, k, v, do, lse, delta, scale_r: float, p2: float,
              causal: bool):
    """B2: ``(dk, dv, dq)`` in the input dtype from one recompute of P per
    tile pair, dq in q units (times ``p2`` in f32 before the cast).  The
    kernel sums dq into a zeroed f32 workspace, then flushes it."""
    if qr.device.type == "cpu":
        dq, dk, dv = _attention_bwd_impl(qr, k, v, lse, delta, do, causal,
                                         scale_r, dq_scale=p2,
                                         round_pds=True)
        return dk, dv, dq
    _check_cuda("flash_bwd", (qr, k, v, do), (lse, delta))
    bh, sq, d = qr.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dq32 = torch.zeros(qr.shape, dtype=torch.float32, device=qr.device)
    dq = torch.empty_like(qr)
    with torch.cuda.device(qr.device):
        _launch(_kernel_fn("flash_bwd", "hvdt_flash_bwd"),
                _DTYPE_CODE[qr.dtype], d, qr.data_ptr(), k.data_ptr(),
                v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                dq32.data_ptr(), dq.data_ptr(), bh, sq, k.shape[1],
                float(scale_r), float(p2), int(causal))
    launches["flash_bwd"] += 1
    return dk, dv, dq


def flash_bwd_dkdv(qr, k, v, do, lse, delta, scale_r: float, causal: bool):
    """K2: ``(dk, dv)`` in the input dtype, no dq."""
    if qr.device.type == "cpu":
        return _attention_bwd_impl(qr, k, v, lse, delta, do, causal,
                                   scale_r)[1:]
    _check_cuda("flash_bwd_dkdv", (qr, k, v, do), (lse, delta),
                _SPLIT_HEAD_DIMS, wide=True)
    bh, sq, d = qr.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(qr.device):
        _launch(_split_body("flash_bwd_split", "hvdt_flash_bwd_dkdv", d),
                _DTYPE_CODE[qr.dtype], d, qr.data_ptr(), k.data_ptr(),
                v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, sq,
                k.shape[1], float(scale_r), int(causal))
    launches["flash_bwd_dkdv"] += 1
    return dk, dv


def flash_bwd_dq(qr, k, v, do, lse, delta, scale_r: float, p2: float,
                 causal: bool):
    """K3: dq in the input dtype, in q units (times ``p2`` in f32 before
    the cast), summed in registers over its query tile's key tiles: no
    workspace, no atomics."""
    if qr.device.type == "cpu":
        return _attention_bwd_impl(qr, k, v, lse, delta, do, causal,
                                   scale_r, dq_scale=p2)[0]
    _check_cuda("flash_bwd_dq", (qr, k, v, do), (lse, delta),
                _SPLIT_HEAD_DIMS, wide=True)
    bh, sq, d = qr.shape
    dq = torch.empty_like(qr)
    with torch.cuda.device(qr.device):
        _launch(_split_body("flash_bwd_split", "hvdt_flash_bwd_dq", d),
                _DTYPE_CODE[qr.dtype], d, qr.data_ptr(), k.data_ptr(),
                v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), bh, sq, k.shape[1],
                float(scale_r), float(p2), int(causal))
    launches["flash_bwd_dq"] += 1
    return dq


def flash_backward(mode: str, qr, k, v, do, lse, delta, scale_r: float,
                   p2: float, causal: bool):
    """``(dk, dv, dq)`` of the backward in ``mode`` (:func:`bwd_mode`): B2
    for ``"combined"``, K2 + K3 for ``"split"``."""
    if mode == "combined":
        return flash_bwd(qr, k, v, do, lse, delta, scale_r, p2, causal)
    dk, dv = flash_bwd_dkdv(qr, k, v, do, lse, delta, scale_r, causal)
    return dk, dv, flash_bwd_dq(qr, k, v, do, lse, delta, scale_r, p2, causal)


def pad_head(x, d_body: int):
    """``x`` (..., d) zero-padded to ``d_body`` columns, contiguous."""
    d = x.shape[-1]
    if d == d_body:
        return x.contiguous()
    return torch.nn.functional.pad(x, (0, d_body - d)).contiguous()


class _FlashAttnFn(torch.autograd.Function):
    """K1 forward; the backward in :func:`bwd_mode`'s mode (B2, or K2 +
    K3), over (batch, heads, seq, head_dim).  A head dim that no body takes
    runs zero-padded to the next one (:func:`padded_head_dim`): the scale
    stays the caller's and the mode follows the caller's head dim, as the
    reference's ``_bwd_plan`` does; the padded output and gradient columns
    are sliced off."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        b, h, sq, d = q.shape
        sk = k.shape[2]
        d_body = padded_head_dim(d)
        # Pre-scale q by the exact pow2 part of sm_scale; the f32 residual
        # (1.0 for power-of-4 head dims) scales the logits in-kernel.
        p2, scale_r = _split_scale(sm_scale)
        qr = pad_head((q * p2).to(q.dtype).reshape(b * h, sq, d), d_body)
        kr = pad_head(k.reshape(b * h, sk, d), d_body)
        vr = pad_head(v.reshape(b * h, sk, d), d_body)
        o, lse = flash_fwd(qr, kr, vr, scale_r, causal)
        ctx.save_for_backward(qr, kr, vr, o, lse)
        ctx.args = (causal, p2, scale_r, q.shape, k.shape)
        return o[..., :d].reshape(b, h, sq, d)

    @staticmethod
    def backward(ctx, g):
        qr, kr, vr, o, lse = ctx.saved_tensors
        causal, p2, scale_r, q_shape, k_shape = ctx.args
        bh, sq, d_body = qr.shape
        d = q_shape[-1]
        do = pad_head(g.reshape(bh, sq, d), d_body)
        delta = _delta(o, do)
        dk, dv, dq = flash_backward(bwd_mode(sq, d, bh), qr, kr, vr, do, lse,
                                    delta, scale_r, p2, causal)
        return (dq[..., :d].reshape(q_shape), dk[..., :d].reshape(k_shape),
                dv[..., :d].reshape(k_shape), None, None)


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    layout: str = "bhsd"):
    """Fused multi-head attention.

    ``layout="bhsd"`` takes ``(batch, heads, seq, head_dim)``;
    ``layout="bshd"`` takes ``(batch, seq, heads, head_dim)`` and returns
    the same layout.

    On a CUDA tensor this is the hand-written kernels (K1 forward; the
    backward in the reference's mode, :func:`bwd_mode`: B2 where it picks
    the combined kernel, as at every sequence up to 2048 with at most 1024
    batch-heads and head_dim up to 128, K2 + K3 where it picks the split
    pair, as at every head_dim above 128) for any head_dim and
    float32/float16/bfloat16, at any sequence length; the bodies take
    head_dim 32/64/96/128 (and 256: K1, K2, K3; above 256 K1, K2 and K3's
    wide bodies take every multiple of 32), and any other head_dim runs
    zero-padded to the next (:func:`padded_head_dim`).  Other inputs
    raise.  On a CPU tensor it is the
    mathematically identical :func:`blockwise_attention`.  ``block_q`` and
    ``block_k`` are accepted for API parity with the JAX package and
    ignored: the kernels fix their own tiles (the forward 128 query rows
    by 128 keys in 16 bits, 64 keys above head_dim 64, and 128 by 64 in
    float32, :func:`fwd_key_tile`; the backward :func:`bwd_key_tile`; K3
    128 query rows by 32 keys at head_dim 256 in 16 bits and in the f32
    K3; above 256, 128 query rows by 128 keys in 16 bits and by
    64 in float32, with at most 128 output columns per block).
    """
    del block_q, block_k
    if layout not in ("bhsd", "bshd"):
        raise ValueError(f"unknown layout {layout!r}")
    if layout == "bshd":
        t = lambda a: a.transpose(1, 2)  # noqa: E731
        return t(flash_attention(t(q), t(k), t(v), causal=causal,
                                 sm_scale=sm_scale))
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return blockwise_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: device {q.device} unsupported")
    return _FlashAttnFn.apply(q, k, v, bool(causal), float(sm_scale))
