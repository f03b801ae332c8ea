"""The flash backward's mode and its B2 wrapper against horovod_tpu's.

``bwd_mode`` is the port's copy of the mode decision of the reference's
``_bwd_plan``; it must agree with it over the grid of lengths, head dims
and batch-heads below (at the default scoped-VMEM budget).  ``flash_bwd``
(B2) on the CPU is its plain version, held against the TPU kernel
``_combined_bwd_call`` in interpret mode, and ``flash_bwd_dkdv`` +
``flash_bwd_dq`` (K2 + K3) likewise against ``_split_bwd_call``;
``_FlashAttnFn`` is held against ``jattn.flash_attention``'s gradients in
both modes.  Inputs come from
numpy and feed both.  Tolerances as in test_torch_attention.py and
test_torch_ring.py: f32 summation order only (2e-5 for values and the
kernel's gradients, 1e-3 for gradients through the autograd function).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import attention as jattn
from horovod_tpu_torch.ops import attention as tattn
from horovod_tpu_torch.ops import kernel_check


@pytest.mark.parametrize("bh", [1, 32, 33, 512, 513, 1024, 1025])
@pytest.mark.parametrize("q_len", [64, 1000, 1024, 4096, 8192, 16384])
@pytest.mark.parametrize("d", [16, 32, 64, 80, 96, 128, 200, 256])
def test_bwd_mode_matches_reference_plan(monkeypatch, d, q_len, bh):
    """Head dims no body takes among them: ``_FlashAttnFn`` decides the
    mode on the caller's head dim, before padding."""
    monkeypatch.delenv("HVD_TPU_VMEM_LIMIT_MB", raising=False)
    want = jattn._bwd_plan(q_len, d, 1024, 1024, bh)[0]
    assert tattn.bwd_mode(q_len, d, bh) == want


@pytest.mark.parametrize("d", tattn.HEAD_DIMS)
@pytest.mark.parametrize("mode", ["combined", "split"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_bwd_tile_table_covers_every_head_dim_and_dtype(mode, dtype, d):
    """Every body's key tile is known for every dtype and head dim: in 16
    bits 128 keys for the combined body (sm90::BWD_BN, two consumer
    warpgroups of 64) and 64 for the split pair (K3's dq_key_tile); in f32
    64 for the combined mode (B2's 3xTF32 body, F32_DKDV_KEYS a CTA) and
    32 for the split pair (K3's 3xTF32 body, F32_DQ_KEYS).  A head dim 16
    short of a body's runs padded to it, so it has that body's tile; past
    256 the split pair's wide bodies take 64 keys in every dtype, and no
    combined body runs."""
    f32 = dtype == torch.float32
    want = (128 if mode == "combined" and not f32
            else 32 if mode == "split" and f32 else 64)
    assert tattn.bwd_key_tile(mode, dtype, d) == want
    assert tattn.bwd_key_tile(mode, dtype, d - 16) == want
    with pytest.raises(ValueError, match="mode"):
        tattn.bwd_key_tile("dense", dtype, d)
    if mode == "split":
        assert tattn.bwd_key_tile(mode, dtype, d + 256) == 64
    else:
        with pytest.raises(ValueError, match="head_dim"):
            tattn.bwd_key_tile(mode, dtype, d + 256)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", tattn.HEAD_DIMS)
def test_plain_side_walks_each_backward_key_tile(dtype, d):
    """The plain side that holds B2 and the one that holds K2 + K3 walk
    their own body's key tile, so their dq differ exactly where the tiles
    do: in 16 bits (B2 128 keys, K3 64) and in f32 (B2 64, K3 32)."""
    qr, k, v, do = (torch.from_numpy(a).to(dtype)
                    for a in _arrays((2, 512, d), seed=d))
    p2, r = tattn._split_scale(d ** -0.5)
    sides = {mode: kernel_check.plain_outputs(qr, k, v, do, True, r, p2,
                                              mode)[0]
             for mode in ("combined", "split")}
    ref = sides["combined"]
    for mode, side in sides.items():
        dq, dk, dv = tattn._attention_bwd_impl(
            qr, k, v, ref["lse"], tattn._delta(ref["o"], do), do, True, r,
            block_size=tattn.bwd_key_tile(mode, dtype, d), dq_scale=p2,
            round_pds=True)
        for name, want in (("dq", dq), ("dk", dk), ("dv", dv)):
            assert torch.equal(side[name], want), (mode, name)
    same = torch.equal(sides["combined"]["dq"], sides["split"]["dq"])
    tiles = {mode: tattn.bwd_key_tile(mode, dtype, d)
             for mode in ("combined", "split")}
    assert same == (tiles["combined"] == tiles["split"])


def _arrays(shape, seed, count=4):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for _ in range(count)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("p2", [0.25, 0.125])
def test_flash_bwd_plain_branch_matches_jax_combined_bwd(causal, p2):
    """B2's plain version (``flash_bwd`` on CPU tensors) against
    ``_combined_bwd_call`` with rotate=False (interpret mode, two query
    and key blocks): dk, dv and dq, dq times the pow2 factor in f32."""
    qr, k, v, do = _arrays((2, 32, 16), seed=11 + causal)
    o, lse = tattn.flash_fwd(*map(torch.tensor, (qr, k, v)), 1.0, causal)
    delta = tattn._delta(o, torch.tensor(do))
    lse8 = np.broadcast_to(lse.numpy()[:, None, :], (2, 8, 32))
    delta8 = np.broadcast_to(delta.numpy()[:, None, :], (2, 8, 32))
    want = jattn._combined_bwd_call(
        *map(jnp.asarray, (qr, do, lse8, delta8, k, v)), 0, 0,
        causal=causal, block_q=16, block_k=16, rotate=False,
        collective_id=None, axis_name=None, mesh_axes=(), interpret=True,
        scale_r=1.0, grad_dtype=jnp.float32, dq_scale=p2)
    got = tattn.flash_bwd(*map(torch.tensor, (qr, k, v, do)), lse, delta,
                          1.0, p2, causal)
    for name, g, w in zip(("dk", "dv", "dq"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=2e-5, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("p2", [0.25, 0.125])
def test_split_pair_plain_branches_match_jax_split_bwd(causal, p2):
    """K2's and K3's plain versions (``flash_bwd_dkdv`` and
    ``flash_bwd_dq`` on CPU tensors) against ``_split_bwd_call``, the two
    TPU kernels (interpret mode, two query and two key blocks): dk, dv,
    and dq times the pow2 factor in f32."""
    qr, k, v, do = _arrays((2, 32, 16), seed=31 + causal)
    o, lse = tattn.flash_fwd(*map(torch.tensor, (qr, k, v)), 1.0, causal)
    delta = tattn._delta(o, torch.tensor(do))
    lse8 = np.broadcast_to(lse.numpy()[:, None, :], (2, 8, 32))
    delta8 = np.broadcast_to(delta.numpy()[:, None, :], (2, 8, 32))
    want = jattn._split_bwd_call(
        *map(jnp.asarray, (qr, do, lse8, delta8, k, v)), causal=causal,
        block_q=16, block_k=16, interpret=True, scale_r=1.0,
        grad_dtype=jnp.float32, dq_scale=p2)
    args = (*map(torch.tensor, (qr, k, v, do)), lse, delta, 1.0)
    dk, dv = tattn.flash_bwd_dkdv(*args, causal)
    dq = tattn.flash_bwd_dq(*args, p2, causal)
    for name, g, w in zip(("dk", "dv", "dq"), (dk, dv, dq), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=2e-5, err_msg=name)


# (shape, block of the JAX side, the mode both sides' plans pick): seq 256
# at 2 heads is combined; 1025 batch-heads at seq 128 take the split pair.
_MODES = {"combined": ((1, 2, 256, 64), 128),
          "split": ((1, 1025, 128, 32), 128)}


@pytest.mark.parametrize("mode", list(_MODES))
def test_flash_attn_fn_backward_mode_matches_jax(monkeypatch, mode):
    """``_FlashAttnFn`` on CPU tensors, whose backward dispatches on
    ``bwd_mode`` to B2 or to K2 + K3 (their plain branches), against the
    JAX package's flash attention in the same mode: values and
    gradients."""
    monkeypatch.delenv("HVD_TPU_VMEM_LIMIT_MB", raising=False)
    shape, block = _MODES[mode]
    b, h, s, d = shape
    assert tattn.bwd_mode(s, d, b * h) == mode
    assert jattn._bwd_plan(s, d, block, block, b * h)[0] == mode
    called = []
    for name in ("flash_bwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        fn = getattr(tattn, name)
        monkeypatch.setattr(tattn, name,
                            lambda *a, _f=fn, _n=name: called.append(_n)
                            or _f(*a))
    q, k, v, ct = _arrays(shape, seed=21)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    import jax

    out, vjp = jax.vjp(lambda a, b_, c: jattn.flash_attention(
        a, b_, c, causal=True, block_q=block, block_k=block), jq, jk, jv)
    want = vjp(jnp.asarray(ct))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    got_out = tattn._FlashAttnFn.apply(*ts, True, d ** -0.5)
    got = torch.autograd.grad(got_out, ts, torch.tensor(ct))
    assert called == (["flash_bwd"] if mode == "combined"
                      else ["flash_bwd_dkdv", "flash_bwd_dq"])
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               atol=2e-5, rtol=2e-5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3,
                                   rtol=1e-3)
