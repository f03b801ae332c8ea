"""The rule that holds the CUDA kernels against their plain versions
(horovod_tpu_torch/ops/kernel_check.py), checked on the CPU.

The plain side must be the plain versions the CPU path runs, rounded
where the kernels round, and the rule must take a one-unit rounding
difference while refusing an output that lost a tile of keys.
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import attention as tattn
from horovod_tpu_torch.ops import kernel_check


def _inputs(shape, dtype, seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape)
                                    .astype(np.float32)).to(dtype)
                   for _ in range(4))
    p2, r = tattn._split_scale(shape[-1] ** -0.5)
    return (q * p2).to(dtype), k, v, do, p2, r


@pytest.mark.parametrize("fwd_tile", [64, 128])
def test_plain_side_is_the_plain_path_in_float32(monkeypatch, fwd_tile):
    """In float32 the forward's key tile (the f32 body's 64, the 16-bit
    body's 128) and round_pds change only summation order: kernel_check's
    plain side agrees with the default plain forward (512-key blocks) and
    backward under the f32 rule."""
    monkeypatch.setattr(tattn, "fwd_key_tile", lambda dtype, d: fwd_tile)
    qr, k, v, do, p2, r = _inputs((2, 200, 64), torch.float32, 0)
    ref, delta = kernel_check.plain_outputs(qr, k, v, do, True, r, p2)
    o, lse = tattn._blockwise_fwd_impl(qr, k, v, True, r)
    dq, dk, dv = tattn._attention_bwd_impl(qr, k, v, lse, tattn._delta(o, do),
                                           do, True, r, dq_scale=p2)
    for name, got in (("o", o), ("lse", lse), ("dq", dq), ("dk", dk),
                      ("dv", dv)):
        assert kernel_check.compare(got, ref[name])["worst"] <= 1.0, name


def test_forward_key_tile_follows_the_kernels():
    """The plain side's forward key block is the forward body's key tile
    (csrc/flash_fwd_sm90.cuh: 128 in 16 bits up to head_dim 64, 64 above
    and in float32); in bf16 the choice is live: p is rounded against the
    running max per tile, so a 128-key plain side differs from a 64-key
    one.  A head dim no body takes answers for the body it is padded to
    (48 for 64's); past 256 the wide bodies' 128 keys in 16 bits
    (csrc/flash_wide_sm90.cuh, FWD_KEYS) and 64 in float32
    (csrc/flash_wide_f32_sm90.cuh, F32_FWD_KEYS); below 1 none runs."""
    for d in tattn.HEAD_DIMS:
        tile16 = 128 if d <= 64 else 64
        assert tattn.fwd_key_tile(torch.bfloat16, d) == tile16
        assert tattn.fwd_key_tile(torch.float16, d) == tile16
        assert tattn.fwd_key_tile(torch.float32, d) == 64
    assert tattn.fwd_key_tile(torch.bfloat16, 48) == 128
    assert tattn.fwd_key_tile(torch.bfloat16, 288) == 128
    assert tattn.fwd_key_tile(torch.float32, 288) == 64
    with pytest.raises(ValueError, match="head_dim"):
        tattn.fwd_key_tile(torch.bfloat16, 0)
    qr, k, v, do, p2, r = _inputs((2, 512, 64), torch.bfloat16, 4)
    ref, _ = kernel_check.plain_outputs(qr, k, v, do, True, r, p2)
    o128, lse128 = tattn._blockwise_fwd_impl(qr, k, v, True, r,
                                             block_size=128)
    o64, _ = tattn._blockwise_fwd_impl(qr, k, v, True, r, block_size=64)
    assert torch.equal(ref["o"], o128) and torch.equal(ref["lse"], lse128)
    assert not torch.equal(o64, o128)
    # The ring step's plain side takes the same tile.
    ring, _ = kernel_check.ring_plain_step(qr, k, v, do, 512, 0, True, r)
    o_ring, _ = tattn._blockwise_fwd_impl(qr, k, v, True, r, block_size=128,
                                          q_offset=512, k_offset=0)
    assert torch.equal(ring["o"], o_ring)


def test_round_pds_rounds_p_and_ds_before_their_products():
    """bf16: the blockwise backward with round_pds equals a dense
    backward that rounds p (for dv) and ds (for dq, dk) to bf16, as the
    reference's Pallas _bwd_block_math does, up to the final cast."""
    qr, k, v, do, p2, r = _inputs((2, 160, 32), torch.bfloat16, 1)
    ref, delta = kernel_check.plain_outputs(qr, k, v, do, True, r, p2)
    s = qr.float() @ k.float().transpose(-1, -2) * r
    keep = torch.ones(160, 160, dtype=torch.bool).tril()
    p = torch.where(keep, torch.exp(s - ref["lse"][..., None]), 0.0)
    dp = do.float() @ v.float().transpose(-1, -2)
    ds = (p * (dp - delta[..., None]) * r).bfloat16().float()
    want = {"dv": p.bfloat16().float().transpose(-1, -2) @ do.float(),
            "dk": ds.transpose(-1, -2) @ qr.float(),
            "dq": ds @ k.float() * p2}
    for name, w in want.items():
        got = ref[name]
        assert got.dtype == torch.bfloat16
        assert kernel_check.compare(got, w.bfloat16())["worst"] <= 1.0, name
    # Without the rounding the same backward differs: the option is live.
    dq_f32 = tattn._attention_bwd_impl(qr, k, v, ref["lse"], delta, do, True,
                                       r, block_size=64, dq_scale=p2)[0]
    assert not torch.equal(dq_f32, ref["dq"])


def test_rule_takes_an_ulp_and_refuses_a_dropped_key_tile():
    qr, k, v, do, p2, r = _inputs((2, 512, 64), torch.bfloat16, 2)
    ref, _ = kernel_check.plain_outputs(qr, k, v, do, False, r, p2)
    o = ref["o"]
    # One unit in the last place up on every element.
    ulp = (o.float() * (1 + 2.0 ** -7)).bfloat16()
    assert kernel_check.compare(ulp, o)["worst"] <= 1.0
    # The output of a kernel that skipped keys 256..319.
    keep = torch.cat([torch.arange(256), torch.arange(320, 512)])
    dropped, _ = tattn._blockwise_fwd_impl(qr, k[:, keep], v[:, keep], False,
                                           r, block_size=64)
    assert kernel_check.compare(dropped, o)["worst"] > 1.0
    assert kernel_check.rtol(torch.bfloat16) == 2 * 2.0 ** -7
    assert kernel_check.rtol(torch.float32) == 1e-4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_rule_takes_rounding_flips_of_p_and_ds(monkeypatch, dtype):
    """A kernel sums s and dp in another order than the plain side, so
    its p and ds can round the other way near a rounding midpoint.
    Emulated here by a one-ulp f32 perturbation of every product on the
    plain side: the rule must take the flips that follow."""
    qr, k, v, do, p2, r = _inputs((8, 512, 64), dtype, 3)
    ref, _ = kernel_check.plain_outputs(qr, k, v, do, True, r, p2)
    gen = torch.Generator().manual_seed(0)
    mm = tattn._mm

    def mm_other_order(a, b):
        out = mm(a, b)
        return out * (1 + torch.randn(out.shape, generator=gen) * 2.0 ** -23)

    monkeypatch.setattr(tattn, "_mm", mm_other_order)
    got, _ = kernel_check.plain_outputs(qr, k, v, do, True, r, p2)
    assert any(not torch.equal(got[n], ref[n]) for n in ref)
    for name in ref:
        assert kernel_check.compare(got[name], ref[name])["worst"] <= 1.0, name


def test_tf32_split_rounds_as_cvt_rna():
    """kernel_check.tf32_split rounds as ``cvt.rna.tf32.f32``: to 10
    mantissa bits, ties away from zero, the 13 low bits of hi and lo both
    0, and hi + lo within 2^-22 of x (relative)."""
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0)) * 100
    hi, lo = kernel_check.tf32_split(x)
    for t in (hi, lo):
        assert bool(((t.view(torch.int32) & 0x1FFF) == 0).all())
    assert ((x - hi) / x).abs().max() <= 2.0 ** -11
    assert ((x - hi - lo) / x).abs().max() <= 2.0 ** -22
    ties = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11,
                         1 + 2.0 ** -12])
    assert kernel_check.tf32_split(ties)[0].tolist() == [
        1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1 + 2.0 ** -9, 1.0]


@pytest.mark.parametrize("d", [288, 512, 1024])
def test_3xtf32_products_keep_the_f32_rule(monkeypatch, d):
    """The wide f32 bodies of K1 and K2 (csrc/flash_wide_f32_sm90.cuh)
    split every operand of every product hi / lo (kernel_check.tf32_split)
    and sum hi.hi + hi.lo + lo.hi.  Emulated on the plain side that holds
    them (kernel_check.mm_3xtf32 in place of every product), o, lse, dk
    and dv pass the f32 rule against the float32 plain side (they read
    ~0.05); hi.hi alone, one TF32 product, fails it in o, dk and dv by
    more than 10x (lse, a log of sums, reads 0.3-1.2)."""
    qr, k, v, do, p2, r = _inputs((2, 256, d), torch.float32, d)
    ref, _ = kernel_check.plain_outputs(qr, k, v, do, True, r, p2, "split")
    mm = tattn._mm
    worst = {}
    for products in (3, 1):
        monkeypatch.setattr(tattn, "_mm", lambda a, b, _p=products:
                            kernel_check.mm_3xtf32(a, b, _p))
        got, _ = kernel_check.plain_outputs(qr, k, v, do, True, r, p2,
                                            "split")
        monkeypatch.setattr(tattn, "_mm", mm)
        worst[products] = {n: kernel_check.compare_outputs(
            {n: got[n]}, {n: ref[n]})[n]["worst"]
            for n in ("o", "lse", "dk", "dv")}
    assert max(worst[3].values()) <= 1.0, worst[3]
    assert min(worst[1][n] for n in ("o", "dk", "dv")) > 10.0, worst[1]
