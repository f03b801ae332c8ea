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
    (csrc/flash_wide_sm90.cuh, FWD_KEYS); in float32 the 3xTF32 body's 64
    at every head dim, 256 included (csrc/flash_wide_f32_sm90.cuh,
    F32_FWD_KEYS); below 1 none runs."""
    for d in tattn.HEAD_DIMS + (tattn.WIDE_HEAD_DIM,):
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


@pytest.mark.parametrize("d", [32, 64, 96, 128, 256, 288, 512, 1024])
def test_3xtf32_products_keep_the_f32_rule(monkeypatch, d):
    """The f32 tensor-core bodies (csrc/flash_wide_f32_sm90.cuh) split
    every operand of every product hi / lo (kernel_check.tf32_split) and
    sum hi.hi + hi.lo + lo.hi.  Emulated on the plain side that holds
    them (kernel_check.mm_3xtf32 in place of every product), o, lse, dq,
    dk and dv pass the f32 rule against the float32 plain side (they read
    ~0.05; dq under its limit with the dq term, ``dq_noise``), and dq
    against a plain side whose products are float64 reads at most 0.5 of
    that limit on query rows 0-7 and 8 on; hi.hi alone, one TF32 product,
    fails it in o, dq, dk and dv by more than 10x (lse, a log of sums,
    reads 0.3-1.2)."""
    mode = "combined" if d <= 128 else "split"
    qr, k, v, do, p2, r = _inputs((2, 256, d), torch.float32, d)
    ref, delta = kernel_check.plain_outputs(qr, k, v, do, True, r, p2, mode)
    mm = tattn._mm
    worst = {}
    for products in (3, 1):
        monkeypatch.setattr(tattn, "_mm", lambda a, b, _p=products:
                            kernel_check.mm_3xtf32(a, b, _p))
        got, _ = kernel_check.plain_outputs(qr, k, v, do, True, r, p2,
                                            mode)
        monkeypatch.setattr(tattn, "_mm", mm)
        names = ("o", "lse", "dq", "dk", "dv")
        worst[products] = {n: e["worst"] for n, e in
                           kernel_check.compare_outputs(
                               {n: got[n] for n in names}, ref).items()}
        if products == 3:
            dq64 = _dq_f64(qr, k, v, do, ref["lse"], delta, p2, r, True,
                           mode)
            first = kernel_check.compare_first_rows(
                got["dq"], dq64, noise=ref["dq_noise"])
    assert max(worst[3].values()) <= 1.0, worst[3]
    assert max(x["worst_new"] for x in first.values()) <= 0.5, first
    assert min(worst[1][n] for n in ("o", "dq", "dk", "dv")) > 10.0, worst[1]


def test_tf32_split3_is_exact():
    """kernel_check.tf32_split3, the f32 K1's split of V: tf32_split's hi
    and lo and the rest rounded the same way, all three TF32 (13 low bits
    0), and hi + lo + lo2 is x bit for bit.  So a row of P that is one
    key's 1 returns that key's row of V exactly from mm_3xtf32's four
    products, and not from three."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(4096, generator=gen) * 10.0 ** torch.randint(
        -6, 6, (4096,), generator=gen)
    hi, lo, lo2 = kernel_check.tf32_split3(x)
    two = kernel_check.tf32_split(x)
    assert torch.equal(hi, two[0]) and torch.equal(lo, two[1])
    for t in (hi, lo, lo2):
        assert bool(((t.view(torch.int32) & 0x1FFF) == 0).all())
    assert torch.equal(hi + lo + lo2, x)
    v = torch.randn(64, 32, generator=gen)
    p = torch.zeros(8, 64)
    p[torch.arange(8), torch.arange(8) * 5] = 1.0
    assert torch.equal(kernel_check.mm_3xtf32(p, v, 4), v[::5][:8])
    assert not torch.equal(kernel_check.mm_3xtf32(p, v), v[::5][:8])


def _dq_f64(qr, k, v, do, lse, delta, p2, r, causal, mode):
    """dq of the plain backward of ``mode``'s key tile with every product
    in float64 (the same lse and delta), rounded to float32 at the end."""
    mm = tattn._mm
    try:
        tattn._mm = lambda a, b: torch.matmul(a.double(), b.double())
        return tattn._attention_bwd_impl(
            qr, k, v, lse, delta, do, causal, r,
            block_size=tattn.bwd_key_tile(mode, qr.dtype, qr.shape[-1]),
            dq_scale=p2, grad_dtype=torch.float64)[0].float()
    finally:
        tattn._mm = mm


def _emulated(qr, k, v, do, r, p2, lse, delta, mode, products):
    """``{o, lse, dq, dk, dv}`` of the f32 bodies emulated on the plain
    side: K1's S from ``products`` TF32 products and its P V from four
    (``products`` 1: both from one), every backward product from
    ``products``; the backward on the given lse and delta, as the kernels
    are held."""
    mm = tattn._mm
    d = qr.shape[-1]
    try:
        tattn._mm = lambda a, b: kernel_check.mm_3xtf32(
            a, b, products if products == 1 or a is qr else 4)
        o, lse_e = tattn._blockwise_fwd_impl(
            qr, k, v, True, r, block_size=tattn.fwd_key_tile(qr.dtype, d))
        tattn._mm = lambda a, b: kernel_check.mm_3xtf32(a, b, products)
        got = kernel_check.plain_bwd_outputs(qr, k, v, do, lse, delta, p2, r,
                                             True, mode)
    finally:
        tattn._mm = mm
    return {"o": o, "lse": lse_e, **got}


@pytest.mark.parametrize("d,mode", [(32, "combined"), (64, "combined"),
                                    (96, "combined"), (128, "combined"),
                                    (256, "split")])
def test_3xtf32_bodies_up_to_256_keep_the_f32_rule(d, mode):
    """The f32 K1 and K2 at head dims up to 256 (csrc/flash_wide_f32_sm90.cuh
    with a window of the whole head dim, two column CTAs at 256), emulated
    on the plain side that holds them at 8 batch-heads: K1's S from three
    TF32 products and its P V from four, every backward product from
    three.  o, lse, dk and dv pass the f32 rule against the float32 plain
    side (they read ~0.05), and dq on query rows 8 on under the rule
    without dq's term (rows 0-7 under it: test_first_rows_dq_is_a_rounding_residue)
    and on every row under the limit with it; hi.hi alone, one TF32
    product, fails o, dk and dv by more than 10x."""
    qr, k, v, do, p2, r = _inputs((8, 256, d), torch.float32, 40 + d)
    ref, delta = kernel_check.plain_outputs(qr, k, v, do, True, r, p2, mode)
    worst = {}
    for products in (3, 1):
        got = _emulated(qr, k, v, do, r, p2, ref["lse"], delta, mode,
                        products)
        worst[products] = {n: e["worst"] for n, e in
                           kernel_check.compare_outputs(
                               {n: got[n] for n in ("o", "lse", "dk", "dv")},
                               ref).items()}
        first = kernel_check.compare_first_rows(got["dq"], ref["dq"],
                                                noise=ref["dq_noise"])
        worst[products]["dq_rows_8_on"] = first["rows_8_on"]["worst"]
        worst[products]["dq"] = max(x["worst_new"] for x in first.values())
    assert max(worst[3].values()) <= 1.0, worst[3]
    assert min(worst[1][n] for n in ("o", "dk", "dv")) > 10.0, worst[1]


@pytest.mark.parametrize("shape", [(8, 1024, 128), (32, 1024, 64)])
def test_first_rows_dq_is_a_rounding_residue(shape):
    """Under a causal mask query row 0 sees one key: p = 1, o = v_0 and
    delta_0 = dO_0 . v_0 = dP_00, so its dS and dq are 0 in exact
    arithmetic and each side returns its own rounding residue of dP -
    delta times k_0.  The float32 plain side against one whose products
    are float64 (the same lse and delta) reads more than 1 of the f32
    rule on query rows 0-7, whose floor (1e-4 rms(dq) / 16) lies below
    that residue, and at most 0.1 on rows 8 on.  So no body that sums dP
    in another order than the plain side's meets the rule there
    (ROADMAP C): B2's and K3's f32 bodies stay SIMT, whose fmaf chain is
    the plain side's order on the card."""
    qr, k, v, do, p2, r = _inputs(shape, torch.float32, 0)
    ref, delta = kernel_check.plain_outputs(qr, k, v, do, True, r, p2)
    mm = tattn._mm
    try:
        tattn._mm = lambda a, b: torch.matmul(a.double(), b.double())
        dq64 = tattn._attention_bwd_impl(
            qr, k, v, ref["lse"], delta, do, True, r,
            block_size=tattn.bwd_key_tile("combined", qr.dtype, shape[-1]),
            dq_scale=p2, grad_dtype=torch.float64)[0]
    finally:
        tattn._mm = mm
    reading = kernel_check.compare_first_rows(ref["dq"], dq64.float())
    assert reading["rows_0_7"]["worst"] > 1.0, reading
    assert reading["rows_8_on"]["worst"] <= 0.1, reading


# The dq term (kernel_check's module docstring): the float32 plain side
# against float64 products, causal at head dims 32-128 (the combined
# mode's key tile) and 256 (the split mode's), and one non-causal ragged
# case.
DQ_TERM_CASES = [((8, 512, 32), "combined", True),
                 ((8, 512, 64), "combined", True),
                 ((8, 512, 96), "combined", True),
                 ((8, 512, 128), "combined", True),
                 ((2, 512, 256), "split", True),
                 ((8, 500, 64), "combined", False)]


@pytest.mark.parametrize("shape,mode,causal", DQ_TERM_CASES)
def test_f32_plain_dq_meets_the_dq_term_against_f64_products(shape, mode,
                                                             causal):
    """The float32 plain side's dq against a plain side whose products are
    float64 (the same lse and delta) reads at most 0.5 of dq's limit with
    its term, ``dq_noise`` (sqrt(d) eps32 |scale_r p2| sqrt(sum_j (p a)^2
    k^2)), on query rows 0-7, where a causal row's dS cancels to a
    rounding residue, and on rows 8 on."""
    qr, k, v, do, p2, r = _inputs(shape, torch.float32, shape[-1] + causal)
    ref, delta = kernel_check.plain_outputs(qr, k, v, do, causal, r, p2,
                                            mode)
    dq64 = _dq_f64(qr, k, v, do, ref["lse"], delta, p2, r, causal, mode)
    reading = kernel_check.compare_first_rows(ref["dq"], dq64,
                                              noise=ref["dq_noise"])
    assert max(x["worst_new"] for x in reading.values()) <= 0.5, reading
    # compare() holds dq by the same limit.
    assert kernel_check.compare(ref["dq"], dq64, noise=ref["dq_noise"])[
        "worst"] <= 0.5


def _dq_mutant(name, qr, k, v, do, p2, r, ref, delta):
    """dq of a plain side that drops work as a body's mutant would: one
    TF32 product (``one_tf32``), dP = dO v^T one k8 slice short in every
    32-column chunk (``dp_one_k8_short``), or key tile 1 (64 keys) left
    out (``key_tile_skipped``)."""
    args = (qr, k, v, do, ref["lse"], delta, p2, r, True)
    if name == "key_tile_skipped":
        tile = tattn._attention_bwd_impl(
            qr, k[:, 64:128], v[:, 64:128], ref["lse"], delta, do, True, r,
            block_size=64, dq_scale=p2, round_pds=True, k_offset=64)[0]
        return ref["dq"] - tile
    keep = torch.arange(qr.shape[-1]) % 32 < 24
    mm = tattn._mm

    def mutant(a, b):
        if name == "dp_one_k8_short" and a is do:
            return mm(a[..., keep], b[..., keep, :])
        if name == "one_tf32":
            return kernel_check.mm_3xtf32(a, b, products=1)
        return mm(a, b)

    try:
        tattn._mm = mutant
        return kernel_check.plain_bwd_outputs(*args)["dq"]
    finally:
        tattn._mm = mm


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("name", ["one_tf32", "dp_one_k8_short",
                                  "key_tile_skipped"])
def test_dq_term_still_refuses_dropped_work(name, d):
    """Under dq's limit with its term the mutants of the f32 bodies' dq
    still fail: one TF32 product, dP one k8 slice short, a key tile
    skipped."""
    qr, k, v, do, p2, r = _inputs((4, 512, d), torch.float32, 7)
    ref, delta = kernel_check.plain_outputs(qr, k, v, do, True, r, p2)
    got = _dq_mutant(name, qr, k, v, do, p2, r, ref, delta)
    reading = kernel_check.compare(got, ref["dq"], noise=ref["dq_noise"])
    assert reading["worst"] > 10.0, reading


@pytest.mark.parametrize("shape,mode", [((8, 512, 32), "combined"),
                                        ((8, 512, 64), "combined"),
                                        ((8, 512, 96), "combined"),
                                        ((8, 512, 128), "combined"),
                                        ((2, 512, 256), "split")])
def test_dq_term_is_small_where_p_is_spread(shape, mode):
    """On query rows 64 on, where p is spread over many keys, dq's term is
    a small share of the limit without it: its median there is at most
    0.15 of that limit (1.4% at head dim 32, 11% at 256)."""
    qr, k, v, do, p2, r = _inputs(shape, torch.float32, 3)
    ref, _ = kernel_check.plain_outputs(qr, k, v, do, True, r, p2, mode)
    old = kernel_check._limit(ref["dq"].float(), torch.float32)
    share = (ref["dq_noise"] / old)[:, 64:]
    assert share.median().item() <= 0.15, share.median().item()
