"""horovod_tpu_torch's CUDA kernels against their plain versions, on a GPU.

Imports no JAX, so it runs on a GPU machine without it::

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Without a CUDA device every test here skips (the kernels have no CPU
mode; the CPU tests in test_torch_attention.py, test_torch_ring.py and
test_torch_ring_model.py hold the plain versions against the JAX
package).  Tolerances are those of
horovod_tpu_torch/ops/kernel_check.py, shared with chip_smoke.py: every
element within rtol * (|ref| + rms(ref)) of a plain version that rounds
p and ds where the kernels do; rtol two units in the last place for
16-bit outputs, 1e-4 for float32 outputs and lse (summation order), and
float32 dq's limit the larger by the rounding noise of dP that its
cancellation lets through (kernel_check's ``dq_noise``).
"""

import ctypes
import importlib

import pytest
import torch

from horovod_tpu_torch.ops import attention as tattn
from horovod_tpu_torch.ops import kernel_check


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, noise=None):
    return kernel_check.compare(got, want, noise=noise)["worst"] <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["combined", "split"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("seq,d,causal", [(256, 64, True), (200, 128, True),
                                          (130, 32, False), (96, 96, True)])
def test_kernels_match_plain_versions(cuda_device, dtype, seq, d, causal,
                                      mode):
    """K1 with the backward in each mode: B2 (combined) or K2 + K3."""
    g = torch.Generator(device=cuda_device).manual_seed(seq + d)
    q, k, v, do = (torch.randn(4, seq, d, device=cuda_device, generator=g)
                   .to(dtype) for _ in range(4))
    p2, r = tattn._split_scale(d ** -0.5)
    qr = (q * p2).to(dtype)
    ref, delta = kernel_check.plain_outputs(qr, k, v, do, causal, r, p2,
                                            mode)
    before = dict(tattn.launches)
    got = kernel_check.kernel_outputs(qr, k, v, do, ref["lse"], delta, p2, r,
                                      causal, mode)
    split = mode == "split"
    assert {n: tattn.launches[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd": int(not split),
        "flash_bwd_dkdv": int(split), "flash_bwd_dq": int(split)}
    for name in got:
        assert _close(got[name], ref[name], ref.get(name + "_noise")), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("seq", [2, 64, 127, 129, 1000])
def test_flash_bwd_at_the_tile_edges(cuda_device, seq, d, causal, dtype):
    """B2's 16-bit body around its 64-row query tile and its 128-key tile
    (64 keys per consumer warpgroup; dQ split by columns at head dims 64
    and 128, by keys at 32 and 96): two rows (one row would make dq and dk
    vanish identically), one query tile, one short of and one past the
    128 keys, and a ragged length over several tiles, where TMA zero-fills
    and the rows past the end read lse POS_BIG."""
    g = torch.Generator(device=cuda_device).manual_seed(seq * 1000 + d + 7)
    q, k, v, do = (torch.randn(3, seq, d, device=cuda_device, generator=g)
                   .to(dtype) for _ in range(4))
    p2, r = tattn._split_scale(d ** -0.5)
    qr = (q * p2).to(dtype)
    ref, delta = kernel_check.plain_outputs(qr, k, v, do, causal, r, p2)
    before = tattn.launches["flash_bwd"]
    dk, dv, dq = tattn.flash_bwd(qr, k, v, do, ref["lse"], delta, r, p2,
                                 causal)
    assert tattn.launches["flash_bwd"] == before + 1
    torch.cuda.synchronize()
    for name, got in (("dq", dq), ("dk", dk), ("dv", dv)):
        assert got.dtype == dtype
        assert _close(got, ref[name]), name


def _b2_holds(cuda_device, bh, seq, d, causal, dtype, seed):
    """B2 alone on ``bh`` x ``seq`` x ``d`` inputs, one launch, its dq, dk
    and dv (in ``dtype``) against the plain side of its 128-key tile."""
    g = torch.Generator(device=cuda_device).manual_seed(seed)
    q, k, v, do = (torch.randn(bh, seq, d, device=cuda_device, generator=g)
                   .to(dtype) for _ in range(4))
    p2, r = tattn._split_scale(d ** -0.5)
    qr = (q * p2).to(dtype)
    ref, delta = kernel_check.plain_outputs(qr, k, v, do, causal, r, p2)
    before = tattn.launches["flash_bwd"]
    dk, dv, dq = tattn.flash_bwd(qr, k, v, do, ref["lse"], delta, r, p2,
                                 causal)
    torch.cuda.synchronize()
    assert tattn.launches["flash_bwd"] == before + 1
    for name, got in (("dq", dq), ("dk", dk), ("dv", dv)):
        assert got.dtype == dtype
        err = kernel_check.compare(got, ref[name])
        assert err["worst"] <= 1.0, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("seq", [63, 65, 128, 193])
def test_b2_at_ragged_lengths(cuda_device, seq, d, causal, dtype):
    """B2's 16-bit body (256-thread CTAs of 128 keys, 64-row query tiles
    through three stages, pipelined at head dims 32 and 64) one
    short of and one past its query tile, at one whole key tile, and one
    past a tile and a half: the loop's first, last and only tiles, the
    stages' refills and the dQ buffers' reuse at their edges."""
    _b2_holds(cuda_device, 3, seq, d, causal, dtype, seq * 31 + d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("heads_together", [False, True],
                         ids=["head_fastest", "heads_together"])
def test_b2_under_both_grid_orders(cuda_device, heads_together, d, causal,
                                   dtype):
    """B2's grid (sm90::tile_order over bh x key tiles) just below
    HEADS_TOGETHER_MIN_CTAS (95 x 8 = 760 CTAs: the head fastest) and at
    it (96 x 8 = 768: each head's tiles together), at a ragged 1000."""
    bh = 96 if heads_together else 95
    assert (bh * -(-1000 // 128) >= _HEADS_TOGETHER_MIN_CTAS) == \
        heads_together
    _b2_holds(cuda_device, bh, 1000, d, causal, dtype, bh + d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 32),
                                     (torch.float16, 64),
                                     (torch.bfloat16, 96),
                                     (torch.float16, 128)])
def test_b2_past_65535_batch_heads(cuda_device, dtype, d):
    """B2's 16-bit body at 65,600 batch-heads x 70 (``flash_attention``
    sends so many batch-heads to the split pair, so B2 is called alone):
    65,600 CTAs of a 1-D grid, each over two query tiles."""
    _b2_holds(cuda_device, 65600, 70, d, True, dtype, 17 + d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("seq", [2, 64, 127, 129, 1000])
def test_split_pair_at_the_tile_edges(cuda_device, seq, d, causal, dtype):
    """K2 (the backward body without its dQ product: 128-key tiles, 64-row
    query steps) and K3 (128-row query tiles, 128 keys up to head_dim 64
    and 64 above) around their tiles: two rows, one query step, one short
    of and one past 128, and a ragged length over several tiles, where
    TMA zero-fills and the rows past the end carry POS_BIG; held against
    the plain side that walks K3's key tile."""
    g = torch.Generator(device=cuda_device).manual_seed(seq * 1000 + d + 9)
    q, k, v, do = (torch.randn(3, seq, d, device=cuda_device, generator=g)
                   .to(dtype) for _ in range(4))
    p2, r = tattn._split_scale(d ** -0.5)
    qr = (q * p2).to(dtype)
    ref, delta = kernel_check.plain_outputs(qr, k, v, do, causal, r, p2,
                                            "split")
    before = dict(tattn.launches)
    dk, dv = tattn.flash_bwd_dkdv(qr, k, v, do, ref["lse"], delta, r, causal)
    dq = tattn.flash_bwd_dq(qr, k, v, do, ref["lse"], delta, r, p2, causal)
    assert {n: tattn.launches[n] - before[n] for n in before} == {
        "flash_fwd": 0, "flash_bwd": 0, "flash_bwd_dkdv": 1,
        "flash_bwd_dq": 1}
    torch.cuda.synchronize()
    for name, got in (("dq", dq), ("dk", dk), ("dv", dv)):
        assert got.dtype == dtype
        assert _close(got, ref[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 32),
                                     (torch.float32, 32),
                                     (torch.bfloat16, 256),
                                     (torch.float16, 256)])
def test_flash_attention_past_65535_batch_heads(cuda_device, dtype, d):
    """65,600 batch-heads (more blocks than a grid's y dimension holds):
    K1, K2 and K3 launch once each (the plan picks the split pair past
    1024 batch-heads), and the output and gradients agree with the plain
    blockwise path; at head dim 256 in 16 bits on K1's and K2's bodies
    that compute S (and dP) once per pair."""
    got, want = _past_65535_batch_heads(cuda_device, dtype, d)
    for name, a in got.items():
        b = want[name]
        assert torch.isfinite(a).all()
        if dtype == torch.float32:
            assert _close(a, b, want.get(name + "_noise")), name
        else:
            # bf16 kernels against the f32 plain path: bf16 rounding of
            # the inputs' products and of the outputs (5e-2 of the
            # largest value).
            err = (a.float() - b).abs().max().item()
            assert err <= 5e-2 * b.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 96, 128, 256])
def test_f32_bodies_past_65535_batch_heads(cuda_device, d):
    """The f32 K1, K2 and K3 on their 3xTF32 bodies (1-D grids of query or
    key tiles x column CTAs x bh blocks) at 65,600 batch-heads and every
    head dim they take up to 256, through ``flash_attention``: o (K1), dk,
    dv (K2) and dq (K3) under the f32 rule, dq under its limit with the
    term of dP's rounding noise (at the causal first query rows dq is a
    rounding residue of dP - delta, zero in exact arithmetic)."""
    got, want = _past_65535_batch_heads(cuda_device, torch.float32, d)
    for name in ("o", "dq", "dk", "dv"):
        assert torch.isfinite(got[name]).all()
        assert _close(got[name], want[name], want.get(name + "_noise")), name


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 96, 128])
def test_f32_b2_past_65535_batch_heads(cuda_device, d):
    """B2 in f32 on its 3xTF32 body (a 1-D grid of key tiles x column CTAs
    x bh blocks) at 65,600 batch-heads x 16 (``flash_attention`` sends so
    many batch-heads to the split pair, so B2 is called alone), held
    against the plain side of its key tile: dq, dk, dv."""
    g = torch.Generator(device=cuda_device).manual_seed(13 + d)
    q, k, v, do = (torch.randn(65600, 16, d, device=cuda_device, generator=g)
                   for _ in range(4))
    p2, r = tattn._split_scale(d ** -0.5)
    qr = q * p2
    ref, delta = kernel_check.plain_outputs(qr, k, v, do, True, r, p2)
    before = tattn.launches["flash_bwd"]
    got = kernel_check.kernel_bwd_outputs(qr, k, v, do, ref["lse"], delta,
                                          p2, r, True)
    torch.cuda.synchronize()
    assert tattn.launches["flash_bwd"] == before + 1
    for name, err in kernel_check.compare_outputs(got, ref).items():
        assert err["worst"] <= 1.0, (name, err)


def _past_65535_batch_heads(cuda_device, dtype, d):
    """``flash_attention``'s ``{o, dq, dk, dv}`` at 65,600 batch-heads x
    16 x ``d`` (K1, K2 and K3 launched once each) and the plain blockwise
    path's in f32 (in f32 with ``dq_noise``, dq's term)."""
    shape = (1, 65600, 16, d)
    g = torch.Generator(device=cuda_device).manual_seed(12)
    q, k, v, ct = (torch.randn(shape, device=cuda_device, generator=g)
                   .to(dtype) for _ in range(4))
    before = dict(tattn.launches)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tattn.flash_attention(*xs, causal=True)
    grads = torch.autograd.grad(out, xs, ct)
    torch.cuda.synchronize()
    assert {n: tattn.launches[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd": 0, "flash_bwd_dkdv": 1,
        "flash_bwd_dq": 1}
    ref_in = [x.float().clone().requires_grad_() for x in (q, k, v)]
    ref = tattn.blockwise_attention(*ref_in, causal=True)
    ref_grads = torch.autograd.grad(ref, ref_in, ct.float())
    names = ("o", "dq", "dk", "dv")
    want = dict(zip(names, (ref.detach(), *ref_grads)))
    if dtype == torch.float32:
        want["dq_noise"] = kernel_check.path_dq_noise(q, k, v, ct, True)
    return dict(zip(names, (out.detach(), *grads))), want


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["combined", "split"])
def test_flash_attention_backward_follows_the_plan(cuda_device, mode):
    """flash_attention's backward launches B2 at the main path's shape and
    K2 + K3 where the reference's plan picks the split pair (more than
    1024 batch-heads); the gradients agree with the plain blockwise
    path."""
    shape = (16, 8, 1024, 64) if mode == "combined" else (1, 1040, 128, 64)
    assert tattn.bwd_mode(shape[2], shape[3], shape[0] * shape[1]) == mode
    g = torch.Generator(device=cuda_device).manual_seed(11)
    q, k, v, ct = (torch.randn(shape, device=cuda_device, generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    before = dict(tattn.launches)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    grads = torch.autograd.grad(tattn.flash_attention(*xs, causal=True), xs,
                                ct)
    torch.cuda.synchronize()
    split = mode == "split"
    assert {n: tattn.launches[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd": int(not split),
        "flash_bwd_dkdv": int(split), "flash_bwd_dq": int(split)}
    ref_in = [x.float().clone().requires_grad_() for x in (q, k, v)]
    ref = torch.autograd.grad(
        tattn.blockwise_attention(*ref_in, causal=True), ref_in, ct.float())
    for a, b in zip(grads, ref):
        assert torch.isfinite(a).all()
        # bf16 kernels against the f32 plain path: bf16 rounding of the
        # inputs' products and of the outputs (5e-2 of the row's size).
        err = (a.float() - b).abs().max().item()
        assert err <= 5e-2 * b.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
@pytest.mark.parametrize("seq", [1, 64, 127, 129, 1000])
def test_flash_fwd_at_the_tile_edges(cuda_device, seq, d, causal, dtype):
    """K1's 16-bit body around its 128-row query tile and its key tile
    (128 keys, 64 above head_dim 64): one row, part of a tile, one short
    of and one past a tile, and a ragged length over several tiles."""
    g = torch.Generator(device=cuda_device).manual_seed(seq * 1000 + d)
    q, k, v = (torch.randn(3, seq, d, device=cuda_device, generator=g)
               .to(dtype) for _ in range(3))
    p2, r = tattn._split_scale(d ** -0.5)
    qr = (q * p2).to(dtype)
    ref, _ = kernel_check.plain_outputs(qr, k, v, v, causal, r, p2)
    before = tattn.launches["flash_fwd"]
    o, lse = tattn.flash_fwd(qr, k, v, r, causal)
    assert tattn.launches["flash_fwd"] == before + 1
    torch.cuda.synchronize()
    assert _close(o, ref["o"])
    assert kernel_check.compare_lse(lse, ref["lse"])["worst"] <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_flash_attention_autograd_matches_blockwise(cuda_device, layout):
    """flash_attention on CUDA (K1 forward, K2 + K3 backward through
    _FlashAttnFn) against the plain blockwise autograd path, f32."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    shape = (2, 2, 160, 64) if layout == "bhsd" else (2, 160, 2, 64)
    q, k, v, ct = (torch.randn(shape, device=cuda_device, generator=g)
                   for _ in range(4))
    t = (lambda a: a) if layout == "bhsd" else (lambda a: a.transpose(1, 2))
    outs = []
    for fn in (lambda a, b, c: tattn.flash_attention(
                   a, b, c, causal=True, layout=layout),
               lambda a, b, c: t(tattn.blockwise_attention(
                   t(a), t(b), t(c), causal=True))):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*xs)
        outs.append((out.detach(), torch.autograd.grad(out, xs, ct)))
    (o1, g1), (o2, g2) = outs
    assert _close(o1, o2)
    noise = t(kernel_check.path_dq_noise(t(q), t(k), t(v), t(ct), True))
    for a, b, n in zip(g1, g2, (noise, None, None)):
        assert _close(a, b, n)


# (head dim, backward mode): every head dim no body takes, the 256 body's,
# and the wide bodies' above 256 (300 runs padded to 320); the combined
# mode stops at 128.
_HEAD_DIM_CASES = [(d, m) for d in (16, 48, 80, 200, 256, 288, 300, 512,
                                    1000)
                   for m in ("combined", "split") if d <= 128 or m == "split"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d,mode", _HEAD_DIM_CASES)
def test_kernels_at_other_head_dims_match_plain_versions(cuda_device, dtype,
                                                          d, mode):
    """K1 and the backward in each mode on inputs zero-padded to the body's
    head dim (as flash_attention pads them), each kernel held alone against
    the plain side at the caller's head dim, which walks the padded body's
    key tiles; the padded columns come out exactly 0."""
    g = torch.Generator(device=cuda_device).manual_seed(d + 3)
    q, k, v, do = (torch.randn(3, 200, d, device=cuda_device, generator=g)
                   .to(dtype) for _ in range(4))
    p2, r = tattn._split_scale(d ** -0.5)
    qr = (q * p2).to(dtype)
    ref, delta = kernel_check.plain_outputs(qr, k, v, do, True, r, p2, mode)
    body = tattn.padded_head_dim(d)
    pad = [tattn.pad_head(t, body) for t in (qr, k, v, do)]
    before = dict(tattn.launches)
    got = kernel_check.kernel_outputs(*pad, ref["lse"], delta, p2, r, True,
                                      mode)
    torch.cuda.synchronize()
    split = mode == "split"
    assert {n: tattn.launches[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd": int(not split),
        "flash_bwd_dkdv": int(split), "flash_bwd_dq": int(split)}
    for name, t in got.items():
        if name != "lse":
            assert torch.count_nonzero(t[..., d:]) == 0, name
            t = t[..., :d]
        assert _close(t, ref[name], ref.get(name + "_noise")) \
            if name != "lse" else \
            kernel_check.compare_lse(t, ref[name])["worst"] <= 1.0, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d,mode", _HEAD_DIM_CASES)
def test_flash_attention_at_other_head_dims(cuda_device, dtype, d, mode):
    """flash_attention at a head dim no body takes (and at 256): K1 once
    and the backward of the caller's head dim's mode once (more than 1024
    batch-heads for the split mode at head dims up to 128; every head dim
    above), output and gradients against the plain blockwise path in f32
    (kernel_check's rule in f32; 5e-2 of the largest value in 16 bits:
    rounding of the inputs' products and of the outputs)."""
    shape = (2, 2, 136, d) if mode == "combined" else (1, 1030, 40, d)
    assert tattn.bwd_mode(shape[2], d, shape[0] * shape[1]) == mode
    g = torch.Generator(device=cuda_device).manual_seed(d + 5)
    q, k, v, ct = (torch.randn(shape, device=cuda_device, generator=g)
                   .to(dtype) for _ in range(4))
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    before = dict(tattn.launches)
    out = tattn.flash_attention(*xs, causal=True)
    grads = torch.autograd.grad(out, xs, ct)
    torch.cuda.synchronize()
    split = mode == "split"
    assert {n: tattn.launches[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd": int(not split),
        "flash_bwd_dkdv": int(split), "flash_bwd_dq": int(split)}
    ref_in = [x.float().clone().requires_grad_() for x in (q, k, v)]
    ref = tattn.blockwise_attention(*ref_in, causal=True)
    ref_grads = torch.autograd.grad(ref, ref_in, ct.float())
    noise = (kernel_check.path_dq_noise(q, k, v, ct, True)
             if dtype == torch.float32 else None)
    for a, b, n in zip((out.detach(), *grads), (ref.detach(), *ref_grads),
                       (None, noise, None, None)):
        assert a.shape == shape and torch.isfinite(a).all()
        if dtype == torch.float32:
            assert _close(a, b, n)
        else:
            err = (a.float() - b).abs().max().item()
            assert err <= 5e-2 * b.abs().max().item(), err


# The wide bodies of K1, K2 and K3 at their edges (16 bits:
# csrc/flash_wide_sm90.cuh; f32: csrc/flash_wide_f32_sm90.cuh): (seq,
# head dim, causal).  Ragged sequences (not a multiple
# of the 128-row and 128-key tiles, of K2's 32-row query step nor of K3's
# 64-key tile), non-causal cases, head dim 288 (9 panels: an odd count, so
# a last one-panel chunk of S, and three column CTAs of 3 panels each) and
# 320 (10: 4 + 3 + 3, the shorter shares' windows shifted left inside the
# head dim).  K3's own: 130 and 191 leave the second consumer warpgroup of
# the last query tile no row below seq (it only waits for and releases
# every stage), causal 191 also a key tile wholly past the first
# warpgroup's rows; seq 2 a single row pair in one ragged key tile.
_WIDE_EDGES = [(200, 288, True), (333, 288, False), (65, 320, True),
               (129, 512, False), (256, 1024, True), (2, 288, True),
               (130, 320, False), (191, 512, True), (2, 1024, False)]


def _hold_wide_bodies(device, seq, d, causal, dtype):
    """K1, K2 and K3 above 256 against the plain side that walks their key
    tiles (kernel_check's rule), one launch each; lse with no POS_BIG row
    (every row sees a key)."""
    g = torch.Generator(device=device).manual_seed(seq * 7 + d)
    q, k, v, do = (torch.randn(3, seq, d, device=device, generator=g)
                   .to(dtype) for _ in range(4))
    p2, r = tattn._split_scale(d ** -0.5)
    qr = (q * p2).to(dtype)
    ref, delta = kernel_check.plain_outputs(qr, k, v, do, causal, r, p2,
                                            "split")
    before = dict(tattn.launches)
    got = kernel_check.kernel_outputs(qr, k, v, do, ref["lse"], delta, p2, r,
                                      causal, "split")
    torch.cuda.synchronize()
    assert {n: tattn.launches[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd": 0, "flash_bwd_dkdv": 1,
        "flash_bwd_dq": 1}
    for name, err in kernel_check.compare_outputs(got, ref).items():
        assert err["worst"] <= 1.0, (name, err)


# K1 and K2 at head dim 256 in 16 bits: a ragged length causal (1000: a
# last query tile of 104 rows, whose second consumer warpgroup holds 40,
# and a last key tile of 40 keys) and not (333), a single row pair in one
# ragged tile (seq 2), and a long causal sequence (8192: 128 key tiles
# into each row's O, 128 query steps into each key's dK and dV).
_EDGES_256 = [(1000, 256, True), (333, 256, False), (2, 256, True),
              (8192, 256, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("seq,d,causal", _WIDE_EDGES + _EDGES_256)
def test_wide_16bit_bodies_at_their_edges(cuda_device, seq, d, causal,
                                          dtype):
    """K1, K2 and K3 on their wgmma wide bodies, and at head dim 256 K1
    (each consumer warpgroup 64 query rows over all 256 columns, O += P V
    as two N = 128 products), K2 (S^T and dP^T once per pair, P^T and
    dS^T shared through shared memory) and K3."""
    _hold_wide_bodies(cuda_device, seq, d, causal, dtype)


# K3's grid at head dim 256 (one CTA per DQ256_ROWS query rows of a head)
# is ordered by its size (sm90::tile_order): the head fastest below
# HEADS_TOGETHER_MIN_CTAS CTAs, each head's tiles adjacent from there on.
_HEADS_TOGETHER_MIN_CTAS = 768
_K3_256_ROWS = 128


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("heads_together", [False, True],
                         ids=["head_fastest", "heads_together"])
@pytest.mark.parametrize("seq,d,causal", _EDGES_256)
def test_k3_at_256_under_both_grid_orders(cuda_device, seq, d, causal,
                                          heads_together, dtype):
    """K3 alone at head dim 256 (``dq256_tile``: 128 query rows a CTA, each
    consumer warpgroup S and dP of its 64 rows once per pair, all 256
    columns of their dQ) at the edges of ``_EDGES_256``, on 3 batch-heads
    (a grid below 768 CTAs) and on enough to reach 768: its dq against the
    plain side that walks its 32-key tiles, one launch."""
    n_qt = -(-seq // _K3_256_ROWS)
    bh = -(-_HEADS_TOGETHER_MIN_CTAS // n_qt) if heads_together else 3
    assert (bh * n_qt >= _HEADS_TOGETHER_MIN_CTAS) == heads_together
    g = torch.Generator(device=cuda_device).manual_seed(seq * 5 + bh)
    q, k, v, do = (torch.randn(bh, seq, d, device=cuda_device, generator=g)
                   .to(dtype) for _ in range(4))
    p2, r = tattn._split_scale(d ** -0.5)
    qr = (q * p2).to(dtype)
    ref, delta = kernel_check.plain_outputs(qr, k, v, do, causal, r, p2,
                                            "split")
    before = tattn.launches["flash_bwd_dq"]
    dq = tattn.flash_bwd_dq(qr, k, v, do, ref["lse"], delta, r, p2, causal)
    torch.cuda.synchronize()
    assert tattn.launches["flash_bwd_dq"] - before == 1
    err = kernel_check.compare(dq, ref["dq"])
    assert err["worst"] <= 1.0, err


@pytest.mark.cuda
@pytest.mark.parametrize("seq,d,causal", _WIDE_EDGES + [(100, 1056, True)])
def test_wide_f32_bodies_at_their_edges(cuda_device, seq, d, causal):
    """K1, K2 and K3 on their 3xTF32 wide bodies
    (csrc/flash_wide_f32_sm90.cuh: 128 query rows by 64-key tiles, 64 keys
    by 32-row query steps, 128 query rows by 32-key tiles, all in 4-panel
    windows: 3 + 3 + 3 panels at 288, where K2's two warpgroups also take
    5 and 4 head-dim chunks, 4 + 3 + 3 at 320); K3's column CTAs one
    thread block cluster (3 CTAs at 288 and 320, 4 at 512, 8 at 1024),
    each summing S and dP over its own panels, and at 1056 (9 column CTAs,
    past the cluster's 8) each recomputing them; held to the f32 rule
    (1e-4; dq with its term)."""
    _hold_wide_bodies(cuda_device, seq, d, causal, torch.float32)


# The f32 K1 and K2 at and below head dim 256: a single row pair in one
# ragged key tile (seq 2), a ragged length over several tiles (1000: a
# last query tile of 104 rows, a last key tile of 40 keys) causal and not.
_F32_EDGES = [(2, True), (1000, True), (1000, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("seq,causal", _F32_EDGES)
@pytest.mark.parametrize("d", [32, 64, 96, 128, 256])
def test_f32_bodies_at_their_edges(cuda_device, seq, d, causal):
    """K1, K2 and K3 in f32 on the 3xTF32 bodies of
    csrc/flash_wide_f32_sm90.cuh at the head dims up to 256: a window of
    the whole head dim (1-4 panels; K2's second warpgroup sums no chunk at
    32 and one of three at 96; K3's 32-key tiles, 1000 a last one of 8
    keys) and two column CTAs of 4 panels at 256; held to the f32 rule
    (1e-4; dq with its term)."""
    _hold_wide_bodies(cuda_device, seq, d, causal, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("seq,causal", _F32_EDGES + [(130, False)])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
def test_f32_b2_at_its_edges(cuda_device, seq, d, causal):
    """B2 in f32 on its 3xTF32 body (csrc/flash_wide_f32_sm90.cuh, K2's
    body with dQ = dS K added: 64 keys a CTA, 32-row query steps, each
    warpgroup's 16 rows of dQ added by TMA reduce; a window of the whole
    head dim up to 64, two column CTAs of 2 panels at 96 (2 + 1 panels,
    the second window shifted left) and 128), one launch, against the
    plain side of its 64-key tile: dq, dk, dv under the f32 rule (dq with
    its term)."""
    g = torch.Generator(device=cuda_device).manual_seed(seq * 5 + d)
    q, k, v, do = (torch.randn(3, seq, d, device=cuda_device, generator=g)
                   for _ in range(4))
    p2, r = tattn._split_scale(d ** -0.5)
    qr = q * p2
    ref, delta = kernel_check.plain_outputs(qr, k, v, do, causal, r, p2)
    before = dict(tattn.launches)
    got = kernel_check.kernel_bwd_outputs(qr, k, v, do, ref["lse"], delta,
                                          p2, r, causal)
    torch.cuda.synchronize()
    assert {n: tattn.launches[n] - before[n] for n in before} == {
        "flash_fwd": 0, "flash_bwd": 1, "flash_bwd_dkdv": 0,
        "flash_bwd_dq": 0}
    for name, err in kernel_check.compare_outputs(got, ref).items():
        assert err["worst"] <= 1.0, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("d,mode", [(64, "combined"), (128, "combined"),
                                    (64, "split"), (128, "split"),
                                    (256, "split"), (288, "split"),
                                    (512, "split")])
def test_f32_bodies_at_a_long_causal_sequence(cuda_device, d, mode):
    """K1 and B2 (``combined``) or K2 and K3 (``split``) in f32 at seq
    8192, causal: K3 adds 256 32-key tiles into each row's dQ (each
    tile's product summed in a fresh accumulator: the tensor cores
    truncate as they accumulate, so a chain over the key loop drifts with
    its length), B2 256 query steps into dK and dV; every output under
    the f32 rule (dq with its term).  At 288 and 512 the wide bodies on
    3xTF32 wgmma in column CTAs of 4-panel windows, K3's one thread block
    cluster sharing S and dP."""
    g = torch.Generator(device=cuda_device).manual_seed(d)
    q, k, v, do = (torch.randn(2, 8192, d, device=cuda_device, generator=g)
                   for _ in range(4))
    p2, r = tattn._split_scale(d ** -0.5)
    qr = q * p2
    ref, delta = kernel_check.plain_outputs(qr, k, v, do, True, r, p2, mode)
    got = kernel_check.kernel_outputs(qr, k, v, do, ref["lse"], delta, p2, r,
                                      True, mode)
    for name, err in kernel_check.compare_outputs(got, ref).items():
        assert err["worst"] <= 1.0, (name, err)


@pytest.mark.cuda
def test_unsupported_cuda_input_raises(cuda_device):
    q = torch.randn(1, 1, 64, 64, device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError, match="dtype"):
        tattn.flash_attention(q, q, q, causal=True)


# ---------------------------------------------------------------------------
# The ring kernels K4-K7 (ops/csrc/ring_flash.cu, ring_permute.cu) on a
# ring of 4 members co-located on the card, each on its own stream.
# ---------------------------------------------------------------------------


def _ring():
    from horovod_tpu_torch.parallel import RingMesh

    return RingMesh(4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("sl,d", [(256, 64), (200, 32), (200, 64),
                                  (200, 96), (200, 128)])
def test_ring_steps_match_plain_versions(cuda_device, dtype, sl, d):
    """K4 and K5 on every kind of ring step (diagonal, wholly visible,
    wholly masked), rotating and not, against their plain versions; the
    rotation lands in the neighbours' slots bit for bit and every flag
    returns to 0.  Shard 200 puts K4's 128-row query tile and its key tile
    (128 keys at head_dim 64, 64 at 128) across the shard's end; a wholly
    masked step must read exact zeros and POS_BIG (kernel_check.compare,
    compare_lse).  K5's 128-key tile (dQ split by columns at head dims 64
    and 128, by keys at 32 and 96) crosses the shard's end too."""
    _hold_ring_steps((2, 2, sl, d), dtype, sl + d,
                     ((0, True), (1, True), (0, False), (3, False)))


def _hold_ring_steps(shard, dtype, seed, steps):
    """K4 and K5 on a ring of 4 members of ``shard`` at each ``(t,
    rotate)`` of ``steps`` (member i holding member (i - t) % 4's K/V),
    every output under kernel_check's rule, the slots bit for bit, the
    flags balanced; every step kind must occur."""
    mesh = _ring()
    members, _, scale_r = kernel_check.ring_inputs(4, shard, dtype, seed)
    kinds = set()
    for t, rotate in steps:
        rows = kernel_check.hold_ring_round(mesh, members, t, scale_r,
                                            rotate=rotate)
        mesh.check()
        assert mesh.flags_balanced()
        for r in rows:
            kinds.add(r["kind"])
            assert r.get("slot_exact", True), (t, r)
            for name, e in r["errors"].items():
                assert e["worst"] <= 1.0, (t, r["kind"], name, e)
    assert kinds == {"diagonal", "visible", "masked"}


@pytest.mark.cuda
@pytest.mark.parametrize("shard", [(1, 2, 8192, 64), (1, 1, 4096, 128)])
def test_f32_ring_steps_at_a_long_causal_shard(cuda_device, shard):
    """K4 and K5 in float32 (the 3xTF32 bodies of
    csrc/flash_wide_f32_sm90.cuh at the step's offsets) on a ring of 4
    long shards: the diagonal (t = 0, rotating), wholly visible and wholly
    masked steps (t = 1, rotating; t = 3, the last step, not).  A sum
    chained over the 128 key tiles or 256 query steps of a shard would
    drift past the f32 rule (dq with its term)."""
    _hold_ring_steps(shard, torch.float32, shard[2] + shard[3],
                     ((0, True), (1, True), (3, False)))


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [100, -100])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_step_with_its_diagonal_inside_a_tile(cuda_device, dtype, d,
                                                   shift):
    """One K4 and one K5 launch whose offsets differ by ``shift`` (q_off -
    k_off, neither 0 nor a shard of 200 or more), against the plain
    versions at the same offsets: the diagonal crosses K4's 128-row query
    tiles and K5's key tiles inside, so the leading tiles that need no
    mask, K4's last key tile and K5's first query step must come from
    absolute positions.  At -100 query rows 0-99 see no key (o = 0, lse
    = POS_BIG): in f32 all 64 rows of K4's first consumer warpgroup, while
    the second's rows from 100 on see keys."""
    from horovod_tpu_torch.ops import ring_flash

    sl, k_off = 200, 400
    q_off = k_off + shift
    members, _, r = kernel_check.ring_inputs(1, (2, 2, sl, d), dtype,
                                             sl + d)
    m = members[0]
    ref, delta = kernel_check.ring_plain_step(m["qr"], m["k"], m["v"],
                                              m["do"], q_off, k_off, True, r)
    mesh = _ring()
    before = dict(ring_flash.launches)
    o, lse = ring_flash.ring_flash_fwd(mesh, 0, m["qr"], m["k"], m["v"],
                                       q_off, k_off, r, True)
    dk, dv, dq = ring_flash.ring_flash_bwd(
        mesh, 0, m["qr"], m["k"], m["v"], m["do"], ref["lse"], delta, q_off,
        k_off, r, True)
    torch.cuda.synchronize()
    assert {n: ring_flash.launches[n] - before[n] for n in before} == {
        "ring_flash_fwd": 1, "ring_flash_bwd": 1, "phase_closer": 0}
    got = {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
    for name, err in kernel_check.compare_outputs(got, ref, dtype).items():
        assert err["worst"] <= 1.0, (name, err)
    if shift < 0:
        assert bool((lse[:, :-shift] == tattn.POS_BIG).all())
        assert bool((o[:, :-shift] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_masked_f32_step_overwrites_freed_nans(cuda_device, d):
    """A wholly masked f32 ring step (every held key in the queries'
    future) loads nothing, yet writes all its outputs: o, lse, dk and dv
    land in the blocks of NaN-filled tensors of their sizes just freed
    (the caching allocator hands them back), and must read exact zeros
    and POS_BIG; the member's running dq total takes no add."""
    from horovod_tpu_torch.ops import ring_flash

    bh, sl = 4, 256
    members, _, r = kernel_check.ring_inputs(1, (1, bh, sl, d),
                                             torch.float32, d)
    m = members[0]
    ref, delta = kernel_check.ring_plain_step(m["qr"], m["k"], m["v"],
                                              m["do"], 0, sl, True, r)
    g = torch.Generator(device=cuda_device).manual_seed(d)
    dq_acc = torch.randn(bh, sl, d, device=cuda_device, generator=g)
    dq_before = dq_acc.clone()
    mesh = _ring()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # In the order and sizes the wrappers allocate: o, lse, then dk, dv.
    nans = [torch.full(shape, float("nan"), device=cuda_device)
            for shape in ((bh, sl, d), (bh, sl), (bh, sl, d), (bh, sl, d))]
    freed = {t.data_ptr() for t in nans}
    del nans
    o, lse = ring_flash.ring_flash_fwd(mesh, 0, m["qr"], m["k"], m["v"], 0,
                                       sl, r, True)
    dk, dv, dq = ring_flash.ring_flash_bwd(
        mesh, 0, m["qr"], m["k"], m["v"], m["do"], ref["lse"], delta, 0, sl,
        r, True, dq_acc=dq_acc)
    torch.cuda.synchronize()
    assert {t.data_ptr() for t in (o, lse, dk, dv)} == freed
    assert bool((o == 0).all()) and bool((lse == tattn.POS_BIG).all())
    assert bool((dk == 0).all()) and bool((dv == 0).all())
    assert dq is dq_acc and torch.equal(dq_acc, dq_before)


@pytest.mark.cuda
def test_k5_as_b2_matches_plain_backward(cuda_device):
    """K5 at B2's offsets (zero, no rotation) computes B2's function as f32
    partials, dq in q' units."""
    from horovod_tpu_torch.ops import ring_flash

    g = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v, do = (torch.randn(8, 256, 64, device=cuda_device, generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    p2, r = tattn._split_scale(64 ** -0.5)
    qr = (q * p2).to(torch.bfloat16)
    ref, delta = kernel_check.ring_plain_step(qr, k, v, do, 0, 0, True, r)
    dk, dv, dq = ring_flash.ring_flash_bwd(
        _ring(), 0, qr, k, v, do, ref["lse"], delta, 0, 0, r, True)
    assert dq.dtype == dk.dtype == torch.float32
    for name, got in (("dq", dq), ("dk", dk), ("dv", dv)):
        assert kernel_check.compare(got, ref[name], torch.bfloat16)[
            "worst"] <= 1.0, name


@pytest.mark.cuda
def test_ring_permute_is_bit_exact_with_its_vjp(cuda_device):
    from horovod_tpu_torch.ops import rdma

    mesh = _ring()
    g = torch.Generator(device=cuda_device).manual_seed(8)
    xs = [torch.randn(4, 96, 32, device=cuda_device, generator=g)
          .to(torch.bfloat16).requires_grad_() for _ in range(4)]
    ws = [torch.randn_like(x) for x in xs]
    for shift in (1, -1):
        outs = rdma.ring_permute(xs, mesh, shift=shift)
        for i, x in enumerate(xs):
            assert torch.equal(outs[(i + shift) % 4], x)
        grads = torch.autograd.grad(outs, xs, ws)
        for i in range(4):
            assert torch.equal(grads[i], ws[(i + shift) % 4])
    torch.cuda.synchronize()
    mesh.check()
    assert mesh.flags_balanced()


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [1, -1])
@pytest.mark.parametrize("nbytes", [16, 4 * 1024 * 1024 + 16,
                                    21 * 1024 * 1024 + 16])
def test_ring_permute_bit_exact_at_any_size(cuda_device, nbytes, shift):
    """K6 at one 16-byte vector, past the ring path's 4.2 MB shard by one,
    and past the two K6_HALF rounds a block holds at once (so its halves
    refill): every rotation bit for bit, every flag back at 0."""
    from horovod_tpu_torch.ops import rdma

    mesh = _ring()
    g = torch.Generator(device=cuda_device).manual_seed(nbytes % 97)
    xs = [torch.randn(nbytes // 2, device=cuda_device, generator=g)
          .to(torch.bfloat16) for _ in range(4)]
    before = rdma.launches["ring_permute"]
    outs = rdma.permute_shards(xs, mesh, shift, 0)
    torch.cuda.synchronize()
    assert rdma.launches["ring_permute"] == before + 4
    for i, x in enumerate(xs):
        assert torch.equal(outs[(i + shift) % 4], x), i
    mesh.check()
    assert mesh.flags_balanced()


@pytest.mark.cuda
def test_ring_permute_gives_up_and_raises(cuda_device):
    """K6 launched by one member alone: its destination never signals, so
    the bounded spins give up after 10 s (block 0's handshake or another
    block's wait at the gate, whichever passes its bound first), the error
    word is set, no block stores a byte (their reads of the shard land
    first), and the mesh raises where it checks."""
    from horovod_tpu_torch.ops import rdma
    from horovod_tpu_torch.parallel.mesh import NS_RDMA

    mesh = _ring()
    x = torch.ones(2 * 1024 * 1024, device=cuda_device,
                   dtype=torch.bfloat16)
    out = torch.zeros_like(x)
    table = (ctypes.c_void_p * 4)(*[out.data_ptr()] * 4)
    with mesh.on(0):
        tattn._launch(rdma._kernel_fn("hvdt_ring_permute"), x.data_ptr(),
                      ctypes.cast(table, ctypes.c_void_p),
                      x.numel() * x.element_size(), rdma.copy_blocks(4), 1,
                      mesh.flags.data_ptr(), mesh.go.data_ptr(),
                      mesh.err.data_ptr(), 0, 4, NS_RDMA,
                      mesh.next_epoch(0, NS_RDMA))
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="timed out"):
        mesh.check()
    assert torch.count_nonzero(out) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 80, 200])
def test_fused_ring_at_other_head_dims(cuda_device, d):
    """The fused ring at head dims 16 and 80 pads to 32 and 96 and launches
    K4, K5 and K7 as the JAX program does; at 200 it takes the reference's
    separable ring and launches none of them.  Values and gradients (f32)
    against the plain blockwise attention of the whole sequence, at the
    tolerances of test_ring_attention_matches_blockwise."""
    from horovod_tpu_torch.ops import rdma, ring_attention

    rf = importlib.import_module("horovod_tpu_torch.ops.ring_flash")
    mesh = _ring()
    g = torch.Generator(device=cuda_device).manual_seed(d)
    q, k, v, ct = (torch.randn(2, 2, 4 * 96, d, device=cuda_device,
                               generator=g) for _ in range(4))
    before = {**rf.launches, **rdma.launches}
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    out = torch.cat(ring_attention(*[list(t.chunk(4, dim=2)) for t in xs],
                                   mesh, causal=True, rotate_impl="fused"), 2)
    grads = torch.autograd.grad(out, xs, ct)
    ref_in = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = tattn.blockwise_attention(*ref_in, causal=True)
    ref_grads = torch.autograd.grad(ref, ref_in, ct)
    torch.cuda.synchronize()
    mesh.check()
    assert mesh.flags_balanced()
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a, b, atol=5e-4, rtol=5e-4)
    after = {**rf.launches, **rdma.launches}
    fused = d <= tattn.HEAD_DIMS[-1]
    assert {n: after[n] - before[n] for n in after} == {
        "ring_flash_fwd": 16 * fused, "ring_flash_bwd": 16 * fused,
        "phase_closer": 8 * fused, "ring_permute": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fused", "rdma", "ppermute"])
def test_ring_attention_matches_blockwise(cuda_device, mode):
    """ring_attention in every mode on the card (f32) against the plain
    blockwise attention of the whole sequence, values and gradients at
    tests/test_ops.py's ring tolerances (2e-5 and 5e-4: the ppermute and
    rdma modes differentiate through the online softmax, not by the flash
    backward); the fused mode launches K4, K5 and K7 as the JAX program
    does."""
    from horovod_tpu_torch.ops import rdma, ring_attention

    rf = importlib.import_module("horovod_tpu_torch.ops.ring_flash")
    mesh = _ring()
    g = torch.Generator(device=cuda_device).manual_seed(9)
    q, k, v, ct = (torch.randn(2, 2, 4 * 96, 64, device=cuda_device,
                               generator=g) for _ in range(4))
    before = {**rf.launches, **rdma.launches}
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    out = torch.cat(ring_attention(*[list(t.chunk(4, dim=2)) for t in xs],
                                   mesh, causal=True, rotate_impl=mode), 2)
    grads = torch.autograd.grad(out, xs, ct)
    ref_in = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = tattn.blockwise_attention(*ref_in, causal=True)
    ref_grads = torch.autograd.grad(ref, ref_in, ct)
    torch.cuda.synchronize()
    mesh.check()
    assert mesh.flags_balanced()
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a, b, atol=5e-4, rtol=5e-4)
    after = {**rf.launches, **rdma.launches}
    delta = {n: after[n] - before[n] for n in after}
    want = {"ring_flash_fwd": 0, "ring_flash_bwd": 0, "phase_closer": 0,
            "ring_permute": 0}
    if mode == "fused":
        want.update(ring_flash_fwd=16, ring_flash_bwd=16, phase_closer=8)
    elif mode == "rdma":
        want["ring_permute"] = 4 * 4 * 3
    assert delta == want


# --- the staging route: CUDA tensors through pinned host memory -------------


def _staging_rank():
    """One rank of the staging tests on this card: each op on CUDA tensors
    against the same op on their CPU copies (the engine's own route), on
    the current and on a non-default stream, and a tensor freed right
    after its async enqueue."""
    import horovod_tpu_torch.torch as hvd

    hvd.init(device="cuda:0")
    r, n = hvd.rank(), hvd.size()
    g = torch.Generator().manual_seed(r)
    for dtype in (torch.float32, torch.bfloat16, torch.float16, torch.float64,
                  torch.int32, torch.int64):
        tag = str(dtype)[6:]
        x = torch.randint(-8, 8, (37, 5), generator=g).to(dtype)
        xc = x.cuda()
        for avg in (False, True):
            got = hvd.allreduce(xc, average=avg, name=f"ar.{tag}.{avg}")
            want = hvd.allreduce(x, average=avg, name=f"ar.cpu.{tag}.{avg}")
            assert got.is_cuda and torch.equal(got.cpu(), want), (tag, avg)
        y = xc.clone()
        assert hvd.allreduce_(y, average=False, name=f"ar_.{tag}") is y
        assert torch.equal(y.cpu(), hvd.allreduce(x, average=False,
                                                  name=f"ar_.cpu.{tag}"))
        part = x[:r + 1]
        assert torch.equal(
            hvd.allgather(part.cuda(), name=f"ag.{tag}").cpu(),
            hvd.allgather(part, name=f"ag.cpu.{tag}"))
        assert torch.equal(
            hvd.broadcast(xc, n - 1, name=f"bc.{tag}").cpu(),
            hvd.broadcast(x, n - 1, name=f"bc.cpu.{tag}"))
        z = xc.clone()
        assert hvd.broadcast_(z, n - 1, name=f"bc_.{tag}") is z
        assert torch.equal(z.cpu(), hvd.broadcast(x, n - 1,
                                                  name=f"bc_.cpu.{tag}"))
    total = float(n * (n + 1) // 2)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        s = torch.full((1 << 16,), float(r + 1), device="cuda")
        out = hvd.synchronize(hvd.allreduce_async(s, average=False,
                                                  name="stream"))
    side.synchronize()
    assert torch.equal(out.cpu(), torch.full((1 << 16,), total))
    t = torch.full((1 << 20,), float(r + 1), device="cuda")
    h = hvd.allreduce_async(t, average=False, name="freed")
    del t
    junk = torch.full((1 << 20,), -7.0, device="cuda")  # may reuse t's block
    assert torch.equal(hvd.synchronize(h).cpu(),
                       torch.full((1 << 20,), total))
    del junk
    x = torch.ones(3, 2, device="cuda", requires_grad=True)
    (hvd.allreduce(x, average=False, name="grad") * (r + 1)).sum().backward()
    assert torch.equal(x.grad.cpu(), torch.full((3, 2), total))
    hvd.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("np_", [1, 2])
def test_staging_route_matches_the_cpu_route(cuda_device, np_):
    import functools
    import os

    from horovod_tpu_torch.runner import launch_fn

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    results = launch_fn(functools.partial(_staging_rank), np_, env=env,
                        timeout=300)
    for res in results:
        assert res.returncode == 0, res.stderr[-3000:]


def _staged_compression_rank():
    """One rank of the compression test on this card: each CUDA tensor's
    bucket against the same op on its CPU copy (the engine's own route):
    the same verdict in the decision log, the same wire and payload bytes,
    the same result bit for bit (fresh names: zero residuals)."""
    import os

    import horovod_tpu_torch.torch as hvd

    os.environ["HVD_TPU_COMPRESSION"] = "bf16"
    os.environ["HVD_TPU_COMPRESSION_MIN_BYTES"] = "8192"
    hvd.init(device="cuda:0")
    g = torch.Generator().manual_seed(hvd.rank())
    seen = {}
    for tag, dtype, n in (("big", torch.float32, 4096),
                          ("small", torch.float32, 64),
                          ("bf16", torch.bfloat16, 4096),
                          ("f16", torch.float16, 4096)):
        x = torch.randn(n, generator=g).to(dtype)
        for route, t in (("cuda", x.cuda()), ("cpu", x)):
            before = hvd.compression_report()["engine"]
            out = hvd.allreduce(t, average=False, name=f"{route}.{tag}")
            after = hvd.compression_report()
            mode = after["log"][-1]
            assert mode["name"] == f"{route}.{tag}", after["log"][-3:]
            eng = after["engine"]
            seen[route, tag] = (
                out.cpu(), mode["mode"],
                eng["wire_bytes"] - before["wire_bytes"],
                eng["payload_bytes"] - before["payload_bytes"])
        got, want = seen["cuda", tag], seen["cpu", tag]
        assert torch.equal(got[0].view(torch.uint8), want[0].view(torch.uint8))
        assert got[1:] == want[1:], (tag, got[1:], want[1:])
    assert seen["cuda", "big"][1] == "bf16" and seen["cuda", "small"][1] == \
        "none"
    for tag in ("bf16", "f16"):  # native width: wire == payload
        assert seen["cuda", tag][2] == seen["cuda", tag][3] == 8192
    hvd.shutdown()


@pytest.mark.cuda
def test_staged_buckets_get_the_cpu_routes_compression(cuda_device):
    import functools
    import os

    from horovod_tpu_torch.runner import launch_fn

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    results = launch_fn(functools.partial(_staged_compression_rank), 2,
                        env=env, timeout=300)
    for res in results:
        assert res.returncode == 0, res.stderr[-3000:]


@pytest.mark.cuda
def test_size_1_cuda_collectives_make_no_host_copy(cuda_device,
                                                   monkeypatch):
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.torch import mpi_ops

    for var in ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_COORD",
                "HVD_TPU_DATA"):
        monkeypatch.delenv(var, raising=False)
    hvd.shutdown()
    hvd.init(device="cuda:0")
    try:
        before = mpi_ops.pinned_allocs[0]
        monkeypatch.setattr(mpi_ops, "_staged", None)  # never reached
        x = torch.arange(10.0, device=cuda_device)
        assert hvd.allreduce_(x, name="a") is x
        out = hvd.allreduce(x, name="b")
        assert out is not x and torch.equal(out, x)
        assert torch.equal(hvd.allgather(x, name="c"), x)
        assert torch.equal(hvd.broadcast(x, 0, name="d"), x)
        model = torch.nn.Linear(4, 2).to(cuda_device)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        model(torch.ones(3, 4, device=cuda_device)).sum().backward()
        grads = [p.grad.clone() for p in model.parameters()]
        opt.synchronize()
        for p, want in zip(model.parameters(), grads):
            assert torch.equal(p.grad, want)
        assert mpi_ops.pinned_allocs[0] == before
    finally:
        hvd.shutdown()


# --- the serving plane on the card ---------------------------------------


def _serving_lm(dtype):
    """A small served model on the card and its CPU twin (same weights)."""
    from horovod_tpu_torch.serving import engine as se

    spec = se.ModelSpec(vocab=97, d_model=64, n_layers=2, n_heads=2,
                        dtype=dtype, seed=1)
    params = se.init_params(spec)
    models = {}
    for dev in ("cuda", "cpu"):
        models[dev] = se.build_model(spec, device=dev)
        models[dev].load_state_dict(params)
    return spec, models


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_store_on_the_card_equals_the_cpu(cuda_device, dtype):
    """gather_context / scatter_new / scatter_bulk are indexing: the card's
    pages equal the CPU's bit for bit, trash block aside."""
    from horovod_tpu_torch.serving import kv_cache, prefill

    td = getattr(torch, dtype)
    g = torch.Generator().manual_seed(0)
    pages = torch.randn(2, 2, 11, 4, 2, 8, generator=g).to(td)
    tables = torch.tensor([[4, 1, 7, 10], [2, 10, 10, 10],
                           [10, 10, 10, 10]])
    k_new, v_new = torch.randn(2, 2, 3, 2, 5, 8, generator=g).to(td)
    lengths, n_new = torch.tensor([6, 1, 0]), torch.tensor([5, 2, 0])
    bulk = torch.randn(2, 2, 1, 2, 16, 8, generator=g).to(td)
    out = {}
    for dev in ("cpu", "cuda"):
        p = pages.clone().to(dev)
        kc, vc = kv_cache.gather_context(p, tables.to(dev))
        kv_cache.scatter_new(p, k_new.to(dev), v_new.to(dev), tables.to(dev),
                             lengths.to(dev), n_new.to(dev))
        prefill.scatter_bulk(p, bulk[0].to(dev), bulk[1].to(dev),
                             [5, 0, 9, 10], 11, 10)
        out[dev] = (kc.cpu(), vc.cpu(), p.cpu())
    for a, b in zip(out["cpu"], out["cuda"]):
        assert torch.equal(a[..., :10, :, :, :] if a.dim() == 6 else a,
                           b[..., :10, :, :, :] if b.dim() == 6 else b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_on_the_card_matches_the_cpu(cuda_device, dtype):
    """Three planned steps of ``make_step_fn`` on the card against the same
    steps on the CPU: pages (atol 1e-5 in float32, 2 bf16 units of the
    values in bfloat16) and, in float32, the sampled tokens (in bfloat16
    the two devices' roundings may flip a near tie); both are fed the
    CPU's tokens.  Then a bulk prefill (K1 once per layer) against the
    CPU's blockwise forward."""
    from horovod_tpu_torch.serving import engine as se
    from horovod_tpu_torch.serving import kv_cache, prefill
    from horovod_tpu_torch.serving.scheduler import Scheduler, ServeConfig

    spec, models = _serving_lm(dtype)
    cfg = ServeConfig(max_batch=3, prefill_chunk=4, block_tokens=4,
                      num_blocks=16, max_blocks_per_seq=8)
    atol = 1e-5 if dtype == "float32" else 2 * 2 ** -8 * 4
    steps = {dev: se.make_step_fn(models[dev], cfg)
             for dev in models}
    pages = {dev: kv_cache.init_pages(2, 2, 32, 16, 4, spec.torch_dtype,
                                      dev) for dev in models}
    sch = Scheduler(cfg)
    for n in (6, 3):
        sch.submit("t", list(range(1, n + 1)), 4)
    holder = type("E", (), {"cfg": cfg, "_trash": cfg.num_blocks})()
    for _ in range(3):
        plan = sch.step_plan()
        tables = se.ServingEngine._tables_array(holder, plan)
        tokens = torch.zeros(3, 4, dtype=torch.long)
        n_new = torch.zeros(3, dtype=torch.long)
        lengths = torch.zeros(3, dtype=torch.long)
        for sp in plan.slots:
            tokens[sp.slot, :sp.n_new] = torch.tensor(sp.tokens)
            n_new[sp.slot], lengths[sp.slot] = sp.n_new, sp.length
        got = {}
        for dev in models:
            got[dev], _ = steps[dev](
                pages[dev], *(t.to(dev) for t in (
                    tokens, n_new, lengths, torch.from_numpy(tables))))
        if dtype == "float32":
            assert torch.equal(got["cuda"].cpu(), got["cpu"])
        diff = (pages["cuda"].cpu().float() - pages["cpu"].float())[
            :, :, :-1].abs().max().item()
        assert diff <= atol, diff
        sch.complete_step(plan, got["cpu"].numpy())
    buf = torch.arange(300).remainder(97).int().numpy()
    before = tattn.launches["flash_fwd"]
    res = {dev: prefill.RingPrefill(models[dev])(buf, 290)
           for dev in models}
    assert tattn.launches["flash_fwd"] - before == spec.n_layers
    assert res["cuda"][2] == res["cpu"][2] or dtype != "float32"
    for i in (0, 1):
        assert (res["cuda"][i].cpu().float() - res["cpu"][i].float()).abs(
        ).max().item() <= 10 * atol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("seq", [256, 512, 768])
def test_k1_at_the_bulk_prefill_shapes(cuda_device, dtype, seq):
    """K1 alone at the shapes bulk prefill gives it (one request of 8
    heads, the bucketed prompt length, head dim 64)."""
    g = torch.Generator(device=cuda_device).manual_seed(seq)
    q, k, v = (torch.randn(8, seq, 64, device=cuda_device, generator=g)
               .to(dtype) for _ in range(3))
    p2, r = tattn._split_scale(64 ** -0.5)
    errs = kernel_check.hold_fwd((q * p2).to(dtype), k, v, r, True)
    assert max(e["worst"] for e in errs.values()) <= 1.0, errs


# --- the pipeline: EngineTransport's staging, the local pipeline -----------


def _transport_rank():
    """Rank 0 sends CUDA tensors (bf16 and f32) through
    ``EngineTransport``; rank 1 receives three in a row through its one
    bucket, each into a fresh device tensor, and sends their sum back."""
    import horovod_tpu_torch.common as hvd
    from horovod_tpu_torch.parallel import EngineTransport

    hvd.init(device="cuda:0")
    r = hvd.rank()
    shape = (2, 64, 32)
    sent = [torch.randn(shape, generator=torch.Generator().manual_seed(i))
            .to(dtype).cuda() for i, dtype in enumerate(
                (torch.bfloat16, torch.float32, torch.bfloat16))]
    transport = EngineTransport(tag=3)
    if r == 0:
        for i, t in enumerate(sent):
            transport.send(t, 1, f"act.{i}")
        back = transport.recv(shape, 1, "sum", "cuda:0")
        transport.flush()
        want = sum(t.float() for t in sent)
        assert back.is_cuda and back.dtype == torch.float32
        assert torch.equal(back.cpu(), want.cpu())
    else:
        got = [transport.recv(shape, 0, f"act.{i}", "cuda:0")
               for i in range(3)]
        bucket = next(iter(transport._buckets.values()))[0]
        assert bucket.is_pinned() and all(
            g.is_cuda and g.data_ptr() != bucket.data_ptr() for g in got)
        for g, t in zip(got, sent):  # earlier results not overwritten
            assert torch.equal(g.cpu(), t.float().cpu())
        transport.send(sum(got), 0, "sum")
        transport.flush()
    assert hvd.metrics_snapshot()["p2p"]["unmatched"] == 0
    hvd.shutdown()


@pytest.mark.cuda
def test_engine_transport_stages_cuda_tensors(cuda_device):
    import functools
    import os

    from horovod_tpu_torch.runner import launch_fn

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    results = launch_fn(functools.partial(_transport_rank), 2, env=env,
                        timeout=300)
    for res in results:
        assert res.returncode == 0, res.stderr[-3000:]


@pytest.mark.cuda
def test_local_pipeline_on_the_card_matches_the_cpu(cuda_device):
    """``run_local_pipeline`` at 2 stages x 2 chunks of a float32 LM
    (head dim 64, seq 128: K1 and B2 on the card, their plain versions on
    the CPU): loss and every gradient against the CPU run (float32 on two
    devices in two summation orders: loss rtol 1e-5, gradients atol 1e-4
    and rtol 1e-3), K1 and B2 once per layer and micro-batch."""
    import numpy as np

    from horovod_tpu_torch.models import TransformerLM, next_token_loss
    from horovod_tpu_torch.parallel import pipeline as P

    vocab, d_model, layers, heads, seq, batch, micro = 96, 128, 4, 2, 128, \
        4, 2
    state = TransformerLM(vocab, d_model, layers, heads, dtype=torch.float32,
                          device="cpu").state_dict()
    tokens = np.random.RandomState(3).randint(0, vocab, (batch, seq + 1))
    out = {}
    for dev in ("cpu", "cuda"):
        modules = P.partition_transformer(vocab, d_model, layers, heads, 2,
                                          2, dtype=torch.float32,
                                          device=dev)
        parts = P.partition_params(state, layers, 2, 2)
        for s in range(2):
            for c in range(2):
                modules[s][c].load_state_dict(parts[s][c])
        transport = P.LocalTransport()
        runners = [P.PipelineRunner(
            modules[s], P.PipelineGrid(2, 2, s), micro, transport,
            loss_fn=next_token_loss if s == 1 else None) for s in range(2)]
        before = dict(tattn.launches)
        loss, grads = P.run_local_pipeline(runners, tokens[:, :-1],
                                           tokens[:, 1:])
        launched = {n: tattn.launches[n] - before[n] for n in before}
        flat = {n: g.cpu() for stage in grads for tree in stage
                for n, g in tree.items()}
        out[dev] = (loss, flat, launched)
    assert out["cuda"][2] == {"flash_fwd": layers * micro,
                              "flash_bwd": layers * micro,
                              "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for name, want in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][name], want, atol=1e-4,
                                   rtol=1e-3, msg=name)
