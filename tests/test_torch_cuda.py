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
16-bit outputs, 1e-4 for float32 outputs and lse (summation order).
"""

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


def _close(got, want):
    return kernel_check.compare(got, want)["worst"] <= 1.0


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
        assert _close(got[name], ref[name]), name


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
    and the stats warp pads with POS_BIG."""
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
    for a, b in zip(g1, g2):
        assert _close(a, b)


@pytest.mark.cuda
def test_unsupported_cuda_input_raises(cuda_device):
    q = torch.randn(1, 1, 64, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        tattn.flash_attention(q, q, q, causal=True)
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
    mesh = _ring()
    members, _, scale_r = kernel_check.ring_inputs(4, (2, 2, sl, d), dtype,
                                                   sl + d)
    kinds = set()
    for t, rotate in ((0, True), (1, True), (0, False), (3, False)):
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
