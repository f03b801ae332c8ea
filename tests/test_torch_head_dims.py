"""Head dims that no kernel body takes, against horovod_tpu's, on the CPU.

The kernel bodies take head dims 32, 64, 96 and 128 (and 256: K1, K2,
K3; above 256, K1, K2 and K3's wide bodies take every multiple of 32);
``_FlashAttnFn``, the autograd function ``flash_attention`` runs on a
CUDA tensor, zero-pads any other head dim to the next body's and slices
the padded columns off.  On CPU tensors it runs the kernel wrappers'
plain branches on the padded tensors, so the padded path is held here
against the JAX package's ``flash_attention`` (Pallas in interpret mode),
at head dims 16, 48, 80 and 200, and at 288, 512 and 1024 on the wide
bodies' path (``bwd_mode`` on the caller's head dim is in
test_torch_bwd_plan.py).  ``fused_ring_attention`` pads up to 128 and
takes the reference's separable ring above 128 (at 200 and 512 here);
both are held against the JAX ring on the virtual CPU mesh.  A TransformerLM
at head dim 16 (d_model 64, 4 heads, as examples/jax_pipeline_transformer.py)
is held against the flax model.  Inputs come from numpy and feed both.
Tolerances: f32 summation order only (2e-5 for values, 1e-3 for
gradients through the autograd function, as test_torch_bwd_plan.py;
2e-5 / 5e-4 for the rings, as test_torch_ring.py; the LM as
test_torch_transformer.py).
"""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.jax.train import shard_map
from horovod_tpu.models import TransformerLM as FlaxLM
from horovod_tpu.models import next_token_loss as flax_loss
from horovod_tpu.ops import attention as jattn
from horovod_tpu.ops import ring_attention as jring_attention
from horovod_tpu_torch.models import TransformerLM, next_token_loss
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import from_flax_params
from horovod_tpu_torch.ops import attention as tattn
from horovod_tpu_torch.ops import kernel_check
from horovod_tpu_torch.ops import ring_attention as tring_attention
from horovod_tpu_torch.ops import ring_flash as trf
from horovod_tpu_torch.parallel import RingMesh

N = 4


def _arrays(shape, seed, count=4):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for _ in range(count)]


@pytest.mark.parametrize("d,body", [(1, 32), (16, 32), (32, 32), (33, 64),
                                    (48, 64), (80, 96), (100, 128),
                                    (128, 128), (129, 256), (200, 256),
                                    (256, 256), (257, 288), (288, 288),
                                    (300, 320), (512, 512), (1000, 1024)])
def test_padded_head_dim_is_the_next_body(d, body):
    assert tattn.padded_head_dim(d) == body


@pytest.mark.parametrize("d", [0, -1])
def test_head_dims_past_the_bodies_raise(d):
    """Only a head dim below 1 is past the bodies: above 256 the wide
    bodies take every multiple of 32."""
    with pytest.raises(ValueError, match="head_dim"):
        tattn.padded_head_dim(d)
    with pytest.raises(ValueError, match="head_dim"):
        tattn.fwd_key_tile(torch.bfloat16, d)


@pytest.mark.parametrize("d", [257, 288, 512, 1000, 1024])
def test_head_dims_above_256_take_the_wide_bodies(d):
    """Above 256 the body is the wide one at the next multiple of 32, and
    the CUDA argument check takes that head dim for K1, K2 and K3 alone."""
    body = tattn.padded_head_dim(d)
    assert body % tattn.WIDE_CHUNK == 0 and 0 <= body - d < 32
    assert tattn.padded_head_dim(body) == body
    tattn._check_cuda("flash_fwd", [torch.zeros(1, 4, body)], wide=True)
    with pytest.raises(ValueError, match="head_dim"):
        tattn._check_cuda("flash_bwd", [torch.zeros(1, 4, body)])
    if body != d:
        with pytest.raises(ValueError, match="head_dim"):
            tattn._check_cuda("flash_fwd", [torch.zeros(1, 4, d)], wide=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [16, 48, 80, 136, 200, 256, 288, 300, 1024])
def test_key_tiles_follow_the_padded_body(d, dtype):
    """The key tiles answer for the body that runs the padded head dim:
    the 16-bit forward 128 keys up to 64, 64 to 256 and 128 above (the
    wgmma wide body's FWD_KEYS); the f32 forward 64 at every head dim (the
    3xTF32 body's F32_FWD_KEYS); the split pair's, K3's, 64 keys in 16
    bits, and in f32 32 up to 256 (the 3xTF32 body's F32_DQ_KEYS) and 64
    above (the SIMT wide body's TK); no combined body above 128."""
    body = tattn.padded_head_dim(d)
    f32 = dtype == torch.float32
    f32_split_tile = 32 if body <= 256 else 64
    assert tattn.fwd_key_tile(dtype, d) == tattn.fwd_key_tile(dtype, body)
    assert tattn.fwd_key_tile(dtype, d) == (
        64 if f32 else (128 if body <= 64 or body > 256 else 64))
    assert tattn.bwd_key_tile("split", dtype, d) == (f32_split_tile if f32
                                                     else 64)
    if body <= 128:
        assert tattn.bwd_key_tile("combined", dtype, d) == (64 if f32
                                                             else 128)
    else:
        with pytest.raises(ValueError, match="combined"):
            tattn.bwd_key_tile("combined", dtype, d)


def _constants(source):
    """``{name: value}`` of the ``constexpr int`` constants of a kernel
    source in ops/csrc."""
    with open(os.path.join(os.path.dirname(tattn.__file__), "csrc",
                           source)) as f:
        return {k: int(v) for k, v in
                re.findall(r"constexpr int (\w+) = (\d+);", f.read())}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_wide_tile_constants_match_the_tables(dtype):
    """The wide bodies' tile and chunk constants, read from the sources,
    are attention.py's tables: the head-dim chunk (K3's SIMT body's DC,
    the 16-bit bodies' PANEL, the f32 bodies' F32_PANEL) is WIDE_CHUNK;
    the forward's key tile is FWD_KEYS of csrc/flash_wide_sm90.cuh in 16
    bits and F32_FWD_KEYS of csrc/flash_wide_f32_sm90.cuh in float32; the
    split mode's is K3's, DQ_KEYS of the 16-bit body and TK of
    csrc/flash_wide.cu (its SIMT body) in float32; the tensor-core bodies'
    windows (FWD_NP, DKDV_NP, DQ_NP; F32_FWD_NP, F32_DKDV_NP) and the
    16-bit ones' panels per chunk of S (CHUNK_PANELS) are
    _WIDE_WINDOW_PANELS, _WIDE_F32_WINDOW_PANELS and WIDE_CHUNK_PANELS.
    The plain side that holds a kernel walks these tiles, so the two
    cannot drift apart."""
    simt = _constants("flash_wide.cu")
    wgmma = _constants("flash_wide_sm90.cuh")
    tf32 = _constants("flash_wide_f32_sm90.cuh")
    assert simt["DC"] == _constants("sm90_common.cuh")["PANEL"] \
        == tf32["F32_PANEL"] == tattn.WIDE_CHUNK
    f32 = dtype == torch.float32
    fwd = tf32["F32_FWD_KEYS"] if f32 else wgmma["FWD_KEYS"]
    split = simt["TK"] if f32 else wgmma["DQ_KEYS"]
    for d in (257, 288, 512, 1000, 1024):
        assert tattn.fwd_key_tile(dtype, d) == fwd
        assert tattn.bwd_key_tile("split", dtype, d) == split
    assert wgmma["CHUNK_PANELS"] == tattn.WIDE_CHUNK_PANELS
    assert tattn._WIDE_WINDOW_PANELS == {
        "flash_fwd": wgmma["FWD_NP"], "flash_bwd_dkdv": wgmma["DKDV_NP"],
        "flash_bwd_dq": wgmma["DQ_NP"]}
    assert tattn._WIDE_F32_WINDOW_PANELS == {
        "flash_fwd": tf32["F32_FWD_NP"],
        "flash_bwd_dkdv": tf32["F32_DKDV_NP"]}
    # At and below 256 the f32 K3's 3xTF32 body and B2's (64 keys a CTA).
    for d in (32, 64, 96, 128, 256):
        assert tattn.bwd_key_tile("split", torch.float32, d) == \
            tf32["F32_DQ_KEYS"]
        if d <= 128:
            assert tattn.bwd_key_tile("combined", torch.float32, d) == \
                tf32["F32_DKDV_KEYS"]


def test_wgmma_header_is_the_generators_output():
    """csrc/wgmma_sm90.cuh is tools/torch_gen_wgmma.py's output, byte for
    byte (it is generated, never edited by hand), and carries the TF32
    shapes the f32 bodies issue (K1's windows of 32-128 columns, K2's
    halves of 16-64)."""
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_gen_wgmma", os.path.join(root, "tools", "torch_gen_wgmma.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    with open(gen.OUT) as f:
        text = f.read()
    assert text == gen.generate()
    for n in (16, 32, 48, 64, 96, 128):
        assert f"m64n{n}k8.f32.tf32.tf32" in text


@pytest.mark.parametrize("name,d,dtype,flops", [
    ("flash_fwd", 288, torch.bfloat16, 3 * (2 * 288 + 256)),
    ("flash_bwd_dkdv", 288, torch.bfloat16, 3 * (4 * 288 + 384)),
    ("flash_bwd_dq", 288, torch.bfloat16, 3 * (4 * 288 + 256)),
    ("flash_bwd_dq", 320, torch.bfloat16, 3 * (4 * 320 + 256)),
    ("flash_bwd_dq", 512, torch.bfloat16, 4 * (4 * 512 + 256)),
    ("flash_bwd_dkdv", 1000, torch.bfloat16, 11 * (4 * 1024 + 384)),
    ("flash_bwd_dq", 1000, torch.bfloat16, 8 * (4 * 1024 + 256)),
    ("flash_fwd", 288, torch.float32, 3 * (3 * 2 * 288 + 4 * 256)),
    ("flash_fwd", 512, torch.float32, 4 * (3 * 2 * 512 + 4 * 256)),
    ("flash_bwd_dkdv", 288, torch.float32, 3 * 3 * (4 * 288 + 512)),
    ("flash_bwd_dkdv", 512, torch.float32, 3 * 4 * (4 * 512 + 512))])
def test_wide_tensor_core_work(name, d, dtype, flops):
    """The wide bodies' tensor-core FLOP per pair: their column CTAs'
    recompute of the score products (at 1000, padded to 1024: K3's
    8 x (4 d + 2 W) against the caller's 6 d, 5.8x) and, in float32, three
    TF32 products for each, four for K1's P V (4-panel windows: 7.0x and
    6.5x the caller's 4 d and 8 d at 288, K2's shared by its two
    warpgroups); a head dim at or below 256 has no wide body, and K3's f32
    body has no tensor-core work (SIMT)."""
    assert tattn.wide_tensor_core_flops(name, d, dtype) == flops
    with pytest.raises(ValueError, match="wide body"):
        tattn.wide_tensor_core_flops(name, 256, dtype)
    with pytest.raises(ValueError, match="tensor-core"):
        tattn.wide_tensor_core_flops("flash_bwd_dq", d, torch.float32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [288, 512, 1024])
def test_wide_plain_side_matches_jax_in_16_bits(monkeypatch, d, dtype):
    """kernel_check's plain side in bf16 and fp16 at a wide head dim,
    walking the 16-bit wide forward's key tile (128 keys: two tiles of
    seq 256) and the split mode's for the backward (K3's 64 keys), against
    the JAX package's flash attention in the same dtype on the same
    128-key blocks (Pallas in interpret mode): o, dq, dk and dv.  Both
    round p to the dtype against the running max after each 128-key
    block, and p and ds before their products, so kernel_check's rule
    holds them: within 2 ulps of the dtype of |ref| + rms_row(ref) +
    rms(ref) / 16 (summation order and the odd rounding flip)."""
    monkeypatch.delenv("HVD_TPU_VMEM_LIMIT_MB", raising=False)
    b, h, s = 1, 2, 256
    tile = tattn.fwd_key_tile(dtype, d)
    assert tile == 128 and tattn.bwd_mode(s, d, b * h) == "split"
    jdtype = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}[
        dtype]
    q, k, v, ct = (torch.from_numpy(a).to(dtype)
                   for a in _arrays((b, h, s, d), seed=70 + d))
    to_j = lambda t: jnp.asarray(t.float().numpy()).astype(  # noqa: E731
        jdtype)
    out, vjp = jax.vjp(lambda a, b_, c: jattn.flash_attention(
        a, b_, c, causal=True, block_q=tile, block_k=tile),
        *map(to_j, (q, k, v)))
    want = dict(zip(("o", "dq", "dk", "dv"), (out, *vjp(to_j(ct)))))
    p2, r = tattn._split_scale(d ** -0.5)
    flat = lambda t: t.reshape(b * h, s, d)  # noqa: E731
    got, _ = kernel_check.plain_outputs(
        flat((q * p2).to(dtype)), flat(k), flat(v), flat(ct), True, r, p2,
        "split")
    for name, w in want.items():
        assert w.dtype == jdtype
        w = torch.from_numpy(np.array(w.astype(jnp.float32))).to(dtype)
        assert got[name].dtype == dtype
        err = kernel_check.compare(got[name], flat(w))
        assert err["worst"] <= 1.0, (name, err)


@pytest.mark.parametrize("d", [288, 512, 1024])
def test_wide_plain_side_matches_jax_in_f32(monkeypatch, d):
    """kernel_check's plain side in float32 at a wide head dim, walking the
    f32 wide forward's key tile (64 keys, F32_FWD_KEYS) and the split
    mode's for the backward (K3's 64 keys), against the JAX package's flash
    attention in float32 on the same 64-key blocks (Pallas in interpret
    mode): o, dq, dk and dv under kernel_check's f32 rule (1e-4 of |ref| +
    rms_row(ref) + rms(ref) / 16: summation order only)."""
    monkeypatch.delenv("HVD_TPU_VMEM_LIMIT_MB", raising=False)
    b, h, s = 1, 2, 256
    tile = tattn.fwd_key_tile(torch.float32, d)
    assert tile == 64 and tattn.bwd_mode(s, d, b * h) == "split"
    assert tattn.bwd_key_tile("split", torch.float32, d) == tile
    q, k, v, ct = (torch.from_numpy(a)
                   for a in _arrays((b, h, s, d), seed=90 + d))
    out, vjp = jax.vjp(lambda a, b_, c: jattn.flash_attention(
        a, b_, c, causal=True, block_q=tile, block_k=tile),
        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = dict(zip(("o", "dq", "dk", "dv"),
                    (out, *vjp(jnp.asarray(ct.numpy())))))
    p2, r = tattn._split_scale(d ** -0.5)
    flat = lambda t: t.reshape(b * h, s, d)  # noqa: E731
    got, _ = kernel_check.plain_outputs(
        flat(q * p2), flat(k), flat(v), flat(ct), True, r, p2, "split")
    for name, w in want.items():
        assert w.dtype == jnp.float32
        err = kernel_check.compare(got[name],
                                   flat(torch.from_numpy(np.array(w))))
        assert err["worst"] <= 1.0, (name, err)


def _record_wrappers(monkeypatch):
    """Patch the kernel wrappers to record (name, head dim) of each call."""
    called = []
    for name in ("flash_fwd", "flash_bwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        fn = getattr(tattn, name)
        monkeypatch.setattr(
            tattn, name,
            lambda *a, _f=fn, _n=name: called.append((_n, a[0].shape[-1]))
            or _f(*a))
    return called


# (shape, block of the JAX side): the mode both plans pick follows.
_CASES = {16: ((1, 2, 128, 16), 64), 48: ((1, 2, 128, 48), 64),
          80: ((1, 2, 96, 80), 32), 200: ((1, 2, 64, 200), 32),
          "48-split": ((1, 1025, 32, 48), 32),
          288: ((1, 2, 80, 288), 32), 512: ((1, 2, 64, 512), 32),
          1024: ((1, 1, 64, 1024), 32)}


@pytest.mark.parametrize("case", list(_CASES))
def test_padded_flash_attn_fn_matches_jax(monkeypatch, case):
    """``_FlashAttnFn`` on CPU tensors at a head dim no body takes: the
    wrappers see the padded head dim, the backward runs in the mode of
    the caller's head dim, and values and gradients match the JAX
    package's flash attention (interpret mode)."""
    monkeypatch.delenv("HVD_TPU_VMEM_LIMIT_MB", raising=False)
    shape, block = _CASES[case]
    b, h, s, d = shape
    mode = tattn.bwd_mode(s, d, b * h)
    assert jattn._bwd_plan(s, d, block, block, b * h)[0] == mode
    called = _record_wrappers(monkeypatch)
    q, k, v, ct = _arrays(shape, seed=40 + d)
    out, vjp = jax.vjp(lambda a, b_, c: jattn.flash_attention(
        a, b_, c, causal=True, block_q=block, block_k=block),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(ct))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    got_out = tattn._FlashAttnFn.apply(*ts, True, d ** -0.5)
    got = torch.autograd.grad(got_out, ts, torch.tensor(ct))
    body = tattn.padded_head_dim(d)
    assert called == [("flash_fwd", body)] + (
        [("flash_bwd", body)] if mode == "combined"
        else [("flash_bwd_dkdv", body), ("flash_bwd_dq", body)])
    assert got_out.shape == shape
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               atol=2e-5, rtol=2e-5)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3,
                                   rtol=1e-3, err_msg=name)


def _jmesh():
    return Mesh(np.array(jax.devices()[:N]), ("sp",))


def _jax_fused_ring(causal, q, k, v, ct):
    spec = P(None, None, "sp", None)
    fn = functools.partial(jring_attention, axis_name="sp", causal=causal,
                           rotate_impl="fused")

    def loss(q, k, v):
        out = shard_map(fn, mesh=_jmesh(), in_specs=(spec,) * 3,
                        out_specs=spec, check_vma=False)(q, k, v)
        return (out * ct).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 200, 512])
def test_fused_ring_at_other_head_dims_matches_jax(monkeypatch, d, causal):
    """The fused ring at head dim 16 runs K4/K5/K7's plain branches on
    shards padded to 32; at 200 and 512 it takes the reference's separable
    ring and none of them runs, so the wide bodies need nothing more there.
    Values and gradients against the JAX fused ring (which routes 200 and
    512 to its separable ring too)."""
    called = []
    for name in ("ring_flash_fwd", "ring_flash_bwd", "phase_closer"):
        fn = getattr(trf, name)
        monkeypatch.setattr(
            trf, name,
            lambda mesh, i, *a, _f=fn, _n=name, **kw: called.append(
                (_n, kw["k"].shape[-1] if "k" in kw else None))
            or _f(mesh, i, *a, **kw))
    q, k, v, ct = _arrays((1, 2, N * 16, d), seed=60 + d + causal)
    want, gwant = _jax_fused_ring(causal, *map(jnp.asarray, (q, k, v, ct)))
    mesh = RingMesh(N, "cpu")
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    shards = [list(t.chunk(N, dim=2)) for t in ts]
    out = torch.cat(tring_attention(*shards, mesh, causal=causal,
                                    rotate_impl="fused"), dim=2)
    grads = torch.autograd.grad((out * torch.tensor(ct)).sum(), ts)
    if d <= tattn.HEAD_DIMS[-1]:
        body = tattn.padded_head_dim(d)
        assert {n for n, _ in called} == {"ring_flash_fwd", "ring_flash_bwd",
                                          "phase_closer"}
        assert all(w in (body, None) for _, w in called)
        assert sum(n == "ring_flash_fwd" for n, _ in called) == N * N
    else:
        assert called == []
    np.testing.assert_allclose(out.detach().numpy(), want, atol=2e-5,
                               rtol=2e-5)
    for a, b in zip(grads, gwant):
        np.testing.assert_allclose(a.numpy(), b, atol=5e-4, rtol=5e-4)
    assert mesh.flags_balanced()


def _kernel_path(q, k, v, causal=True):
    """flash_attention as it runs on a CUDA tensor: ``_FlashAttnFn``."""
    return tattn._FlashAttnFn.apply(q, k, v, causal, q.shape[-1] ** -0.5)


@pytest.mark.parametrize("path", ["blockwise", "kernel"])
def test_lm_at_head_dim_16_matches_flax(monkeypatch, path):
    """TransformerLM at d_model 64 over 4 heads (head dim 16, as
    examples/jax_pipeline_transformer.py) against the flax model on the
    same weights: logits, loss and every parameter gradient.  ``kernel``
    routes attention through ``_FlashAttnFn`` (the padded kernels' path);
    ``blockwise`` is the CPU route of ``flash_attention``."""
    vocab, d_model, layers, heads, seq = 128, 64, 2, 4, 64
    if path == "kernel":
        monkeypatch.setattr(ttr, "flash_attention", _kernel_path)
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, vocab, (2, seq + 1)).astype(np.int32)
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    flax_model = FlaxLM(vocab_size=vocab, d_model=d_model, n_layers=layers,
                        n_heads=heads, dtype=jnp.float32, use_flash=True)
    params = flax_model.init(jax.random.PRNGKey(1), jnp.asarray(inp))[
        "params"]

    def loss_fn(p):
        logits = flax_model.apply({"params": p}, jnp.asarray(inp))
        return flax_loss(logits, jnp.asarray(tgt)), logits

    (loss, logits), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    model = TransformerLM(vocab, d_model, layers, heads, dtype=torch.float32,
                          use_flash=True, device="cpu")
    model.load_state_dict(from_flax_params(jax.device_get(params)),
                          strict=True)
    got_logits = model(torch.from_numpy(inp).long())
    got_loss = next_token_loss(got_logits, torch.from_numpy(tgt).long())
    got_loss.backward()
    np.testing.assert_allclose(got_logits.detach().numpy(),
                               np.asarray(logits), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=1e-4,
                               atol=1e-5)
    want = from_flax_params(jax.device_get(jgrads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)
