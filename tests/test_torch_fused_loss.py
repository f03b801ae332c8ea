"""horovod_tpu_torch's fused head and loss (``fused_next_token_loss``,
``TransformerLM(tokens, targets=)``) against horovod_tpu's, on the CPU.

The same flax weights (``models.convert.from_flax_params``) and numpy
tokens go through both packages, ``use_flash=False`` on the JAX side (its
blockwise scan; the port's model runs its own default attention, whose
CPU form is the same blockwise math).  Cases: seq 32 and 31 (2 x 31
tokens are not divisible by 8 chunks: the one-chunk fallback).

Tolerances:
- float32, the model's loss and every parameter gradient, and the
  function alone: ``tests/test_transformer.py``'s fused-loss parity (loss
  rtol 1e-6; gradients atol 1e-6, rtol 1e-5).
- bfloat16, the function alone: loss rtol 1e-6 (a float32 sum either
  way), gradients atol 1e-6, rtol 2**-8 (one bfloat16 rounding).  The
  dtype of each cotangent product follows the reference's: a chunk's
  d-hidden and d-head rounded to bfloat16, the d-head summed over the
  chunks in bfloat16, last chunk first.  At 2 x 32 tokens (another
  seed), summing it in float32 read 23x this limit, first chunk first
  36x, a bfloat16 product for d-hidden 5.8x; the sound function 0.

Also: the refusals under sequence parallelism, decode and K/V capture,
and no ``(tokens, vocab)`` tensor saved for the backward
(``torch.autograd.graph.saved_tensors_hooks``), where the logits path
saves several.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import TransformerLM as FlaxLM
from horovod_tpu.models import next_token_loss as flax_loss
from horovod_tpu.models.transformer import (
    fused_next_token_loss as flax_fused)
from horovod_tpu_torch.models import (TransformerLM, fused_next_token_loss,
                                      next_token_loss)
from horovod_tpu_torch.models.convert import from_flax_params
from horovod_tpu_torch.parallel import RingMesh

VOCAB, D_MODEL, LAYERS, HEADS, BATCH = 64, 16, 2, 2, 2
SEQS = (32, 31)
BF16_RTOL = 2.0 ** -8


def _tokens(seq):
    tokens = np.random.RandomState(seq).randint(
        0, VOCAB, (BATCH, seq + 1)).astype(np.int32)
    return tokens[:, :-1], tokens[:, 1:]


def _flax():
    return FlaxLM(vocab_size=VOCAB, d_model=D_MODEL, n_layers=LAYERS,
                  n_heads=HEADS, dtype=jnp.float32, use_flash=False)


@pytest.fixture(scope="module")
def flax_runs():
    """Per seq: the flax params and the fused loss and its gradients."""
    model = _flax()
    out = {}
    for seq in SEQS:
        inp, tgt = _tokens(seq)
        params = model.init(jax.random.PRNGKey(seq), jnp.asarray(inp))[
            "params"]
        loss, grads = jax.jit(jax.value_and_grad(lambda p: model.apply(
            {"params": p}, jnp.asarray(inp), targets=jnp.asarray(tgt))))(
                params)
        out[seq] = dict(params=jax.device_get(params), loss=float(loss),
                        grads=from_flax_params(jax.device_get(grads)))
    return out


def _port(params):
    model = TransformerLM(VOCAB, D_MODEL, LAYERS, HEADS, dtype=torch.float32,
                          device="cpu")
    model.load_state_dict(from_flax_params(params), strict=True)
    return model


@pytest.mark.parametrize("seq", SEQS)
def test_model_targets_match_flax_fused_loss(flax_runs, seq):
    want = flax_runs[seq]
    model = _port(want["params"])
    inp, tgt = (torch.from_numpy(x).long() for x in _tokens(seq))
    loss = model(inp, targets=tgt)
    np.testing.assert_allclose(loss.item(), want["loss"], rtol=1e-6)
    loss.backward()
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want["grads"])
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want["grads"][name].numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("seq", SEQS)
def test_model_targets_match_the_logits_path(flax_runs, seq):
    """The port's fused loss against its own logits path on float32
    logits, at the same tolerances (the reference's own test)."""
    inp, tgt = (torch.from_numpy(x).long() for x in _tokens(seq))
    fused, full = (_port(flax_runs[seq]["params"]) for _ in range(2))
    a = fused(inp, targets=tgt)
    b = next_token_loss(full(inp), tgt)
    np.testing.assert_allclose(a.item(), b.item(), rtol=1e-6)
    a.backward()
    b.backward()
    for (name, p), q in zip(fused.named_parameters(), full.parameters()):
        np.testing.assert_allclose(p.grad.numpy(), q.grad.numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=name)


def _function_case(seq, dtype):
    rng = np.random.RandomState(100 + seq)
    hidden = rng.standard_normal((BATCH, seq, D_MODEL)).astype(np.float32)
    w = (rng.standard_normal((D_MODEL, VOCAB)) / 4).astype(np.float32)
    tgt = rng.randint(0, VOCAB, (BATCH, seq))
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    h_j = jnp.asarray(hidden).astype(jdt)
    loss, (gh, gw) = jax.value_and_grad(
        lambda h, v: flax_fused(h, v, jnp.asarray(tgt), dtype=jdt),
        argnums=(0, 1))(h_j, jnp.asarray(w))
    h_t = torch.from_numpy(np.asarray(h_j.astype(jnp.float32))).to(
        dtype).requires_grad_()
    w_t = torch.from_numpy(w).requires_grad_()
    got = fused_next_token_loss(h_t, w_t, torch.from_numpy(tgt), dtype=dtype)
    got.backward()
    return (got.item(), h_t.grad, w_t.grad), (
        float(loss), np.asarray(gh.astype(jnp.float32)), np.asarray(gw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("seq", SEQS)
def test_function_matches_flax(seq, dtype):
    (loss, gh, gw), (want, want_h, want_w) = _function_case(seq, dtype)
    assert gh.dtype == dtype and gw.dtype == torch.float32
    rtol = 1e-5 if dtype == torch.float32 else BF16_RTOL
    np.testing.assert_allclose(loss, want, rtol=1e-6)
    np.testing.assert_allclose(gh.float().numpy(), want_h, atol=1e-6,
                               rtol=rtol)
    np.testing.assert_allclose(gw.numpy(), want_w, atol=1e-6, rtol=rtol)


def test_refusals():
    inp, tgt = (torch.from_numpy(x).long() for x in _tokens(32))
    ring = TransformerLM(VOCAB, D_MODEL, 1, HEADS, dtype=torch.float32,
                         device="cpu", seq_axis=RingMesh(4, "cpu"))
    with pytest.raises(ValueError, match="sequence parallelism"):
        ring(inp, targets=tgt)
    model = TransformerLM(VOCAB, D_MODEL, 1, HEADS, dtype=torch.float32,
                          device="cpu")
    with pytest.raises(ValueError, match="capture_kv"):
        model(inp, targets=tgt, capture_kv=True)
    _, (k, v) = model(inp, capture_kv=True)
    from horovod_tpu_torch.models import DecodeContext

    ctx = DecodeContext(k, v, torch.ones(BATCH, 32, dtype=torch.bool),
                        torch.full((BATCH, 1), 32))
    with pytest.raises(ValueError, match="decode_ctx"):
        model(inp[:, :1], targets=tgt[:, :1], decode_ctx=ctx)


def _largest_saved(fn):
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = fn()
    loss.backward()
    return max(sizes)


def test_no_tokens_by_vocab_tensor_is_saved():
    inp, tgt = (torch.from_numpy(x).long() for x in _tokens(32))
    model = TransformerLM(VOCAB, D_MODEL, LAYERS, HEADS, d_ff=48,
                          dtype=torch.float32, device="cpu")
    tokens_by_vocab = BATCH * 32 * VOCAB
    assert _largest_saved(lambda: model(inp, targets=tgt)) < tokens_by_vocab
    # The control: the logits path saves the whole logits.
    assert _largest_saved(lambda: next_token_loss(model(inp), tgt)) >= \
        tokens_by_vocab
