"""horovod_tpu_torch's ring ops against horovod_tpu's, on the CPU.

The JAX side runs as tests/test_ops.py runs it: ``shard_map`` over a ring
of 4 devices of the virtual 8-device CPU mesh, Pallas in interpret mode
(which skips the handshakes).  The port runs its plain versions on a
``RingMesh(4, "cpu")`` (which keep the handshakes' flag bookkeeping).
Inputs come from numpy and feed both.  Tolerances: exact for the
rotation; values at 2e-5 and gradients at 5e-4, as tests/test_ops.py
holds the JAX ring modes against the dense reference (f32 summation
order); bf16 at 3e-2, as tests/test_ops.py's bf16 fused case.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import horovod_tpu.ops.rdma as jrdma
import horovod_tpu.ops.ring_flash as jrf
from horovod_tpu.jax.train import shard_map
from horovod_tpu.ops import attention as jattn
from horovod_tpu.ops import ring_attention as jring_attention
from horovod_tpu_torch.ops import attention as tattn
from horovod_tpu_torch.ops import rdma as trdma
from horovod_tpu_torch.ops import ring_attention as tring_attention
from horovod_tpu_torch.parallel import RingMesh
from horovod_tpu_torch.parallel.mesh import N_NS

# The ops package re-exports the function under the module's name.
trf = importlib.import_module("horovod_tpu_torch.ops.ring_flash")

N = 4


def _jmesh(axis="sp"):
    return Mesh(np.array(jax.devices()[:N]), (axis,))


def _arrays(shape, seed, count=4):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for _ in range(count)]


def _shards(a, axis=2, requires_grad=False):
    t = torch.tensor(a, requires_grad=requires_grad)
    return t, list(t.chunk(N, dim=axis))


def test_rotation_phases_match_jax():
    for n in range(1, 9):
        assert trf.rotation_phases(n) == jrf._rotation_phases(n), n


@pytest.mark.parametrize("shift", [1, -1])
def test_ring_permute_values_and_vjp_match_jax(shift):
    x = np.arange(N * 8 * 128, dtype=np.float32).reshape(N, 8, 128)
    w = np.random.RandomState(0).rand(N, 8, 128).astype(np.float32)
    spec = P("r", None, None)

    def loss(x):
        rotated = shard_map(
            lambda t: jrdma.ring_permute(t, "r", shift=shift),
            mesh=_jmesh("r"), in_specs=spec, out_specs=spec,
            check_vma=False)(x)
        return (rotated * w).sum(), rotated

    (_, want), gwant = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(x))
    mesh = RingMesh(N, "cpu")
    xt, xs = _shards(x, axis=0, requires_grad=True)
    got = torch.cat(trdma.ring_permute(xs, mesh, shift=shift), dim=0)
    (ggot,) = torch.autograd.grad((got * torch.tensor(w)).sum(), xt)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(ggot.numpy(), np.asarray(gwant))
    assert mesh.flags_balanced()


def _jax_ring(mode, causal, q, k, v, ct):
    spec = P(None, None, "sp", None)
    fn = functools.partial(jring_attention, axis_name="sp", causal=causal,
                           rotate_impl=mode)

    def loss(q, k, v):
        out = shard_map(fn, mesh=_jmesh(), in_specs=(spec,) * 3,
                        out_specs=spec, check_vma=False)(q, k, v)
        return (out.astype(jnp.float32) * ct).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(out, np.float32), [np.asarray(g, np.float32)
                                         for g in grads]


def _torch_ring(mode, causal, q, k, v, ct, dtype=torch.float32):
    mesh = RingMesh(N, "cpu")
    ts = [torch.tensor(a).to(dtype).requires_grad_() for a in (q, k, v)]
    shards = [list(t.chunk(N, dim=2)) for t in ts]
    out = torch.cat(tring_attention(*shards, mesh, causal=causal,
                                    rotate_impl=mode), dim=2)
    grads = torch.autograd.grad((out.float() * torch.tensor(ct)).sum(), ts)
    return (out.detach().float().numpy(), [g.float().numpy() for g in grads],
            mesh)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["ppermute", "rdma", "fused"])
def test_ring_attention_matches_jax(mode, causal):
    q, k, v, ct = _arrays((1, 2, N * 32, 16), seed=3 + causal)
    want, gwant = _jax_ring(mode, causal, *map(jnp.asarray, (q, k, v, ct)))
    got, ggot, mesh = _torch_ring(mode, causal, q, k, v, ct)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    for a, b in zip(ggot, gwant):
        np.testing.assert_allclose(a, b, atol=5e-4, rtol=5e-4)
    # Every handshake's signal was consumed (plain bookkeeping).
    assert mesh.flags_balanced()


def test_fused_ring_bf16_matches_jax():
    q, k, v, ct = _arrays((2, 3, N * 16, 32), seed=9)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want, _ = _jax_ring("fused", True, *jb, jnp.asarray(ct))
    dense = np.asarray(jattn.mha_reference(*map(jnp.asarray, (q, k, v)),
                                           causal=True))
    got, _, _ = _torch_ring("fused", True, q, k, v, ct, torch.bfloat16)
    np.testing.assert_allclose(got, want, atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(got, dense, atol=3e-2, rtol=3e-2)


def _chains(phases):
    chains = {0: [], 1: []}
    for p in phases:
        chains[p // 2].append(p % 2)
    return chains


def test_rdma_phase_streams_match_jax(monkeypatch):
    """Both rotation chains (K on 0/1, V on 2/3) through forward and
    backward: the port's execution-order stream per chain is the JAX
    program's, alternating seam included."""
    jphases, tphases = [], []
    real_j, real_t = jrdma._ring_permute_raw, trdma.permute_shards

    def rec_j(x, axis_name, shift, interpret, phase):
        jphases.append(phase % 4)
        return real_j(x, axis_name, shift, interpret, phase)

    def rec_t(xs, mesh, shift, phase):
        tphases.append(phase % 4)
        return real_t(xs, mesh, shift, phase)

    monkeypatch.setattr(jrdma, "_ring_permute_raw", rec_j)
    monkeypatch.setattr(trdma, "permute_shards", rec_t)
    q, k, v, ct = _arrays((1, 1, N * 16, 8), seed=4)
    _jax_ring("rdma", False, *map(jnp.asarray, (q, k, v, ct)))
    _torch_ring("rdma", False, q, k, v, ct)
    jchains, tchains = _chains(jphases), _chains(tphases)
    assert tchains == jchains, (tphases, jphases)
    for stream in tchains.values():
        assert len(stream) == 2 * (N - 1)
        assert all(a != b for a, b in zip(stream, stream[1:])), tphases


def test_fused_phase_stream_matches_jax_schedule(monkeypatch):
    """The fused ring's launches through forward and backward: rotating
    K4 and K5 steps on ``_rotation_phases(n)`` of the JAX package, each
    pass closed by K7 on phase 1 (n even), so the whole stream
    alternates."""
    events = []
    real = trf.launch_round

    def rec(mesh, kernel, calls):
        if kernel is trf.phase_closer:
            events.append(("closer", 1))
        elif calls[0]["rotate"]:
            events.append((kernel.__name__, calls[0]["phase"]))
        return real(mesh, kernel, calls)

    monkeypatch.setattr(trf, "launch_round", rec)
    q, k, v, ct = _arrays((1, 1, N * 16, 8), seed=5)
    _torch_ring("fused", True, q, k, v, ct)
    want, closer = jrf._rotation_phases(N)
    assert closer
    fwd = [("ring_flash_fwd", p) for p in want] + [("closer", 1)]
    bwd = [("ring_flash_bwd", p) for p in want] + [("closer", 1)]
    assert events == fwd + bwd, events
    stream = [p for _, p in events]
    assert all(a != b for a, b in zip(stream, stream[1:]))


# (q_offset, k_offset) of the three kinds of ring step, shard 32.
_STEPS = {"diagonal": (32, 32), "visible": (64, 0), "masked": (0, 64)}


@pytest.mark.parametrize("kind", list(_STEPS))
def test_k4_plain_version_matches_jax_step_kernel(kind):
    """K4's plain version against the TPU kernel ``_step_kernel`` (the
    non-rotating variant, interpret mode) at absolute offsets, over two
    key blocks: o, and lse including the POS_BIG rows of a masked step."""
    q_off, k_off = _STEPS[kind]
    qr, k, v = _arrays((2, 32, 16), seed=6, count=3)
    want_o, want_lse, _, _ = jrf._ring_flash_step(
        *map(jnp.asarray, (qr, k, v)), q_off, k_off, causal=True,
        block_q=16, block_k=16, rotate=False, phase=0, axis_name="sp",
        interpret=True, scale_r=1.0)
    mesh = RingMesh(N, "cpu")
    o, lse = trf.ring_flash_fwd(mesh, 0, *map(torch.tensor, (qr, k, v)),
                                q_off, k_off, 1.0, True)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=2e-5, rtol=2e-5)
    if kind == "masked":
        assert (lse.numpy() == np.float32(tattn.POS_BIG)).all()
        assert not o.numpy().any()


@pytest.mark.parametrize("use", ["ring_diagonal", "ring_visible",
                                 "ring_masked", "b2"])
def test_k5_plain_version_matches_jax_combined_bwd(use):
    """K5's plain version against ``_combined_bwd_kernel`` (interpret
    mode): ring use at offsets, and B2's function at zero offsets (f32
    partials, dq in q' units; B2's own wrapper, which applies the pow2
    factor, is held in test_torch_bwd_plan.py)."""
    qr, k, v, do = _arrays((2, 32, 16), seed=7)
    if use == "b2":
        q_off = k_off = 0
    else:
        q_off, k_off = _STEPS[use.split("_")[1]]
    mesh = RingMesh(N, "cpu")
    o, lse = trf.ring_flash_fwd(mesh, 0, *map(torch.tensor, (qr, k, v)),
                                q_off, k_off, 1.0, True)
    delta = tattn._delta(o, torch.tensor(do))
    lse8 = np.broadcast_to(lse.numpy()[:, None, :], (2, 8, 32))
    delta8 = np.broadcast_to(delta.numpy()[:, None, :], (2, 8, 32))
    want = jattn._combined_bwd_call(
        *map(jnp.asarray, (qr, do, lse8, delta8, k, v)), q_off, k_off,
        causal=True, block_q=16, block_k=16, rotate=False,
        collective_id=None, axis_name=None, mesh_axes=(), interpret=True,
        scale_r=1.0, grad_dtype=jnp.float32)
    dk, dv, dq = trf.ring_flash_bwd(
        mesh, 0, *map(torch.tensor, (qr, k, v, do)), lse, delta, q_off,
        k_off, 1.0, True)
    for got, ref in zip((dk, dv, dq), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                                   rtol=2e-5)


def test_blockwise_offsets_match_jax():
    """``blockwise_attention``'s q_offset/k_offset (the separable ring's
    building block), values and gradients."""
    q, k, v, ct = _arrays((1, 2, 64, 16), seed=8)

    def jfn(q, k, v):
        return jattn.blockwise_attention(q[:, :, 32:], k, v, causal=True,
                                         block_size=16, q_offset=32,
                                         k_offset=0)

    want, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    gwant = vjp(jnp.asarray(ct[:, :, 32:]))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    got = tattn.blockwise_attention(ts[0][:, :, 32:], ts[1], ts[2],
                                    causal=True, block_size=16, q_offset=32,
                                    k_offset=0)
    ggot = torch.autograd.grad(got, ts, torch.tensor(ct[:, :, 32:]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)
    for a, b in zip(ggot, gwant):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4,
                                   rtol=5e-4)


def test_ring_mesh_on_the_cpu():
    mesh = RingMesh(N, "cpu")
    assert mesh.members == [torch.device("cpu")] * N
    assert mesh.streams == [None] * N
    assert mesh.flags.shape == (N, N_NS) and mesh.flags_balanced()
    assert mesh.fork() is None
    mesh.check()
    k, v = mesh.slots((2, 8, 4), torch.float32)
    assert k.shape == v.shape == (N, 2, 2, 8, 4)
    assert mesh.slots((2, 8, 4), torch.float32)[0] is k
    assert [mesh.next_epoch(1, 4) for _ in range(2)] == [1, 2]
    mesh.err.fill_(1)
    with pytest.raises(RuntimeError, match="handshake timed out"):
        mesh.check()
    for size in (0, 9):
        with pytest.raises(ValueError, match="ring size"):
            RingMesh(size, "cpu")
    with pytest.raises(ValueError, match="one shard per member"):
        tring_attention([torch.zeros(1, 1, 4, 8)], [], [], RingMesh(2, "cpu"))
    with pytest.raises(ValueError, match="rotate_impl"):
        tring_attention(*[[torch.zeros(1, 1, 4, 8)] * 2] * 3,
                        RingMesh(2, "cpu"), rotate_impl="nccl")
