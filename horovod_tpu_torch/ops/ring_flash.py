"""Fused ring-flash attention: the K4, K5 and K7 kernels and their plain
versions.

Counterpart of ``horovod_tpu/ops/ring_flash.py``.  One ring step is one
kernel launch per member that attends the K/V shard the member holds while
the same launch copies that shard into its right neighbour's receive slot
(``csrc/ring_flash.cu``):

* K4 :func:`ring_flash_fwd` replaces ``_step_kernel``: ``(o, lse)`` of the
  member's pre-scaled queries over the held shard at absolute offsets.
* K5 :func:`ring_flash_bwd` replaces ``_combined_bwd_kernel`` with
  ``rotate=True``: f32 dK, dV and dQ partials from one recompute of P per
  tile pair, on the backward body that B2 (``attention.flash_bwd``) runs
  on the main path (``csrc/flash_bwd_sm90.cuh`` in 16 bits; in f32 the
  3xTF32 body of ``csrc/flash_wide_f32_sm90.cuh``, as K4's f32 forward is
  K1's).
* K7 :func:`phase_closer` replaces ``_phase_closer_kernel``: the handshake
  alone, closing a pass with an odd number of rotating steps.

:func:`fused_ring_attention` strings them into ``_fused_forward`` and
``_fused_backward`` of the reference, in one ``torch.autograd.Function``:
the steps merge in f32 (:func:`_merge`), the phase schedule is
:func:`rotation_phases`, the f32 dK/dV partials follow their shard round
the ring with a final hop to the owner, and dQ, accumulated in q' units,
is rescaled once.  The member streams fork off the caller's stream and
join back once per pass, and the join raises if a spin gave up
(``RingMesh.join``); between steps a member waits for an event of its
left neighbour's previous step (the write into its slot), which is what
the data dependence on ``k_next``/``v_next`` gives the JAX program.

On the CPU every wrapper runs its plain version: K4 the blockwise scan at
offsets, K5 the plain combined backward at offsets, the copy a slot copy,
K7 zeros; the handshake's flag bookkeeping is kept and its wait skipped,
as the reference's interpret mode skips it.  On the card nothing on this
path calls a plain version, and a kernel that cannot take its input
raises.

Left out as TPU-only (the reference's ``lse8``/``delta8`` sublane
broadcasts, the VMEM ``_bwd_plan`` route of long shards to the separable
ring, the multi-axis interpret fallback, ``_pick_block``'s 128-multiples):
the kernels mask any shard length.  Kept: above head_dim 128, where the
reference's plan is never the combined kernel, the fused mode takes the
reference's separable ppermute ring (:func:`fused_ring_attention`); a
head_dim up to 128 that no body takes runs zero-padded.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from horovod_tpu_torch.ops import attention as A
from horovod_tpu_torch.parallel.mesh import NS_FUSED

# Copy blocks of a rotating K4/K5 launch: each holds a whole SM while it
# waits for the handshake; on the H100, 16 copy the shard as fast as 32 and
# faster than 8 (tools/torch_ring_copy_blocks.py, PERF.md).
COPY_BLOCKS = 16

# Kernel launches per wrapper, counted only where the kernel is launched.
launches = {"ring_flash_fwd": 0, "ring_flash_bwd": 0, "phase_closer": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_RING = [_P, _P, _P, _I, _I, _I, _I]  # flags, go, err, my, n, ns, epoch
_ARGTYPES = {
    "hvdt_ring_flash_fwd": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _F, _I, _P, _P, _I, _I] + _RING + [_P],
    "hvdt_ring_flash_bwd": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                            _I, _I, _I, _I, _I, _F, _I, _P, _P, _I, _I]
                           + _RING + [_P],
    "hvdt_phase_closer": [_P, _P, _P, _I, _I, _I, _P],
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def rotation_phases(n: int):
    """``(phases, needs_closer)`` of one fused pass over ``n`` members:
    ``phases[t]`` is the namespace (0/1) of rotating step ``t`` (the last
    step does not rotate), and ``needs_closer`` says whether a trailing
    :func:`phase_closer` on phase 1 makes the pass's stream even, so that
    consecutive passes (forward, backward, the next step) alternate."""
    phases = [t % 2 for t in range(n - 1)]
    return phases, len(phases) % 2 == 1


def _kernel_fn(stem, symbol):
    from horovod_tpu_torch.ops import _build

    fn = getattr(_build.load(stem), symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
    return fn


def _ring_args(mesh, member, ns, epoch):
    return (mesh.flags.data_ptr(), mesh.go.data_ptr(), mesh.err.data_ptr(),
            member, mesh.size, ns, epoch)


def _copy_args(mesh, member, k, rotate, phase):
    """(k_slots, v_slots, n_copy, phase, ring...) of a launch."""
    if not rotate:
        return (0, 0, 0, 0) + _ring_args(mesh, member, NS_FUSED, 0)
    ks, vs = mesh.slots(k.shape, k.dtype)
    ns = NS_FUSED + phase % 2
    return ((ks.data_ptr(), vs.data_ptr(), COPY_BLOCKS, phase % 2)
            + _ring_args(mesh, member, ns, mesh.next_epoch(member, ns)))


def _plain_copy(mesh, member, k, v, phase):
    """The copy's plain version: the handshake's bookkeeping, then k and v
    into the right neighbour's slot of this phase."""
    mesh.plain_handshake(member, 1, NS_FUSED + phase % 2)
    ks, vs = mesh.slots(k.shape, k.dtype)
    dst = (member + 1) % mesh.size
    ks[dst, phase % 2].copy_(k)
    vs[dst, phase % 2].copy_(v)


def _fwd_outputs(qr, **_):
    return (torch.empty_like(qr),
            torch.empty(qr.shape[:2], dtype=torch.float32, device=qr.device))


def ring_flash_fwd(mesh, member: int, qr, k, v, q_offset: int,
                   k_offset: int, scale_r: float, causal: bool,
                   rotate: bool = False, phase: int = 0, out=None):
    """K4: ``(o, lse)`` of member ``member``'s pre-scaled queries ``qr``
    over the held shard ``k``/``v`` (all ``(bh, s, d)``), the queries at
    absolute position ``q_offset`` and the keys at ``k_offset``.  o is in
    the input dtype, lse float32 ``(bh, sq)``, POS_BIG on rows with no
    mass.  With ``rotate`` the launch also copies k and v into the right
    neighbour's receive slot of ``phase`` (``mesh.slots``).  ``out``:
    preallocated ``(o, lse)`` (see :func:`launch_round`)."""
    if qr.device.type == "cpu":
        o, lse = A._blockwise_fwd_impl(qr, k, v, causal, scale_r,
                                       q_offset=q_offset, k_offset=k_offset)
        if rotate:
            _plain_copy(mesh, member, k, v, phase)
        return o, lse
    A._check_cuda("ring_flash_fwd", (qr, k, v))
    if k.shape != v.shape:
        raise ValueError("ring_flash_fwd: k and v shapes differ")
    bh, sq, d = qr.shape
    o, lse = _fwd_outputs(qr) if out is None else out
    A._launch(_kernel_fn("ring_flash", "hvdt_ring_flash_fwd"),
              A._DTYPE_CODE[qr.dtype], d, qr.data_ptr(), k.data_ptr(),
              v.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, sq, k.shape[1],
              int(q_offset), int(k_offset), float(scale_r), int(causal),
              *_copy_args(mesh, member, k, rotate, phase))
    launches["ring_flash_fwd"] += 1
    return o, lse


def _bwd_outputs(qr, k, dq_acc=None, **_):
    """(dk, dv, dq) of one K5 launch, f32: dq is ``dq_acc`` when given."""
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty_like(dk)
    if dq_acc is None:
        dq_acc = torch.empty(qr.shape, dtype=torch.float32, device=qr.device)
    return dk, dv, dq_acc


def ring_flash_bwd(mesh, member: int, qr, k, v, do, lse, delta,
                   q_offset: int, k_offset: int, scale_r: float,
                   causal: bool, rotate: bool = False, phase: int = 0,
                   dq_acc: Optional[torch.Tensor] = None, out=None):
    """K5: f32 partials ``(dk, dv, dq)`` of one step for the held shard,
    from one recompute of P; dq in q' units.  Given ``dq_acc`` (f32
    ``(bh, sq, d)``) this step's dq is added into it in place and it is
    returned.  With ``rotate`` the launch also copies k and v as K4 does.
    ``out``: preallocated outputs (see :func:`launch_round`)."""
    if qr.device.type == "cpu":
        dq, dk, dv = A._attention_bwd_impl(
            qr, k, v, lse, delta, do, causal, scale_r, round_pds=True,
            q_offset=q_offset, k_offset=k_offset, grad_dtype=torch.float32)
        if dq_acc is not None:
            dq = dq_acc.add_(dq)
        if rotate:
            _plain_copy(mesh, member, k, v, phase)
        return dk, dv, dq
    A._check_cuda("ring_flash_bwd", (qr, k, v, do), (lse, delta))
    if dq_acc is not None and not (
            dq_acc.dtype == torch.float32 and dq_acc.shape == qr.shape
            and dq_acc.is_contiguous()):
        raise ValueError("ring_flash_bwd: dq_acc takes f32 partials in q' "
                         "units of q's shape")
    bh, sq, d = qr.shape
    dk, dv, dq = _bwd_outputs(qr, k, dq_acc) if out is None else out
    A._launch(_kernel_fn("ring_flash", "hvdt_ring_flash_bwd"),
              A._DTYPE_CODE[qr.dtype], d, qr.data_ptr(), k.data_ptr(),
              v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
              dk.data_ptr(), dv.data_ptr(), dq.data_ptr(),
              int(dq_acc is None), bh, sq, k.shape[1], int(q_offset),
              int(k_offset), float(scale_r), int(causal),
              *_copy_args(mesh, member, k, rotate, phase))
    launches["ring_flash_bwd"] += 1
    return dk, dv, dq


def _closer_outputs(mesh, **_):
    return torch.empty((8, 128), dtype=torch.float32, device=mesh.device)


def phase_closer(mesh, member: int, out=None) -> torch.Tensor:
    """K7: member ``member``'s handshake on the fused ring's phase 1, and
    an (8, 128) float32 zero block (``out`` if given)."""
    ns = NS_FUSED + 1
    out = _closer_outputs(mesh) if out is None else out
    if not mesh.on_cuda:
        mesh.plain_handshake(member, 1, ns)
        return out.zero_()
    A._launch(_kernel_fn("ring_permute", "hvdt_phase_closer"),
              out.data_ptr(), mesh.flags.data_ptr(), mesh.err.data_ptr(),
              member, mesh.size, ns)
    launches["phase_closer"] += 1
    return out


_OUTPUTS = {ring_flash_fwd: _fwd_outputs, ring_flash_bwd: _bwd_outputs,
            phase_closer: _closer_outputs}


def launch_round(mesh, kernel, calls):
    """``kernel(mesh, i, **calls[i])`` for every member ``i``, each on its
    stream, under the mesh's launch discipline: every member's outputs are
    allocated first, then the launches follow back to back, so no
    allocation can wait for the card while a launched kernel waits for a
    neighbour's launch.  Returns the members' results."""
    outs = []
    for i, call in enumerate(calls):
        if call.get("rotate"):
            mesh.slots(call["k"].shape, call["k"].dtype)
        with mesh.on(i):
            outs.append(_OUTPUTS[kernel](mesh=mesh, **call)
                        if mesh.on_cuda else None)
    results = []
    for i, call in enumerate(calls):
        with mesh.on(i):
            results.append(kernel(mesh, i, **call, out=outs[i]))
    return results


def _merge(o1, lse1, o2, lse2):
    """Flash-merge two partial results (the reference's ``_merge``):
    POS_BIG lse rows carry no mass.  Returns the merged output in float32,
    the running accumulator's dtype across the ring."""
    e1 = torch.where(lse1 > A.POS_BIG / 2, A.NEG_INF, lse1)
    e2 = torch.where(lse2 > A.POS_BIG / 2, A.NEG_INF, lse2)
    m = torch.maximum(e1, e2)
    both_empty = m <= A.NEG_INF / 2
    m_safe = torch.where(both_empty, 0.0, m)
    w1 = torch.where(e1 <= A.NEG_INF / 2, 0.0, torch.exp(e1 - m_safe))
    w2 = torch.where(e2 <= A.NEG_INF / 2, 0.0, torch.exp(e2 - m_safe))
    total = w1 + w2
    safe_total = torch.where(total == 0.0, 1.0, total)
    out = (o1.float() * (w1 / safe_total)[..., None]
           + o2.float() * (w2 / safe_total)[..., None])
    lse = torch.where(both_empty, A.POS_BIG, m_safe + torch.log(safe_total))
    return out, lse


def _shards(ts, bh, sl, d_body):
    """``(bh, sl, d_body)`` shards, zero-padded to the body's head dim."""
    return [A.pad_head(t.reshape(bh, sl, t.shape[-1]), d_body) for t in ts]


def _fused_forward(mesh, qs, ks, vs, causal, sm_scale):
    n = mesh.size
    b, h, sl, d = qs[0].shape
    bh, dp = b * h, A.padded_head_dim(d)
    p2, scale_r = A._split_scale(sm_scale)
    qr = _shards([(q * p2).to(q.dtype) for q in qs], bh, sl, dp)
    kc, vc = _shards(ks, bh, sl, dp), _shards(vs, bh, sl, dp)
    k_slots, v_slots = mesh.slots((bh, sl, dp), kc[0].dtype)
    phases, needs_closer = rotation_phases(n)
    out, lse = [None] * n, [None] * n
    keep = []  # every tensor a member stream touches, held until the join
    caller = mesh.fork()
    prev = [None] * n
    for t in range(n):
        rotate = t < n - 1
        calls = []
        for i in range(n):
            if t == 0:
                k_cur, v_cur = kc[i], vc[i]
            else:
                mesh.wait(i, prev[(i - 1) % n])
                k_cur = k_slots[i, phases[t - 1]]
                v_cur = v_slots[i, phases[t - 1]]
            calls.append(dict(qr=qr[i], k=k_cur, v=v_cur, q_offset=i * sl,
                              k_offset=((i - t) % n) * sl, scale_r=scale_r,
                              causal=causal, rotate=rotate,
                              phase=phases[t] if rotate else 0))
        steps = launch_round(mesh, ring_flash_fwd, calls)
        keep += [x for step in steps for x in step]
        events = []
        for i, (o_t, lse_t) in enumerate(steps):
            with mesh.on(i):
                keep += [out[i], lse[i]]
                if out[i] is None:
                    out[i], lse[i] = o_t, lse_t
                else:
                    out[i], lse[i] = _merge(out[i], lse[i], o_t, lse_t)
                events.append(mesh.record(i))
        prev = events
    if needs_closer:
        # Even ring: an odd number of rotating steps [0, 1, ..., 0]; close
        # the namespace stream on 1.
        keep += launch_round(mesh, phase_closer, [{}] * n)
    results = []
    for i in range(n):
        with mesh.on(i):
            results.append((out[i][..., :d].reshape(qs[i].shape)
                            .to(qs[i].dtype),
                            lse[i].reshape(qs[i].shape[:-1])))
    mesh.join(caller, [t for pair in results for t in pair])
    del keep
    return results


def _fused_backward(mesh, qs, ks, vs, outs, lses, gs, causal, sm_scale):
    n = mesh.size
    b, h, sl, d = qs[0].shape
    bh, dp = b * h, A.padded_head_dim(d)
    p2, scale_r = A._split_scale(sm_scale)
    qr = _shards([(q * p2).to(q.dtype) for q in qs], bh, sl, dp)
    kc, vc = _shards(ks, bh, sl, dp), _shards(vs, bh, sl, dp)
    dor = _shards(gs, bh, sl, dp)
    delta = [A._delta(o, g).reshape(bh, sl).contiguous()
             for o, g in zip(outs, gs)]
    lse = [x.reshape(bh, sl).contiguous() for x in lses]
    k_slots, v_slots = mesh.slots((bh, sl, dp), kc[0].dtype)
    phases, needs_closer = rotation_phases(n)
    dq = [None] * n
    acc_k, acc_v = [None] * n, [None] * n
    keep = []
    caller = mesh.fork()
    prev = [None] * n
    for t in range(n):
        rotate = t < n - 1
        calls = []
        for i in range(n):
            if t == 0:
                k_cur, v_cur = kc[i], vc[i]
            else:
                mesh.wait(i, prev[(i - 1) % n])
                k_cur = k_slots[i, phases[t - 1]]
                v_cur = v_slots[i, phases[t - 1]]
            calls.append(dict(qr=qr[i], k=k_cur, v=v_cur, do=dor[i],
                              lse=lse[i], delta=delta[i], q_offset=i * sl,
                              k_offset=((i - t) % n) * sl, scale_r=scale_r,
                              causal=causal, rotate=rotate,
                              phase=phases[t] if rotate else 0,
                              dq_acc=dq[i]))
        steps = launch_round(mesh, ring_flash_bwd, calls)
        keep += [x for step in steps for x in step[:2]]
        events, new_k, new_v = [], [None] * n, [None] * n
        for i, (dk_t, dv_t, dq[i]) in enumerate(steps):
            with mesh.on(i):
                if t == 0:
                    new_k[i], new_v[i] = dk_t, dv_t
                else:
                    # The partials chase their K/V shard: one hop from the
                    # left neighbour, plus this member's contribution for
                    # the shard it now holds.
                    new_k[i] = acc_k[(i - 1) % n] + dk_t
                    new_v[i] = acc_v[(i - 1) % n] + dv_t
                events.append(mesh.record(i))
        keep += acc_k + acc_v
        acc_k, acc_v, prev = new_k, new_v, events
    if needs_closer:
        keep += launch_round(mesh, phase_closer, [{}] * n)
    grads = []
    for i in range(n):
        with mesh.on(i):
            # After the last step shard j's totals sit one hop left of j.
            mesh.wait(i, prev[(i - 1) % n])
            grads.append(((dq[i][..., :d] * p2).reshape(qs[i].shape)
                          .to(qs[i].dtype),
                          acc_k[(i - 1) % n][..., :d].reshape(ks[i].shape)
                          .to(ks[i].dtype),
                          acc_v[(i - 1) % n][..., :d].reshape(vs[i].shape)
                          .to(vs[i].dtype)))
    mesh.join(caller, [t for g in grads for t in g])
    del keep
    return grads


class _FusedRingFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, causal, sm_scale, *qkv):
        n = mesh.size
        qs, ks, vs = qkv[:n], qkv[n:2 * n], qkv[2 * n:]
        results = _fused_forward(mesh, qs, ks, vs, causal, sm_scale)
        outs = [o for o, _ in results]
        ctx.save_for_backward(*qkv, *outs, *[x for _, x in results])
        ctx.args = (mesh, causal, sm_scale)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        mesh, causal, sm_scale = ctx.args
        n = mesh.size
        saved = ctx.saved_tensors
        qs, ks, vs = saved[:n], saved[n:2 * n], saved[2 * n:3 * n]
        outs, lses = saved[3 * n:4 * n], saved[4 * n:]
        gs = [torch.zeros_like(o) if g is None else g
              for g, o in zip(gs, outs)]
        grads = _fused_backward(mesh, qs, ks, vs, outs, lses, gs, causal,
                                sm_scale)
        return (None, None, None, *[g[0] for g in grads],
                *[g[1] for g in grads], *[g[2] for g in grads])


def fused_ring_attention(qs: Sequence[torch.Tensor],
                         ks: Sequence[torch.Tensor],
                         vs: Sequence[torch.Tensor], mesh,
                         causal: bool = False,
                         sm_scale: Optional[float] = None
                         ) -> List[torch.Tensor]:
    """Ring attention with the rotation fused into the flash kernels.

    Same contract as :func:`horovod_tpu_torch.ops.ring_attention`: per
    member shards ``(batch, heads, seq_local, head_dim)``, the global
    sequence the concatenation of the members' shards in ring order;
    returns the members' output shards.  Differentiable.  On the card the
    kernels take head_dim 32/64/96/128 in float32, float16 or bfloat16, at
    any shard length; a head_dim up to 128 that no body takes runs
    zero-padded to the next (``attention.padded_head_dim``), the scale the
    caller's.  Above head_dim 128 this takes the reference's own route, by
    choice and on the CPU too: its fused ring sends every shard whose
    backward plan is not the combined kernel to the separable ppermute
    ring, and the plan is never combined above 128
    (``horovod_tpu/ops/ring_flash.py::fused_ring_attention``), so
    ``ring_attention(..., rotate_impl="ppermute")`` runs and K4, K5 and K7
    do not launch.  Other inputs raise."""
    if len(qs) != mesh.size or len(ks) != mesh.size or len(vs) != mesh.size:
        raise ValueError("fused_ring_attention: one shard per member")
    if sm_scale is None:
        sm_scale = qs[0].shape[-1] ** -0.5
    if qs[0].shape[-1] > A.HEAD_DIMS[-1]:
        from horovod_tpu_torch.ops.ring_attention import ring_attention

        return ring_attention(qs, ks, vs, mesh, causal=causal,
                              sm_scale=sm_scale, rotate_impl="ppermute")
    return list(_FusedRingFn.apply(mesh, bool(causal), float(sm_scale),
                                   *qs, *ks, *vs))
