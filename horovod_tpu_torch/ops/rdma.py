"""Ring rotation of per-member shards: the K6 kernel and its plain version.

Counterpart of ``horovod_tpu/ops/rdma.py``.  :func:`ring_permute` moves
every member's shard ``shift`` places up the ring of a
:class:`~horovod_tpu_torch.parallel.RingMesh`: member ``(i + shift) % n``
receives member ``i``'s shard, bit for bit.  It is differentiable: the VJP
of a rotation by ``shift`` is the rotation of the cotangents by
``-shift``, on the flipped namespace ``phase ^ 1`` of the same chain.

On the card each member launches K6 (``csrc/ring_permute.cu``), which
replaces ``_permute_kernel``: a ready handshake on the mesh's flag words,
then one copy into the destination's receive slot.  The receive slots of a
call are output tensors allocated for every member: a rotated shard is
kept by the separable ring for its backward, so a slot reused by a later
call would clobber it.  On the CPU the plain version copies the shard and
does the handshake's flag bookkeeping without waiting.

Namespace discipline (the reference's, ``rdma.py:23-34``): consecutive
rotations of one dependency chain alternate ``phase`` within a pair
(0/1 or 2/3), and independent chains use disjoint pairs; ``phase % 4`` is
the flag namespace.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from horovod_tpu_torch.ops import attention as A
from horovod_tpu_torch.parallel.mesh import NS_RDMA

COPY_BLOCKS = 32

# Kernel launches per wrapper, counted only where the kernel is launched.
launches = {"ring_permute": 0}

_P, _I, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
_ARGTYPES = {
    "hvdt_ring_permute": [_P, _P, _S, _I, _I, _P, _P, _P, _I, _I, _I, _I,
                          _P],
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _kernel_fn(symbol):
    from horovod_tpu_torch.ops import _build

    fn = getattr(_build.load("ring_permute"), symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
    return fn


def _check(xs, mesh):
    if len(xs) != mesh.size:
        raise ValueError(f"ring_permute: {len(xs)} shards for a ring of "
                         f"{mesh.size}")
    x0 = xs[0]
    for x in xs:
        if x.shape != x0.shape or x.dtype != x0.dtype:
            raise ValueError("ring_permute: the members' shards differ in "
                             "shape or dtype")
        if x.device != mesh.device:
            raise ValueError(f"ring_permute: shard on {x.device}, mesh on "
                             f"{mesh.device}")
    if mesh.on_cuda and (x0.numel() * x0.element_size()) % 16:
        raise ValueError("ring_permute: shard bytes must be a multiple of 16")


def permute_shards(xs: Sequence[torch.Tensor], mesh, shift: int,
                   phase: int) -> List[torch.Tensor]:
    """One rotation, no autograd: ``out[(i + shift) % n] = xs[i]``.  K6
    on the card (one launch per member, each on its member's stream), the
    plain slot copy on the CPU."""
    _check(xs, mesh)
    n = mesh.size
    shift %= n
    ns = NS_RDMA + phase % 4
    if not mesh.on_cuda:
        for i in range(n):
            mesh.plain_handshake(i, shift, ns)
        mesh.join(None)
        return [xs[(j - shift) % n].clone() for j in range(n)]
    xs = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in xs]
    table = (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs])
    table_ptr = ctypes.cast(table, ctypes.c_void_p)
    nbytes = xs[0].numel() * xs[0].element_size()
    fn = _kernel_fn("hvdt_ring_permute")
    caller = mesh.fork()
    for i in range(n):
        with mesh.on(i):
            A._launch(fn, xs[i].data_ptr(), table_ptr, nbytes, COPY_BLOCKS,
                      shift, mesh.flags.data_ptr(), mesh.go.data_ptr(),
                      mesh.err.data_ptr(), i, n, ns, mesh.next_epoch(i, ns))
        launches["ring_permute"] += 1
    mesh.join(caller)
    return outs


class _RingPermuteFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, shift, phase, *xs):
        ctx.args = (mesh, shift, phase)
        ctx.like = (xs[0].shape, xs[0].dtype, xs[0].device)
        return tuple(permute_shards(xs, mesh, shift, phase))

    @staticmethod
    def backward(ctx, *gs):
        mesh, shift, phase = ctx.args
        shape, dtype, device = ctx.like
        gs = [torch.zeros(shape, dtype=dtype, device=device) if g is None
              else g for g in gs]
        # The transpose of "send my shard +shift" is "send the cotangent
        # -shift", on the flipped namespace of the same chain, so the
        # composed forward+backward chain alternates, seam included.
        return (None, None, None,
                *permute_shards(gs, mesh, -shift, phase ^ 1))


def ring_permute(xs: Sequence[torch.Tensor], mesh, shift: int = 1,
                 phase: int = 0) -> List[torch.Tensor]:
    """Rotate the members' shards ``shift`` places up the ring
    (``lax.ppermute`` with ``[(i, (i + shift) % n)]``).  Differentiable.
    A chain of dependent rotations alternates ``phase`` (0, 1, 0, ... or
    2, 3, 2, ...); an independent chain uses the other pair."""
    return list(_RingPermuteFn.apply(mesh, int(shift), int(phase), *xs))
