"""Ring attention: attention over a sequence sharded across a ring mesh.

Counterpart of ``horovod_tpu/ops/ring_attention.py``.  Each member keeps
its query shard and passes its key/value shard round the ring of a
:class:`~horovod_tpu_torch.parallel.RingMesh`, merging partial results
with the online-softmax statistics.  ``rotate_impl`` says how K/V travel:

* ``"ppermute"`` — the plain rotation (member ``j`` takes member
  ``j - 1``'s shard) and the plain attend, the reference's ``lax.ppermute``
  ring;
* ``"rdma"`` — K6 rotations (:func:`horovod_tpu_torch.ops.rdma.ring_permute`),
  the K chain on phases 0/1 and the V chain on 2/3, alternating per step,
  and the plain attend;
* ``"fused"`` — :func:`horovod_tpu_torch.ops.ring_flash.fused_ring_attention`,
  the K4/K5/K7 kernels.

In the first two modes each step's attend is recomputed in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``), so no
step's (seq_local, seq_local) probability block is saved.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch.ops import attention as A


def _step_attend(q, k, v, m, l, acc, q_offset, k_offset, causal, sm_scale):
    mask = A._block_mask(0, k.shape[-2], q.shape[-2], causal, q.device,
                         q_offset, k_offset)
    return A._block_attend(q, k, v, m, l, acc, mask, sm_scale)


def ring_attention(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                   vs: Sequence[torch.Tensor], mesh, causal: bool = False,
                   sm_scale: Optional[float] = None,
                   rotate_impl: str = "ppermute") -> List[torch.Tensor]:
    """Attention over a sequence sharded across ``mesh``'s members.

    ``qs``, ``ks``, ``vs``: one ``(batch, heads, seq_local, head_dim)``
    shard per member; the global sequence is the concatenation of the
    shards in ring order, and ``causal`` masks over global positions.
    Returns the members' output shards, each of its ``q``'s shape and
    dtype.  Differentiable in every mode."""
    n = mesh.size
    if len(qs) != n or len(ks) != n or len(vs) != n:
        raise ValueError("ring_attention: one shard per member")
    if sm_scale is None:
        sm_scale = qs[0].shape[-1] ** -0.5
    if rotate_impl == "fused":
        from horovod_tpu_torch.ops.ring_flash import fused_ring_attention

        return fused_ring_attention(qs, ks, vs, mesh, causal=causal,
                                    sm_scale=sm_scale)
    if rotate_impl == "ppermute":
        def rotate(ts, phase):
            del phase
            return [ts[(j - 1) % n] for j in range(n)]
    elif rotate_impl == "rdma":
        from horovod_tpu_torch.ops.rdma import ring_permute

        def rotate(ts, phase):
            # The K and V chains are independent: each alternates within
            # its own namespace pair (K 0/1, V 2/3), see ops/rdma.py.
            return ring_permute(ts, mesh, shift=1, phase=phase)
    else:
        raise ValueError(f"unknown rotate_impl {rotate_impl!r}")

    sl = qs[0].shape[-2]
    state = [A._init_state(q, v.shape[-1]) for q, v in zip(qs, vs)]
    k_cur, v_cur = list(ks), list(vs)
    for t in range(n):
        for i in range(n):
            # After t right-rotations member i holds the shard that started
            # on member (i - t) mod n.
            state[i] = checkpoint(
                _step_attend, qs[i], k_cur[i], v_cur[i], *state[i], i * sl,
                ((i - t) % n) * sl, causal, sm_scale, use_reentrant=False)
        if t < n - 1:
            k_cur = rotate(k_cur, t % 2)
            v_cur = rotate(v_cur, 2 + t % 2)
    return [A._finalize(m, l, acc, q.dtype)
            for (m, l, acc), q in zip(state, qs)]
