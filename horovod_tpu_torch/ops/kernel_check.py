"""How the attention kernels K1-K5 and B2 are held against their plain
versions.

One rule for ``chip_smoke.py``, ``tests/test_torch_cuda.py`` and
``tools/torch_kernel_control.py``.  The ring kernels K4 and K5 are held by
the same rule at absolute offsets (:func:`ring_plain_step`); an lse row
with no mass must carry the POS_BIG sentinel on both sides
(:func:`compare_lse`), and an all-zero output (a wholly masked step) must
be exactly zero.

The plain side rounds where the kernels round, so the limit can be tight:

* forward — the blockwise scan over key blocks of the forward body's key
  tile (``attention.fwd_key_tile``: 128 keys in 16 bits, 64 in float32):
  the running max advances per tile as in K1 and K4, so p is rounded to
  the storage dtype against the same max before its product with v;
* backward — p and ds rounded to the storage dtype before their products
  (``round_pds``), as B2, K2/K3, K5 and the reference's
  ``_bwd_block_math`` do, over key blocks of the kernel's key tile
  (``attention.bwd_key_tile``).

What is left is summation order (B2's and K5's dQ adds vary it from run
to run), ``expf`` against ``torch.exp``, and rounding: the final cast
can land one unit in the last place away, and where the two sides' s or
dp differ in the last f32 bit, a p or ds that lies near a rounding
midpoint rounds the other way.  One such flip moves
an output element by at most eps * p * |do| (for dv; likewise for the
others), which is bounded by the size of the output's own row.  So each
element must satisfy

    |got - ref| <= rtol * (|ref| + rms_row(ref) + rms(ref) / 16)

where rms_row is taken over the element's row (the last axis: head_dim,
or the sequence for lse) and rms(ref) / 16 is a floor for rows that all
but cancel (dq of the first query is ~0 by construction).  rtol is 2 eps
of the storage dtype for 16-bit outputs (two units in the last place:
bf16 0.0156, fp16 0.00195), and of the operands' dtype for K5's float32
partials when its inputs are 16-bit (p and ds are rounded to it before
their products, so one flip moves the f32 sum as much), and 1e-4 for
float32 outputs of float32 inputs and for lse,
which is float32 in every case (summation order only, ~1e-6 relative
expected).  ``worst`` is the largest error over its limit: the check
passes at ``worst <= 1``.

dq in float32 takes one term more.  Where a row's p sits on few keys,
dS = p (dP - delta) scale_r cancels: under a causal mask query row 0 sees
one key, so p = 1, o = v_0 and delta_0 = dO_0 . v_0 = dP_00, its dS and
dq are 0 in exact arithmetic, and each side returns its own rounding
residue of dP - delta times k_0.  The limit above assumes an output that
does not cancel, and its floor lies below that residue: the float32 plain
side itself reads up to 6 of it against one whose products are float64.
So the limit of dq grows by the rounding error that the cancellation lets
through, that of dP = dO v^T, a float32 sum over the head dim d.  Under
the probabilistic model of rounding (Higham and Mary, 2019) such a sum is
off by about sqrt(d) u a_ij, with a_ij = sum_c |dO_ic| |v_jc| and u =
eps32 = 2^-23; the errors pass through dS with the factor p_ij scale_r and
are summed over the keys with independent signs, so

    noise_ic = sqrt(d) eps32 |scale_r p2| sqrt(sum_j (p_ij a_ij)^2 k_jc^2)

is added to dq's limit (p2 the pow2 factor dq carries; the constant is 1).
It is computed on the plain side's own p over the same key blocks
(``attention._attention_bwd_impl(..., dq_noise=True)``, two products a
block) and travels beside dq as ``dq_noise``.  Where p is spread over many
keys it adds a few percent to the limit (median 1.5-11% at head dims 32-256
on query rows 8 on), so a body with one TF32 product still fails by 20x and
more.  The worst-case bound gamma_d = d u on sum_j p_ij a_ij |k_jc| is not
used: it would raise the limit of rows past the first ones several times
over (a median 3.4x at head dim 64, 7.7x at 128), a loosening and no
measure of rounding.  o, lse, dk, dv and every 16-bit limit keep the rule
above; :func:`compare_first_rows` reports dq's first rows under both.
"""

from __future__ import annotations

import torch

from horovod_tpu_torch.ops import attention as A


def plain_outputs(qr, k, v, do, causal, scale_r, p2, mode="combined"):
    """``{o, lse, dq, dk, dv}`` of the plain versions on the kernels'
    inputs, rounded where the kernels round (the backward over the key
    tiles of ``mode``'s body; in float32 dq's term ``dq_noise`` too), and
    the ``delta`` of that o."""
    o, lse = A._blockwise_fwd_impl(
        qr, k, v, causal, scale_r,
        block_size=A.fwd_key_tile(qr.dtype, qr.shape[-1]))
    delta = A._delta(o, do)
    return {"o": o, "lse": lse,
            **plain_bwd_outputs(qr, k, v, do, lse, delta, p2, scale_r,
                                causal, mode)}, delta


def plain_bwd_outputs(qr, k, v, do, lse, delta, p2, scale_r, causal,
                      mode="combined"):
    """``{dq, dk, dv}`` of the plain backward that holds ``mode``'s body:
    p and ds rounded as the kernels round them, keys walked in the body's
    key tile (:func:`attention.bwd_key_tile`); in float32 also
    ``dq_noise``, the term dq's limit gains (module docstring)."""
    out = A._attention_bwd_impl(
        qr, k, v, lse, delta, do, causal, scale_r,
        block_size=A.bwd_key_tile(mode, qr.dtype, qr.shape[-1]),
        dq_scale=p2,
        round_pds=True, dq_noise=qr.dtype == torch.float32)
    return dict(zip(("dq", "dk", "dv", "dq_noise"), out))


def path_dq_noise(q, k, v, do, causal, sm_scale=None):
    """dq's term (module docstring) for a float32 dq of ``flash_attention``
    held against the plain blockwise path on ``(..., seq, head_dim)``
    inputs at the caller's ``sm_scale``: from the plain forward's lse and
    o and the plain backward's own p."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    flat = [t.reshape(-1, *t.shape[-2:]).float() for t in (q, k, v, do)]
    o, lse = A._blockwise_fwd_impl(*flat[:3], causal, sm_scale)
    noise = A._attention_bwd_impl(*flat[:3], lse, A._delta(o, flat[3]),
                                  flat[3], causal, sm_scale,
                                  dq_noise=True)[3]
    return noise.reshape(q.shape)


def kernel_bwd_outputs(qr, k, v, do, lse, delta, p2, scale_r, causal,
                       mode="combined"):
    """``{dq, dk, dv}`` of the backward in ``mode``: B2 (``combined``) or
    K2 + K3 (``split``)."""
    dk, dv, dq = A.flash_backward(mode, qr, k, v, do, lse, delta, scale_r,
                                  p2, causal)
    return {"dq": dq, "dk": dk, "dv": dv}


def kernel_outputs(qr, k, v, do, lse, delta, p2, scale_r, causal,
                   mode="combined"):
    """``{o, lse, dq, dk, dv}`` of K1 and the backward in ``mode`` on the
    plain side's inputs: the backward takes the plain lse and delta, so
    each kernel is held alone."""
    o, lse_k = A.flash_fwd(qr, k, v, scale_r, causal)
    return {"o": o, "lse": lse_k,
            **kernel_bwd_outputs(qr, k, v, do, lse, delta, p2, scale_r,
                                 causal, mode)}


def hold_fwd(qr, k, v, scale_r, causal) -> dict:
    """``{o, lse: {max_abs_err, worst}}`` of K1 alone against the plain
    forward over its key tile."""
    o, lse = A._blockwise_fwd_impl(
        qr, k, v, causal, scale_r,
        block_size=A.fwd_key_tile(qr.dtype, qr.shape[-1]))
    got_o, got_lse = A.flash_fwd(qr, k, v, scale_r, causal)
    return {"o": compare(got_o, o), "lse": compare_lse(got_lse, lse)}


def tf32_split(x):
    """``(hi, lo)`` of a float32 tensor as the wide f32 bodies split their
    operands (csrc/flash_wide_f32_sm90.cuh, ``split``): hi = x rounded to
    TF32 (10 mantissa bits) to nearest with ties away from zero, as
    ``cvt.rna.tf32.f32`` rounds, and lo = x - hi rounded the same way.
    Both come back as float32 tensors whose 13 low mantissa bits are 0."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        # Half a TF32 unit added to the magnitude bits, then truncated:
        # the sign bit stays, so ties round away from zero.
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    x = x.float()
    hi = rna(x)
    return hi, rna(x - hi)


def tf32_split3(x):
    """``(hi, lo, lo2)``: :func:`tf32_split`'s hi and lo and the rest x -
    hi - lo rounded the same way, as the f32 K1 splits V
    (csrc/flash_wide_f32_sm90.cuh, ``split3``); hi + lo + lo2 is x
    exactly (the rest has at most 3 significant bits)."""
    hi, lo = tf32_split(x)
    return hi, lo, tf32_split(x.float() - hi - lo)[0]


def mm_3xtf32(a, b, products=3):
    """``a @ b`` as the f32 tensor-core bodies compute every product: each
    operand split by :func:`tf32_split` and hi.hi + hi.lo + lo.hi summed
    in float32 (``products=1``: hi.hi alone, a single TF32 product;
    ``products=4``: K1's P V, which adds a's hi times b's rest,
    :func:`tf32_split3`, so that a row of P that is one key's 1 returns
    that key's row of b exactly).  The TF32 products are exact in float32
    (11 x 11 significant bits)."""
    ah, al = tf32_split(a)
    bh, bl, bl2 = tf32_split3(b)
    out = torch.matmul(ah, bh)
    if products >= 3:
        out = out + torch.matmul(ah, bl) + torch.matmul(al, bh)
    if products == 4:
        out = out + torch.matmul(ah, bl2)
    return out


def rtol(dtype) -> float:
    if dtype == torch.float32:
        return 1e-4
    return 2 * torch.finfo(dtype).eps


def compare(got, want, rounded=None, noise=None) -> dict:
    """``max_abs_err`` and ``worst`` (largest error over its limit) of
    ``got`` against ``want``, under the rule of this module.  ``rounded``
    is the dtype the operands were rounded to where it is narrower than
    the output's (K5's f32 partials from 16-bit p and ds): rtol is then
    that dtype's.  ``noise``: float32 dq's term (the plain side's
    ``dq_noise``), added to the limit element by element.  Where ``want``
    is all zeros (a wholly masked ring step) and no noise is given the
    limit is 0: only exact zeros pass."""
    err, over = _err_over_limit(got, want, rounded, noise)
    return {"max_abs_err": err.max().item(), "worst": over.max().item()}


def _err_over_limit(got, want, rounded=None, noise=None):
    """``(|got - want|, that over its limit)`` element by element."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    return err, err / _limit(w, want.dtype, rounded, noise)


def _limit(w, dtype, rounded=None, noise=None):
    """The limit of each element of the float32 reference ``w`` (of
    ``dtype``), with ``noise`` added where given."""
    row = w.square().mean(dim=-1, keepdim=True).sqrt()
    floor = w.square().mean().sqrt() / 16
    tol = max(rtol(dtype), rtol(rounded or dtype))
    limit = tol * (w.abs() + row + floor)
    if noise is not None:
        limit = limit + noise
    return limit.clamp_min(torch.finfo(torch.float32).tiny)


def compare_first_rows(got, want, first=8, noise=None) -> dict:
    """:func:`compare` of ``(bh, s, d)`` outputs with its reading taken
    apart over the first ``first`` query rows and over the rest (the
    limits are :func:`compare`'s, of the whole tensor).  Under a causal
    mask query row 0 sees one key, so its dq is zero in exact arithmetic
    and each side returns its own rounding residue of dP - delta there.
    ``worst`` is read under the limit without dq's term, so the residue
    stays visible; given ``noise``, ``worst_new`` beside it is read under
    the limit with it, the one dq is held to."""
    err, over = _err_over_limit(got, want)
    if noise is not None:
        over_new = err / _limit(want.float(), want.dtype, noise=noise)
    out = {}
    for name, rows in ((f"rows_0_{first - 1}", slice(None, first)),
                       (f"rows_{first}_on", slice(first, None))):
        out[name] = {"max_abs_err": err[:, rows].max().item(),
                     "worst": over[:, rows].max().item()}
        if noise is not None:
            out[name]["worst_new"] = over_new[:, rows].max().item()
    return out


def compare_lse(got, want) -> dict:
    """:func:`compare` for an lse that may hold the POS_BIG sentinel of
    rows with no mass: the sentinel rows must be the same and hold
    POS_BIG exactly; the finite rows are held by the rule."""
    sentinel = want >= A.POS_BIG / 2
    if not torch.equal(got == A.POS_BIG, sentinel):
        return {"max_abs_err": float("inf"), "worst": float("inf")}
    if bool(sentinel.all()):
        return {"max_abs_err": 0.0, "worst": 0.0}
    return compare(torch.where(sentinel, 0.0, got),
                   torch.where(sentinel, 0.0, want))


def ring_plain_step(qr, k, v, do, q_offset, k_offset, causal, scale_r):
    """``{o, lse, dq, dk, dv}`` of the plain versions of K4 and K5 at
    absolute offsets, rounded where the kernels round (the gradients f32
    partials, dq in q' units; in float32 dq's term ``dq_noise`` too), and
    the ``delta`` of that o (K5 takes the plain lse and delta)."""
    o, lse = A._blockwise_fwd_impl(
        qr, k, v, causal, scale_r,
        block_size=A.fwd_key_tile(qr.dtype, qr.shape[-1]),
        q_offset=q_offset, k_offset=k_offset)
    delta = A._delta(o, do)
    out = A._attention_bwd_impl(
        qr, k, v, lse, delta, do, causal, scale_r,
        block_size=A.bwd_key_tile("combined", qr.dtype, qr.shape[-1]),
        round_pds=True, q_offset=q_offset, k_offset=k_offset,
        grad_dtype=torch.float32, dq_noise=qr.dtype == torch.float32)
    return {"o": o, "lse": lse,
            **dict(zip(("dq", "dk", "dv", "dq_noise"), out))}, delta


def compare_outputs(got, want, rounded=None) -> dict:
    """``{name: compare(...)}`` over K1-K5 outputs, lse (float32 from
    float32 logits) by its own rule, each output ``n`` with the term
    ``want[n + "_noise"]`` where the plain side gives one (float32 dq);
    ``rounded`` as in :func:`compare`."""
    return {n: compare_lse(got[n], want[n]) if n == "lse"
            else compare(got[n], want[n], rounded, want.get(n + "_noise"))
            for n in got}


def ring_inputs(n, shape, dtype, seed, device="cuda"):
    """Per-member ``{qr, k, v, do}`` shards ``(bh, sl, d)`` for a ring of
    ``n`` members of shard ``shape`` = (batch, heads, sl, d), and the
    ``(p2, scale_r)`` split of head_dim ** -0.5."""
    b, h, sl, d = shape
    g = torch.Generator(device=device).manual_seed(seed)
    p2, scale_r = A._split_scale(d ** -0.5)

    def mk():
        return torch.randn(b * h, sl, d, device=device, generator=g,
                           dtype=torch.float32).to(dtype)

    members = []
    for _ in range(n):
        q, k, v, do = mk(), mk(), mk(), mk()
        members.append({"qr": (q * p2).to(dtype), "k": k, "v": v, "do": do})
    return members, p2, scale_r


def hold_ring_round(mesh, members, t, scale_r, causal=True, rotate=True):
    """Ring step ``t`` on every member of ``mesh``: K4 then K5, each
    member on its stream, held against the plain versions; member ``i``
    holds member ``(i - t) % n``'s K/V.  Returns per member ``{errors:
    {o, lse, dq, dk, dv}, kind}`` and, when rotating, whether the right
    neighbours' receive slots hold the held K/V bit for bit.  The round
    raises if a spin gave up (``mesh.join``); the caller checks the flag
    balance."""
    from horovod_tpu_torch.ops import ring_flash as RF

    n = mesh.size
    sl = members[0]["qr"].shape[1]
    phase = t % 2
    refs = []
    for i in range(n):
        kv = (i - t) % n
        m = members[i]
        refs.append(ring_plain_step(m["qr"], members[kv]["k"],
                                    members[kv]["v"], m["do"], i * sl,
                                    kv * sl, causal, scale_r))
    mesh.slots(members[0]["k"].shape, members[0]["k"].dtype)
    fwd, bwd = [], []
    for i in range(n):
        kv = (i - t) % n
        common = dict(qr=members[i]["qr"], k=members[kv]["k"],
                      v=members[kv]["v"], q_offset=i * sl, k_offset=kv * sl,
                      scale_r=scale_r, causal=causal, rotate=rotate,
                      phase=phase)
        fwd.append(common)
        bwd.append(dict(common, do=members[i]["do"], lse=refs[i][0]["lse"],
                        delta=refs[i][1]))
    caller = mesh.fork()
    outs_f = RF.launch_round(mesh, RF.ring_flash_fwd, fwd)
    outs_b = RF.launch_round(mesh, RF.ring_flash_bwd, bwd)
    got = [{"o": o, "lse": lse, "dk": dk, "dv": dv, "dq": dq}
           for (o, lse), (dk, dv, dq) in zip(outs_f, outs_b)]
    mesh.join(caller)
    if mesh.on_cuda:
        torch.cuda.synchronize()
    out = []
    for i in range(n):
        kv = (i - t) % n
        kind = ("diagonal" if kv == i else
                "visible" if kv < i or not causal else "masked")
        row = {"member": i, "kind": kind,
               "errors": compare_outputs(got[i], refs[i][0],
                                         members[i]["qr"].dtype)}
        if rotate:
            ks, vs = mesh.slots(members[0]["k"].shape, members[0]["k"].dtype)
            dst = (i + 1) % n
            row["slot_exact"] = bool(
                torch.equal(ks[dst, phase], members[kv]["k"])
                and torch.equal(vs[dst, phase], members[kv]["v"]))
        out.append(row)
    return out
