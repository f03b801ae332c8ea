"""Chip smoke test of horovod_tpu_torch: build, hold, train, report.

Run from the repository root on a machine with one CUDA GPU::

    python3 chip_smoke.py

Phases, one JSON line each:

1. ``device``  — the card's name and ``nvidia-smi`` name/power limit.
2. ``build``   — nvcc seconds per kernel source (all built in parallel).
3. ``kernels`` — K1 ``flash_fwd``, B2 ``flash_bwd`` (the combined
   backward, on the body K5 shares) and K2 ``flash_bwd_dkdv`` + K3
   ``flash_bwd_dq`` (the split pair) held against their plain PyTorch
   versions (``ops/attention.py``) on the same inputs, each backward
   against the plain side of its own key tile: bf16 and f32 at the main
   path's shape (16, 8, 1024, 64), fp16, a non-causal case, and a ragged
   length with head_dim 128.  Times (CUDA events, median after warm-up)
   of K1 and B2 (and K2 + K3 beside B2), their plain versions and the
   library yardstick
   (``scaled_dot_product_attention``, which the port never calls, timed
   under each backend that takes the shape: flash, memory-efficient and
   cuDNN; ``library_ms`` is the fastest).
4. ``model``   — a small TransformerLM on the card: the kernels' path
   against the plain blockwise path, logits and every gradient.
5. ``train``   — the main path: ``hvd.init()``, the bench-width
   TransformerLM (vocab 32768, d_model 512, 8 layers, 8 heads, d_ff 2048,
   bf16, bf16 logits), ``DistributedOptimizer(AdamW)`` and
   ``build_train_step``, batch 16 x seq 1024, 2 warm-up + 5 timed steps.
   Launch counters are zeroed just before and read just after: K1 and B2
   must have run 8 layers x 7 steps times, K2 and K3 never (the
   reference's plan picks the combined backward at this shape).
   Then ``split``, the split pair's own path: at a shape where the plan
   picks it (1040 batch-heads, seq 512, bf16) K2 and K3 (and B2 beside
   them) held against the plain version that walks their key tile;
   ``flash_attention`` forward and backward with the counters zeroed just
   before and read just after (K1, K2 and K3 once, B2 never), its
   gradients against the plain blockwise path; the times of K2, K3, their
   plain version and SDPA's backward there (K2's and K3's entries in the
   summary), and B2 against K2 + K3 there and at seq 8192 (64
   batch-heads) and 16384 (32), where the plan also picks the split pair.
6. ``ring_kernels`` — K4 ``ring_flash_fwd``, K5 ``ring_flash_bwd``, K6
   ``ring_permute`` and K7 ``phase_closer`` on a ring of 4 members
   co-located on the card (``RingMesh``, one stream each), shard
   (4, 8, 1024, 64): K4 and K5 in bf16 and f32 on diagonal, wholly
   visible and wholly masked steps, rotating and not, against their plain
   versions (POS_BIG lse rows must match, masked outputs be exactly 0),
   the rotated K/V in the neighbours' slots bit for bit; K6 bit-exact at
   shift +1 and -1 with its VJP; K7's zero block, and every flag word
   back at 0 after a fused forward + backward.
   Times of each kernel, its plain version and its library yardstick; K6
   also by CUDA events on the member streams around its four launches
   alone (``kernel_ms``), beside its round with the fork and join.
7. ``ring_model`` — a small f32 LM sequence-parallel over 4 members in the
   fused, rdma and ppermute modes against the unsharded model on the same
   weights and tokens: logits and every gradient to 1e-4, and the launch
   counts each mode implies.
8. ``ring_train`` — the slice's path at full width: the same bench-width
   LM sequence-parallel over 4 members (``RING_HEADLINE``), batch 4 x seq
   4096, fused ring, 2 warm-up + 5 timed steps; counters zeroed just
   before and read just after, which must equal, per member, layer and
   step, K4 n, K5 n and K7 2 (n = 4 is even).  Then ``ring_train_rdma``:
   two steps of the rdma ring at the same width, K6 2(n-1) forward +
   2(n-1) backward per member and layer.

Then the ``{"kernels": [...]}`` summary (K1-K7 and B2), the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  Any
failure raises: the script exits non-zero and prints no result line.
Tolerances (``horovod_tpu_torch/ops/kernel_check.py``, which gives the
reasons): every element within rtol * (|ref| + rms of its row + rms(ref)
/ 16) of a plain version that rounds p and ds to the storage dtype where the
kernels do; rtol is two units in the last place for 16-bit outputs and
for K5's f32 partials of 16-bit inputs (bf16 0.0156, fp16 0.00195) and
1e-4 for float32 outputs of float32 inputs and lse (summation order
only).

The members of a ring all sit on this one card: the run shows the ring's
kernels, handshakes and numbers, not the memory per member falling as
O(seq/n) or NVLink transfer times.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device")

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch.models import TransformerLM, next_token_loss  # noqa
from horovod_tpu_torch.ops import _build  # noqa: E402
from horovod_tpu_torch.ops import attention as A  # noqa: E402
from horovod_tpu_torch.ops import kernel_check  # noqa: E402
from horovod_tpu_torch.ops import rdma  # noqa: E402
from horovod_tpu_torch.ops import ring_flash as RF  # noqa: E402
from horovod_tpu_torch.parallel import RingMesh  # noqa: E402
from horovod_tpu_torch.torch.lm_step import (HEADLINE,  # noqa: E402
                                             RING_HEADLINE, build_lm_step)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")
# H100 SXM data-sheet peaks (dense), at the 700 W limit.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
PEAK_BYTES = 3.35e12
SLEEP_CYCLES = 2_000_000  # ≈1 ms at the H100's clock: time_ms's lead
MAIN = (16, 8, 1024, 64)  # batch, heads, seq, head_dim of the LM step
# Where the reference's plan picks the split backward (K2 + K3): more than
# 1024 batch-heads at a short sequence, and long sequences.
SPLIT = (1, 1040, 512, 64)
SPLIT_LONG = ((8, 8, 8192, 64), (4, 8, 16384, 64))
RING = (4, 8, 1024, 64)  # one member's shard on the ring path (4 members)
N_MEMBERS = 4
REPLACES = {
    "flash_fwd": "horovod_tpu/ops/attention.py:356",
    "flash_bwd": "horovod_tpu/ops/attention.py:498",
    "flash_bwd_dkdv": "horovod_tpu/ops/attention.py:429",
    "flash_bwd_dq": "horovod_tpu/ops/attention.py:465",
    "ring_flash_fwd": "horovod_tpu/ops/ring_flash.py:78",
    "ring_flash_bwd": "horovod_tpu/ops/attention.py:498",
    "ring_permute": "horovod_tpu/ops/rdma.py:103",
    "phase_closer": "horovod_tpu/ops/ring_flash.py:286",
}
SOURCES = {
    "flash_fwd": "horovod_tpu_torch/ops/csrc/flash_fwd.cu",
    "flash_bwd": "horovod_tpu_torch/ops/csrc/flash_bwd.cu",
    "flash_bwd_dkdv": "horovod_tpu_torch/ops/csrc/flash_bwd.cu",
    "flash_bwd_dq": "horovod_tpu_torch/ops/csrc/flash_bwd.cu",
    "ring_flash_fwd": "horovod_tpu_torch/ops/csrc/ring_flash.cu",
    "ring_flash_bwd": "horovod_tpu_torch/ops/csrc/ring_flash.cu",
    "ring_permute": "horovod_tpu_torch/ops/csrc/ring_permute.cu",
    "phase_closer": "horovod_tpu_torch/ops/csrc/ring_permute.cu",
}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, warmup=3, iters=15, host_ahead=True):
    """Median milliseconds of ``fn`` on the card (CUDA events).  With
    ``host_ahead`` a 1 ms sleep kernel runs ahead of the start event, so
    the host has queued ``fn``'s launches before the card reaches them
    and the events hold device time alone; without it they also hold the
    host's time to issue them (the Python wrapper's checks, allocations
    and launch), as the port's first timings did."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if host_ahead:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sdpa_ms(make):
    """``({backend: ms or None}, fastest ms)`` of the callable ``make()``
    returns, made and timed under each SDPA backend; None where the
    backend refuses the shape."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    times = {}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION"):
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                times[name] = time_ms(make())
        except RuntimeError:
            times[name] = None
    done = [x for x in times.values() if x is not None]
    return times, (min(done) if done else None)


def causal_pairs(sq, sk, causal):
    if not causal:
        return sq * sk
    return sum(min(i + 1, sk) for i in range(sq))


def bound_ms(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / PEAK_BYTES
    return max(t_ops, t_mem) * 1e3, "operations" if t_ops >= t_mem else "bytes"


def _entry(name, ms, plain_ms, library_ms, flops, nbytes, dtype, err,
           **extra):
    bms, by = bound_ms(flops, nbytes, dtype)
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": None,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
            "flops": flops, "bytes": nbytes, **extra}


def kernel_inputs(shape, dtype, seed):
    b, h, s, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda: torch.randn(b * h, s, d, device="cuda", generator=g,  # noqa
                             dtype=torch.float32).to(dtype)
    q, k, v, do = mk(), mk(), mk(), mk()
    p2, scale_r = A._split_scale(d ** -0.5)
    qr = (q * p2).to(dtype)
    return q, qr, k, v, do, p2, scale_r


def check_case(shape, dtype, causal, seed=0):
    """``{output: {max_abs_err, worst}}`` of K1, B2 (``dq``, ``dk``,
    ``dv``) and K2 + K3 (``split_dq``, ...) against the plain versions
    (``kernel_check``); fails on a non-finite output."""
    _, qr, k, v, do, p2, scale_r = kernel_inputs(shape, dtype, seed)
    ref, delta = kernel_check.plain_outputs(qr, k, v, do, causal, scale_r,
                                            p2)
    got = kernel_check.kernel_outputs(qr, k, v, do, ref["lse"], delta, p2,
                                      scale_r, causal)
    # The split pair against the plain side that walks its own key tile.
    args = (qr, k, v, do, ref["lse"], delta, p2, scale_r, causal, "split")
    split = kernel_check.kernel_bwd_outputs(*args)
    split_ref = kernel_check.plain_bwd_outputs(*args)
    got.update({f"split_{n}": t for n, t in split.items()})
    ref.update({f"split_{n}": t for n, t in split_ref.items()})
    for name, t in got.items():
        if not torch.isfinite(t).all():
            fail(f"{name} not finite at {shape} {dtype}")
    # lse is compared finite-to-finite (ragged or causal rows all have
    # mass, so no POS_BIG sentinel appears here).
    return {n: kernel_check.compare(got[n], ref[n]) for n in got}


def phase_kernels():
    cases = [(MAIN, torch.bfloat16, True), (MAIN, torch.float32, True),
             (MAIN, torch.float16, True), (MAIN, torch.bfloat16, False),
             ((16, 8, 1000, 128), torch.bfloat16, True),
             ((16, 8, 1000, 128), torch.float32, True)]
    results = []
    main_errs = None
    for shape, dtype, causal in cases:
        errs = check_case(shape, dtype, causal)
        ok = all(e["worst"] <= 1.0 for e in errs.values())
        results.append({"shape": list(shape), "dtype": str(dtype),
                        "causal": causal, "ok": ok, "errors": errs})
        if (shape, dtype, causal) == (MAIN, torch.bfloat16, True):
            main_errs = errs
        if not ok:
            emit("kernels", cases=results)
            fail(f"kernel disagrees with its plain version: {results[-1]}")

    # Times at the main path's shape and dtype; the plain times are of the
    # plain versions as held against the kernels above.
    dtype, causal = torch.bfloat16, True
    q, qr, k, v, do, p2, scale_r = kernel_inputs(MAIN, dtype, 1)
    o, lse = A.flash_fwd(qr, k, v, scale_r, causal)
    delta = A._delta(o, do)
    t_fwd = time_ms(lambda: A.flash_fwd(qr, k, v, scale_r, causal))
    t_fwd_host = time_ms(lambda: A.flash_fwd(qr, k, v, scale_r, causal),
                         host_ahead=False)
    t_b2 = time_ms(lambda: A.flash_bwd(qr, k, v, do, lse, delta, scale_r, p2,
                                       causal))
    t_dkdv = time_ms(lambda: A.flash_bwd_dkdv(qr, k, v, do, lse, delta,
                                              scale_r, causal))
    t_dq = time_ms(lambda: A.flash_bwd_dq(qr, k, v, do, lse, delta, scale_r,
                                          p2, causal))
    t_plain_fwd = time_ms(lambda: A._blockwise_fwd_impl(
        qr, k, v, causal, scale_r,
        block_size=A.fwd_key_tile(dtype, MAIN[3])), warmup=1, iters=5)
    t_plain_bwd = time_ms(lambda: A._attention_bwd_impl(
        qr, k, v, lse, delta, do, causal, scale_r,
        block_size=A.bwd_key_tile("combined", dtype), dq_scale=p2,
        round_pds=True), warmup=1, iters=5)
    # Library yardstick: PyTorch's SDPA on (b, h, s, d) under each
    # backend, forward and its backward alone (dq, dk, dv in one autograd
    # call).
    b, h, s, d = MAIN
    qs, ks, vs = (t.reshape(b, h, s, d).detach().requires_grad_()
                  for t in (q, k, v))
    dos = do.reshape(b, h, s, d)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd, t_lib_fwd = sdpa_ms(
        lambda: lambda: sdpa(qs, ks, vs, is_causal=causal))

    def sdpa_bwd():
        out = sdpa(qs, ks, vs, is_causal=causal)
        return lambda: torch.autograd.grad(out, (qs, ks, vs), dos,
                                           retain_graph=True)
    lib_bwd, t_lib_bwd = sdpa_ms(sdpa_bwd)

    bh = b * h
    pairs = causal_pairs(s, s, causal) * bh
    el = torch.tensor([], dtype=dtype).element_size()
    tile = bh * s * d * el
    row = bh * s * 4
    err = {n: max(main_errs[o]["max_abs_err"] for o in outs)
           for n, outs in (("flash_fwd", ("o", "lse")),
                           ("flash_bwd", ("dq", "dk", "dv")))}
    entries = {  # (flops, bytes: each input read once, each output written)
        "flash_fwd": _entry(
            "flash_fwd", t_fwd, t_plain_fwd, t_lib_fwd, 4 * d * pairs,
            3 * tile + tile + row, dtype, err["flash_fwd"],
            library_by_backend=lib_fwd, ms_with_host=t_fwd_host),
        "flash_bwd": _entry(
            "flash_bwd", t_b2, t_plain_bwd, t_lib_bwd, 10 * d * pairs,
            4 * tile + 2 * row + 3 * tile, dtype, err["flash_bwd"],
            library_by_backend=lib_bwd, k2_plus_k3_ms=t_dkdv + t_dq),
    }
    emit("kernels", cases=results, shape=list(MAIN), dtype=str(dtype),
         timing={n: {k: e[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}
                 for n, e in entries.items()},
         k2_ms=t_dkdv, k3_ms=t_dq, sdpa_fwd_ms=lib_fwd, sdpa_bwd_ms=lib_bwd,
         note="library_ms: the fastest SDPA backend's forward for K1, its "
              "whole backward (dq, dk, dv) for B2; k2_ms, k3_ms: the split "
              "pair at this shape, which no path gives it (its entries come "
              "from the split phase)")
    return entries


def phase_model():
    """The kernels' path against the plain path through a small LM."""
    cfg = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=2,
               dtype=torch.float32)
    flash = TransformerLM(**cfg, use_flash=True)
    plain = TransformerLM(**cfg, use_flash=False)
    plain.load_state_dict(flash.state_dict())
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, 512, (2, 257))).cuda()
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    out = {}
    for name, m in (("flash", flash), ("plain", plain)):
        logits = m(inp)
        loss = next_token_loss(logits, tgt)
        loss.backward()
        out[name] = (logits.detach(), loss.item(),
                     {n: p.grad for n, p in m.named_parameters()})
    dl = (out["flash"][0] - out["plain"][0]).abs().max().item()
    dg = max((out["flash"][2][n] - out["plain"][2][n]).abs().max().item()
             for n in out["flash"][2])
    emit("model", logits_max_abs_err=dl, grad_max_abs_err=dg,
         loss_flash=out["flash"][1], loss_plain=out["plain"][1])
    # f32 on both sides: summation order only.
    if dl > 1e-4 or dg > 1e-4:
        fail(f"model path disagrees with the plain path: {dl}, {dg}")


def phase_train():
    hvd.init()
    torch.cuda.set_device(hvd.local_rank())
    _, step, data = build_lm_step(**HEADLINE)
    vocab, batch, seq = (HEADLINE[k] for k in ("vocab_size", "batch", "seq"))
    n_layers = HEADLINE["n_layers"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warmup, timed = 2, 5
    A.reset_launches()
    losses, step_ms = [], []
    for i in range(warmup + timed):
        t0 = time.perf_counter()
        loss = step(data).item()  # .item() synchronizes
        dt = (time.perf_counter() - t0) * 1e3
        losses.append(loss)
        if i >= warmup:
            step_ms.append(dt)
    torch.cuda.synchronize()
    launched = dict(A.launches)
    med = statistics.median(step_ms)
    emit("train", tokens_per_s=batch * seq / (med / 1e3),
         median_step_ms=med, step_ms=step_ms,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         first_loss=losses[0], last_loss=losses[-1], losses=losses,
         launches=launched)
    per = n_layers * (warmup + timed)
    want = {"flash_fwd": per, "flash_bwd": per, "flash_bwd_dkdv": 0,
            "flash_bwd_dq": 0}
    if launched != want:
        fail(f"the main path launched {launched}, want {want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss: {losses}")
    # Random weights start near log(vocab); one fixed batch is memorised.
    if abs(losses[0] - math.log(vocab)) > 1.0 or losses[-1] >= losses[0]:
        fail(f"implausible loss trajectory: {losses}")
    hvd.shutdown()
    return launched


def phase_split():
    """The split backward where the reference's plan picks it (more than
    1024 batch-heads at seq 512), bf16, causal: K2 and K3 held against
    their plain version at this shape, B2 beside them; ``flash_attention``
    forward and backward with the counters zeroed just before and read
    just after (K1, K2 and K3 once, B2 never) and its gradients against
    the plain blockwise path; then the times of K2, K3, B2, the plain
    version and SDPA's backward here, and of B2 against K2 + K3 (both
    held first) at two long sequences that the plan also sends to the
    split pair.  Returns the launches and K2's and K3's entries."""
    dtype, causal = torch.bfloat16, True
    b, h, s, d = SPLIT
    bh = b * h
    mode = A.bwd_mode(s, d, bh)
    if mode != "split":
        fail(f"the plan picks {mode} at {SPLIT}, not split")
    q, qr, k, v, do, p2, scale_r = kernel_inputs(SPLIT, dtype, 4)
    ref, delta = kernel_check.plain_outputs(qr, k, v, do, causal, scale_r,
                                            p2, "split")
    args = (qr, k, v, do, ref["lse"], delta, p2, scale_r, causal)
    errs = {}
    for m in ("split", "combined"):
        got = kernel_check.kernel_bwd_outputs(*args, m)
        want = kernel_check.plain_bwd_outputs(*args, m)
        errs[m] = {n: kernel_check.compare(got[n], want[n]) for n in got}
    held = all(e["worst"] <= 1.0 for es in errs.values() for e in es.values())

    xs = [t.reshape(SPLIT).clone().requires_grad_() for t in (q, k, v)]
    ct = do.reshape(SPLIT)
    torch.cuda.synchronize()
    A.reset_launches()
    grads = torch.autograd.grad(A.flash_attention(*xs, causal=True), xs, ct)
    torch.cuda.synchronize()
    launched = dict(A.launches)
    ref_in = [x.detach().float().requires_grad_() for x in xs]
    ref_grads = torch.autograd.grad(
        A.blockwise_attention(*ref_in, causal=True), ref_in, ct.float())
    # bf16 kernels against the f32 plain path: bf16 rounding of the inputs'
    # products and of the outputs (5e-2 of the largest gradient).
    path_err = [(a.float() - r).abs().max().item() / r.abs().max().item()
                for a, r in zip(grads, ref_grads)]
    del ref_in, ref_grads

    t_dkdv = time_ms(lambda: A.flash_bwd_dkdv(qr, k, v, do, ref["lse"],
                                              delta, scale_r, causal))
    t_dq = time_ms(lambda: A.flash_bwd_dq(qr, k, v, do, ref["lse"], delta,
                                          scale_r, p2, causal))
    t_b2 = time_ms(lambda: A.flash_bwd(qr, k, v, do, ref["lse"], delta,
                                       scale_r, p2, causal))
    t_plain = time_ms(lambda: kernel_check.plain_bwd_outputs(*args, "split"),
                      warmup=1, iters=5)
    qs, ks, vs = (t.reshape(SPLIT).detach().requires_grad_()
                  for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_bwd():
        out = sdpa(qs, ks, vs, is_causal=causal)
        return lambda: torch.autograd.grad(out, (qs, ks, vs), ct,
                                           retain_graph=True)
    lib_bwd, t_lib_bwd = sdpa_ms(sdpa_bwd)
    del qs, ks, vs
    times = {"x".join(map(str, SPLIT)): {"b2_ms": t_b2,
                                         "k2_plus_k3_ms": t_dkdv + t_dq}}
    for shape in SPLIT_LONG:
        if A.bwd_mode(shape[2], shape[3], shape[0] * shape[1]) != "split":
            fail(f"the plan does not pick split at {shape}")
        _, lqr, lk, lv, ldo, lp2, lr = kernel_inputs(shape, dtype, 6)
        o, lse = A.flash_fwd(lqr, lk, lv, lr, causal)
        ldelta = A._delta(o, ldo)
        # Both modes held here too (the backward alone, on K1's lse), so
        # the times compare kernels that are right at this length.
        kargs = (lqr, lk, lv, ldo, lse, ldelta, lp2, lr, causal)
        worst = {}
        for m in ("split", "combined"):
            got = kernel_check.kernel_bwd_outputs(*kargs, m)
            want = kernel_check.plain_bwd_outputs(*kargs, m)
            worst[m] = max(kernel_check.compare(got[n], want[n])["worst"]
                           for n in got)
            del got, want
        held &= max(worst.values()) <= 1.0
        largs = (lqr, lk, lv, ldo, lse, ldelta, lr)
        times["x".join(map(str, shape))] = {
            "b2_ms": time_ms(lambda: A.flash_bwd(*largs, lp2, causal)),
            "k2_plus_k3_ms": time_ms(lambda: (
                A.flash_bwd_dkdv(*largs, causal),
                A.flash_bwd_dq(*largs, lp2, causal))),
            "worst": worst}
        del lqr, lk, lv, ldo, o, lse, ldelta, kargs, largs
    emit("split", shape=list(SPLIT), mode=mode, launches=launched,
         errors=errs, path_rel_err=path_err, times=times,
         timing={"flash_bwd_dkdv": t_dkdv, "flash_bwd_dq": t_dq,
                 "plain_ms": t_plain, "library_ms": t_lib_bwd},
         sdpa_bwd_ms=lib_bwd)
    want = {"flash_fwd": 1, "flash_bwd": 0, "flash_bwd_dkdv": 1,
            "flash_bwd_dq": 1}
    if not held:
        fail(f"split pair or B2 disagrees with its plain version: {errs}, "
             f"{times}")
    if launched != want or max(path_err) > 5e-2:
        fail(f"split path launched {launched} for {want}, gradients off "
             f"by {path_err}")

    pairs = causal_pairs(s, s, causal) * bh
    tile = bh * s * d * torch.tensor([], dtype=dtype).element_size()
    row = bh * s * 4
    err = {n: max(errs["split"][o]["max_abs_err"] for o in outs)
           for n, outs in (("flash_bwd_dkdv", ("dk", "dv")),
                           ("flash_bwd_dq", ("dq",)))}
    entries = {
        "flash_bwd_dkdv": _entry(
            "flash_bwd_dkdv", t_dkdv, t_plain, t_lib_bwd, 8 * d * pairs,
            4 * tile + 2 * row + 2 * tile, dtype, err["flash_bwd_dkdv"],
            library_by_backend=lib_bwd, shape=list(SPLIT)),
        "flash_bwd_dq": _entry(
            "flash_bwd_dq", t_dq, t_plain, t_lib_bwd, 6 * d * pairs,
            4 * tile + 2 * row + tile, dtype, err["flash_bwd_dq"],
            library_by_backend=lib_bwd, shape=list(SPLIT)),
    }
    return launched, entries


def _worst(rows):
    return max(e["worst"] for r in rows for e in r["errors"].values())


def _max_err(rows, names):
    return max(r["errors"][n]["max_abs_err"] for r in rows for n in names)


def k6_kernel_ms(mesh, xs, warmup=3, iters=15):
    """Median over rounds of the longest member's K6 launch, by CUDA events
    on the member streams around the launches alone.  Each round forks
    the member streams off a sleep on the caller's stream, so every
    launch is queued before any starts, and joins them after the events;
    the fork and join stay outside the events."""
    n = mesh.size
    outs = [torch.empty_like(x) for x in xs]
    table = (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs])
    table_ptr = ctypes.cast(table, ctypes.c_void_p)
    nbytes = xs[0].numel() * xs[0].element_size()
    fn = rdma._kernel_fn("hvdt_ring_permute")
    ns = rdma.NS_RDMA
    rounds = []
    for _ in range(warmup + iters):
        torch.cuda._sleep(SLEEP_CYCLES)
        caller = mesh.fork()
        events = []
        for i in range(n):
            with mesh.on(i):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                A._launch(fn, xs[i].data_ptr(), table_ptr, nbytes,
                          rdma.COPY_BLOCKS, 1, mesh.flags.data_ptr(),
                          mesh.go.data_ptr(), mesh.err.data_ptr(), i, n, ns,
                          mesh.next_epoch(i, ns))
                end.record()
                events.append((start, end))
        mesh.join(caller, outs)
        rounds.append(events)
    torch.cuda.synchronize()
    return statistics.median(max(s.elapsed_time(e) for s, e in events)
                             for events in rounds[warmup:])


def phase_ring_kernels():
    """K4-K7 held against their plain versions (``kernel_check``) and
    timed."""
    cases, rows_by = [], {}
    for dtype in (torch.bfloat16, torch.float32):
        mesh = RingMesh(N_MEMBERS)
        members, _, scale_r = kernel_check.ring_inputs(N_MEMBERS, RING,
                                                       dtype, 0)
        # t=0: every member on the diagonal; t=1: member 0 wholly masked,
        # the others wholly visible; t=n-1 without rotation: masked but
        # for the last member.  Rotating and non-rotating variants.
        for t, rotate in ((0, True), (1, True), (0, False),
                          (N_MEMBERS - 1, False)):
            rows = kernel_check.hold_ring_round(mesh, members, t, scale_r,
                                                rotate=rotate)
            balanced = mesh.flags_balanced()
            slots = all(r.get("slot_exact", True) for r in rows)
            ok = _worst(rows) <= 1.0 and balanced and slots
            cases.append({"dtype": str(dtype), "step": t, "rotate": rotate,
                          "kinds": [r["kind"] for r in rows],
                          "worst": _worst(rows), "slots_exact": slots,
                          "flags_balanced": balanced, "ok": ok})
            rows_by.setdefault(dtype, []).extend(rows)
            if not ok:
                emit("ring_kernels", cases=cases, failed=rows)
                fail(f"ring kernel disagrees with its plain version: "
                     f"{cases[-1]}")
    bf16_rows = rows_by[torch.bfloat16]

    # K6: bit-exact rotations by +1 and -1, and the VJP (rotation by -1 on
    # the flipped namespace).
    mesh = RingMesh(N_MEMBERS)
    g = torch.Generator(device="cuda").manual_seed(5)
    shard = (RING[0] * RING[1], RING[2], RING[3])
    xs = [torch.randn(shard, device="cuda", generator=g).to(torch.bfloat16)
          for _ in range(N_MEMBERS)]
    exact = {}
    for shift in (1, -1):
        outs = rdma.permute_shards(xs, mesh, shift, 0)
        torch.cuda.synchronize()
        exact[shift] = all(torch.equal(outs[(i + shift) % N_MEMBERS], x)
                           for i, x in enumerate(xs))
    xg = [x.clone().requires_grad_() for x in xs]
    ws = [torch.randn(shard, device="cuda", generator=g).to(torch.bfloat16)
          for _ in range(N_MEMBERS)]
    rot = rdma.ring_permute(xg, mesh, 1, 2)
    grads = torch.autograd.grad(rot, xg, ws)
    exact["vjp"] = all(torch.equal(grads[i], ws[(i + 1) % N_MEMBERS])
                       for i in range(N_MEMBERS))
    k6_ok = all(exact.values()) and mesh.flags_balanced()

    # K7: zero blocks, and every flag back in balance after a full fused
    # forward + backward (which closes each pass with K7 on an even ring).
    caller = mesh.fork()
    zeros = RF.launch_round(mesh, RF.phase_closer, [{}] * N_MEMBERS)
    mesh.join(caller)
    torch.cuda.synchronize()
    k7_zero = all(bool((z == 0).all()) for z in zeros)
    ring_qkv = [[m[n].reshape(RING).clone().requires_grad_()
                 for m in members] for n in ("qr", "k", "v")]
    outs = RF.fused_ring_attention(*ring_qkv, mesh, causal=True)
    torch.autograd.grad(outs, [t for ts in ring_qkv for t in ts],
                        [torch.ones_like(o) for o in outs])
    torch.cuda.synchronize()
    k7_ok = k7_zero and mesh.flags_balanced()
    if not (k6_ok and k7_ok):
        fail(f"K6/K7 check failed: K6 {exact}, K7 zeros {k7_zero}, "
             f"flags {mesh.flags.tolist()}")

    # Times at the ring path's shape, bf16: K4 and K5 on a wholly visible
    # step (the heaviest kind), one launch without rotation; a rotating
    # round of all members beside it.  K6 and K7: one round of all members.
    dtype = torch.bfloat16
    members, _, scale_r = kernel_check.ring_inputs(N_MEMBERS, RING, dtype, 1)
    m0, m1 = members[0], members[1]
    sl = RING[2]
    ref, delta = kernel_check.ring_plain_step(m1["qr"], m0["k"], m0["v"],
                                              m1["do"], sl, 0, True, scale_r)
    t_k4 = time_ms(lambda: RF.ring_flash_fwd(
        mesh, 1, m1["qr"], m0["k"], m0["v"], sl, 0, scale_r, True))
    t_k4_host = time_ms(lambda: RF.ring_flash_fwd(
        mesh, 1, m1["qr"], m0["k"], m0["v"], sl, 0, scale_r, True),
        host_ahead=False)
    t_k5 = time_ms(lambda: RF.ring_flash_bwd(
        mesh, 1, m1["qr"], m0["k"], m0["v"], m1["do"], ref["lse"], delta,
        sl, 0, scale_r, True))
    t_k4_plain = time_ms(lambda: A._blockwise_fwd_impl(
        m1["qr"], m0["k"], m0["v"], True, scale_r,
        block_size=A.fwd_key_tile(dtype, RING[3]), q_offset=sl, k_offset=0),
        warmup=1, iters=5)
    t_k5_plain = time_ms(lambda: A._attention_bwd_impl(
        m1["qr"], m0["k"], m0["v"], ref["lse"], delta, m1["do"], True,
        scale_r, block_size=A.bwd_key_tile("combined", dtype),
        round_pds=True, q_offset=sl,
        k_offset=0, grad_dtype=torch.float32), warmup=1, iters=5)
    calls = [dict(qr=members[i]["qr"], k=members[i]["k"],
                  v=members[i]["v"], q_offset=i * sl, k_offset=i * sl,
                  scale_r=scale_r, causal=True, rotate=True, phase=0)
             for i in range(N_MEMBERS)]

    def rotating_round(kernel, calls):
        caller = mesh.fork()
        RF.launch_round(mesh, kernel, calls)
        mesh.join(caller)
    t_k4_round = time_ms(lambda: rotating_round(RF.ring_flash_fwd, calls))
    b, h, _, d = RING
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (x.reshape(RING).detach().requires_grad_()
                  for x in (m1["qr"], m0["k"], m0["v"]))
    lib_fwd, t_lib_fwd = sdpa_ms(lambda: lambda: sdpa(qs, ks, vs, scale=1.0))
    dos = m1["do"].reshape(RING)

    def sdpa_bwd():
        out = sdpa(qs, ks, vs, scale=1.0)
        return lambda: torch.autograd.grad(out, (qs, ks, vs), dos,
                                           retain_graph=True)
    lib_bwd, t_lib_bwd = sdpa_ms(sdpa_bwd)
    t_k6 = time_ms(lambda: rdma.permute_shards(xs, mesh, 1, 0))
    t_k6_kernel = k6_kernel_ms(mesh, xs)
    dsts = [torch.empty_like(x) for x in xs]
    t_copy = time_ms(lambda: [o.copy_(x) for o, x in zip(dsts, xs)])
    t_k7 = time_ms(lambda: rotating_round(RF.phase_closer,
                                          [{}] * N_MEMBERS))
    mesh.check()
    if not mesh.flags_balanced():
        fail(f"flags out of balance after the timed rounds: "
             f"{mesh.flags.tolist()}")

    bh = b * h
    el = torch.tensor([], dtype=dtype).element_size()
    tile, tile32, row = bh * sl * d * el, bh * sl * d * 4, bh * sl * 4
    pairs = bh * sl * sl  # a wholly visible step
    entries = {
        "ring_flash_fwd": _entry(
            "ring_flash_fwd", t_k4, t_k4_plain, t_lib_fwd, 4 * d * pairs,
            3 * tile + tile + row, dtype, _max_err(bf16_rows, ("o", "lse")),
            rotating_round_ms=t_k4_round, library_by_backend=lib_fwd,
            ms_with_host=t_k4_host),
        "ring_flash_bwd": _entry(
            "ring_flash_bwd", t_k5, t_k5_plain, t_lib_bwd, 10 * d * pairs,
            4 * tile + 2 * row + 3 * tile32, dtype,
            _max_err(bf16_rows, ("dq", "dk", "dv")),
            library_by_backend=lib_bwd),
        "ring_permute": _entry(
            "ring_permute", t_k6, None, t_copy, 0,
            2 * N_MEMBERS * tile, dtype, 0.0, kernel_ms=t_k6_kernel,
            note="ms: one round, fork and join included; kernel_ms: the "
                 "longest member launch by CUDA events on its stream; "
                 "library: one copy_ per member"),
        "phase_closer": _entry(
            "phase_closer", t_k7, None, None, 0, N_MEMBERS * 8 * 128 * 4,
            torch.float32, 0.0, note="one round: every member's launch"),
    }
    emit("ring_kernels", cases=cases, shard=list(RING), members=N_MEMBERS,
         k6_exact=exact, k7_zero=k7_zero,
         timing={n: {k: e.get(k) for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")}
                 for n, e in entries.items()},
         k4_rotating_round_ms=t_k4_round,
         note="K4/K5: one launch on a wholly visible step of the ring "
              "shard, no rotation; library_ms: SDPA forward / backward "
              "(non-causal) on the same shard")
    return entries


def ring_launches():
    return {**{n: RF.launches[n] for n in RF.launches},
            **{n: rdma.launches[n] for n in rdma.launches}}


def reset_ring_launches():
    RF.reset_launches()
    rdma.reset_launches()


def phase_ring_model():
    """A small f32 LM sequence-parallel over a ring of 4 members, in every
    ring mode, against the unsharded model on the same weights and
    tokens: logits and every gradient."""
    cfg = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=2,
               dtype=torch.float32)
    base = TransformerLM(**cfg)
    rng = np.random.RandomState(1)
    tokens = torch.from_numpy(rng.randint(0, 512, (2, 4 * 64 + 1))).cuda()
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    logits = base(inp)
    next_token_loss(logits, tgt).backward()
    want = (logits.detach(), {n: p.grad for n, p in base.named_parameters()})
    result = {}
    n_layers = cfg["n_layers"]
    for impl in ("fused", "rdma", "ppermute"):
        mesh = RingMesh(N_MEMBERS)
        model = TransformerLM(**cfg, seq_axis=mesh, ring_impl=impl)
        model.load_state_dict(base.state_dict())
        reset_ring_launches()
        logits = model(inp)
        next_token_loss(logits, tgt, axis_name=mesh).backward()
        torch.cuda.synchronize()
        got = ring_launches()
        dl = (logits.detach() - want[0]).abs().max().item()
        dg = max((p.grad - want[1][n]).abs().max().item()
                 for n, p in model.named_parameters())
        per = N_MEMBERS * n_layers
        expect = {"ring_flash_fwd": 0, "ring_flash_bwd": 0,
                  "phase_closer": 0, "ring_permute": 0}
        if impl == "fused":
            expect.update(ring_flash_fwd=per * N_MEMBERS,
                          ring_flash_bwd=per * N_MEMBERS,
                          phase_closer=per * 2 * (N_MEMBERS % 2 == 0))
        elif impl == "rdma":
            expect["ring_permute"] = per * 4 * (N_MEMBERS - 1)
        result[impl] = {"logits_max_abs_err": dl, "grad_max_abs_err": dg,
                        "launches": got,
                        "flags_balanced": mesh.flags_balanced()}
        # f32 on both sides: summation order only (K5's dQ atomics too).
        if dl > 1e-4 or dg > 1e-4 or got != expect \
                or not mesh.flags_balanced():
            emit("ring_model", modes=result)
            fail(f"ring model ({impl}) disagrees with the unsharded "
                 f"model, or launched {got} for {expect}")
    emit("ring_model", members=N_MEMBERS, modes=result)


def phase_ring_train():
    """The slice's path at full width: the headline LM sequence-parallel
    over a ring of 4 members on the card, batch 4 x seq 4096, fused
    (K4, K5, K7); then two steps with ``ring_impl="rdma"`` (K6)."""
    hvd.init()
    cfg = {k: v for k, v in RING_HEADLINE.items()}
    vocab, batch, seq = cfg["vocab_size"], cfg["batch"], cfg["seq"]
    n_layers, members = cfg["n_layers"], cfg["members"]
    model, step, data = build_lm_step(**cfg)
    mesh = model.seq_axis
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warmup, timed = 2, 5
    reset_ring_launches()
    losses, step_ms = [], []
    for i in range(warmup + timed):
        t0 = time.perf_counter()
        loss = step(data).item()
        dt = (time.perf_counter() - t0) * 1e3
        losses.append(loss)
        if i >= warmup:
            step_ms.append(dt)
    torch.cuda.synchronize()
    launched = ring_launches()
    peak = torch.cuda.max_memory_allocated()
    per = members * n_layers * (warmup + timed)
    want = {"ring_flash_fwd": per * members, "ring_flash_bwd": per * members,
            "phase_closer": per * 2 * (members % 2 == 0), "ring_permute": 0}
    med = statistics.median(step_ms)
    emit("ring_train", members=members, batch=batch, seq=seq,
         ring_impl=cfg["ring_impl"], tokens_per_s=batch * seq / (med / 1e3),
         median_step_ms=med, step_ms=step_ms, max_memory_allocated=peak,
         first_loss=losses[0], last_loss=losses[-1], losses=losses,
         launches=launched, want_launches=want,
         flags_balanced=mesh.flags_balanced())
    if launched != want:
        fail(f"ring path launched {launched}, the JAX program implies "
             f"{want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss: {losses}")
    if abs(losses[0] - math.log(vocab)) > 1.0 or losses[-1] >= losses[0]:
        fail(f"implausible loss trajectory: {losses}")
    if not mesh.flags_balanced():
        fail(f"flags out of balance: {mesh.flags.tolist()}")
    del model, step, data

    # The rdma ring at the same width: K6 rotates K and V.
    rcfg = dict(cfg, ring_impl="rdma")
    model, step, data = build_lm_step(**rcfg)
    steps = 2
    reset_ring_launches()
    rlosses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        rlosses.append(step(data).item())
    rdma_ms = (time.perf_counter() - t0) * 1e3 / steps
    torch.cuda.synchronize()
    rlaunched = ring_launches()
    rwant = {"ring_flash_fwd": 0, "ring_flash_bwd": 0, "phase_closer": 0,
             "ring_permute": members * n_layers * steps * 4 * (members - 1)}
    emit("ring_train_rdma", members=members, batch=batch, seq=seq,
         losses=rlosses, mean_step_ms=rdma_ms, launches=rlaunched,
         want_launches=rwant)
    if rlaunched != rwant:
        fail(f"rdma ring launched {rlaunched}, want {rwant}")
    # Same weights and tokens as the fused run's first step.
    if abs(rlosses[0] - losses[0]) > 1e-2 or rlosses[1] >= rlosses[0]:
        fail(f"rdma ring losses {rlosses} against fused {losses[:2]}")
    hvd.shutdown()
    return {**launched, "ring_permute": rlaunched["ring_permute"]}


def main():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit("device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    info = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         sources={k: {"seconds": v["seconds"], "cached": v["cached"]}
                  for k, v in info.items()})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        for k, v in info.items():
            f.write(f"== {k}\n{v['log']}\n")

    entries = phase_kernels()
    phase_model()
    launched = phase_train()
    split, split_entries = phase_split()
    entries.update(split_entries)
    ring_entries = phase_ring_kernels()
    phase_ring_model()
    launched.update(phase_ring_train())
    entries.update(ring_entries)
    for name_, e in entries.items():
        # K2 and K3 run on the split path, every other kernel on the main
        # path or the ring path.
        e["launches"] = (split if name_ in ("flash_bwd_dkdv", "flash_bwd_dq")
                         else launched)[name_]
        if not e["launches"]:
            fail(f"{name_} was not launched on its path")
    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
