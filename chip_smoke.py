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
   gradients against the plain blockwise path, here and at 65,600
   batch-heads (seq 16, head_dim 32) in bf16 and f32; the times of K2,
   K3 and B2 apart, beside SDPA's backward and K2's and K3's bounds, here
   and at seq 8192 (64 batch-heads) and 16384 (32), where the plan also
   picks the split pair (K2's and K3's entries in the summary come from
   the first shape).
   Then ``head_dims``: K1, K2 and K3 at head dim 256 (bf16, 1040
   batch-heads x seq 512), and K1 and B2 at head dims 16 and 80 on the
   main path's shape (run zero-padded to 32 and 96), each held alone
   against its plain version at the caller's head dim, the padded columns
   exactly 0; ``flash_attention`` forward and backward at each with the
   counters zeroed just before and read just after (K1 1, and K2 1 + K3
   1 at 256, B2 1 at 16 and 80), its output and gradients against the
   plain blockwise path; times beside SDPA's fastest backend at the same
   head dim and the bound of the caller's work.  The summary's d-256 rows
   come from here.
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
   and K7 also by CUDA events on the member streams around their four
   launches alone (``kernel_ms``), beside their rounds with the fork and
   join, with K6 moving no bytes (its handshake and gate alone), an empty
   kernel per member (the floor of that measurement) and one ``copy_``
   per member on its stream.
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

9. ``engine``  — the port's collective engine (``engine/cc``, host C++):
   the g++ seconds of its build (started beside the nvcc builds) and its
   exported dynamic symbols, which must all be ``hvd_tpu_*``.
10. ``collectives`` — 2 ranks started by the port's runner
   (``horovod_tpu_torch.runner``) on this one card, each
   ``hvd.init(device="cuda:0")``, CUDA tensors staged through pinned host
   memory to the engine's host ring: allreduce (sum and average) in f32,
   bf16, f16 and i32 at 1, 1001 elements and 64 MiB (small integers, so
   every sum is exact in 16 bits), the in-place variants, 64 small
   tensors enqueued async and completed in fewer engine cycles than
   tensors (fusion), allgather with a different dim 0 per rank, broadcast
   from root 1, each against its exact value; a shape mismatch across
   ranks must raise ``ValueError``, not hang.  Then an allreduce of 224
   MiB of f32 (the LM's gradient bytes) split into D2H, engine and H2D
   milliseconds, and timed whole; and the engine alone on host buffers
   of 1, 4, 16, 64 and 224 MiB.
11. ``train_dp`` — the main path data-parallel over 2 ranks on this card:
   ``HEADLINE`` per rank (weak scaling), rank r's weights seeded 100 + r
   and then broadcast from rank 0 with the optimizer state,
   ``DistributedOptimizer(AdamW)`` and ``build_train_step``, 2 warm-up +
   5 timed steps.  Every parameter must be equal across ranks bit for bit
   (one digest per rank), the loss finite and falling, K1 and B2 launched
   8 x 7 times per rank and K2, K3 never; printed: the job's tokens/s (2 x
   16,384 tokens a step), step ms, ``sync_sec``, each rank's peak memory,
   the engine cycles that completed each step's 51 gradient handles, and
   one profiled step's kernel, D2H and H2D milliseconds.  Then the
   averaging check: 3 steps of both ranks from one seed, rank r on rows
   [8r, 8r + 8) of a 16-row batch, against 3 steps of the size-1 step on
   all 16 rows; the losses must agree within 3 x the spread of two
   size-1 runs, with a floor of 1e-3 relative (printed beside them).

The two ranks time-slice the one card (two CUDA contexts, no MPS), and
NCCL cannot run two ranks on one device: the run shows the engine, the
staging and their numbers, not NVLink or NCCL.  Any rank that exits
non-zero, any mismatch and any timeout fails the run.

Then the ``{"kernels": [...]}`` summary (K1-K7, B2, and K1-K3 at head
dim 256; K1 and B2 with their launches per rank on ``train_dp``), the
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
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device")

import horovod_tpu_torch as hvd  # noqa: E402
import horovod_tpu_torch.torch as hvdt  # noqa: E402
from horovod_tpu_torch import common as hvd_common  # noqa: E402
from horovod_tpu_torch.engine import build as engine_build  # noqa: E402
from horovod_tpu_torch.models import TransformerLM, next_token_loss  # noqa
from horovod_tpu_torch.ops import _build  # noqa: E402
from horovod_tpu_torch.ops import attention as A  # noqa: E402
from horovod_tpu_torch.ops import kernel_check  # noqa: E402
from horovod_tpu_torch.ops import rdma  # noqa: E402
from horovod_tpu_torch.ops import ring_flash as RF  # noqa: E402
from horovod_tpu_torch.parallel import RingMesh  # noqa: E402
from horovod_tpu_torch.runner import run_command  # noqa: E402
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
# More batch-heads than a grid's y dimension holds (65,535).
SPLIT_WIDE = (1, 65600, 16, 32)
RING = (4, 8, 1024, 64)  # one member's shard on the ring path (4 members)
# Head dims beside the main path's 64 (the head_dims phase): the wide body
# (K1, K2, K3) on the split phase's shape, and two head dims no body takes
# (run zero-padded to 32 and 96) on the main path's shape.
HEAD_DIM_WIDE = (1, 1040, 512, 256)
HEAD_DIM_PADDED = ((16, 8, 1024, 16), (16, 8, 1024, 80))
N_MEMBERS = 4
# The data-parallel phases: ranks on this one card, the LM's gradient
# bytes (58.7 M f32 parameters), the averaging check's seed.
DP_RANKS = 2
GRAD_BYTES = 224 << 20
AVG_SEED = 7
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
    "flash_bwd_dkdv": "horovod_tpu_torch/ops/csrc/flash_bwd_split.cu",
    "flash_bwd_dq": "horovod_tpu_torch/ops/csrc/flash_bwd_split.cu",
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
           kernel=None, **extra):
    """A row of the summary; ``kernel`` names the kernel where ``name``
    is a row of its own (the d-256 rows)."""
    bms, by = bound_ms(flops, nbytes, dtype)
    kernel = kernel or name
    return {"name": name, "route": "cuda", "source": SOURCES[kernel],
            "replaces": REPLACES[kernel], "launches": None,
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
    _, qr, k, v, do, p2, scale_r = kernel_inputs(MAIN, dtype, 1)
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
        block_size=A.bwd_key_tile("combined", dtype, MAIN[3]), dq_scale=p2,
        round_pds=True), warmup=1, iters=5)
    # Library yardstick: PyTorch's SDPA on (b, h, s, d) under each
    # backend, forward and its backward alone (dq, dk, dv in one autograd
    # call).
    b, h, s, d = MAIN
    lib_fwd, t_lib_fwd, lib_bwd, t_lib_bwd = sdpa_times(MAIN, dtype, causal,
                                                        None, 1)

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


def split_bounds(shape, dtype, causal):
    """``{kernel: (flops, bytes)}`` of K2 and K3 at ``shape`` (each input
    read once, each output written once)."""
    b, h, s, d = shape
    bh = b * h
    pairs = causal_pairs(s, s, causal) * bh
    tile = bh * s * d * torch.tensor([], dtype=dtype).element_size()
    row = bh * s * 4
    return {"flash_bwd_dkdv": (8 * d * pairs, 4 * tile + 2 * row + 2 * tile),
            "flash_bwd_dq": (6 * d * pairs, 4 * tile + 2 * row + tile)}


def hold_many_heads(dtype):
    """``flash_attention`` forward and backward at SPLIT_WIDE (65,600
    batch-heads, past a grid's 65,535 y-blocks) with the counters zeroed
    just before and read just after (K1, K2, K3 once: the plan picks the
    split pair past 1024 batch-heads); output and gradients against the
    plain blockwise path."""
    launched, got, want = drive_flash_attention(SPLIT_WIDE, dtype, True, 7)
    if dtype == torch.float32:
        # f32 on both sides: summation order only (kernel_check's rule).
        errs = {n: kernel_check.compare(got[n], want[n]) for n in got}
        ok = all(e["worst"] <= 1.0 for e in errs.values())
    else:
        # 16-bit kernels against the f32 plain path: rounding of the
        # inputs' products and of the outputs (5e-2 of the largest value).
        errs = _rel_errs(got, want)
        ok = max(errs.values()) <= 5e-2
    finite = all(bool(torch.isfinite(x).all()) for x in got.values())
    return {"dtype": str(dtype), "launches": launched, "errors": errs,
            "finite": finite, "ok": ok and finite}


def phase_split():
    """The split backward where the reference's plan picks it (more than
    1024 batch-heads at seq 512), bf16, causal: K2 and K3 held against
    their plain version at this shape, B2 beside them; ``flash_attention``
    forward and backward with the counters zeroed just before and read
    just after (K1, K2 and K3 once, B2 never) and its gradients against
    the plain blockwise path, here and at 65,600 batch-heads in bf16 and
    f32; then K2, K3 and B2 (all held first) timed apart at this shape and
    at two long sequences that the plan also sends to the split pair,
    beside SDPA's backward; the plain version timed here.  Returns the
    launches and K2's and K3's entries."""
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
    del xs, grads, ref_in, ref_grads
    wide = [hold_many_heads(dt) for dt in (torch.bfloat16, torch.float32)]

    t_plain = time_ms(lambda: kernel_check.plain_bwd_outputs(*args, "split"),
                      warmup=1, iters=5)
    times = {}
    for shape in (SPLIT,) + SPLIT_LONG:
        if A.bwd_mode(shape[2], shape[3], shape[0] * shape[1]) != "split":
            fail(f"the plan does not pick split at {shape}")
        if shape == SPLIT:
            sqr, sk_, sv, sdo, sp2, sr = qr, k, v, do, p2, scale_r
            slse, sdelta = ref["lse"], delta
            worst = {m: max(e["worst"] for e in errs[m].values())
                     for m in errs}
        else:
            _, sqr, sk_, sv, sdo, sp2, sr = kernel_inputs(shape, dtype, 6)
            o, slse = A.flash_fwd(sqr, sk_, sv, sr, causal)
            sdelta = A._delta(o, sdo)
            del o
            # Both modes held here too (the backward alone, on K1's lse),
            # so the times compare kernels that are right at this length.
            kargs = (sqr, sk_, sv, sdo, slse, sdelta, sp2, sr, causal)
            worst = {}
            for m in ("split", "combined"):
                got = kernel_check.kernel_bwd_outputs(*kargs, m)
                want = kernel_check.plain_bwd_outputs(*kargs, m)
                worst[m] = max(kernel_check.compare(got[n], want[n])["worst"]
                               for n in got)
                del got, want
            held &= max(worst.values()) <= 1.0
        largs = (sqr, sk_, sv, sdo, slse, sdelta, sr)
        t_k2 = time_ms(lambda: A.flash_bwd_dkdv(*largs, causal))
        t_k3 = time_ms(lambda: A.flash_bwd_dq(*largs, sp2, causal))
        t_b2 = time_ms(lambda: A.flash_bwd(*largs, sp2, causal))
        _, _, lib_bwd, t_lib = sdpa_times(shape, dtype, causal, sr, 6)
        bounds = {n: bound_ms(f, nb, dtype)[0] for n, (f, nb)
                  in split_bounds(shape, dtype, causal).items()}
        times["x".join(map(str, shape))] = {
            "k2_ms": t_k2, "k3_ms": t_k3, "k2_plus_k3_ms": t_k2 + t_k3,
            "b2_ms": t_b2, "sdpa_bwd_ms": lib_bwd, "library_ms": t_lib,
            "k2_bound_ms": bounds["flash_bwd_dkdv"],
            "k3_bound_ms": bounds["flash_bwd_dq"], "worst": worst}
        del largs, sqr, sk_, sv, sdo, slse, sdelta
    emit("split", shape=list(SPLIT), mode=mode, launches=launched,
         errors=errs, path_rel_err=path_err, many_heads=wide, times=times,
         plain_ms=t_plain,
         note="sdpa_bwd_ms, library_ms: SDPA's whole backward (dq, dk, dv) "
              "per backend and the fastest, at the kernels' q'")
    want = {"flash_fwd": 1, "flash_bwd": 0, "flash_bwd_dkdv": 1,
            "flash_bwd_dq": 1}
    if not held:
        fail(f"split pair or B2 disagrees with its plain version: {errs}, "
             f"{times}")
    if launched != want or max(path_err) > 5e-2:
        fail(f"split path launched {launched} for {want}, gradients off "
             f"by {path_err}")
    for w in wide:
        if w["launches"] != want or not w["ok"]:
            fail(f"flash_attention at {SPLIT_WIDE}: {w}, want launches "
                 f"{want}")

    err = {n: max(errs["split"][o]["max_abs_err"] for o in outs)
           for n, outs in (("flash_bwd_dkdv", ("dk", "dv")),
                           ("flash_bwd_dq", ("dq",)))}
    at = times["x".join(map(str, SPLIT))]
    entries = {}
    for name, key, body in (
            ("flash_bwd_dkdv", "k2_ms", "flash_bwd_sm90.cuh"),
            ("flash_bwd_dq", "k3_ms", "flash_dq_sm90.cuh")):
        flops, nbytes = split_bounds(SPLIT, dtype, causal)[name]
        entries[name] = _entry(
            name, at[key], t_plain, at["library_ms"], flops, nbytes, dtype,
            err[name], library_by_backend=at["sdpa_bwd_ms"],
            shape=list(SPLIT), body=f"horovod_tpu_torch/ops/csrc/{body}",
            note="plain_ms: the whole plain split backward; library_ms: "
                 "SDPA's whole backward")
    return launched, entries


def hold_padded(shape, dtype, causal, mode, seed):
    """K1 and the backward in ``mode``, each alone, on inputs zero-padded
    to the body's head dim as ``flash_attention`` pads them, against the
    plain side at the caller's head dim (``kernel_check``; the plain side
    walks the padded body's key tiles): ``{output: compare}``, and whether
    every padded column came out exactly 0."""
    d = shape[-1]
    _, qr, k, v, do, p2, scale_r = kernel_inputs(shape, dtype, seed)
    ref, delta = kernel_check.plain_outputs(qr, k, v, do, causal, scale_r,
                                            p2, mode)
    body = A.padded_head_dim(d)
    pad = [A.pad_head(t, body) for t in (qr, k, v, do)]
    got = kernel_check.kernel_outputs(*pad, ref["lse"], delta, p2, scale_r,
                                      causal, mode)
    zero_pad = all(int(torch.count_nonzero(t[..., d:])) == 0
                   for n, t in got.items() if n != "lse")
    got = {n: t if n == "lse" else t[..., :d] for n, t in got.items()}
    for name, t in got.items():
        if not torch.isfinite(t).all():
            fail(f"{name} not finite at {shape} {dtype}")
    return kernel_check.compare_outputs(got, ref), zero_pad


def drive_flash_attention(shape, dtype, causal, seed):
    """``flash_attention`` forward and backward at ``shape`` on inputs
    from ``seed``, with the counters zeroed just before and read just
    after: ``(launches, {o, dq, dk, dv}, the same of the plain blockwise
    path in f32)``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, ct = (torch.randn(shape, device="cuda", generator=g,
                               dtype=torch.float32).to(dtype)
                   for _ in range(4))
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    torch.cuda.synchronize()
    A.reset_launches()
    out = A.flash_attention(*xs, causal=causal)
    grads = torch.autograd.grad(out, xs, ct)
    torch.cuda.synchronize()
    launched = dict(A.launches)
    ref_in = [x.detach().float().requires_grad_() for x in xs]
    ref = A.blockwise_attention(*ref_in, causal=causal)
    ref_grads = torch.autograd.grad(ref, ref_in, ct.float())
    names = ("o", "dq", "dk", "dv")
    return (launched, dict(zip(names, (out.detach(), *grads))),
            dict(zip(names, (ref.detach(), *ref_grads))))


def _rel_errs(got, want):
    """Largest error of each output over the largest value of its plain
    version."""
    return {n: (got[n].float() - want[n]).abs().max().item()
            / want[n].abs().max().item() for n in got}


def sdpa_times(shape, dtype, causal, scale, seed):
    """SDPA's forward and whole backward at ``shape`` under each backend:
    ``(fwd by backend, fastest fwd, bwd by backend, fastest bwd)``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qs, ks, vs = (torch.randn(shape, device="cuda", generator=g,
                              dtype=torch.float32).to(dtype)
                  .requires_grad_() for _ in range(3))
    dos = torch.randn(shape, device="cuda", generator=g).to(dtype)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd, t_fwd = sdpa_ms(lambda: lambda: sdpa(qs, ks, vs, is_causal=causal,
                                              scale=scale))

    def bwd():
        out = sdpa(qs, ks, vs, is_causal=causal, scale=scale)
        return lambda: torch.autograd.grad(out, (qs, ks, vs), dos,
                                           retain_graph=True)
    bwd_by, t_bwd = sdpa_ms(bwd)
    return fwd, t_fwd, bwd_by, t_bwd


def attention_work(shape, dtype, causal):
    """``(pairs, tile bytes, row bytes)`` of attention at ``shape``."""
    b, h, s, d = shape
    pairs = causal_pairs(s, s, causal) * b * h
    tile = b * h * s * d * torch.tensor([], dtype=dtype).element_size()
    return pairs, tile, b * h * s * 4


def phase_head_dims():
    """Head dims other than the main path's (ROADMAP C.1), bf16, causal.
    K1, K2 and K3 at the wide head dim 256 on the split phase's shape, and
    K1 and B2 at head dims 16 and 80 (no body takes them: the inputs run
    zero-padded to 32 and 96) on the main path's shape, each held alone
    against its plain version at the caller's head dim; ``flash_attention``
    forward and backward at each, the counters zeroed just before and read
    just after each (K1 1, and K2 1 + K3 1 at 256, B2 1 at 16 and 80), its
    output and gradients against the plain blockwise path; then the
    kernels (at 256) and ``flash_attention`` (at 16 and 80, padding
    included) timed beside SDPA's fastest backend at the same head dim and
    the bound of the caller's work.  Returns the d-256 rows of the
    summary."""
    dtype, causal = torch.bfloat16, True
    cases = [(HEAD_DIM_WIDE, "split")] + [(s, "combined")
                                          for s in HEAD_DIM_PADDED]
    result, entries = {}, {}
    for shape, mode in cases:
        d = shape[-1]
        if A.bwd_mode(shape[2], d, shape[0] * shape[1]) != mode:
            fail(f"the plan does not pick {mode} at {shape}")
        errs, zero_pad = hold_padded(shape, dtype, causal, mode, 20 + d)
        launched, got, want = drive_flash_attention(shape, dtype, causal,
                                                    30 + d)
        if not all(bool(torch.isfinite(t).all()) for t in got.values()):
            fail(f"flash_attention at {shape}: non-finite output")
        path_err = _rel_errs(got, want)
        del got, want
        want_launches = {"flash_fwd": 1,
                         "flash_bwd": int(mode == "combined"),
                         "flash_bwd_dkdv": int(mode == "split"),
                         "flash_bwd_dq": int(mode == "split")}
        worst = max(e["worst"] for e in errs.values())
        row = {"shape": list(shape), "mode": mode,
               "body_head_dim": A.padded_head_dim(d), "errors": errs,
               "worst": worst, "padded_columns_zero": zero_pad,
               "launches": launched, "path_rel_err": path_err}
        result[f"d{d}"] = row
        if worst > 1.0 or not zero_pad or launched != want_launches \
                or max(path_err.values()) > 5e-2:
            emit("head_dims", cases=result)
            fail(f"head dim {d}: {row}, want launches {want_launches}")

        # Times: the kernels at 256; flash_attention itself at 16 and 80,
        # where the padding is part of the cost.
        pairs, tile, rowb = attention_work(shape, dtype, causal)
        scale = d ** -0.5
        lib_fwd, t_lib_fwd, lib_bwd, t_lib_bwd = sdpa_times(
            shape, dtype, causal, scale, 40 + d)
        fwd_bound = bound_ms(4 * d * pairs, 4 * tile + rowb, dtype)
        if mode == "split":
            _, qr, k, v, do, p2, scale_r = kernel_inputs(shape, dtype, 50)
            o, lse = A.flash_fwd(qr, k, v, scale_r, causal)
            delta = A._delta(o, do)
            del o
            largs = (qr, k, v, do, lse, delta, scale_r)
            t_k1 = time_ms(lambda: A.flash_fwd(qr, k, v, scale_r, causal))
            t_k2 = time_ms(lambda: A.flash_bwd_dkdv(*largs, causal))
            t_k3 = time_ms(lambda: A.flash_bwd_dq(*largs, p2, causal))
            t_plain_fwd = time_ms(lambda: A._blockwise_fwd_impl(
                qr, k, v, causal, scale_r,
                block_size=A.fwd_key_tile(dtype, d)), warmup=1, iters=3)
            t_plain_bwd = time_ms(lambda: kernel_check.plain_bwd_outputs(
                qr, k, v, do, lse, delta, p2, scale_r, causal, "split"),
                warmup=1, iters=3)
            row["times"] = {"k1_ms": t_k1, "k2_ms": t_k2, "k3_ms": t_k3,
                            "sdpa_fwd_ms": lib_fwd, "sdpa_bwd_ms": lib_bwd,
                            "k1_bound_ms": fwd_bound[0]}
            err = {n: max(errs[o]["max_abs_err"] for o in outs)
                   for n, outs in (("flash_fwd", ("o", "lse")),
                                   ("flash_bwd_dkdv", ("dk", "dv")),
                                   ("flash_bwd_dq", ("dq",)))}
            bounds = split_bounds(shape, dtype, causal)
            note = (f"head dim 256 at {list(shape)}; library_ms: SDPA's "
                    "fastest backend (forward for K1, whole backward for "
                    "K2 and K3)")
            entries["flash_fwd_d256"] = _entry(
                "flash_fwd_d256", t_k1, t_plain_fwd, t_lib_fwd,
                4 * d * pairs, 4 * tile + rowb, dtype, err["flash_fwd"],
                kernel="flash_fwd", library_by_backend=lib_fwd,
                shape=list(shape), note=note)
            for name, t in (("flash_bwd_dkdv", t_k2), ("flash_bwd_dq", t_k3)):
                entries[f"{name}_d256"] = _entry(
                    f"{name}_d256", t, t_plain_bwd, t_lib_bwd, *bounds[name],
                    dtype, err[name], kernel=name, library_by_backend=lib_bwd,
                    shape=list(shape),
                    note=note + "; plain_ms: the whole plain split backward")
            for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
                entries[f"{name}_d256"]["launches"] = launched[name]
            del largs, qr, k, v, do, lse, delta
        else:
            g = torch.Generator(device="cuda").manual_seed(60 + d)
            xs = [torch.randn(shape, device="cuda", generator=g,
                              dtype=torch.float32).to(dtype).requires_grad_()
                  for _ in range(3)]
            ct = torch.randn(shape, device="cuda", generator=g).to(dtype)
            with torch.no_grad():
                t_fwd = time_ms(lambda: A.flash_attention(*xs, causal=causal))
            out = A.flash_attention(*xs, causal=causal)
            t_bwd = time_ms(lambda: torch.autograd.grad(
                out, xs, ct, retain_graph=True))
            bwd_bound = bound_ms(10 * d * pairs, 7 * tile + 2 * rowb, dtype)
            # K1 and B2 alone on the padded inputs: the bodies' share.
            _, qr, k, v, do, p2, scale_r = kernel_inputs(shape, dtype, 50)
            pad = [A.pad_head(t, A.padded_head_dim(d)) for t in (qr, k, v, do)]
            o, lse = A.flash_fwd(*pad[:3], scale_r, causal)
            delta = A._delta(o, pad[3])
            t_k1 = time_ms(lambda: A.flash_fwd(*pad[:3], scale_r, causal))
            t_b2 = time_ms(lambda: A.flash_bwd(*pad, lse, delta, scale_r, p2,
                                               causal))
            del pad, o, lse, delta, qr, k, v, do
            row["times"] = {
                "fwd_ms": t_fwd, "bwd_ms": t_bwd, "k1_padded_ms": t_k1,
                "b2_padded_ms": t_b2, "sdpa_fwd_ms": lib_fwd,
                "sdpa_bwd_ms": lib_bwd, "library_fwd_ms": t_lib_fwd,
                "library_bwd_ms": t_lib_bwd, "fwd_bound_ms": fwd_bound[0],
                "bwd_bound_ms": bwd_bound[0]}
            del xs, ct, out
    emit("head_dims", cases=result,
         note="times: flash_attention (fwd_ms, bwd_ms: the padding, the "
              "kernels and the slicing) at head dims 16 and 80, K1 and B2 "
              "alone on the padded inputs beside them, the kernels alone at "
              "256; bounds of the caller's head dim's work; sdpa: each "
              "backend at the same head dim")
    return entries


def _worst(rows):
    return max(e["worst"] for r in rows for e in r["errors"].values())


def _max_err(rows, names):
    return max(r["errors"][n]["max_abs_err"] for r in rows for n in names)


def member_round_ms(mesh, launch, warmup=3, iters=15):
    """Median over rounds of the longest member's ``launch(i)``, by CUDA
    events on the member streams around the launches alone.  Each round
    forks the member streams off a sleep on the caller's stream, so every
    launch is queued before any starts, and joins them after the events;
    the fork and join stay outside the events."""
    rounds = []
    for _ in range(warmup + iters):
        torch.cuda._sleep(SLEEP_CYCLES)
        caller = mesh.fork()
        events = []
        for i in range(mesh.size):
            with mesh.on(i):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                launch(i)
                end.record()
                events.append((start, end))
        mesh.join(caller)
        rounds.append(events)
    torch.cuda.synchronize()
    return statistics.median(max(s.elapsed_time(e) for s, e in events)
                             for events in rounds[warmup:])


def handshake_split(mesh, xs):
    """Kernel-only times (``member_round_ms``) of K6 on the shards ``xs``,
    of K6 moving no bytes (its handshake and gate alone), of K7, of an
    empty kernel per member (the floor of any kernel on these streams) and
    of one ``copy_`` per member on its stream."""
    n = mesh.size
    outs = [torch.empty_like(x) for x in xs]
    table = (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs])
    table_ptr = ctypes.cast(table, ctypes.c_void_p)
    nbytes = xs[0].numel() * xs[0].element_size()
    k6 = rdma._kernel_fn("hvdt_ring_permute")
    k7 = RF._kernel_fn("ring_permute", "hvdt_phase_closer")
    zeros = [torch.empty((8, 128), device="cuda") for _ in range(n)]
    ns6, ns7 = rdma.NS_RDMA, RF.NS_FUSED + 1
    blocks = rdma.copy_blocks(n)

    def k6_launch(size):
        return lambda i: A._launch(
            k6, xs[i].data_ptr(), table_ptr, size, blocks, 1,
            mesh.flags.data_ptr(), mesh.go.data_ptr(), mesh.err.data_ptr(),
            i, n, ns6, mesh.next_epoch(i, ns6))
    split = {
        "k6_kernel_ms": member_round_ms(mesh, k6_launch(nbytes)),
        "k6_0b_kernel_ms": member_round_ms(mesh, k6_launch(0)),
        "k7_kernel_ms": member_round_ms(mesh, lambda i: A._launch(
            k7, zeros[i].data_ptr(), mesh.flags.data_ptr(),
            mesh.err.data_ptr(), i, n, ns7)),
        "empty_kernel_ms": member_round_ms(
            mesh, lambda i: torch.cuda._sleep(0)),
        "copy_members_ms": member_round_ms(
            mesh, lambda i: outs[i].copy_(xs[i]))}
    if not all(torch.equal(outs[i], x) for i, x in enumerate(xs)):
        fail("copy_ on the member streams did not copy")
    if not all(bool((z == 0).all()) for z in zeros):
        fail("K7 left a nonzero in its zero block")
    return split


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
        scale_r, block_size=A.bwd_key_tile("combined", dtype, RING[3]),
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
    lib_fwd, t_lib_fwd, lib_bwd, t_lib_bwd = sdpa_times(RING, dtype, False,
                                                        1.0, 1)
    t_k6 = time_ms(lambda: rdma.permute_shards(xs, mesh, 1, 0))
    split = handshake_split(mesh, xs)
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
            2 * N_MEMBERS * tile, dtype, 0.0,
            kernel_ms=split["k6_kernel_ms"], **{k: split[k] for k in (
                "k6_0b_kernel_ms", "empty_kernel_ms", "copy_members_ms")},
            note="ms: one round, fork and join included; kernel_ms: the "
                 "longest member launch by CUDA events on its stream "
                 "(k6_0b: moving no bytes, the handshake and gate alone; "
                 "empty: an empty kernel per member, the floor); library: "
                 "one copy_ per member on one stream (copy_members: each on "
                 "its member's stream, kernel-only)"),
        "phase_closer": _entry(
            "phase_closer", t_k7, None, None, 0, N_MEMBERS * 8 * 128 * 4,
            torch.float32, 0.0, kernel_ms=split["k7_kernel_ms"],
            empty_kernel_ms=split["empty_kernel_ms"],
            note="ms: one round, every member's launch, fork and join "
                 "included; kernel_ms: the longest member launch"),
    }
    emit("ring_kernels", cases=cases, shard=list(RING), members=N_MEMBERS,
         k6_exact=exact, k7_zero=k7_zero,
         timing={n: {k: e.get(k) for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")}
                 for n, e in entries.items()},
         k4_rotating_round_ms=t_k4_round, handshake_split=split,
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

# --- the data-parallel phases: ranks of the port's runner on this card ---


def run_ranks(phase, timeout, script=__file__):
    """Run ``<script> --rank <phase>`` (this script by default) on
    ``DP_RANKS`` ranks; each rank's ``RESULT`` line, parsed.  A rank that
    exits non-zero or a timeout fails the run; every rank's output is kept
    in OUT_DIR."""
    env = dict(os.environ)
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    results = run_command(
        [sys.executable, os.path.abspath(script), "--rank", phase],
        DP_RANKS, env=env, timeout=timeout, capture=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    out = []
    for r in results:
        with open(os.path.join(OUT_DIR, f"{phase}_rank{r.rank}.log"),
                  "w") as f:
            f.write(r.stdout + "\n--- stderr ---\n" + r.stderr)
        if r.returncode != 0:
            fail(f"{phase}: rank {r.rank} exited {r.returncode}:\n"
                 f"{r.stderr[-4000:]}")
        lines = [ln for ln in r.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if not lines:
            fail(f"{phase}: rank {r.rank} printed no result")
        out.append(json.loads(lines[-1][len("RESULT "):]))
    return out


def rank_result(**fields):
    print("RESULT " + json.dumps(fields), flush=True)


def events_ms(fn):
    """Milliseconds of ``fn``'s work on the current stream (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def rank_collectives():
    """One rank of ``collectives``: every op held against its exact value;
    raises on the first mismatch."""
    hvdt.init(device="cuda:0")
    r, n = hvdt.rank(), hvdt.size()
    held = []

    def hold(name, got, want):
        got = got.cpu()
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise RuntimeError(
                f"{name}: got {got.flatten()[:6].tolist()} ({got.dtype}, "
                f"{tuple(got.shape)}), want {want.flatten()[:6].tolist()} "
                f"({want.dtype}, {tuple(want.shape)})")
        held.append(name)

    for dtype in (torch.float32, torch.bfloat16, torch.float16, torch.int32):
        for numel in (1, 1001, (64 << 20) // dtype.itemsize):
            base = torch.arange(numel, device="cuda") % 7
            x = (base + r + 1).to(dtype)
            total = n * base + n * (n + 1) // 2
            mean = (total.double() / n if dtype.is_floating_point
                    else total // n)  # the engine truncates integer means
            tag = f"{str(dtype)[6:]}.{numel}"
            hold(f"sum.{tag}", hvdt.allreduce(x, average=False,
                                              name=f"sum.{tag}"),
                 total.to(dtype).cpu())
            hold(f"mean.{tag}", hvdt.allreduce(x, average=True,
                                               name=f"mean.{tag}"),
                 mean.to(dtype).cpu())
            y = x.clone()
            if hvdt.allreduce_(y, average=False, name=f"sum_.{tag}") is not y:
                raise RuntimeError("allreduce_ did not return its input")
            hold(f"sum_.{tag}", y, total.to(dtype).cpu())
            z = (base * (r + 1)).to(dtype)
            if hvdt.broadcast_(z, 1, name=f"bcast_.{tag}") is not z:
                raise RuntimeError("broadcast_ did not return its input")
            hold(f"bcast_.{tag}", z, (base * 2).to(dtype).cpu())
            del base, x, y, z, total, mean
    # The small copies queue behind a ~20 ms sleep kernel and land
    # together, as a backward's gradients do, so the staging thread
    # enqueues them in a burst that the engine can fuse.
    smalls = [torch.full((16,), float(i + r), device="cuda")
              for i in range(64)]
    torch.cuda._sleep(20 * SLEEP_CYCLES)
    handles = [hvdt.allreduce_async(x, average=False, name=f"small.{i}")
               for i, x in enumerate(smalls)]
    for i, h in enumerate(handles):
        hold(f"small.{i}", hvdt.synchronize(h),
             torch.full((16,), float(n * i + n * (n - 1) // 2)))
    small_ticks = len({h.completion_tick for h in handles})
    if small_ticks >= len(handles):
        raise RuntimeError(f"64 small allreduces took {small_ticks} engine "
                           "cycles: not fused")
    hold("allgather", hvdt.allgather(
        torch.full((r + 1, 3), float(r + 1), device="cuda"),
        name="allgather"),
        torch.cat([torch.full((k + 1, 3), float(k + 1)) for k in range(n)]))
    ramp = torch.arange(1001, dtype=torch.float32)
    hold("broadcast.root1", hvdt.broadcast(
        (ramp * (r + 1)).cuda(), 1, name="broadcast.root1"), ramp * 2)
    try:
        hvdt.allreduce(torch.ones(r + 2, device="cuda"), name="mismatch")
        raise RuntimeError("a shape mismatch across ranks did not raise")
    except ValueError as exc:
        mismatch = f"{type(exc).__name__}: {exc}"[:300]

    # 224 MiB of f32, split: D2H into pinned memory, the engine's host
    # allreduce of it, H2D back; then through the staging route whole.
    numel = GRAD_BYTES // 4
    g = torch.full((numel,), float(r + 1), device="cuda")
    mean = torch.full((len(range(0, numel, 1 << 16)),), (n + 1) / 2)
    buf = torch.empty(numel, pin_memory=True)
    seq = iter(range(1 << 30))

    def barrier():
        hvd_common.allreduce_async(torch.zeros(1), False,
                                   f"barrier.{next(seq)}").wait()

    split = {"d2h_ms": [], "engine_ms": [], "h2d_ms": [], "whole_ms": []}
    for i in range(4):
        torch.cuda.synchronize()
        barrier()
        d2h = events_ms(lambda: buf.copy_(g, non_blocking=True))
        barrier()
        t0 = time.perf_counter()
        hvd_common.allreduce_async(buf, True, "big.host", out=buf).wait()
        eng = (time.perf_counter() - t0) * 1e3
        h2d = events_ms(lambda: g.copy_(buf, non_blocking=True))
        hold(f"big.host.{i}", g[:: 1 << 16], mean)
        g.fill_(float(r + 1))  # the ranks differ again for the whole route
        barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hvdt.allreduce_(g, average=True, name="big")
        torch.cuda.synchronize()
        whole = (time.perf_counter() - t0) * 1e3
        hold(f"big.{i}", g[:: 1 << 16], mean)
        g.fill_(float(r + 1))
        if i:
            for k, v in zip(split, (d2h, eng, h2d, whole)):
                split[k].append(v)
    # The engine alone on host buffers by size: where its rate settles.
    sweep = {}
    for mib in (1, 4, 16, 64, 224):
        host = buf[:(mib << 20) // 4]
        times = []
        for _ in range(3):
            barrier()
            t0 = time.perf_counter()
            hvd_common.allreduce_async(host, True, f"sweep.{mib}",
                                       out=host).wait()
            times.append((time.perf_counter() - t0) * 1e3)
        sweep[mib] = statistics.median(times)
    rank_result(rank=r, size=n, held=len(held), small_ticks=small_ticks,
                mismatch=mismatch, pinned_allocs=hvdt.mpi_ops.pinned_allocs[0],
                **{k: statistics.median(v) for k, v in split.items()},
                split_runs=split, engine_ms_by_mib=sweep)
    hvdt.shutdown()


def phase_collectives():
    res = run_ranks("collectives", timeout=300)
    smi = smi_line()
    emit("collectives", ranks=res, nvidia_smi=smi,
         grad_bytes=GRAD_BYTES,
         d2h_ms=max(x["d2h_ms"] for x in res),
         engine_ms=max(x["engine_ms"] for x in res),
         h2d_ms=max(x["h2d_ms"] for x in res),
         whole_ms=max(x["whole_ms"] for x in res),
         engine_ms_by_mib={k: max(x["engine_ms_by_mib"][k] for x in res)
                           for k in res[0]["engine_ms_by_mib"]})
    if len({x["held"] for x in res}) != 1 or not res[0]["held"]:
        fail(f"collectives: the ranks held different checks: {res}")


def profile_step(step, data, rank):
    """One step under ``torch.profiler``: ``(wall ms, kernel-busy ms,
    D2H ms, H2D ms)`` of this process, or Nones if the trace holds no
    device time."""
    path = os.path.join(OUT_DIR, f"train_dp_trace_rank{rank}.json")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(data).item()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    copies = [e for e in events
              if e.get("cat") == "gpu_memcpy" and "dur" in e]
    if not kernels:
        return wall, None, None, None
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels + copies)
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    d2h = sum(e["dur"] for e in copies if "DtoH" in e["name"]) / 1e3
    h2d = sum(e["dur"] for e in copies if "HtoD" in e["name"]) / 1e3
    return wall, busy / 1e3, d2h, h2d


def params_digest(model):
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().contiguous().cpu().view(torch.uint8).numpy())
    return h.hexdigest()


def rank_train_dp():
    """One rank of ``train_dp``."""
    hvdt.init(device="cuda:0")
    r, n = hvdt.rank(), hvdt.size()
    batch = HEADLINE["batch"]
    model, step, data = build_lm_step(**HEADLINE, seed=100)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    warmup, timed = 2, 5
    A.reset_launches()
    losses, step_ms, sync_ms, cycles = [], [], [], []
    for i in range(warmup + timed):
        t0 = time.perf_counter()
        loss = step(data).item()
        dt = (time.perf_counter() - t0) * 1e3
        losses.append(loss)
        cycles.append(len(set(step.optimizer.last_ticks)))
        if i >= warmup:
            step_ms.append(dt)
            sync_ms.append(step.sync_sec[-1] * 1e3)
    torch.cuda.synchronize()
    launched = dict(A.launches)
    peak = torch.cuda.max_memory_allocated()
    handles = len(step.optimizer.last_ticks)
    digest = params_digest(model)
    wall, busy, d2h, h2d = profile_step(step, data, r)
    del model, step, data
    torch.cuda.empty_cache()
    avg_losses = averaging_losses(slice(r * batch // n, (r + 1) * batch // n))
    rank_result(rank=r, size=n, losses=losses, step_ms=step_ms,
                median_step_ms=statistics.median(step_ms), sync_ms=sync_ms,
                median_sync_ms=statistics.median(sync_ms),
                max_memory_allocated=peak, launches=launched,
                grad_handles=handles, engine_cycles_per_step=cycles,
                digest=digest, profiled_step_ms=wall, busy_ms=busy,
                d2h_ms=d2h, h2d_ms=h2d, avg_losses=avg_losses)
    hvdt.shutdown()


def averaging_losses(rows):
    """The averaging check's run on this rank: 3 steps of the LM headline
    from ``AVG_SEED`` on rows ``rows`` of one batch drawn from
    ``RandomState(AVG_SEED)``.  Every size starts from the same weights
    and optimizer state: at size 1 the zero-learning-rate step that a
    data-parallel run's ``broadcast_optimizer_state`` takes is taken
    here."""
    _, step, _ = build_lm_step(**HEADLINE, seed=AVG_SEED)
    if hvd.size() == 1:
        hvdt.broadcast_optimizer_state(step.optimizer, root_rank=0)
    vocab, batch, seq = (HEADLINE[k] for k in ("vocab_size", "batch", "seq"))
    tokens = torch.from_numpy(np.random.RandomState(AVG_SEED).randint(
        0, vocab, (batch, seq + 1))[rows]).cuda()
    losses = [step((tokens[:, :-1], tokens[:, 1:])).item() for _ in range(3)]
    del step, tokens
    torch.cuda.empty_cache()
    return losses


def averaging_reference():
    """``(refs, tolerance)``: two size-1 runs of ``averaging_losses`` on
    every row, and per step 3x their spread (B2's f32 dQ adds are not
    ordered), at least 1e-3 of the loss."""
    hvd.init()
    refs = [averaging_losses(slice(None)) for _ in range(2)]
    hvd.shutdown()
    spread = [abs(a - b) for a, b in zip(*refs)]
    return refs, [max(3 * s, 1e-3 * abs(a)) for s, a in zip(spread, refs[0])]


def phase_train_dp():
    torch.cuda.empty_cache()
    res = run_ranks("train_dp", timeout=300)
    vocab, batch, seq = (HEADLINE[k] for k in ("vocab_size", "batch", "seq"))
    per = HEADLINE["n_layers"] * 7
    want = {"flash_fwd": per, "flash_bwd": per, "flash_bwd_dkdv": 0,
            "flash_bwd_dq": 0}
    step_ms = max(x["median_step_ms"] for x in res)
    busy = [x["busy_ms"] for x in res]
    idle = (None if None in busy
            else 1.0 - sum(busy) / max(x["profiled_step_ms"] for x in res))

    refs, tol = averaging_reference()
    dp = res[0]["avg_losses"]
    off = [abs(a - b) for a, b in zip(dp, refs[0])]
    emit("train_dp", ranks=DP_RANKS, batch_per_rank=batch, seq=seq,
         nvidia_smi=smi_line(),
         tokens_per_s=DP_RANKS * batch * seq / (step_ms / 1e3),
         median_step_ms=step_ms,
         median_sync_ms=[x["median_sync_ms"] for x in res],
         max_memory_allocated=[x["max_memory_allocated"] for x in res],
         engine_cycles_per_step=[x["engine_cycles_per_step"] for x in res],
         grad_handles=res[0]["grad_handles"],
         profiled_step_ms=[x["profiled_step_ms"] for x in res],
         kernel_and_copy_busy_ms=busy,
         d2h_ms=[x["d2h_ms"] for x in res], h2d_ms=[x["h2d_ms"] for x in res],
         card_idle_share_estimate=idle,
         losses=res[0]["losses"], launches=[x["launches"] for x in res],
         want_launches=want, digests=[x["digest"] for x in res],
         averaging={"dp": dp, "size1": refs, "abs_err": off,
                    "tolerance": tol})
    for x in res:
        if x["launches"] != want:
            fail(f"train_dp rank {x['rank']} launched {x['launches']}, "
                 f"want {want}")
        if x["losses"] != res[0]["losses"]:
            fail(f"train_dp: the ranks' mean losses differ: {res}")
        if x["grad_handles"] != 51 or max(
                x["engine_cycles_per_step"]) >= x["grad_handles"]:
            fail(f"train_dp: gradient handles not fused: {x}")
    if len({x["digest"] for x in res}) != 1:
        fail("train_dp: the ranks' parameters differ after the steps")
    losses = res[0]["losses"]
    if not all(math.isfinite(x) for x in losses):
        fail(f"train_dp: non-finite loss: {losses}")
    if abs(losses[0] - math.log(vocab)) > 1.0 or losses[-1] >= losses[0]:
        fail(f"train_dp: implausible loss trajectory: {losses}")
    if any(o > t for o, t in zip(off, tol)):
        fail(f"train_dp: averaged losses {dp} against size-1 {refs[0]}, "
             f"tolerance {tol}")
    return res[0]["launches"]


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main():
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    emit("device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    # The engine (g++) builds beside the kernels (nvcc).
    engine = {}

    def build_engine():
        try:
            engine["path"] = engine_build.build()
        except BaseException as exc:
            engine["error"] = exc

    engine_thread = threading.Thread(target=build_engine)
    engine_thread.start()
    t0 = time.perf_counter()
    info = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         sources={k: {"seconds": v["seconds"], "cached": v["cached"]}
                  for k, v in info.items()})
    engine_thread.join()
    if "error" in engine:
        raise engine["error"]
    symbols = engine_build.exported_symbols(engine["path"])
    foreign = [x for x in symbols if not x.startswith("hvd_tpu_")]
    emit("engine", seconds=engine_build.build_info["seconds"],
         cached=engine_build.build_info["cached"],
         library=os.path.basename(engine["path"]), exported=len(symbols),
         not_c_api=foreign)
    if foreign or not symbols:
        fail(f"the engine exports {len(foreign)} symbols beyond its C API: "
             f"{foreign[:10]}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        for k, v in info.items():
            f.write(f"== {k}\n{v['log']}\n")

    entries = phase_kernels()
    phase_model()
    launched = phase_train()
    split, split_entries = phase_split()
    entries.update(split_entries)
    wide_entries = phase_head_dims()
    ring_entries = phase_ring_kernels()
    phase_ring_model()
    launched.update(phase_ring_train())
    phase_collectives()
    dp_launched = phase_train_dp()
    entries.update(ring_entries)
    for name_, e in entries.items():
        # K2 and K3 run on the split path, every other kernel on the main
        # path or the ring path.
        e["launches"] = (split if name_ in ("flash_bwd_dkdv", "flash_bwd_dq")
                         else launched)[name_]
    for name_ in ("flash_fwd", "flash_bwd"):
        entries[name_]["launches_train_dp_per_rank"] = dp_launched[name_]
    # The d-256 rows carry the launches of the head_dims phase's path.
    entries.update(wide_entries)
    for name_, e in entries.items():
        if not e["launches"]:
            fail(f"{name_} was not launched on its path")
    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


RANK_PHASES = {"collectives": rank_collectives, "train_dp": rank_train_dp}

if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        RANK_PHASES[sys.argv[2]]()
    else:
        main()
