"""Where the time of one horovod_tpu_torch training step goes, on the GPU.

Run from the repository root on a machine with one CUDA GPU::

    python3 tools/torch_step_profile.py [--steps 3] [--ring]

Builds the main path that ``chip_smoke.py`` drives
(``horovod_tpu_torch/torch/lm_step.py``: bench-width TransformerLM, bf16,
batch 16 x seq 1024, ``DistributedOptimizer(AdamW)``,
``build_train_step``; K1 and the combined backward B2) or, with
``--ring``, its ring path (the same widths sequence-parallel over 4
members on the card, batch 4 x seq 4096, the fused ring: K4, K5, K7),
warms it up, times ``--steps`` untraced steps with CUDA events, then
traces ``--steps`` more with ``torch.profiler``.  From
the Chrome trace it sums GPU kernel time by category (the port's flash
kernels, matrix products, everything else) and the union of kernel
intervals (the members' streams overlap, so the categories can sum to
more than the union).  That union against the traced window's host wall
time is the
measured idle share under the profiler; against the untraced step time
it is an estimate of the idle share without the profiler (kernel
durations taken from the traced steps).  Prints one JSON line.  A table
of the 25 largest kernels goes to ``chiprun_out/`` (``_ring`` in its name
with ``--ring``), and so does the main path's trace; the ring path's
trace is deleted once read (it is larger than a chip call brings back).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch.ops import attention as A  # noqa: E402
from horovod_tpu_torch.ops import ring_flash as RF  # noqa: E402
from horovod_tpu_torch.torch.lm_step import (HEADLINE,  # noqa: E402
                                             RING_HEADLINE, build_lm_step)


def category(name: str) -> str:
    for kernel, cat in (("ring_fwd_kernel", "ring_flash_fwd"),
                        ("ring_fwd_f32_kernel", "ring_flash_fwd"),
                        ("ring_bwd_kernel", "ring_flash_bwd"),
                        ("ring_bwd_f32_kernel", "ring_flash_bwd"),
                        ("phase_closer_kernel", "phase_closer"),
                        # B2's dQ flush (the ring path never flushes)
                        ("scale_cast_kernel", "flash_bwd")):
        if kernel in name:
            return cat
    if "flash_fwd_kernel" in name or "flash_fwd_f32_kernel" in name:
        return "flash_fwd"
    if "flash_bwd_kernel" in name or "flash_bwd_f32_kernel" in name:
        return "flash_bwd"
    if "flash_bwd_dkdv_kernel" in name:
        return "flash_bwd_dkdv"
    if "flash_bwd_dq_kernel" in name:
        return "flash_bwd_dq"
    low = name.lower()
    if any(t in low for t in ("gemm", "cutlass", "xmma", "cublas", "sm90_",
                              "nvjet")):
        return "matmul"
    if "adam" in low or "multi_tensor" in low or "foreach" in low:
        return "optimizer"
    if "softmax" in low or "nll" in low or "cross_entropy" in low:
        return "loss"
    if "copy_kernel" in low:
        return "cast_copy"
    if "elementwise_kernel" in low:
        return "elementwise"
    if "reduce_kernel" in low:
        return "reduce"
    return "other"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--ring", action="store_true",
                    help="the sequence-parallel ring path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_step_profile: no CUDA device")
    hvd.init()
    torch.cuda.set_device(hvd.local_rank())
    _, step, data = build_lm_step(**(RING_HEADLINE if args.ring
                                     else HEADLINE))
    tag = "_ring" if args.ring else ""
    for _ in range(3):
        step(data).item()
    torch.cuda.synchronize()
    # The same steps untraced first, timed with CUDA events, so the idle
    # estimate below sets traced kernel time against an untraced step of
    # this process.
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.steps):
        step(data)
    end.record()
    end.synchronize()
    untraced_ms = start.elapsed_time(end) / args.steps

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, f"torch_step_trace{tag}.json")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    A.reset_launches()
    RF.reset_launches()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(data)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    prof.export_chrome_trace(trace_path)

    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    if args.ring:
        os.remove(trace_path)
    kernels = [e for e in events
               if e.get("cat") == "kernel" and "dur" in e]
    if not kernels:
        sys.exit("torch_step_profile: the trace holds no GPU kernels")
    by_cat, by_name = {}, {}
    for e in kernels:
        by_cat[category(e["name"])] = by_cat.get(
            category(e["name"]), 0.0) + e["dur"]
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    kernel_sum = sum(by_cat.values())
    result = {
        "device": torch.cuda.get_device_name(0),
        "steps": args.steps,
        "step_ms_wall": wall_us / args.steps / 1e3,
        "kernel_ms_per_step": {k: v / args.steps / 1e3
                               for k, v in sorted(by_cat.items())},
        "kernel_share": {k: v / kernel_sum for k, v in sorted(by_cat.items())},
        "device_busy_ms_per_step": busy / args.steps / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "step_ms_untraced": untraced_ms,
        "device_idle_share_untraced_estimate":
            1.0 - busy / args.steps / 1e3 / untraced_ms,
        "path": "ring" if args.ring else "main",
        "launches": {**A.launches, **RF.launches},
    }
    with open(os.path.join(out_dir, f"torch_step_top_kernels{tag}.txt"),
              "w") as f:
        for name, us in sorted(by_name.items(), key=lambda x: -x[1])[:25]:
            f.write(f"{us / args.steps / 1e3:10.4f} ms/step  {name}\n")
    print(json.dumps(result), flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
