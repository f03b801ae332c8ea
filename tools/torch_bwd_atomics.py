"""What the dQ adds cost B2, the combined flash backward, on the GPU.

Run from the repository root on a machine with one CUDA GPU::

    python3 tools/torch_bwd_atomics.py          # bf16
    python3 tools/torch_bwd_atomics.py --f32    # the 3xTF32 body

B2 (``csrc/flash_bwd_sm90.cuh``; in float32 ``csrc/flash_wide_f32_sm90.cuh``,
whose body adds each warpgroup's 16-row dQ tile of a 32-row query step)
adds each 64-row dQ tile of its key tile into an f32 workspace (a TMA
reduce-add per 32-column panel, atomic in the L2): the one step that
leaves the tensor cores.  This builds a copy of ``flash_bwd.cu`` whose
body skips those adds (under ``horovod_tpu_torch/_build/atomics/``; the
checked-in sources are not touched; its dq is wrong, the rest is the
same work) and times B2 at the main path's shape (bh 128, seq 1024,
head_dim 64, bf16 or float32, causal) with the sound build and the copy
in turns (sound, copy, copy, sound, twice), by CUDA events around the
wrapper (its zero fill of the workspace, the kernel and the flush),
median of 15 after warm-up, a sleep kernel ahead of each so the events
hold device time.  A
``torch.profiler`` trace of 10 calls of each build splits the wrapper's
device time by kernel.  Prints one JSON line: ``atomics_share`` is the
share of the sound kernel's time that the copy saves.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from horovod_tpu_torch.ops import _build  # noqa: E402
from horovod_tpu_torch.ops import attention as A  # noqa: E402

SHAPE = (128, 1024, 64)  # (batch*heads, seq, head_dim) of the LM step
# dtype: (the body's file, its adds, the body's kernel in a profile)
ADDS = {
    torch.bfloat16: ("flash_bwd_sm90.cuh", """\
            tma_reduce_add(mdq, base + dq_off + p * L::DQ_PANEL,
                           col0 + 32 * p, q0, bh);
""", "flash_bwd_kernel"),
    torch.float32: ("flash_wide_f32_sm90.cuh", """\
            tma_reduce_add(mdq, base + L::dq + c * L::DQ_BYTES +
                                    p * L::DQ_PANEL,
                           (cols.w0 + p) * F32_PANEL,
                           q0 + c * F32_BWD_DQ_ROWS, bh);
""", "wide32::bwd_kernel"),
}
SLEEP_CYCLES = 2_000_000  # ≈1 ms at the H100's clock


def build_without_adds(dtype) -> str:
    file, adds, _ = ADDS[dtype]
    d = os.path.join(_build.BUILD_DIR, "atomics")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    path = os.path.join(d, file)
    text = open(path).read()
    if text.count(adds) != 1:
        raise RuntimeError("the dQ adds are not found once in the body")
    with open(path, "w") as f:
        f.write(text.replace(adds, "            (void)p;\n"))
    out = os.path.join(d, "flash_bwd.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
                           os.path.join(d, "flash_bwd.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    return out


def time_ms(fn, warmup=3, iters=15):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms(fn, calls=10):
    """Device ms per call of each kernel ``fn`` launches (profiler)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        dev = getattr(e, "device_time_total", None)
        if dev is None:
            dev = e.cuda_time_total
        if dev > 0:
            out[e.key[:80]] = dev / calls / 1e3
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--f32", action="store_true",
                    help="float32 inputs: B2's 3xTF32 body")
    dtype = torch.float32 if ap.parse_args().f32 else torch.bfloat16
    if not torch.cuda.is_available():
        sys.exit("torch_bwd_atomics: no CUDA device")
    _build.build_all(["flash_bwd"])
    libs = {"sound": _build.load("flash_bwd"),
            "no_adds": ctypes.CDLL(build_without_adds(dtype))}
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(*SHAPE, device="cuda", generator=g)
                   .to(dtype) for _ in range(4))
    p2, scale_r = A._split_scale(SHAPE[2] ** -0.5)
    qr = (q * p2).to(dtype)
    o, lse = A.flash_fwd(qr, k, v, scale_r, True)
    delta = A._delta(o, do)

    def b2():
        return A.flash_bwd(qr, k, v, do, lse, delta, scale_r, p2, True)

    runs = {name: [] for name in libs}
    for name in ("sound", "no_adds", "no_adds", "sound") * 2:
        _build._libs["flash_bwd"] = libs[name]
        runs[name].append(time_ms(b2))
    split = {}
    for name, lib in libs.items():
        _build._libs["flash_bwd"] = lib
        split[name] = kernel_ms(b2)
    _build._libs["flash_bwd"] = libs["sound"]

    def body(name):
        return sum(ms for key, ms in split[name].items()
                   if ADDS[dtype][2] in key)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "shape": list(SHAPE), "dtype": str(dtype), "wrapper_ms": runs,
        "wrapper_ms_median": {n: statistics.median(r)
                              for n, r in runs.items()},
        "kernel_ms_per_call": split,
        "atomics_share": 1.0 - body("no_adds") / body("sound"),
    }), flush=True)


if __name__ == "__main__":
    main()
