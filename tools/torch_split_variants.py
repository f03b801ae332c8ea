"""Design choices of the split backward pair (K2, K3), timed on the GPU.

Run from the repository root on a machine with one CUDA GPU::

    python3 tools/torch_split_variants.py

Each variant is a copy of the kernel sources with one or two lines
changed (under ``horovod_tpu_torch/_build/variants/``; the checked-in
sources are not touched), built with the same nvcc flags, all builds in
parallel.  ``VARIANTS`` holds the alternatives to the checked-in choices:

* ``k2_two_stages`` — K2 (``flash_bwd_dkdv``, the backward body of B2 and
  K5 with its dQ product compiled out) streams its (q', dO) tiles through
  two stages, as B2 does, instead of the ``DKDV_STAGES`` the shared memory
  freed by the dQ buffers allows;
* ``k3_128_keys`` — K3 (``flash_bwd_dq``) takes 128-key tiles up to head
  dim 64 (S, dP, the packed dS and dQ of the pipelined loop then need
  more registers than a consumer warpgroup has: ptxas spills);
* ``k3_two_stages``, ``k3_four_stages`` — K3 streams K and V through two
  or four stages instead of ``DQ_STAGES``.

Every build is held against the plain side of the split pair that walks
its own K3 key tile (``kernel_check``; ``worst`` <= 1 passes), then K2
and K3 are timed with the checked-in build and each variant in turns
(checked-in, variant, variant, checked-in, twice) at the split path's
shapes (bf16, causal, head dim 64), by CUDA events, median of 15 after
warm-up with a sleep kernel ahead.  Prints one JSON line: per shape and
kernel, each build's medians.
"""

from __future__ import annotations

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
from horovod_tpu_torch.ops import kernel_check  # noqa: E402

STEM = "flash_bwd_split"
SHAPES = ((1040, 512, 64), (64, 8192, 64), (32, 16384, 64))  # bh, s, d
SLEEP_CYCLES = 2_000_000  # ≈1 ms at the H100's clock
# variant: ([(file, line, replacement)], K3's key tile at head dim 64)
VARIANTS = {
    "k2_two_stages": ([("flash_bwd_sm90.cuh",
                        "constexpr int DKDV_STAGES = 3;",
                        "constexpr int DKDV_STAGES = 2;")], None),
    "k3_128_keys": ([("flash_dq_sm90.cuh", "  return 64;\n",
                      "  return D <= 64 ? 128 : 64;\n")], 128),
    "k3_two_stages": ([("flash_dq_sm90.cuh",
                        "constexpr int DQ_STAGES = 3;",
                        "constexpr int DQ_STAGES = 2;")], None),
    "k3_four_stages": ([("flash_dq_sm90.cuh",
                         "constexpr int DQ_STAGES = 3;",
                         "constexpr int DQ_STAGES = 4;")], None),
}


def build_variants():
    """``{variant: path of its shared library}``, nvcc runs in parallel."""
    procs = {}
    for name, (edits, _) in VARIANTS.items():
        d = os.path.join(_build.BUILD_DIR, "variants", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        for file, old, new in edits:
            path = os.path.join(d, file)
            text = open(path).read()
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: line not found once in {file}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        out = os.path.join(d, f"{STEM}.so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
             os.path.join(d, f"{STEM}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    paths = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        paths[name] = out
    return paths


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


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_split_variants: no CUDA device")
    _build.build_all([STEM])
    libs = {"checked_in": _build.load(STEM)}
    libs.update({n: ctypes.CDLL(p) for n, p in build_variants().items()})
    result, ok = {}, True
    for bh, s, d in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(s)
        q, k, v, do = (torch.randn(bh, s, d, device="cuda", generator=g)
                       .to(torch.bfloat16) for _ in range(4))
        p2, r = A._split_scale(d ** -0.5)
        qr = (q * p2).to(torch.bfloat16)
        o, lse = A.flash_fwd(qr, k, v, r, True)
        delta = A._delta(o, do)
        args = (qr, k, v, do, lse, delta, r)
        kernels = {"k2": lambda: A.flash_bwd_dkdv(*args, True),
                   "k3": lambda: A.flash_bwd_dq(*args, p2, True)}
        tiles = {n: VARIANTS[n][1] if n in VARIANTS else None for n in libs}
        wants = {}
        for tile in set(tiles.values()):
            block = tile or A.bwd_key_tile("split", torch.bfloat16, d)
            dq, dk, dv = A._attention_bwd_impl(
                qr, k, v, lse, delta, do, True, r, block_size=block,
                dq_scale=p2, round_pds=True)
            wants[tile] = {"dq": dq, "dk": dk, "dv": dv}
        worst = {}
        for n, lib in libs.items():
            _build._libs[STEM] = lib
            dk, dv = kernels["k2"]()
            got = {"dq": kernels["k3"](), "dk": dk, "dv": dv}
            worst[n] = max(kernel_check.compare(got[x], wants[tiles[n]][x])[
                "worst"] for x in got)
            ok &= worst[n] <= 1.0
        times = {kern: {n: [] for n in libs} for kern in kernels}
        for n in VARIANTS:
            for m in ("checked_in", n, n, "checked_in") * 2:
                _build._libs[STEM] = libs[m]
                for kern, fn in kernels.items():
                    times[kern][m].append(time_ms(fn))
        _build._libs[STEM] = libs["checked_in"]
        result["x".join(map(str, (bh, s, d)))] = {
            "median_ms": {kern: {n: statistics.median(t)
                                 for n, t in ts.items()}
                          for kern, ts in times.items()},
            "worst": worst}
        del q, k, v, do, qr, o, lse, delta, args, wants
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "ok": ok, "shapes": result}),
          flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
