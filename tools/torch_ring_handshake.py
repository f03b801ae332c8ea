"""The ring's handshake kernels K6 and K7, timed apart on the GPU.

Run from the repository root on a machine with one CUDA GPU::

    python3 tools/torch_ring_handshake.py [--root CHECKOUT] [--label NAME]

``--root`` times the kernels of another checkout of the repository (its
``horovod_tpu_torch``, built from its own sources), so one call can take
two trees in turns.  On a ring of 4 members co-located on the card, each
on its own stream (``RingMesh``), at the ring path's shard (32, 1024, 64)
bf16, 4.2 MB per member:

* ``k6`` — K6 (``ring_permute``) kernel-only: the longest member launch;
* ``k6_16b``, ``k6_0b`` — K6 moving 16 bytes, and none: the handshake and
  the gate alone;
* ``k6_no_gate`` — a build of K6 with its gate compiled out (a copy of the
  sources under ``horovod_tpu_torch/_build/variants/``): the copy alone;
* ``k7`` — K7 (``phase_closer``) kernel-only;
* ``empty`` — an empty kernel per member (``torch.cuda._sleep(0)``): the
  floor of any kernel on these streams;
* ``copy_members`` — one ``copy_`` per member on its stream;
* ``copy_seq`` — four ``copy_`` calls on one stream (the library
  yardstick of K6 in ``chip_smoke.py``);
* ``k6_round``, ``k7_round`` — a round with the fork and the join.

Kernel-only: each round forks the member streams off a 1 ms sleep on the
caller's stream, so every launch is queued before any starts, records
CUDA events on each member's stream around its launch alone, and joins
after; the longest member's time, median over 15 rounds after 3 warm-up
rounds (``spread``: the least, the quartiles and the largest).  K6's rotations are checked bit for bit and every flag word must
be back at 0 at the end.  Prints one JSON line, then the ``nvidia-smi``
name and power limit.
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

SLEEP_CYCLES = 2_000_000  # ≈1 ms at the H100's clock
SHARD = (32, 1024, 64)    # a member's K (or V) shard on the ring path
N = 4
# The line of ring_permute.cu that gates the copy, in each K6 design; the
# variant drops it.
GATE_LINES = (
    "  if (!copy_gate(ring, shift, blockIdx.x)) return;\n",
    "  const bool open = gate(ring, shift, rounds > 0);\n",
)
GATE_REPLACEMENTS = ("", "  const bool open = true;\n")


def member_round_ms(mesh, launch, warmup=3, iters=15):
    """The longest member's ``launch(i)`` of each timed round, sorted, by
    CUDA events on the member streams around the launches alone."""
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
    return sorted(max(s.elapsed_time(e) for s, e in ev)
                  for ev in rounds[warmup:])


def time_ms(fn, warmup=3, iters=15):
    """Median device milliseconds of ``fn`` behind a 1 ms sleep."""
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


def build_no_gate(build_mod):
    """The shared library of ring_permute.cu with its gate compiled out."""
    d = os.path.join(build_mod.BUILD_DIR, "variants", "k6_no_gate")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(build_mod.CSRC, d)
    path = os.path.join(d, "ring_permute.cu")
    text = open(path).read()
    for old, new in zip(GATE_LINES, GATE_REPLACEMENTS):
        if text.count(old) == 1:
            text = text.replace(old, new)
            break
    else:
        raise RuntimeError("k6_no_gate: no known gate line in ring_permute.cu")
    with open(path, "w") as f:
        f.write(text)
    out = os.path.join(d, "ring_permute.so")
    proc = subprocess.run([build_mod._nvcc(), *build_mod.NVCC_FLAGS, "-o",
                           out, path], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for k6_no_gate:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(out)
    prep = lib.hvdt_ring_permute_prepare
    prep.argtypes, prep.restype = [], ctypes.c_int
    rc = prep()
    if rc:
        raise RuntimeError(f"k6_no_gate: prepare failed (cudaError {rc})")
    return lib


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_ring_handshake: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import attention as A
    from horovod_tpu_torch.ops import rdma
    from horovod_tpu_torch.ops import ring_flash as RF
    from horovod_tpu_torch.parallel import RingMesh

    _build.build_all(["ring_permute", "ring_flash"])
    no_gate = build_no_gate(_build)
    mesh = RingMesh(N)
    g = torch.Generator(device="cuda").manual_seed(5)
    xs = [torch.randn(SHARD, device="cuda", generator=g).to(torch.bfloat16)
          for _ in range(N)]
    outs = [torch.empty_like(x) for x in xs]
    table = (ctypes.c_void_p * N)(*[o.data_ptr() for o in outs])
    table_ptr = ctypes.cast(table, ctypes.c_void_p)
    nbytes = xs[0].numel() * xs[0].element_size()
    blocks = (rdma.copy_blocks(N) if hasattr(rdma, "copy_blocks")
              else rdma.COPY_BLOCKS)
    k6 = rdma._kernel_fn("hvdt_ring_permute")
    fn_ng = no_gate.hvdt_ring_permute
    fn_ng.argtypes, fn_ng.restype = k6.argtypes, ctypes.c_int
    k7 = RF._kernel_fn("ring_permute", "hvdt_phase_closer")
    zeros = [torch.empty((8, 128), device="cuda") for _ in range(N)]
    ns6, ns7 = rdma.NS_RDMA, RF.NS_FUSED + 1

    def k6_launch(fn, size):
        def launch(i):
            A._launch(fn, xs[i].data_ptr(), table_ptr, size, blocks, 1,
                      mesh.flags.data_ptr(), mesh.go.data_ptr(),
                      mesh.err.data_ptr(), i, N, ns6, mesh.next_epoch(i, ns6))
        return launch

    def k7_launch(i):
        A._launch(k7, zeros[i].data_ptr(), mesh.flags.data_ptr(),
                  mesh.err.data_ptr(), i, N, ns7)

    result = {"label": args.label, "root": os.path.abspath(args.root),
              "shard_bytes": nbytes, "blocks": blocks}
    spread = {}

    def kernel_only(name, launch):
        """The median into ``result``, the quartiles and extremes into
        ``spread``."""
        t = member_round_ms(mesh, launch)
        result[name] = statistics.median(t)
        spread[name] = [t[0], t[len(t) // 4], t[3 * len(t) // 4], t[-1]]
    for o in outs:
        o.zero_()
    kernel_only("k6", k6_launch(k6, nbytes))
    exact = all(torch.equal(outs[(i + 1) % N], x) for i, x in enumerate(xs))
    kernel_only("k6_16b", k6_launch(k6, 16))
    kernel_only("k6_0b", k6_launch(k6, 0))
    for o in outs:
        o.zero_()
    kernel_only("k6_no_gate", k6_launch(fn_ng, nbytes))
    exact_ng = all(torch.equal(outs[(i + 1) % N], x)
                   for i, x in enumerate(xs))
    kernel_only("k7", k7_launch)
    kernel_only("empty", lambda i: torch.cuda._sleep(0))
    kernel_only("copy_members", lambda i: outs[i].copy_(xs[i]))
    result["copy_seq"] = time_ms(lambda: [o.copy_(x)
                                          for o, x in zip(outs, xs)])

    def round_of(kernel_round):
        caller = mesh.fork()
        kernel_round()
        mesh.join(caller)
    result["k6_round"] = time_ms(lambda: rdma.permute_shards(xs, mesh, 1, 0))
    result["k7_round"] = time_ms(lambda: round_of(
        lambda: RF.launch_round(mesh, RF.phase_closer, [{}] * N)))
    torch.cuda.synchronize()
    mesh.check()
    result.update(
        spread=spread, k6_exact=exact, k6_no_gate_exact=exact_ng,
        k7_zero=all(bool((z == 0).all()) for z in zeros),
        flags_balanced=mesh.flags_balanced(),
        bound_ms=2 * N * nbytes / 3.35e12 * 1e3)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    result["nvidia_smi"] = smi
    print(json.dumps(result), flush=True)
    print(smi, flush=True)
    ok = exact and exact_ng and result["k7_zero"] and result["flags_balanced"]
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
