"""How many copy blocks a rotating K4 launch should carry.

Run from the repository root on a machine with one CUDA GPU::

    python3 tools/torch_ring_copy_blocks.py

A rotating ring step launches K4 with ``ring_flash.COPY_BLOCKS`` copy
blocks ahead of its attention blocks (``csrc/ring_flash.cu``).  A copy
block has the kernel's block shape, so with the 16-bit forward body it
holds a whole SM while it waits for the neighbour's handshake.  This
times, on the ring path's shard (4 members, (4, 8, 1024, 64) bf16, a
wholly visible step for members 1-3), a round of the 4 members' K4
launches without rotation and with rotation at several copy-block
counts, each round forked off and joined back to the caller's stream
(CUDA events, median of 15 after 3 warm-up rounds, alternating the
counts).  Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from horovod_tpu_torch.ops import kernel_check  # noqa: E402
from horovod_tpu_torch.ops import ring_flash as RF  # noqa: E402
from horovod_tpu_torch.parallel import RingMesh  # noqa: E402

SHARD = (4, 8, 1024, 64)
COUNTS = (2, 4, 8, 16, 32)


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_ring_copy_blocks: no CUDA device")
    n = 4
    mesh = RingMesh(n)
    members, _, scale_r = kernel_check.ring_inputs(n, SHARD, torch.bfloat16,
                                                   1)
    sl = SHARD[2]

    def calls(rotate):
        # Member i holds member (i - 1)'s shard: visible but for member 0.
        return [dict(qr=members[i]["qr"], k=members[(i - 1) % n]["k"],
                     v=members[(i - 1) % n]["v"], q_offset=i * sl,
                     k_offset=((i - 1) % n) * sl, scale_r=scale_r,
                     causal=True, rotate=rotate, phase=0) for i in range(n)]

    def round_ms(rotate):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        caller = mesh.fork()
        RF.launch_round(mesh, RF.ring_flash_fwd, calls(rotate))
        mesh.join(caller)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    keys = ["none"] + [str(c) for c in COUNTS]
    times = {k: [] for k in keys}
    default = RF.COPY_BLOCKS
    try:
        for it in range(18):
            for key in keys:
                if key != "none":
                    RF.COPY_BLOCKS = int(key)
                ms = round_ms(key != "none")
                if it >= 3:
                    times[key].append(ms)
    finally:
        RF.COPY_BLOCKS = default
    mesh.check()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "shard": list(SHARD), "members": n, "nvidia_smi": smi,
        "copy_blocks_default": default,
        "round_ms": {k: statistics.median(v) for k, v in times.items()},
        "round_ms_spread": {k: [min(v), max(v)] for k, v in times.items()},
        "flags_balanced": mesh.flags_balanced()}), flush=True)


if __name__ == "__main__":
    main()
