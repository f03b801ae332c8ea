"""Where ``chip_smoke.py``'s ``compression`` steps spend their
synchronize: the engine's timeline of the same run, per wire mode.

Run from the repository root on a machine with one CUDA GPU::

    python3 tools/torch_compression_trace.py [--modes off,bf16,fp8]

Each mode runs ``compression``'s ranks (``train_dp``'s 2 ranks, seed and
data, 2 warm-up + 5 timed steps, floor 1024 B) with the engine's timeline
on (``HVD_TPU_TIMELINE=<dir>/``, one trace per rank).  Per timed step and
rank, the milliseconds of the ``TRAIN_STEP`` span covered by the gradient
rows' spans (``chip_smoke.hold_trace``): ``ALLREDUCE`` (the collective in
flight), ``MEMCPY_IN_FUSION_BUFFER`` (the copy into the fusion buffer and,
when a bucket compresses, the error-feedback quantize of every element),
``RING_ALLREDUCE`` (the ring: narrowing each segment it sends, the wire,
widening and adding each one it receives) and
``MEMCPY_OUT_FUSION_BUFFER``; and ``NEGOTIATE`` on rank 0.  The timeline
costs time of its own, the same in every mode: compare the modes with
each other, not with ``compression``'s untraced step.

Prints one JSON object: the ``nvidia-smi`` line and, per mode, each
rank's step and sync ms and the medians of those spans over the timed
steps.
"""

import json
import os
import shutil
import statistics
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as S  # noqa: E402  (exits without a CUDA device)

WARMUP, STEPS = 2, 7  # rank_compression's steps


def main(modes):
    out = {"nvidia_smi": S.smi_line(), "modes": {}}
    S.TIMELINE_STEPS = STEPS  # hold_trace's count of TRAIN_STEP spans
    for mode in modes:
        tl = tempfile.mkdtemp(prefix="hvdt_comp_trace_")
        try:
            res = S.run_ranks(
                "compression", timeout=300, script=__file__,
                tag=f"compression_trace_{mode}",
                env={"HVD_TPU_COMPRESSION": mode,
                     "HVD_TPU_COMPRESSION_MIN_BYTES": str(S.COMP_FLOOR),
                     "HVD_TPU_TIMELINE": tl + os.sep})
            ranks = []
            for x in res:
                steps = S.hold_trace(S._trace(os.path.join(
                    tl, f"rank{x['rank']}.json")), x["rank"])[WARMUP:]
                ranks.append({
                    "median_step_ms": x["median_step_ms"],
                    "median_sync_ms": x["median_sync_ms"],
                    "spans_ms": {k: statistics.median(s[k] for s in steps)
                                 for k in steps[0]}})
        finally:
            shutil.rmtree(tl, ignore_errors=True)
        out["modes"][mode] = {"wire_over_payload": res[0]["wire_bytes"]
                              / max(res[0]["payload_bytes"], 1),
                              "ranks": ranks}
    print(json.dumps(out))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        S.rank_compression()
    else:
        modes = ("off", "bf16", "fp8")
        if sys.argv[1:2] == ["--modes"]:
            modes = tuple(sys.argv[2].split(","))
        main(modes)
