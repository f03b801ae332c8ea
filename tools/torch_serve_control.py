"""Control for ``chip_smoke.py``'s bf16 logits gate (phase ``serve``):
K/V written one position off must fail it.

Run from the repository root on a machine with one CUDA GPU::

    python3 tools/torch_serve_control.py

The gate holds every position the paged decode step computes in the bf16
headline run against the full-context forward of the same tokens
(``chip_smoke.paged_logit_errors``: ||paged - full|| / ||full|| per
position, at most ``chip_smoke.SERVE_LOGIT_TOL``).  Here the same run is
made twice in one process:

* ``sound``             — the code as it is;
* ``one_position_late`` — ``kv_cache.scatter_new`` replaced, in this
  process's memory only, by one that writes each step's fresh K/V one
  cache position late (its lengths plus one); no file changes.

Prints one JSON object: per variant, the positions held, the largest and
the median error, and whether the gate fails it.
"""

import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as S  # noqa: E402  (exits without a CUDA device)
import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch.serving import kv_cache  # noqa: E402


def main():
    sound = kv_cache.scatter_new

    def one_position_late(pages, k_new, v_new, tables, lengths, n_new):
        return sound(pages, k_new, v_new, tables, lengths + 1, n_new)

    out = {"nvidia_smi": S.smi_line(), "tolerance": S.SERVE_LOGIT_TOL,
           "variants": {}}
    hvd.init()
    try:
        for name, fn in (("sound", sound),
                         ("one_position_late", one_position_late)):
            kv_cache.scatter_new = fn
            numbers, _, errs = S.serve_bf16()
            out["variants"][name] = {
                "positions": len(errs), "max_rel_err": max(errs),
                "median_rel_err": statistics.median(errs),
                "fails_gate": max(errs) > S.SERVE_LOGIT_TOL,
                "tokens_per_s": numbers["tokens_per_s"]}
    finally:
        kv_cache.scatter_new = sound
        hvd.shutdown()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
