"""Control for ``chip_smoke.py``'s pipeline parity check: a backward seeded
with 1 in place of 1/M must fail it.

Run from the repository root on a machine with one CUDA GPU::

    python3 tools/torch_pipeline_control.py

The parity check (phase ``pipeline``) runs 3 steps of ``PIPE_HEADLINE``'s
pipeline in float32 from ``AVG_SEED`` on 2 stage ranks sharing the card
and holds the last stage's losses and each stage's gradient norm before
each update against 3 size-1 ``build_lm_step`` steps on the whole batch
(3 x the spread of two size-1 runs, floor ``PIPE_FLOOR`` relative).  Here
the same 2-rank run is repeated with ``PipelineRunner._loss_seed`` patched
in the rank processes:

* ``sound``   — unpatched: the reading the check passes;
* ``seed_one`` — the last stage seeds each micro-batch's backward with 1,
  not 1/M, so every accumulated gradient is M (= 4) times the mean.

Prints one JSON object: the size-1 references and, per variant, the
rule's report (values, distances, tolerances) and whether the check
fails it.  AdamW's update is nearly invariant to a constant gradient
scale, so the losses alone barely see this fault; the gradient norms do.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402  (exits without a CUDA device)
import horovod_tpu_torch.torch as hvdt  # noqa: E402
from horovod_tpu_torch.parallel.pipeline import PipelineRunner  # noqa: E402

VARIANTS = ("sound", "seed_one")


def rank(variant):
    hvdt.init(device="cuda:0")
    if variant == "seed_one":
        PipelineRunner._loss_seed = lambda self, loss: torch.ones_like(loss)
    S.rank_result(rank=hvdt.rank(), stage=hvdt.rank(), parity={
        "float32": S.pipeline_parity_run(torch.float32)})
    hvdt.shutdown()


def main():
    refs = S.pipeline_reference()
    out = {"nvidia_smi": S.smi_line(), "size1": refs["float32"],
           "floor": S.PIPE_FLOOR, "variants": {}}
    for variant in VARIANTS:
        res = S.run_ranks(variant, timeout=400, ranks=S.PIPE_RANKS,
                          script=__file__)
        ok, report = S.pipeline_rule(res, refs)
        out["variants"][variant] = {"fails_check": not ok,
                                    "report": report}
    print(json.dumps(out))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank(sys.argv[2])
    else:
        main()
