"""Control for ``chip_smoke.py``'s averaging check: a wrong gradient
average must fail it.

Run from the repository root on a machine with one CUDA GPU::

    python3 tools/torch_averaging_control.py

The averaging check (phase ``train_dp``) runs 3 data-parallel steps of the
LM headline on 2 ranks sharing the card, rank r on rows [8r, 8r+8) of one
16-row batch, and holds the losses against 3 size-1 steps on all 16 rows.
Here the same 2-rank run is repeated with the gradient allreduce of
``DistributedOptimizer`` patched in the rank processes:

* ``sound``      — unpatched: the reading the check passes;
* ``rank0_half`` — rank 1 zeroes its gradients before the average, so
  every rank steps on half of rank 0's gradient;
* ``sum``        — the ranks' gradients summed, not averaged.

Prints one JSON object: the size-1 reference, the check's tolerance and,
per variant, the losses, their distance from the reference and whether
the check would fail it.  A replica digest cannot see either fault: the
replicas stay identical.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as S  # noqa: E402  (exits without a CUDA device)
import horovod_tpu_torch.torch as hvdt  # noqa: E402

VARIANTS = ("sound", "rank0_half", "sum")


def _patch(variant):
    """Swap the allreduce the optimizer's hooks enqueue for ``variant``'s."""
    real = hvdt.allreduce_async_

    def rank0_half(tensor, average=True, name=None, **kw):
        if hvdt.rank():
            tensor.zero_()
        return real(tensor, average=average, name=name, **kw)

    def summed(tensor, average=True, name=None, **kw):
        return real(tensor, average=False, name=name, **kw)

    if variant != "sound":
        hvdt.allreduce_async_ = {"rank0_half": rank0_half,
                                 "sum": summed}[variant]


def rank(variant):
    hvdt.init(device="cuda:0")
    _patch(variant)
    r, n, batch = hvdt.rank(), hvdt.size(), S.HEADLINE["batch"]
    S.rank_result(rank=r, losses=S.averaging_losses(
        slice(r * batch // n, (r + 1) * batch // n)))
    hvdt.shutdown()


def main():
    refs, tol = S.averaging_reference()
    out = {"nvidia_smi": S.smi_line(), "size1": refs, "tolerance": tol,
           "variants": {}}
    for variant in VARIANTS:
        losses = S.run_ranks(variant, timeout=300, script=__file__)[0][
            "losses"]
        err = [abs(a - b) for a, b in zip(losses, refs[0])]
        out["variants"][variant] = {
            "losses": losses, "abs_err": err,
            "fails_check": any(e > t for e, t in zip(err, tol))}
    print(json.dumps(out))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank(sys.argv[2])
    else:
        main()
