"""Control for ``chip_smoke.py``'s averaging check: a wrong gradient
average must fail it.

Run from the repository root on a machine with one CUDA GPU::

    python3 tools/torch_averaging_control.py [--ring | --compression]

The averaging check (phase ``train_dp``) runs 3 data-parallel steps of the
LM headline on 2 ranks sharing the card, rank r on rows [8r, 8r+8) of one
16-row batch, and holds the losses against 3 size-1 steps on all 16 rows.
Here the same 2-rank run is repeated with the gradient allreduce of
``DistributedOptimizer`` patched in the rank processes:

* ``sound``      — unpatched: the reading the check passes;
* ``rank0_half`` — rank 1 zeroes its gradients before the average, so
  every rank steps on half of rank 0's gradient;
* ``sum``        — the ranks' gradients summed, not averaged.

With ``--ring`` the same for ``ring_dp``'s averaging check (2 ranks,
each a fused ring of 4 members on rows [2r, 2r+2) of one 4-row batch
whose rank-1 rows hold only their first 512 targets, against the size-1
ring on all 4 rows):

* ``sound``     — unpatched;
* ``own_count`` — each rank normalises its masked loss by its own count
  of valid targets per shard, not the count averaged over the ranks
  (``next_token_loss``'s ``("dp", mesh)`` reduced to the mesh alone).

With ``--compression`` the same for ``compression``'s bf16 gate (each of
the 7 steps' losses within 2% relative of the uncompressed run's): the
uncompressed run is ``compression``'s step under
``HVD_TPU_COMPRESSION=off``, then under ``bf16``:

* ``sound``      — unpatched;
* ``rank0_half`` — as above, rank 1's gradients zeroed before the
  average.

Prints one JSON object: the size-1 reference (the uncompressed run with
``--compression``), the check's tolerance and, per variant, the losses,
their distance from the reference and whether the check would fail it.
A replica digest cannot see any of these faults: the replicas stay
identical.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as S  # noqa: E402  (exits without a CUDA device)
import horovod_tpu_torch.torch as hvdt  # noqa: E402

VARIANTS = ("sound", "rank0_half", "sum")
RING_VARIANTS = ("sound", "own_count")
COMP_VARIANTS = ("sound", "rank0_half")


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


def _patch_ring(variant):
    """``own_count``: the count of valid targets is not averaged over the
    ranks, so each rank divides by its own."""
    from horovod_tpu_torch.models import transformer

    if variant == "own_count":
        transformer._ranks_mean = lambda count: count


def rank(variant):
    if variant.startswith("comp:"):
        _patch(variant[len("comp:"):])
        S.rank_compression()
        return
    hvdt.init(device="cuda:0")
    r, n = hvdt.rank(), hvdt.size()
    if variant.startswith("ring:"):
        _patch_ring(variant[len("ring:"):])
        batch, losses_of = S.RING_HEADLINE["batch"], S.ring_averaging_losses
    else:
        _patch(variant)
        batch, losses_of = S.HEADLINE["batch"], S.averaging_losses
    S.rank_result(rank=r, losses=losses_of(
        slice(r * batch // n, (r + 1) * batch // n)))
    hvdt.shutdown()


def main_compression():
    base = S.run_ranks("comp:sound", timeout=300, script=__file__,
                       tag="control_comp_off",
                       env={"HVD_TPU_COMPRESSION": "off"})[0]["losses"]
    tol = [S.COMP_LOSS_RTOL * abs(v) for v in base]
    out = {"nvidia_smi": S.smi_line(), "uncompressed": base,
           "tolerance": tol, "variants": {}}
    for variant in COMP_VARIANTS:
        losses = S.run_ranks(
            "comp:" + variant, timeout=300, script=__file__,
            tag=f"control_comp_{variant}",
            env={"HVD_TPU_COMPRESSION": "bf16",
                 "HVD_TPU_COMPRESSION_MIN_BYTES": str(S.COMP_FLOOR)})[0][
                     "losses"]
        err = [abs(a - b) for a, b in zip(losses, base)]
        out["variants"][variant] = {
            "losses": losses, "abs_err": err,
            "fails_check": any(e > t for e, t in zip(err, tol))}
    print(json.dumps(out))


def main(ring):
    refs, tol = (S.ring_averaging_reference() if ring
                 else S.averaging_reference())
    out = {"nvidia_smi": S.smi_line(), "size1": refs, "tolerance": tol,
           "variants": {}}
    for variant in RING_VARIANTS if ring else VARIANTS:
        losses = S.run_ranks("ring:" + variant if ring else variant,
                             timeout=300, script=__file__)[0]["losses"]
        err = [abs(a - b) for a, b in zip(losses, refs[0])]
        out["variants"][variant] = {
            "losses": losses, "abs_err": err,
            "fails_check": any(e > t for e, t in zip(err, tol))}
    print(json.dumps(out))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank(sys.argv[2])
    elif sys.argv[1:2] == ["--compression"]:
        main_compression()
    else:
        main(sys.argv[1:2] == ["--ring"])
