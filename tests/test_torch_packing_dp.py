"""horovod_tpu_torch's packed image step data-parallel: np 2 through the
port's runner, packed against unpacked.

``tests/test_models.py::test_packed_train_step_bit_identical``'s case
(ResNet-18 with the 3 x 3 stem, float32, 32 x 32, 10 classes, three
SGD-momentum steps) with the batch of 4 split as ``chip_smoke.py``'s
``resnet_dp`` splits it, rows [2r, 2r + 2) on rank r, in the two BN modes
of the image step: the fused EMA (``bench.py``'s, the packed statistics
averaged as one aux tensor) and cross-replica BN (``axis_name="hvd"``,
statistics averaged inside the forward, the module writing its running
statistics into the packed buffer's views).  Each rank starts from its
own weights (``seed + rank``), so the ranks end equal only if
``broadcast_parameters`` and ``broadcast_optimizer_state`` carried the
packed module's ``module.*``, ``small`` and ``stats``.  Held: both ranks
bit for bit equal in every run, the packed runs within the reference
test's bounds of the unpacked ones (loss rtol 1e-5; parameters and
statistics rtol 1e-5, atol 1e-6), and the hooked tensors 62 -> 22.
"""

import functools

import numpy as np
import pytest
import torch

from tests.test_torch_engine import _bits, _launch
from tests.test_torch_packing import small_stem

MODES = {"fused_ema": dict(fused_ema=True),
         "cross_replica": dict(fused_ema=False, axis_name="hvd")}


def _rank(out_dir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.torch.image_step import build_image_step

    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    rows = slice(r * 4 // n, (r + 1) * 4 // n)
    out = {}
    for mode, kw in MODES.items():
        for packed in (False, True):
            with small_stem():
                net, step, data = build_image_step(
                    "cpu", model="resnet18_small", batch=4, image=32,
                    num_classes=10, dtype=torch.float32, packed=packed,
                    rows=rows, **kw)
            losses = [step(data).item() for _ in range(3)]
            state = (net.unpacked_state_dict() if packed
                     else {k: v.clone() for k, v in net.state_dict().items()})
            out[mode, packed] = {"losses": losses, "state": state,
                                 "hooked": len(list(net.parameters()))}
    torch.save(out, f"{out_dir}/rank{r}.pt")
    hvd.shutdown()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("packed_dp")
    _launch(functools.partial(_rank, str(out_dir)), 2, timeout=180,
            OMP_NUM_THREADS="2")
    return [torch.load(out_dir / f"rank{r}.pt") for r in range(2)]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
def test_ranks_equal_bit_for_bit(runs, mode, packed):
    a, b = (x[mode, packed] for x in runs)
    assert a["losses"] == b["losses"]
    assert set(a["state"]) == set(b["state"])
    for name, v in a["state"].items():
        assert torch.equal(_bits(v), _bits(b["state"][name])), name


@pytest.mark.parametrize("mode", list(MODES))
def test_packed_matches_unpacked_at_np2(runs, mode):
    want, got = runs[0][mode, False], runs[0][mode, True]
    assert (want["hooked"], got["hooked"]) == (62, 22)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert want["losses"][-1] < want["losses"][0]
    assert set(got["state"]) == set(want["state"])
    for name, a in want["state"].items():
        np.testing.assert_allclose(got["state"][name].numpy(), a.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
