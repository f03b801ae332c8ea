"""horovod_tpu_torch's data-parallel training across processes against
horovod_tpu's.

- Three steps of the port's ``build_train_step`` at np 2 (ranks of the
  port's runner, CPU), each rank on its half of ``test_torch_train.py``'s
  batch, against that file's ``_jax_run(2)``: the JAX ``build_train_step``
  on a 2-device mesh with the same weights.  The same at np 3, each rank
  on 2 rows of a 6-row batch, against ``_jax_run(3, 6)`` on a (3, 1)
  mesh.  Loss rtol 1e-4, final
  parameters atol 5e-5 (that file's tolerances: float32 summation order
  through three Adam steps).  Every rank ends on the same parameters, bit
  for bit.
- ``DistributedOptimizer(..., backward_passes_per_step=2)`` against
  ``horovod_tpu.torch``'s on the same micro-batches, and
  ``broadcast_parameters`` + ``broadcast_optimizer_state`` from a
  non-zero root across ranks seeded differently (the empty-state
  bootstrap included), at np 2: bit for bit, each side in its own rank
  processes (the reference's through ``tests/distributed.py``).
- In one process: the error when a gradient is produced again while its
  allreduce is in flight, and ``step()`` after ``synchronize()`` not
  reducing twice.
"""

import functools
import os

import numpy as np
import pytest
import torch

from tests.test_torch_engine import OUT_ENV, _bits, _launch
from tests.distributed import run_ranks
from tests.torch_watch import ENV, watched


@pytest.fixture(scope="module", autouse=True)
def engines_built():
    """Both engines built before any timed launch (in a fresh checkout
    the first ranks would build them inside the launch's limit)."""
    from horovod_tpu.engine import build as ref_build
    from horovod_tpu_torch.engine import build as port_build

    ref_build()
    port_build.build()


def _dp_rank(out_dir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import TransformerLM, next_token_loss
    from horovod_tpu_torch.torch import DistributedOptimizer
    from horovod_tpu_torch.torch.train import build_train_step

    hvd.init(device="cpu")
    r, n = hvd.rank(), hvd.size()
    init = torch.load(os.path.join(out_dir, "init.pt"))
    vocab, d_model, layers, heads = init["dims"]
    model = TransformerLM(vocab, d_model, layers, heads,
                          dtype=torch.float32, use_flash=False, device="cpu")
    model.load_state_dict(init["state"], strict=True)
    opt = DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4),
        named_parameters=model.named_parameters())

    def loss_fn(m, batch):
        return next_token_loss(m(batch[0]), batch[1])

    step = build_train_step(loss_fn, opt, model)
    rows = slice(r * len(init["inp"]) // n, (r + 1) * len(init["inp"]) // n)
    batch = (init["inp"][rows], init["tgt"][rows])
    losses = [step(batch).item() for _ in range(init["steps"])]
    assert len(step.sync_sec) == init["steps"]
    torch.save({"losses": losses, "state": model.state_dict()},
               os.path.join(out_dir, f"dp{r}.pt"))
    hvd.shutdown()


def _dp_steps_match_jax(tmp_path, np_, batch):
    """``np_`` port ranks, each on its ``batch / np_`` rows, against the
    JAX step on an ``(np_, 1)`` mesh: the same losses and parameters, and
    every rank's parameters equal bit for bit."""
    from horovod_tpu_torch.models.convert import (from_flax_params,
                                                  to_flax_params)
    from tests import test_torch_train as T

    inp, tgt = T._data(batch)
    torch.save({"state": from_flax_params(T._init_params()),
                "inp": torch.from_numpy(inp).long(),
                "tgt": torch.from_numpy(tgt).long(),
                "dims": (T.VOCAB, T.D_MODEL, T.LAYERS, T.HEADS),
                "steps": T.STEPS}, tmp_path / "init.pt")
    with watched(110, f"the port's DP launch at np {np_}"):
        _launch(functools.partial(_dp_rank, str(tmp_path)), np_, **ENV)
    want_losses, want_params = T._jax_run(np_, batch)
    want = T._flat(want_params)
    runs = [torch.load(tmp_path / f"dp{r}.pt") for r in range(np_)]
    for run in runs[1:]:
        for name, v in runs[0]["state"].items():
            assert torch.equal(_bits(v), _bits(run["state"][name])), name
    got_losses = runs[0]["losses"]
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    assert got_losses[-1] < got_losses[0]
    got = T._flat(to_flax_params(runs[0]["state"]))
    assert set(got) == set(want)
    for name, a in want.items():
        np.testing.assert_allclose(got[name], a, atol=5e-5, err_msg=name)


def test_dp_steps_match_jax_build_train_step(tmp_path):
    _dp_steps_match_jax(tmp_path, 2, 4)


def test_dp_steps_at_three_ranks_match_jax_build_train_step(tmp_path):
    """np 3 against a (3, 1) mesh, on a batch of 6 rows that 3 divides:
    the engine's ring at an odd size averages the same gradients."""
    _dp_steps_match_jax(tmp_path, 3, 6)


def _mlp(seed):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(5, 8), torch.nn.Tanh(),
                               torch.nn.Linear(8, 3))


def _micro_batch(r, step, micro):
    rng = np.random.RandomState(100 * r + 10 * step + micro)
    return torch.from_numpy(rng.standard_normal((4, 5))).float()


def _optimizer_cases(hvd, out_path):
    """Gradient accumulation over 2 micro-batches, then the broadcasts
    from the last rank across ranks seeded differently."""
    r, n = hvd.rank(), hvd.size()
    model = _mlp(0)
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=0.01),
        named_parameters=model.named_parameters(),
        backward_passes_per_step=2)
    for step in range(2):
        for micro in range(2):
            model(_micro_batch(r, step, micro)).pow(2).mean().backward()
        opt.step()
        opt.zero_grad()
    out = {"accumulated": {k: v.clone() for k, v in
                           model.state_dict().items()}}

    model = _mlp(100 + r)
    # Scalars differ across ranks (tuples such as ``betas`` are not
    # broadcast, by the reference either).
    opt = torch.optim.Adam(model.parameters(), lr=0.01 * (r + 1),
                           eps=1e-8 * (r + 1))
    hvd.broadcast_parameters(model.state_dict(), root_rank=n - 1)
    hvd.broadcast_optimizer_state(opt, root_rank=n - 1)
    model(_micro_batch(0, 9, 0)).pow(2).mean().backward()
    opt.step()
    sd = opt.state_dict()
    out["broadcast.params"] = model.state_dict()
    out["broadcast.state"] = {f"{pid}.{k}": v
                              for pid, st in sd["state"].items()
                              for k, v in st.items()}
    out["broadcast.groups"] = [
        {k: v for k, v in g.items() if k != "params"}
        for g in sd["param_groups"]]
    torch.save(out, out_path)


def _ref_optimizer_rank():
    import horovod_tpu.torch as hvd

    hvd.init()
    _optimizer_cases(hvd, os.path.join(os.environ[OUT_ENV],
                                       f"ref{hvd.rank()}.pt"))
    hvd.shutdown()


def _port_optimizer_rank(out_dir):
    import horovod_tpu_torch.torch as hvd

    hvd.init(device="cpu")
    _optimizer_cases(hvd, os.path.join(out_dir, f"port{hvd.rank()}.pt"))
    hvd.shutdown()


def test_accumulation_and_broadcasts_match_reference(tmp_path, monkeypatch):
    monkeypatch.setenv(OUT_ENV, str(tmp_path))
    run_ranks(_ref_optimizer_rank, 2, timeout=120)
    _launch(functools.partial(_port_optimizer_rank, str(tmp_path)), 2)
    for r in range(2):
        ref = torch.load(tmp_path / f"ref{r}.pt")
        got = torch.load(tmp_path / f"port{r}.pt")
        assert got["broadcast.groups"] == ref["broadcast.groups"]
        for case in ("accumulated", "broadcast.params", "broadcast.state"):
            assert set(got[case]) == set(ref[case])
            for name, want in ref[case].items():
                assert torch.equal(_bits(got[case][name]), _bits(want)), \
                    (r, case, name)
    # The broadcasts made the ranks alike: rank 1's hyperparameters.
    ranks = [torch.load(tmp_path / f"port{r}.pt") for r in range(2)]
    assert ranks[0]["broadcast.groups"] == ranks[1]["broadcast.groups"]
    assert ranks[0]["broadcast.groups"][0]["lr"] == 0.02
    assert ranks[0]["broadcast.groups"][0]["eps"] == 2e-8
    for name, v in ranks[0]["broadcast.params"].items():
        assert torch.equal(v, ranks[1]["broadcast.params"][name])


@pytest.fixture
def size_1(monkeypatch):
    import horovod_tpu_torch as hvd

    for var in ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_COORD",
                "HVD_TPU_DATA"):
        monkeypatch.delenv(var, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_gradient_produced_again_in_flight_raises(size_1):
    from horovod_tpu_torch.torch import DistributedOptimizer

    model = _mlp(0)
    opt = DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                               named_parameters=model.named_parameters())
    model(_micro_batch(0, 0, 0)).sum().backward()
    assert len(opt._handles) == 4
    with pytest.raises(RuntimeError, match="produced again while its "
                                           "allreduce is still in flight"):
        model(_micro_batch(0, 0, 1)).sum().backward()
    opt.synchronize()
    assert not opt._handles


def test_step_after_synchronize_reduces_once(size_1, monkeypatch):
    from horovod_tpu_torch.torch import DistributedOptimizer
    from horovod_tpu_torch.torch import mpi_ops

    model = _mlp(0)
    opt = DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                               named_parameters=model.named_parameters())
    calls = []
    real = mpi_ops._submit
    monkeypatch.setattr(mpi_ops, "_submit",
                        lambda *a, **k: calls.append(a[2]) or real(*a, **k))
    model(_micro_batch(0, 0, 0)).sum().backward()
    opt.synchronize()
    opt.step()
    assert sorted(calls) == sorted(opt._names.values())
    assert len(opt.sync_sec) == 1 and len(opt.last_ticks) == 4
