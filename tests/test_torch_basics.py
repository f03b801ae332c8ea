"""horovod_tpu_torch's process API, device rule, collectives at size 1,
native-build errors, the engine's configuration, and its import isolation
from JAX and horovod_tpu."""

import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics, resolve_device
from horovod_tpu_torch.torch import (DistributedOptimizer, allreduce,
                                     allreduce_, broadcast,
                                     broadcast_optimizer_state,
                                     broadcast_parameters)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ENV = ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_LOCAL_RANK",
        "HVD_TPU_LOCAL_SIZE", "HVD_TPU_COORD", "HVD_TPU_DATA")


@pytest.fixture
def clean_env(monkeypatch):
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    hvd.shutdown()
    yield monkeypatch
    hvd.shutdown()


def test_init_defaults_to_rank_0_of_1(clean_env):
    hvd.init(device="cpu")
    assert hvd.is_initialized()
    assert (hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size()) == \
        (0, 1, 0, 1)
    hvd.shutdown()
    assert not hvd.is_initialized()
    with pytest.raises(ValueError, match="init"):
        hvd.rank()


def test_init_reads_launcher_env(clean_env):
    for var, val in zip(_ENV[:4], ("0", "1", "0", "1")):
        clean_env.setenv(var, val)
    hvd.init(device="cpu")
    assert (hvd.rank(), hvd.size()) == (0, 1)


def test_process_set_from_env(clean_env):
    for var, val in zip(_ENV, ("5", "8", "1", "4", "h:1",
                               ",".join(f"h:{2 + i}" for i in range(8)))):
        clean_env.setenv(var, val)
    ps = basics.resolve_process_set()
    assert (ps.rank, ps.size, ps.local_rank, ps.local_size) == (5, 8, 1, 4)
    assert ps.coord_endpoint == "h:1" and ps.data_endpoints[7] == "h:9"
    clean_env.setenv("HVD_TPU_LOCAL_RANK", "7")
    with pytest.raises(ValueError, match="local_rank"):
        basics.resolve_process_set()
    clean_env.setenv("HVD_TPU_RANK", "x")
    with pytest.raises(ValueError, match="not an int"):
        basics.resolve_process_set()


def test_size_above_one_raises(clean_env):
    """A size-2 environment without the engine's endpoints."""
    clean_env.setenv("HVD_TPU_RANK", "1")
    clean_env.setenv("HVD_TPU_SIZE", "2")
    with pytest.raises(ValueError, match="HVD_TPU_COORD"):
        hvd.init(device="cpu")
    clean_env.setenv("HVD_TPU_COORD", "127.0.0.1:1")
    with pytest.raises(ValueError, match="HVD_TPU_DATA"):
        hvd.init(device="cpu")
    clean_env.setenv("HVD_TPU_DATA", "127.0.0.1:2")  # one for two ranks
    with pytest.raises(ValueError, match="one data endpoint per rank"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


def test_device_defaults_to_cuda_and_raises_without_it(clean_env):
    clean_env.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hvd.init()
    from horovod_tpu_torch.models import TransformerLM

    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(64, 32, 1, 2)
    assert resolve_device("cpu") == torch.device("cpu")
    assert TransformerLM(64, 32, 1, 2, device="cpu").embed.weight.device \
        == torch.device("cpu")


def test_collectives_are_identities_at_size_1(clean_env):
    t = torch.arange(4.0)
    with pytest.raises(ValueError, match="init"):
        allreduce(t)
    hvd.init(device="cpu")
    out = allreduce(t, name="x")
    assert out is not t and torch.equal(out, t)
    assert torch.equal(broadcast(t, 0, name="y"), t)
    assert allreduce_(t, name="z") is t
    assert torch.equal(t, torch.arange(4.0))
    with pytest.raises(ValueError, match="root rank 1 out of range"):
        broadcast(t, 1)
    model = torch.nn.Linear(3, 2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    broadcast_parameters(model.state_dict())
    broadcast_parameters(model.named_parameters())
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])


def test_distributed_optimizer_shares_state_with_inner(clean_env):
    hvd.init(device="cpu")
    model = torch.nn.Linear(3, 2)
    inner = torch.optim.AdamW(model.parameters(), lr=1e-3,
                              weight_decay=1e-4)
    opt = DistributedOptimizer(inner, model.named_parameters())
    assert isinstance(opt, torch.optim.Optimizer)
    assert opt.param_groups[0] is inner.param_groups[0]
    assert sorted(opt._names.values()) == [
        "DistributedOptimizer.bias", "DistributedOptimizer.weight"]
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    assert opt.state is inner.state and len(inner.state) == 2
    broadcast_optimizer_state(opt)
    opt.param_groups[0]["lr"] = 5e-4
    assert inner.param_groups[0]["lr"] == 5e-4
    opt.zero_grad(set_to_none=True)
    assert model.weight.grad is None
    sd = opt.state_dict()
    opt.load_state_dict(sd)
    assert opt.state is inner.state


def test_build_without_nvcc_raises(monkeypatch):
    from horovod_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
    assert [os.path.basename(s) for s in _build.sources()] == [
        "flash_bwd.cu", "flash_bwd_split.cu", "flash_fwd.cu", "flash_wide.cu",
        "ring_flash.cu", "ring_permute.cu"]


def test_import_turns_tf32_off_for_matmuls_and_convolutions():
    """Importing the package sets the float32 policy of the card: neither
    matmuls nor cuDNN convolutions run in TF32, so the float32 image models
    compute what the float32 reference computes.  In a fresh interpreter:
    PyTorch's default leaves cuDNN's flag on before the import."""
    code = ("import torch\n"
            "before = torch.backends.cudnn.allow_tf32\n"
            "import horovod_tpu_torch\n"
            "print(before, torch.backends.cuda.matmul.allow_tf32,\n"
            "      torch.backends.cudnn.allow_tf32)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert out == ["True", "False", "False"]
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "horovod_tpu")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    files += glob.glob(os.path.join(REPO, "tools", "torch_*.py"))
    files += glob.glob(os.path.join(REPO, "examples", "hvdt_*.py"))
    for root, dirs, names in os.walk(os.path.join(REPO, "horovod_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]  # build output
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_nothing_of_jax_or_horovod_tpu(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in _FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_import_walk_covers_the_engine_and_the_runner():
    rel = {os.path.relpath(p, REPO) for p in _port_files()}
    for path in ("horovod_tpu_torch/engine/build.py",
                 "horovod_tpu_torch/runner/launch.py",
                 "horovod_tpu_torch/runner/__main__.py",
                 "horovod_tpu_torch/common/config.py",
                 "horovod_tpu_torch/torch/mpi_ops.py",
                 "horovod_tpu_torch/state/_tree.py",
                 "horovod_tpu_torch/state/partition.py",
                 "horovod_tpu_torch/state/checkpoint.py"):
        assert path in rel, path
