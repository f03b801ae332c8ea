"""The port's examples (BASELINE.json configs 3 and 5 on
horovod_tpu_torch) at np 2 on the CPU, through the port's runner.

examples/hvdt_pytorch_mnist.py and examples/hvdt_pytorch_imagenet_resnet50.py
are examples/pytorch_mnist.py and examples/pytorch_imagenet_resnet50.py
with ``import horovod_tpu_torch.torch as hvd``, the card pinned by
``local_rank()`` and ``--device`` (``cpu`` here).  The ResNet-50 example
runs both legs of tests/test_examples.py's resume check: a fresh run that
checkpoints on rank 0, then a resumed run that finds the epoch-1
checkpoint, broadcasts the resume decision and restores rank 0's state.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_example(script, extra_args, np_=2, timeout=300):
    # Two ranks share the CPU: two compute threads each (PyTorch's default
    # of one per core oversubscribes it about fourfold here).
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for var in ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_COORD",
                "HVD_TPU_DATA"):
        env.pop(var, None)
    # --timeout makes the launcher kill every rank; the outer subprocess
    # timeout alone would orphan them.
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", "-np",
           str(np_), "--timeout", str(timeout - 30), "--", sys.executable,
           os.path.join(REPO, "examples", script), "--device", "cpu"]
    out = subprocess.run(cmd + extra_args, env=env, capture_output=True,
                         text=True, timeout=timeout, cwd=REPO)
    assert out.returncode == 0, (
        f"{script} failed:\n--- stdout ---\n{out.stdout[-1500:]}\n"
        f"--- stderr ---\n{out.stderr[-1500:]}")
    return out.stdout


def test_hvdt_pytorch_mnist_example():
    out = _run_example("hvdt_pytorch_mnist.py",
                       ["--epochs", "1", "--train-samples", "256",
                        "--batch-size", "32"])
    assert "Test set:" in out


def test_hvdt_pytorch_imagenet_resnet50_example_with_resume(tmp_path):
    fmt = str(tmp_path / "ckpt-{epoch}.pth.tar")
    common = ["--synthetic-batches", "2", "--batch-size", "2",
              "--val-batch-size", "2", "--image-size", "32",
              "--checkpoint-format", fmt]
    out = _run_example("hvdt_pytorch_imagenet_resnet50.py",
                       ["--epochs", "1"] + common)
    assert "validation" in out
    assert os.path.exists(fmt.format(epoch=1))
    out = _run_example("hvdt_pytorch_imagenet_resnet50.py",
                       ["--epochs", "2"] + common)
    assert "Epoch 1 validation" in out and "Epoch 0" not in out
    assert os.path.exists(fmt.format(epoch=2))
