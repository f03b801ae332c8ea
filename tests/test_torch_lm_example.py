"""examples/hvdt_pytorch_transformer_lm.py (dp x sp on the port) against
examples/jax_transformer_lm.py at the same flags, on the CPU.

The port's example runs at np 2 through the port's runner (``--device
cpu``), each rank a ring of 4 members; the JAX example runs in one
process with ``--dp 2`` on the virtual 8-device CPU mesh.  The sequence
length (63) is one that 4 does not divide, so both pad the shifted
sequence and mask the padding.  Checked: the ``mesh:`` lines are equal,
both losses fall, and each printed loss is within 0.15 of the JAX
example's (as the pipeline example's test: the two draw their initial
weights from different generators, flax's ``PRNGKey(0)`` and torch's
``Generator`` seeded 0).  CPU readings at these flags: 4.5296 -> 4.4850
against 4.4595 -> 4.4203; the port's first loss over torch seeds 0-7
ranged 4.458-4.752, so a tighter bound would hold the draw, not the
training.  The numerics are held step for step in
``tests/test_torch_dp_sp.py``.
"""

import os
import re
import subprocess
import sys

from tests.test_torch_examples import REPO, _run_example

FLAGS = ["--sp", "4", "--batch", "4", "--seq-len", "63", "--vocab", "64",
         "--d-model", "16", "--n-layers", "1", "--n-heads", "2",
         "--steps", "3"]


def _lines(out):
    """``(mesh line, [loss at each printed step])``."""
    mesh = next(ln for ln in out.splitlines() if ln.startswith("mesh:"))
    losses = [float(x) for x in re.findall(r"step +\d+ +loss ([0-9.]+)",
                                           out)]
    assert "tokens/sec" in out, out
    return mesh, losses


def test_hvdt_pytorch_transformer_lm_example():
    port = _lines(_run_example("hvdt_pytorch_transformer_lm.py", FLAGS))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples",
                                      "jax_transformer_lm.py"),
         "--dp", "2", *FLAGS], env=env, capture_output=True, text=True,
        timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-1500:]
    ref = _lines(out.stdout)
    assert port[0] == ref[0]
    assert len(port[1]) == len(ref[1]) == 2
    for got, want in zip(port[1], ref[1]):
        assert abs(got - want) < 0.15, (port[1], ref[1])
    assert port[1][-1] < port[1][0] and ref[1][-1] < ref[1][0]
