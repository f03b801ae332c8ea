"""One rank program, run under each package's launcher.

The port's engine tests that need a job of their own (a crash, a
relaunch, a reshape, a network fault) write the rank program once, over
these names, and run it twice: under ``horovod_tpu_torch``'s launcher on
CPU tensors and under ``horovod_tpu``'s on numpy arrays.

- ``hvd``: the collectives (``horovod_tpu_torch.torch`` / ``horovod_tpu``);
- ``top``: the process API (``metrics_snapshot``, ``ElasticState``,
  ``run_elastic``, the typed errors; ``horovod_tpu_torch`` /
  ``horovod_tpu``);
- ``lib``: the engine library (``common._load_lib()``);
- ``INIT()``: ``init`` on the CPU;
- ``ones(n)``, ``zeros(n)``, ``arange(n)``: float32 vectors;
- ``as_list(x)``, ``to_bytes(x)``: a vector's values, its bytes;
- ``_shm_job_prefix(coord)``: the package launcher's name prefix of the
  job's ``/dev/shm`` segments.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = {
    True: (
        "import torch\n"
        "import horovod_tpu_torch as top\n"
        "import horovod_tpu_torch.torch as hvd\n"
        "from horovod_tpu_torch.common import _load_lib as lib\n"
        "def INIT(): hvd.init(device='cpu')\n"
        "def ones(n): return torch.ones(n)\n"
        "def zeros(n): return torch.zeros(n)\n"
        "def arange(n): return torch.arange(n, dtype=torch.float32)\n"
        "def as_list(x): return x.tolist()\n"
        "def to_bytes(x): return x.numpy().tobytes()\n"
        "from horovod_tpu_torch.runner.launch import _shm_job_prefix\n"),
    False: (
        "import numpy as np\n"
        "import horovod_tpu as top\n"
        "import horovod_tpu as hvd\n"
        "from horovod_tpu.common import _load_lib as lib\n"
        "def INIT(): hvd.init()\n"
        "def ones(n): return np.ones(n, np.float32)\n"
        "def zeros(n): return np.zeros(n, np.float32)\n"
        "def arange(n): return np.arange(n, dtype=np.float32)\n"
        "def as_list(x): return x.tolist()\n"
        "def to_bytes(x): return x.tobytes()\n"
        "from horovod_tpu.runner.launch import _shm_job_prefix\n"),
}

# Variables a test job must not inherit from the test's environment.
_SCRUB = ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_COORD", "HVD_TPU_DATA",
          "HVD_TPU_LOCAL_RANK", "HVD_TPU_LOCAL_SIZE", "HVD_TPU_FAULT_SPEC",
          "HVD_TPU_RESTART_EPOCH", "HVD_TPU_NET_FAULT_SPEC",
          "HVD_TPU_HEARTBEAT_MS", "HVD_TPU_HEARTBEAT_MISS",
          "HVD_TPU_ANOMALY_SIGMA", "HVD_TPU_ANOMALY_INTERVAL_MS",
          "HVD_TPU_LINK_STATS", "HVD_TPU_MONITOR_PORT", "HVD_TPU_SHM",
          "HVD_TPU_SHM_RING_BYTES", "HVD_TPU_COORD_TREE",
          "HOROVOD_HIERARCHICAL_ALLREDUCE", "HVD_TPU_HIERARCHICAL_ALLREDUCE",
          "HVD_TPU_COMPRESSION", "HVD_TPU_POSTMORTEM_DIR")


def env(**overrides):
    """The job's environment: the repo importable, the CPU, one intra-op
    thread a rank, ``overrides`` on top.  (The launchers read their kill
    grace, ``HVD_TPU_KILL_GRACE_SEC``, from the test's own environment.)"""
    out = {k: v for k, v in os.environ.items() if k not in _SCRUB}
    out["PYTHONPATH"] = REPO + os.pathsep + out.get("PYTHONPATH", "")
    out["JAX_PLATFORMS"] = "cpu"
    out["OMP_NUM_THREADS"] = "1"
    out.update({k: str(v) for k, v in overrides.items()})
    return out


def program(port, body):
    """``body`` after the package's prelude."""
    return PRELUDE[port] + body


def launcher(port):
    """The package's ``horovod_tpu*.runner`` module."""
    if port:
        import horovod_tpu_torch.runner as runner
    else:
        import horovod_tpu.runner as runner
    return runner


def run(port, body, np_, timeout=90.0, how="command", **kwargs):
    """Run ``body`` on ``np_`` ranks of the package (``port`` or the
    reference) through its launcher's ``run_command`` (``how="command"``),
    ``run_elastic`` or ``run_membership``; ``kwargs`` go to the launcher
    (``env=`` a dict from :func:`env`).  The launcher's return value."""
    runner = launcher(port)
    cmd = [sys.executable, "-c", program(port, body)]
    kwargs.setdefault("env", env())
    if how == "command":
        return runner.run_command(cmd, np_, timeout=timeout, capture=True,
                                  **kwargs)
    fn = {"elastic": runner.run_elastic,
          "membership": runner.run_membership}[how]
    return fn(cmd, np_, timeout=timeout, capture=True,
              report=lambda msg: None, **kwargs)


def lines(results, tag):
    """Every rank's stdout lines starting with ``tag``, by rank."""
    return {r.rank: [ln[len(tag):].strip() for ln in r.stdout.splitlines()
                     if ln.startswith(tag)] for r in results}


def failures(results):
    """``(rank, returncode, stderr tail)`` of every rank that failed."""
    return [(r.rank, r.returncode, r.stderr[-1500:]) for r in results
            if r.returncode != 0]


def both(body, np_, port_env=None, ref_env=None, **kwargs):
    """:func:`run` of ``body`` under each package, one after the other
    (the jobs' ranks would otherwise share the cores with the other
    package's): ``(port's, reference's)``.  ``port_env`` and ``ref_env``
    default to :func:`env`."""
    return (run(True, body, np_, env=port_env or env(), **kwargs),
            run(False, body, np_, env=ref_env or env(), **kwargs))
