"""Lazy native build of the port's CUDA kernels.

Counterpart of ``horovod_tpu/engine/build.py``: each ``ops/csrc/*.cu``
compiles with ``nvcc`` for Hopper (``sm_90a``) into its own shared
library with a plain C interface under ``horovod_tpu_torch/_build/``,
named by a hash of the sources and flags, and loads with ``ctypes``.
Nothing includes PyTorch's headers, so a build takes seconds.  The
sources build in parallel, one ``nvcc`` each.  A missing ``nvcc``, a
failed compile or a failed load raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
# Seconds and compiler output of the last build of each source.
build_info: Dict[str, dict] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "horovod_tpu_torch are compiled at first use and need the CUDA "
        "toolkit")


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _lib_path(src: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def build_all(names: Optional[list] = None) -> Dict[str, dict]:
    """Compile every source (or those whose stems are in ``names``) that
    has no library for its current hash, all ``nvcc`` processes started
    together; returns ``{stem: {"seconds", "cached", "log"}}``, the log
    (nvcc's output, ptxas's lines included) kept beside the library and
    read back for a cached one."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for src in sources():
        stem = os.path.splitext(os.path.basename(src))[0]
        if names is not None and stem not in names:
            continue
        out = _lib_path(src)
        if os.path.exists(out):
            log = ""
            if os.path.exists(out + ".log"):
                with open(out + ".log") as f:
                    log = f.read()
            build_info[stem] = {"seconds": 0.0, "cached": True, "log": log}
            continue
        tmp = f"{out}.{os.getpid()}.part"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        procs[stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    failed = []
    for stem, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_info[stem] = {"seconds": time.perf_counter() - t0,
                            "cached": False, "log": log}
        if proc.returncode != 0:
            failed.append(f"{stem}:\n{log}")
            continue
        with open(out + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {k: build_info[k] for k in build_info
            if names is None or k in names}


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built first if needed."""
    lib = _libs.get(stem)
    if lib is not None:
        return lib
    src = os.path.join(CSRC, f"{stem}.cu")
    if not os.path.exists(src):
        raise FileNotFoundError(src)
    path = _lib_path(src)
    if not os.path.exists(path):
        build_all([stem])
    lib = ctypes.CDLL(path)
    _libs[stem] = lib
    return lib
