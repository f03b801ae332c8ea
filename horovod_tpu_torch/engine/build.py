"""Build the port's collective engine (``libhvdtpu_torch-<hash>.so``).

Counterpart of ``horovod_tpu/engine/build.py``, trimmed: the host-only C++
of ``engine/cc/`` (sockets, pthreads, shm; no CUDA) compiles with ``g++``
at first use into ``horovod_tpu_torch/_build/``, each source as its own
object, all compilers started together, then one link.  The library is
named by a hash of the sources, the flags and the host CPU's ISA line
(``-march=native``), so a tree copied to another host rebuilds instead of
loading instructions its CPU lacks.

The link exports only the ``hvd_tpu_*`` C API (a version script with
``local: *``) and binds the library's own calls inside it
(``-Wl,-Bsymbolic``); ``common._load_lib`` loads it ``RTLD_LOCAL``.  So a
process that also holds ``horovod_tpu``'s engine (loaded ``RTLD_GLOBAL``,
every C++ symbol exported) keeps two engines with two sets of globals.

Concurrent builders (pytest workers, the ranks of a job) serialize on a
lock file; the objects go to a temporary directory beside the library,
which is renamed into place when linked.  A missing
compiler or a failed compile raises.

Sanitized builds (``docs/contributing.md#sanitized-engine-builds``):
``HVD_TPU_SANITIZE=thread|address|undefined`` compiles the engine with
``-O1 -fno-omit-frame-pointer -g -fsanitize=<mode>`` in place of ``-O3
-march=native`` into a library of its own,
``libhvdtpu_torch.<mode>-<hash>.so``, whose hash (its stamp) covers the
mode's flags: switching modes never touches the normal cached build.  The
version script and ``-Bsymbolic`` stay.  An uninstrumented python that
loads it needs the sanitizer's runtime preloaded:
:func:`sanitizer_preload` names it, and the launcher puts it first in each
rank's ``LD_PRELOAD`` (``runner/launch.py``).
"""

from __future__ import annotations

import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CC_DIR = os.path.join(_HERE, "cc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ["net.cc", "transport.cc", "wire.cc", "timeline.cc", "autotune.cc",
           "flight.cc", "engine.cc", "simscale.cc", "c_api.cc"]
LIB_STEM = "libhvdtpu_torch"
# The reference's flags less ``-g``: debug info doubles engine.cc's
# compile time (24 s against 14 on 8 cores) and changes no instruction.
CXX_FLAGS = ["-std=c++17", "-O3", "-march=native", "-fPIC", "-pthread",
             "-Wall", "-Wextra", "-Wno-unused-parameter"]
LINK_FLAGS = ["-shared", "-pthread", "-Wl,-Bsymbolic"]
# Only the C API leaves the library.
VERSION_SCRIPT = "{\n  global: hvd_tpu_*;\n  local: *;\n};\n"
# Sanitizer mode -> (its flags, the runtime an uninstrumented host
# preloads): one table, so the build and the preload resolver accept the
# same modes.
SANITIZERS = {
    "thread": (["-fsanitize=thread"], "libtsan.so"),
    "address": (["-fsanitize=address"], "libasan.so"),
    "undefined": (["-fsanitize=undefined", "-fno-sanitize-recover=all"],
                  "libubsan.so"),
}

# Seconds of the last build in this process, and whether it was cached.
build_info: Dict[str, object] = {}


def _cpu_line() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line
    except OSError:
        pass
    return ""


def sanitize_mode() -> str:
    """The validated ``HVD_TPU_SANITIZE`` mode ('' for the normal build)."""
    mode = (os.environ.get("HVD_TPU_SANITIZE") or "").strip().lower()
    _check_mode(mode)
    return mode


def _check_mode(mode: str) -> None:
    if mode and mode not in SANITIZERS:
        raise ValueError(
            f"HVD_TPU_SANITIZE: unknown sanitizer {mode!r} "
            f"(want {', '.join(sorted(SANITIZERS))})")


def cxx_flags(mode: str = "") -> List[str]:
    """The compile flags of ``mode``: the sanitizer's swap in for ``-O3
    -march=native`` (``-O1`` and frame pointers keep reports readable)."""
    _check_mode(mode)
    if not mode:
        return list(CXX_FLAGS)
    base = [f for f in CXX_FLAGS if f not in ("-O3", "-march=native")]
    return base + ["-O1", "-fno-omit-frame-pointer", "-g"] + \
        SANITIZERS[mode][0]


def link_flags(mode: str = "") -> List[str]:
    _check_mode(mode)
    return LINK_FLAGS + (SANITIZERS[mode][0] if mode else [])


def build_stamp(mode: str = "") -> str:
    """The hash in the library's name: the sources, ``mode``'s flags, the
    version script and the host CPU's ISA line."""
    h = hashlib.sha256(" ".join(cxx_flags(mode) + link_flags(mode))
                       .encode())
    h.update(VERSION_SCRIPT.encode())
    h.update(_cpu_line().encode())
    for name in sorted(os.listdir(CC_DIR)):
        if name.endswith((".cc", ".h")):
            h.update(name.encode())
            with open(os.path.join(CC_DIR, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def lib_path(mode: Optional[str] = None) -> str:
    """Where the library of ``mode`` (default ``HVD_TPU_SANITIZE``'s) for
    the current sources, flags and CPU lives."""
    if mode is None:
        mode = sanitize_mode()
    stem = f"{LIB_STEM}.{mode}" if mode else LIB_STEM
    return os.path.join(BUILD_DIR, f"{stem}-{build_stamp(mode)}.so")


def sanitizer_preload(mode: Optional[str] = None) -> str:
    """The sanitizer runtime to ``LD_PRELOAD`` into an uninstrumented
    python that loads ``mode``'s engine: '' for the normal build, or
    when the compiler cannot name it.  ``ValueError`` on an unknown
    mode."""
    if mode is None:
        mode = sanitize_mode()
    _check_mode(mode)
    return _resolve_preload(mode) if mode else ""


@functools.lru_cache(maxsize=None)
def _resolve_preload(mode: str) -> str:
    """One compiler call per mode and process: the launcher asks once a
    rank."""
    cxx = os.environ.get("CXX", "g++")
    try:
        out = subprocess.run(
            [cxx, f"-print-file-name={SANITIZERS[mode][1]}"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return ""
    # An unresolved -print-file-name echoes the bare name back.
    if not out or os.sep not in out:
        return ""
    real = os.path.realpath(out)
    return real if os.path.exists(real) else ""


def _compile(out: str, tmpdir: str, mode: str) -> None:
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        raise RuntimeError(
            f"C++ compiler {cxx!r} not found: the collective engine of "
            "horovod_tpu_torch is compiled at first use")
    procs = []
    for src in SOURCES:
        obj = os.path.join(tmpdir, src.replace(".cc", ".o"))
        cmd = [cxx, *cxx_flags(mode), "-c", os.path.join(CC_DIR, src),
               "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, _, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
    if failed:
        raise RuntimeError("failed to build the engine:\n" + "\n".join(failed))
    script = os.path.join(tmpdir, "exports.map")
    with open(script, "w") as f:
        f.write(VERSION_SCRIPT)
    # -lrt after the objects: shm_open lives in librt on glibc < 2.34.
    cmd = [cxx, *link_flags(mode), f"-Wl,--version-script={script}",
           "-o", out, *[obj for _, obj, _ in procs], "-lrt"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"failed to link the engine:\n{proc.stderr}")


def build() -> str:
    """The path of the engine library (``HVD_TPU_SANITIZE``'s variant),
    compiled first if there is none for the current sources.  Raises on
    failure."""
    mode = sanitize_mode()
    lib = lib_path(mode)
    if os.path.exists(lib):
        build_info.update(seconds=0.0, cached=True)
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{LIB_STEM}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(lib):  # a concurrent builder finished it
            build_info.update(seconds=0.0, cached=True)
            return lib
        t0 = time.perf_counter()
        tmpdir = tempfile.mkdtemp(prefix=f"{LIB_STEM}-", dir=BUILD_DIR)
        try:
            out = os.path.join(tmpdir, os.path.basename(lib))
            _compile(out, tmpdir, mode)
            os.replace(out, lib)
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)
        build_info.update(seconds=time.perf_counter() - t0, cached=False)
    return lib


def exported_symbols(path: str) -> list:
    """The defined dynamic symbols of the library at ``path`` (``nm``)."""
    proc = subprocess.run(["nm", "-D", "--defined-only", path],
                          capture_output=True, text=True, check=True)
    return sorted(line.split()[-1] for line in proc.stdout.splitlines()
                  if line.strip())


if __name__ == "__main__":
    print(build())
