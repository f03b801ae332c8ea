"""Phases of ``chip_smoke.py`` from two checkouts, in turns, on one card.

Run from the repository root on a machine with one CUDA GPU::

    python3 tools/torch_phase_turns.py --parent proof/parent \\
        [--phases train ring_train train_dp resnet kernels] [--rounds 1]
    python3 tools/torch_phase_turns.py --parent proof/parent --phases
        # no phase: the kernels' builds compared alone

Host-side step times move by tens of percent between chip calls, so a
change is compared with its parent inside one call, in turns: parent,
change, change, parent (``--rounds`` repeats the four).  Each turn is a
fresh ``python3 -c`` process in that checkout's root that imports its
``chip_smoke`` and calls ``phase_<name>()`` for each phase (the kernels
and the engine build once per checkout, before its first turn, in its own
``_build`` directories).  The phases' JSON lines are written to
``chiprun_out/phase_turns.jsonl`` tagged with the checkout and the turn;
one summary line per phase is printed: the tokens/s of every turn and
the median of each side (``kernels``: the milliseconds of K1 and B2 in
bf16 and of K1, B2, K2 and K3 in float32 at the main shape;
``ring_kernels``: of K4 and K5 in bf16 and in float32 on a wholly visible
step of the ring shard; each median apart).

First it prints one ``ptxas`` line comparing the two checkouts' kernel
builds, kernel by kernel (every instantiation of every ``ops/csrc/*.cu``):
the kernels whose ptxas lines (registers, spills, C75xx notes) or whose
SASS (``cuobjdump -sass``, addresses included, whitespace collapsed)
differ, with both sides' ptxas lines, and the count of kernels equal in
both.  A library whose
build kept no nvcc log (a checkout whose ``_build.py`` predates the logs)
is rebuilt, so both sides have their ptxas lines; a kernel still without
one is listed under ``ptxas_missing``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.torch_split_variants import ptxas_summary  # noqa: E402
# The throughput each phase reports (resnet: ResNet-50's, its first run).
METRIC = {"train": "tokens_per_s", "ring_train": "tokens_per_s",
          "train_dp": "tokens_per_s", "resnet": "images_per_s",
          "kernels": "ms", "ring_kernels": "ms"}


def metric(phase: str, rec: dict):
    if phase == "resnet":
        return rec["runs"][0][METRIC[phase]]
    if phase == "kernels":
        f32 = rec["f32"]
        return {"k1_bf16": rec["timing"]["flash_fwd"]["ms"],
                "b2_bf16": rec["timing"]["flash_bwd"]["ms"],
                "k1_f32": f32["timing"]["flash_fwd"]["ms"],
                "b2_f32": f32["timing"]["flash_bwd"]["ms"],
                "k2_f32": f32["k2_ms"], "k3_f32": f32["k3_ms"]}
    if phase == "ring_kernels":
        return {"k4_bf16": rec["timing"]["ring_flash_fwd"]["ms"],
                "k5_bf16": rec["timing"]["ring_flash_bwd"]["ms"],
                "k4_f32": rec["f32"]["ring_flash_fwd"]["ms"],
                "k5_f32": rec["f32"]["ring_flash_bwd"]["ms"]}
    return rec.get(METRIC[phase])


def median(values):
    """The median of numbers, or per key of dicts of numbers."""
    if isinstance(values[0], dict):
        return {k: statistics.median(v[k] for v in values)
                for k in values[0]}
    return statistics.median(values)


def run_turn(root: str, phases) -> dict:
    """``{phase: its JSON line}`` of one process in ``root``."""
    # chip_smoke.main() makes its output directory; the phases alone
    # write there too (train_dp's ranks their traces).
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    code = ("import sys; sys.argv = ['chip_smoke.py']; import chip_smoke as c"
            + "".join(f"; c.phase_{p}()" for p in phases))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=1800)
    if out.returncode != 0:
        raise RuntimeError(f"{root}: exit {out.returncode}\n"
                           f"{out.stderr[-3000:]}")
    lines = {}
    for ln in out.stdout.splitlines():
        if ln.startswith("{"):
            rec = json.loads(ln)
            if rec.get("phase") in phases:
                lines[rec["phase"]] = rec
    return lines


# Run in a checkout's root: build its kernels, rebuilding every library
# whose nvcc log holds no ptxas lines (one cached by a _build.py that kept
# no log beside it), then its engine; print {stem: [log, library]}.
BUILD_CODE = """\
import json, os, sys
sys.path.insert(0, '.')
from horovod_tpu_torch.ops import _build
info = _build.build_all()
stale = [st for st, i in info.items() if 'Compiling entry' not in i['log']]
for st in stale:
    os.remove(_build._lib_path(os.path.join(_build.CSRC, st + '.cu')))
if stale:
    info.update(_build.build_all(stale))
from horovod_tpu_torch.engine import build
build.build()
print(json.dumps({st: [i['log'], _build._lib_path(src)]
                  for src in _build.sources() for st, i in info.items()
                  if src.endswith('/' + st + '.cu')}))
"""


def build(root: str) -> dict:
    """Build ``root``'s kernels and engine; ``{kernel: {"ptxas": its
    ptxas lines, "sass": a hash of its SASS}}`` of every kernel built."""
    out = subprocess.run([sys.executable, "-c", BUILD_CODE], cwd=root,
                         timeout=900, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{root}: build failed\n{out.stderr}")
    built = json.loads(out.stdout.strip().splitlines()[-1])
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    kernels = {}
    for stem, (log, lib) in built.items():
        for name, line in ptxas_summary(log, "").items():
            kernels[name] = {"ptxas": line}
        sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                              text=True, check=True).stdout
        for part in re.split(r"\n\s*Function : ", sass)[1:]:
            name, body = part.split("\n", 1)
            # Whitespace collapsed: cuobjdump pads its columns to the
            # file's longest name, so a new kernel in the same library
            # would move every line of an unchanged one.
            kernels.setdefault(name.strip(), {})["sass"] = hashlib.sha256(
                re.sub(r"\s+", " ", body).encode()).hexdigest()[:16]
    return kernels


def compare_builds(parent: dict, change: dict) -> dict:
    """The kernels whose ptxas lines or SASS differ between the two
    builds, those built on one side only, and those with no ptxas line
    on a side (held by their SASS alone)."""
    both = sorted(set(parent) & set(change))
    differ = {n: {"parent": parent[n].get("ptxas"),
                  "change": change[n].get("ptxas"),
                  "sass_equal": parent[n].get("sass") ==
                  change[n].get("sass")}
              for n in both if parent[n] != change[n]}
    return {"equal": len(both) - len(differ),
            "differ": differ,
            "ptxas_missing": [n for n in both if "ptxas" not in parent[n]
                              or "ptxas" not in change[n]],
            "parent_only": sorted(set(parent) - set(change)),
            "change_only": sorted(set(change) - set(parent))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="root of the parent's checkout")
    ap.add_argument("--phases", nargs="*",
                    default=["train", "ring_train", "train_dp"])
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    roots = {"parent": os.path.abspath(args.parent), "change": ROOT}
    builds = {side: build(root) for side, root in roots.items()}
    print(json.dumps({"ptxas": compare_builds(builds["parent"],
                                              builds["change"])}),
          flush=True)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    seen = {p: {"parent": [], "change": []} for p in args.phases}
    with open(os.path.join(out_dir, "phase_turns.jsonl"), "w") as log:
        for rnd in range(args.rounds):
            for turn, side in enumerate(("parent", "change", "change",
                                         "parent")):
                lines = run_turn(roots[side], args.phases)
                for phase, rec in lines.items():
                    log.write(json.dumps({"side": side, "round": rnd,
                                          "turn": turn, **rec}) + "\n")
                    seen[phase][side].append(metric(phase, rec))
                log.flush()
    for phase, sides in seen.items():
        print(json.dumps({
            "phase": phase, "metric": METRIC[phase], "turns": sides,
            "median": {s: median(v) for s, v in sides.items() if v},
        }), flush=True)


if __name__ == "__main__":
    main()
