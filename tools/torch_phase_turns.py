"""Phases of ``chip_smoke.py`` from two checkouts, in turns, on one card.

Run from the repository root on a machine with one CUDA GPU::

    python3 tools/torch_phase_turns.py --parent proof/parent \\
        [--phases train ring_train train_dp resnet kernels] [--rounds 1]

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
bf16 and of K1, B2, K2 and K3 in float32 at the main shape, each
median apart).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The throughput each phase reports (resnet: ResNet-50's, its first run).
METRIC = {"train": "tokens_per_s", "ring_train": "tokens_per_s",
          "train_dp": "tokens_per_s", "resnet": "images_per_s",
          "kernels": "ms"}


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


def build(root: str) -> None:
    code = ("import sys; sys.path.insert(0, '.'); "
            "from horovod_tpu_torch.ops import _build; _build.build_all(); "
            "from horovod_tpu_torch.engine import build; build.build()")
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=900)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="root of the parent's checkout")
    ap.add_argument("--phases", nargs="+",
                    default=["train", "ring_train", "train_dp"])
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    roots = {"parent": os.path.abspath(args.parent), "change": ROOT}
    for root in roots.values():
        build(root)
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
