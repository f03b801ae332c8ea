"""Seconds of each phase of ``chip_smoke.py``, from any checkout.

Run from the repository root on a machine with one CUDA GPU::

    python3 tools/torch_smoke_seconds.py                   # this tree
    python3 tools/torch_smoke_seconds.py --root proof/parent  # another

Runs ``python3 -u chip_smoke.py`` in the checkout's root and stamps each
line of its standard output with the seconds since the start as it
arrives (``<seconds>\\t<line>``, written to ``--out``), so that a checkout
whose lines carry no ``t_s`` is timed the same way.  A phase's seconds
run from the previous phase's line to its own.  Then prints one JSON
line: the exit code, the whole run's seconds, ``{phase: seconds}`` in
order, and the ``build`` phase's seconds per kernel source.  Exits with
``chip_smoke.py``'s code.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose chip_smoke.py runs")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "chip_smoke.stamped"))
    args = ap.parse_args()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-u", "chip_smoke.py"],
                            cwd=os.path.abspath(args.root),
                            stdout=subprocess.PIPE, text=True)
    phases, build, prev = [], None, 0.0
    with open(args.out, "w") as out:
        for line in proc.stdout:
            t = time.perf_counter() - t0
            out.write(f"{t:.3f}\t{line}")
            out.flush()
            if not line.startswith('{"phase"'):
                continue
            rec = json.loads(line)
            phases.append([rec["phase"], t - prev])
            prev = t
            if rec["phase"] == "build":
                build = {k: v["seconds"] for k, v in rec["sources"].items()}
    rc = proc.wait()
    print(json.dumps({"rc": rc, "seconds": time.perf_counter() - t0,
                      "phases": phases, "build_sources": build}),
          flush=True)
    sys.exit(rc)


if __name__ == "__main__":
    main()
