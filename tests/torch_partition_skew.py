"""The chaos partition job with one rank's init started late.

``tests/test_torch_chaos.py``'s partition job (``partition=0,1/2,3@after=4``,
4 ranks) with a sleep before one rank's ``INIT()``, under one package's
launcher: a rank whose engine starts late must not let either side of the
cut name a rank on its own side.  The port's engine arms the clause at the
end of init's topology agreement, on every rank at one instant; an engine
that arms it at its own start leaves the late rank reachable after the
others' clauses armed.

Run from the repository root on the CPU::

    JAX_PLATFORMS=cpu python -m tests.torch_partition_skew port --runs 10
    JAX_PLATFORMS=cpu python -m tests.torch_partition_skew reference
    JAX_PLATFORMS=cpu python -m tests.torch_partition_skew port \\
        --root proof/parent        # another checkout's packages and job

Prints one JSON line a run (the ranks' exit codes and ``DOWN`` lines, and
whether it failed the test's two conditions) and a summary line.
"""

import argparse
import json
import os
import sys

HEARTBEAT = {"HVD_TPU_HEARTBEAT_MS": "100", "HVD_TPU_HEARTBEAT_MISS": "10"}
SPEC = "partition=0,1/2,3@after=4"


def late_job(body, rank, seconds):
    """``body`` with rank ``rank``'s ``INIT()`` started ``seconds`` late."""
    return ("import os, time\n"
            f"if os.environ.get('HVD_TPU_RANK') == '{rank}':\n"
            f"    time.sleep({seconds})\n" + body)


def job_env(twin):
    return twin.env(HVD_TPU_NET_FAULT_SPEC=SPEC,
                    HVD_TPU_COLLECTIVE_TIMEOUT_SEC="30", **HEARTBEAT)


def verdict(twin, results):
    """``(failed, exit codes, DOWN lines)`` of one job: it fails unless
    every rank exits 7 and every ``DOWN`` line names only far-side ranks
    within 15 s, the test's conditions."""
    codes = {r.rank: r.returncode for r in results}
    downs = twin.lines(results, "DOWN")
    failed = codes != {r: 7 for r in range(4)} or any(
        v and (v[-1].split()[0] != "True" or float(v[-1].split()[1]) >= 15.0)
        for v in downs.values())
    return failed, codes, downs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("package", choices=("port", "reference"))
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--late-rank", type=int, default=0)
    ap.add_argument("--late-seconds", type=float, default=2.5)
    ap.add_argument("--root", default=None,
                    help="the checkout whose packages and job run")
    args = ap.parse_args()
    if args.root:
        root = os.path.abspath(args.root)
        sys.path.insert(0, root)
        os.chdir(root)
        for name in [m for m in sys.modules if m.split(".")[0] == "tests"]:
            del sys.modules[name]
    from tests import torch_twin as twin
    from tests.test_torch_chaos import _PARTITION

    port = args.package == "port"
    if port:
        from horovod_tpu_torch.engine import build
        build.build()
    else:
        from horovod_tpu.engine import build
        build()
    body = late_job(_PARTITION, args.late_rank, args.late_seconds)
    failures = 0
    for i in range(args.runs):
        results = twin.run(port, body, 4, timeout=90.0, env=job_env(twin))
        failed, codes, downs = verdict(twin, results)
        failures += failed
        print(json.dumps({"run": i, "failed": failed, "codes": codes,
                          "down": downs}), flush=True)
    print(json.dumps({"package": args.package, "root": twin.REPO,
                      "late_rank": args.late_rank,
                      "late_seconds": args.late_seconds, "runs": args.runs,
                      "failed": failures}), flush=True)


if __name__ == "__main__":
    main()
