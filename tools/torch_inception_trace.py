"""Where InceptionV3's float32 gradients on the card leave float64.

Run from the repository root on a machine with one CUDA GPU::

    python3 tools/torch_inception_trace.py            # 299 x 299, batch 2
    python3 tools/torch_inception_trace.py --image 75 --device cpu  # rehearsal

The model and data are ``chip_smoke.py``'s ``image_models`` case:
InceptionV3 at batch 2 with weights from seed 5, standard-normal images
and labels from ``RandomState(3)``, training-mode BN, dropout off, one
forward and backward of the cross-entropy.  It runs five times: on the
CPU in float64 (the reference) and float32, and on the card in float32
three times: as the package sets it up (``torch.backends.cudnn.benchmark``
as found), with ``cudnn.benchmark`` off and
``torch.use_deterministic_algorithms(True)`` (``warn_only``: an op with no
deterministic kernel warns), and with cuDNN off
(``torch.backends.cudnn.enabled = False``: PyTorch's own CUDA
convolutions).

Every module's output and the gradient of the loss with respect to it
are recorded (forward hooks; a tensor hook on each output), and each
run's relative distance from float64 is taken norm-wise per module,
``||x - x64|| / ||x64||``.  A module is *off* where a card run's
distance is above 4 x the CPU float32 run's, floor 1e-6
(``image_models``' rule for the logits).  The JSON line printed names,
per card run, the first module in forward order whose output is off
while its input is not (the input: the output of the module that ran
before it, or for the first module the image), the first in backward
order whose output gradient is off, and the modules around each, with
the parameter gradients farthest from float64, and the ReLU masks that
differ from float64's: per BN output (the ReLU's input) the elements
whose sign differs from float64's, card and CPU float32, where either
has one.  ``--device cpu`` runs
the "card" runs on the CPU (a rehearsal of the script, not a
measurement).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# cuBLAS needs this before its first call to be deterministic.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import horovod_tpu_torch  # noqa: E402,F401  (the package's TF32 policy)
from horovod_tpu_torch.models.layers import Dense  # noqa: E402
from horovod_tpu_torch.torch import image_step as IS  # noqa: E402

CLASSES = 1000


def run(image, dtype, device):
    """``(records, param_grads)`` of one forward and backward: records in
    execution order, ``[name, output, grad of output]`` in float64 on the
    CPU, the image first as ``"input"``."""
    rng = np.random.RandomState(3)
    images = torch.from_numpy(rng.standard_normal(
        (2, image, image, 3)).astype(np.float32)).permute(0, 3, 1, 2)
    labels = torch.from_numpy(rng.randint(0, CLASSES, 2))
    net = IS.build_image_model("inception_v3", num_classes=CLASSES,
                               image=image, dtype=dtype, seed=5,
                               device=device, fused_ema=False)
    if dtype == torch.float64:
        net.double()
        for m in net.modules():
            if isinstance(m, Dense):
                m.dtype = torch.float64
    net.train()
    for m in net.modules():
        if isinstance(m, torch.nn.Dropout):
            m.eval()
    records = []

    def hook(name):
        def fn(_module, _inputs, out):
            rec = [name, out.detach().double().cpu(), None]
            records.append(rec)
            if out.requires_grad:
                out.register_hook(
                    lambda g: rec.__setitem__(2, g.detach().double().cpu()))
        return fn

    for name, m in net.named_modules():
        if name and not isinstance(m, torch.nn.ModuleList):
            m.register_forward_hook(hook(name))
    x = images.to(device, dtype)
    records.append(["input", x.double().cpu(), None])
    logits = net(x)
    torch.nn.functional.cross_entropy(logits, labels.to(device)).backward()
    grads = {n: p.grad.double().cpu() for n, p in net.named_parameters()}
    return records, grads


def dist(a, b):
    if a is None or b is None:
        return None
    return ((a - b).norm() / b.norm().clamp_min(1e-300)).item()


def off(card, cpu):
    return card is not None and card > max(4 * (cpu or 0.0), 1e-6)


def trace(ref, cpu32, card, grads64, grads32, grads_card):
    """The first off module forward (output off, input not) and backward
    (output gradient off), with the rows around each."""
    rows = []
    for (name, y64, g64), (_, y32, g32), (_, yc, gc) in zip(ref, cpu32,
                                                            card):
        rows.append({"module": name, "out": [dist(yc, y64), dist(y32, y64)],
                     "grad": [dist(gc, g64), dist(g32, g64)]})
    fwd = next((i for i in range(1, len(rows))
                if off(*rows[i]["out"]) and not off(*rows[i - 1]["out"])),
               None)
    # Backward runs in reverse execution order; the image has no gradient.
    bwd = next((i for i in reversed(range(1, len(rows)))
                if off(*rows[i]["grad"])), None)
    flips = []
    for (name, y64, _), (_, y32, _), (_, yc, _) in zip(ref, cpu32, card):
        if name.endswith(".bn"):
            sign = y64 > 0
            n = [int(((y > 0) != sign).sum()) for y in (yc, y32)]
            if any(n):
                flips.append({"module": name, "card": n[0], "cpu32": n[1],
                              "elements": y64.numel()})
    params = sorted(((dist(grads_card[n], g), dist(grads32[n], g), n)
                     for n, g in grads64.items()), reverse=True)[:8]
    return {"first_forward": rows[fwd]["module"] if fwd is not None
            else None,
            "forward_rows": rows[max(0, (fwd or 0) - 3):(fwd or 0) + 4],
            "first_backward": rows[bwd]["module"] if bwd is not None
            else None,
            "backward_rows": rows[max(0, (bwd or 0) - 3):(bwd or 0) + 4],
            "logits": rows[-1]["out"],
            "all_grads": [dist(torch.cat([x.flatten() for x in d.values()]),
                               torch.cat([x.flatten()
                                          for x in grads64.values()]))
                          for d in (grads_card, grads32)],
            "farthest_params": [{"param": n, "card": c, "cpu32": k}
                                for c, k, n in params],
            "relu_flips": {"card": sum(f["card"] for f in flips),
                           "cpu32": sum(f["cpu32"] for f in flips),
                           "first": flips[:6],
                           "most": sorted(flips, key=lambda f: -f["card"])
                           [:6]}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image", type=int, default=299)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("torch_inception_trace: no CUDA device")
    ref, grads64 = run(args.image, torch.float64, "cpu")
    cpu32, grads32 = run(args.image, torch.float32, "cpu")
    result = {}
    for mode in ("as_set", "deterministic", "cudnn_off"):
        det = mode == "deterministic"
        bench = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = bench and not det
        torch.backends.cudnn.enabled = mode != "cudnn_off"
        torch.use_deterministic_algorithms(det, warn_only=True)
        try:
            card, grads_card = run(args.image, torch.float32, args.device)
        finally:
            torch.backends.cudnn.benchmark = bench
            torch.backends.cudnn.enabled = True
            torch.use_deterministic_algorithms(False)
        result[mode] = {"cudnn_benchmark": bench and not det,
                        "cudnn": mode != "cudnn_off", "deterministic": det,
                        **trace(ref, cpu32, card, grads64, grads32,
                                grads_card)}
        del card, grads_card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip() if args.device == "cuda" else None
    print(json.dumps({"device": args.device, "nvidia_smi": smi,
                      "image": args.image, "rule": "off: card distance "
                      "from float64 > 4 x the CPU float32's, floor 1e-6",
                      "runs": result}), flush=True)


if __name__ == "__main__":
    main()
