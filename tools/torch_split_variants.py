"""Design choices of two kernel families, timed on the GPU: the split
backward pair (K2, K3) at head dim 64, and the 16-bit wide bodies of K1,
K2 and K3 (head dims above 256).

Run from the repository root on a machine with one CUDA GPU::

    python3 tools/torch_split_variants.py                 # the split pair
    python3 tools/torch_split_variants.py --family wide   # K1-K3 above 256
    python3 tools/torch_split_variants.py --family wide_f32  # K1, K2 f32
    python3 tools/torch_split_variants.py --family f32   # the same, <= 256

Each variant is a copy of the kernel sources with one or two lines
changed (under ``horovod_tpu_torch/_build/variants/``; the checked-in
sources are not touched), built with the same nvcc flags, all builds in
parallel.  ``FAMILIES`` holds, per family, the source's stem, the shapes
and the alternatives to the checked-in choices.  ``split``:

* ``k2_two_stages`` — K2 (``flash_bwd_dkdv``, the backward body of B2 and
  K5 with its dQ product compiled out) streams its (q', dO) tiles through
  two stages, as B2 does, instead of the ``DKDV_STAGES`` the shared memory
  freed by the dQ buffers allows;
* ``k3_128_keys`` — K3 (``flash_bwd_dq``) takes 128-key tiles up to head
  dim 64 (S, dP, the packed dS and dQ of the pipelined loop then need
  more registers than a consumer warpgroup has: ptxas spills);
* ``k3_two_stages``, ``k3_four_stages`` — K3 streams K and V through two
  or four stages instead of ``DQ_STAGES``.

``wide`` (``csrc/flash_wide_sm90.cuh``):

* ``dkdv_64_rows`` — K2 steps over the queries 64 rows at a time
  instead of ``DKDV_ROWS`` (S^T and dP^T as m64n64k16 products in twice
  the registers, K and V chunks re-streamed half as often);
* ``dkdv_4_panels`` — K2's CTAs compute windows of 4 output panels (128
  columns) instead of ``DKDV_NP``: fewer column CTAs recomputing S^T and
  dP^T (4 at 512, 8 at 1024), dK and dV in more registers;
* ``dkdv_4_stages`` — K2 streams its (K, V, q', dO) chunks through four
  stages instead of ``DKDV_STAGES``;
* ``fwd_3_panels`` — K1's CTAs compute windows of 3 output panels
  instead of ``FWD_NP`` (O in fewer registers, more column CTAs);
* ``fwd_64_keys`` — K1 takes 64-key tiles instead of ``FWD_KEYS`` (S in
  half the registers, Q re-streamed twice as often; the plain side then
  walks 64 keys);
* ``dq_32_keys`` — K3 takes 32-key tiles instead of ``DQ_KEYS`` (S, dP
  and the packed dS in half the registers, q' and dO re-streamed twice
  as often; the plain side's dq then walks 32 keys);
* ``dq_3_panels`` — K3's CTAs compute windows of 3 output panels instead
  of ``DQ_NP`` (dQ in 48 registers, more column CTAs recomputing S and
  dP above 288);
* ``dq_4_stages`` — K3 streams its (q', dO, K, V) chunks through four
  stages instead of ``DQ_STAGES``.

``wide_f32`` (``csrc/flash_wide_f32_sm90.cuh``, 3xTF32, float32 inputs;
K1 and K2 alone, K3's f32 body being SIMT):

* ``fwd_one_chain``, ``dkdv_one_chain`` — K1's S (K2's S^T and dP^T) is
  chained through one wgmma accumulator over the whole head dim (3 d / 8
  steps) instead of summed per 32-column chunk in f32 registers: 32
  fewer registers a thread, and the tensor cores' truncating accumulation
  drifts with the chain's length;
* ``fwd_p_at_once`` — K1 splits all of P into its hi / lo A fragments
  before the P V products instead of one 8-key slice at a time (48 more
  registers at the product, fewer waits);
* ``fwd_2_stages`` — K1 streams two chunk stages instead of
  ``F32_FWD_STAGES`` (K2's two are fixed: its note says why).

``f32`` (the same header, the bodies at head dims 32-256, built into
``flash_fwd`` and ``flash_bwd_split``): ``fwd_one_chain``,
``dkdv_one_chain``, ``fwd_p_at_once``, ``fwd_2_stages`` as above, and

* ``fwd_three_pv_products`` — K1's P V without its fourth product (P's
  hi against V's rest): what o = v exactly where p = 1 costs.

Every build is held against the plain side that walks its own key tile
(``kernel_check``; ``worst`` <= 1 passes), then the family's kernels are
timed with the checked-in build and each variant in turns (checked-in,
variant, variant, checked-in, twice) at the family's shapes (bf16;
``wide_f32`` float32; causal), by CUDA events, median of 15 after
warm-up with a sleep kernel ahead, each turn's shape and build named on
stderr first.  For ``wide`` and ``wide_f32`` (whose ``worst`` is also
given per output) it first prints each build's registers and spills
(``-Xptxas -v``, with the C75xx notes of each kernel) as one JSON line.
Then one JSON line: per shape and kernel, each build's medians.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from horovod_tpu_torch.ops import _build  # noqa: E402
from horovod_tpu_torch.ops import attention as A  # noqa: E402
from horovod_tpu_torch.ops import kernel_check  # noqa: E402

SLEEP_CYCLES = 2_000_000  # ≈1 ms at the H100's clock
WH = "flash_wide_sm90.cuh"
# family: stem (or stems: every source that launches the family's
# bodies), shapes (bh, s, d), the namespace whose kernels' ptxas lines are
# printed (or None), and variant: ([(file, line, replacement)],
# the key tiles the plain side walks where they change: (forward, dq), None
# for the checked-in tile).
FAMILIES = {
    "split": {
        "stem": "flash_bwd_split", "ptxas": None,
        "shapes": ((1040, 512, 64), (64, 8192, 64), (32, 16384, 64)),
        "variants": {
            "k2_two_stages": ([("flash_bwd_sm90.cuh",
                                "constexpr int DKDV_STAGES = 3;",
                                "constexpr int DKDV_STAGES = 2;")], None),
            "k3_128_keys": ([("flash_dq_sm90.cuh", "  return 64;\n",
                              "  return D <= 64 ? 128 : 64;\n")],
                            (None, 128)),
            "k3_two_stages": ([("flash_dq_sm90.cuh",
                                "constexpr int DQ_STAGES = 3;",
                                "constexpr int DQ_STAGES = 2;")], None),
            "k3_four_stages": ([("flash_dq_sm90.cuh",
                                 "constexpr int DQ_STAGES = 3;",
                                 "constexpr int DQ_STAGES = 4;")], None),
        }},
    "wide": {
        "stem": "flash_wide", "ptxas": "wide90",
        "shapes": ((64, 1024, 288), (64, 1024, 512), (32, 1024, 1024)),
        "variants": {
            "dkdv_64_rows": ([(WH, "constexpr int DKDV_ROWS = 32;",
                               "constexpr int DKDV_ROWS = 64;")], None),
            "dkdv_4_panels": ([(WH, "constexpr int DKDV_NP = 3;",
                                "constexpr int DKDV_NP = 4;")], None),
            "dkdv_4_stages": ([(WH, "constexpr int DKDV_STAGES = 3;",
                                "constexpr int DKDV_STAGES = 4;")], None),
            "fwd_3_panels": ([(WH, "constexpr int FWD_NP = 4;",
                               "constexpr int FWD_NP = 3;")], None),
            "fwd_64_keys": ([(WH, "constexpr int FWD_KEYS = 128;",
                              "constexpr int FWD_KEYS = 64;")], (64, None)),
            "dq_32_keys": ([(WH, "constexpr int DQ_KEYS = 64;",
                             "constexpr int DQ_KEYS = 32;")], (None, 32)),
            "dq_3_panels": ([(WH, "constexpr int DQ_NP = 4;",
                              "constexpr int DQ_NP = 3;")], None),
            "dq_4_stages": ([(WH, "constexpr int DQ_STAGES = 3;",
                              "constexpr int DQ_STAGES = 4;")], None),
        }},
}


WF = "flash_wide_f32_sm90.cuh"
_K1_S = ("        Wgmma<BN, float>::rs(sc, qh[kk % 2], kh, kk != 0);\n"
         "        Wgmma<BN, float>::rs(sc, qh[kk % 2], kl, 1);\n"
         "        Wgmma<BN, float>::rs(sc, ql[kk % 2], kh, 1);\n")
_K2_S = ("        Wgmma<QB, float>::rs(sc, kh[b], qh, kk != 0);\n"
         "        Wgmma<QB, float>::rs(sc, kh[b], ql, 1);\n"
         "        Wgmma<QB, float>::rs(sc, kl[b], qh, 1);\n"
         "        Wgmma<QB, float>::rs(dpc, vh[b], dh, kk != 0);\n"
         "        Wgmma<QB, float>::rs(dpc, vh[b], dl, 1);\n"
         "        Wgmma<QB, float>::rs(dpc, vl[b], dh, 1);\n")
_K2_SUM = ("      for (int i = 0; i < QB / 2; ++i) {\n"
           "        s[i] = first ? sc[i] : s[i] + sc[i];\n"
           "        dp[i] = first ? dpc[i] : dp[i] + dpc[i];\n"
           "      }\n")
_K1_PV4 = "        Wgmma<CW, float>::rs(acc, ph[j % 2], vl2, 1);\n"
_K1_PV = ("        Wgmma<CW, float>::rs(acc, ph[j % 2], vh, 1);\n"
          "        Wgmma<CW, float>::rs(acc, ph[j % 2], vl, 1);\n"
          "        Wgmma<CW, float>::rs(acc, pl[j % 2], vh, 1);\n"
          + _K1_PV4 +
          "        wg_commit();\n"
          "        wg_wait<1>();\n"
          "      }\n"
          "      wg_wait<0>();\n")
FAMILIES["wide_f32"] = {
    "stem": "flash_wide", "ptxas": "wide32", "dtype": torch.float32,
    "shapes": ((64, 1024, 288), (64, 1024, 512), (16, 1024, 1024)),
    "variants": {
        "fwd_one_chain": ([
            (WF, _K1_S, _K1_S.replace("(sc,", "(s,").replace(
                "kk != 0", "!(first && kk == 0)")),
            (WF, "      for (int i = 0; i < BN / 2; ++i) s[i] = first ? "
             "sc[i] : s[i] + sc[i];\n", "")], None),
        "dkdv_one_chain": ([
            (WF, _K2_S, _K2_S.replace("(sc,", "(s,").replace(
                "(dpc,", "(dp,").replace("kk != 0", "!(first && kk == 0)")),
            (WF, _K2_SUM, "")], None),
        "fwd_p_at_once": ([
            (WF, "      uint32_t ph[2][4], pl[2][4];\n#pragma unroll\n"
             "      for (int j = 0; j < BN / 8; ++j) {\n"
             "        split_acc(s, j, ph[j % 2], pl[j % 2]);\n",
             "      uint32_t ph[BN / 8][4], pl[BN / 8][4];\n#pragma unroll\n"
             "      for (int i = 0; i < BN / 8; ++i) "
             "split_acc(s, i, ph[i], pl[i]);\n#pragma unroll\n"
             "      for (int j = 0; j < BN / 8; ++j) {\n"),
            (WF, _K1_PV, _K1_PV.replace("[j % 2]", "[j]").replace(
                "        wg_commit();\n        wg_wait<1>();\n      }\n"
                "      wg_wait<0>();\n",
                "      }\n      wg_commit();\n      wg_wait<0>();\n"))],
            None),
        "fwd_2_stages": ([(WF, "constexpr int F32_FWD_STAGES = 3;",
                           "constexpr int F32_FWD_STAGES = 2;")], None),
    }}
FAMILIES["f32"] = {
    "stem": ("flash_fwd", "flash_bwd_split"), "ptxas": "wide32",
    "dtype": torch.float32,
    "shapes": ((128, 1024, 64), (32, 1024, 128), (8, 1024, 256)),
    "variants": {
        **FAMILIES["wide_f32"]["variants"],
        "fwd_three_pv_products": ([(WF, _K1_PV4, "")], None)}}


def build_variants(stems, variants):
    """``{variant: ({stem: path of its shared library}, nvcc logs)}`` of
    each of ``stems``' sources under each of ``variants``' edits, nvcc
    runs in parallel."""
    procs = {}
    for name, (edits, _) in variants.items():
        d = os.path.join(_build.BUILD_DIR, "variants", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        for file, old, new in edits:
            path = os.path.join(d, file)
            text = open(path).read()
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: line not found once in {file}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        for stem in stems:
            out = os.path.join(d, f"{stem}.so")
            procs[name, stem] = (subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out,
                 os.path.join(d, f"{stem}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), out)
    built = {}
    for (name, stem), (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} ({stem}):\n{log}")
        paths, logs = built.setdefault(name, ({}, ""))
        paths[stem] = out
        built[name] = (paths, logs + log)
    return built


def ptxas_summary(log, namespace):
    """``{kernel: "registers, spills[; C75xx notes]"}`` of ``namespace``'s
    kernels in an nvcc ``-Xptxas -v`` log."""
    out, notes, name = {}, {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if namespace in m.group(1) else None
        elif name and ("spill" in line or "Used" in line):
            out[name] = (out.get(name, "") + " " + line.split(":", 1)[-1]
                         .strip()).strip()
        m = re.search(r"\((C75\d\d)\).* function '(\w+)'", line)
        if m and namespace in m.group(2):
            notes.setdefault(m.group(2), set()).add(m.group(1))
    return {k: v + ("; " + ", ".join(sorted(notes[k])) if k in notes else "")
            for k, v in out.items()}


def time_ms(fn, warmup=3, iters=15):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _dq(qr, k, v, do, lse, delta, p2, r, tile):
    """The plain side's dq, dk, dv with dq summed over ``tile``-key blocks
    (None: K3's checked-in tile)."""
    block = tile or A.bwd_key_tile("split", torch.bfloat16, qr.shape[-1])
    return A._attention_bwd_impl(qr, k, v, lse, delta, do, True, r,
                                 block_size=block, dq_scale=p2,
                                 round_pds=True)


def split_case(qr, k, v, do, p2, r, tiles):
    """K2 and K3 of the split pair, and the plain outputs per dq tile."""
    o, lse = A.flash_fwd(qr, k, v, r, True)
    delta = A._delta(o, do)
    args = (qr, k, v, do, lse, delta, r)
    kernels = {"k2": lambda: A.flash_bwd_dkdv(*args, True),
               "k3": lambda: A.flash_bwd_dq(*args, p2, True)}

    def outputs():
        dk, dv = kernels["k2"]()
        return {"dq": kernels["k3"](), "dk": dk, "dv": dv}

    wants = {}
    for tile in tiles:
        dq, dk, dv = _dq(qr, k, v, do, lse, delta, p2, r, tile[1])
        wants[tile] = {"dq": dq, "dk": dk, "dv": dv}
    return kernels, outputs, wants


def wide_case(qr, k, v, do, p2, r, tiles):
    """K1, K2 and K3 of the wide bodies, and the plain outputs per (K1,
    K3) tile pair."""
    d = qr.shape[-1]
    fwd = {}
    for tile in {t[0] for t in tiles}:
        fwd[tile] = A._blockwise_fwd_impl(
            qr, k, v, True, r,
            block_size=tile or A.fwd_key_tile(torch.bfloat16, d))
    lse, delta = fwd[None][1], A._delta(fwd[None][0], do)
    bwd = {tile: _dq(qr, k, v, do, lse, delta, p2, r, tile)
           for tile in {t[1] for t in tiles}}
    wants = {t: {"o": fwd[t[0]][0], "lse": fwd[t[0]][1], "dq": bwd[t[1]][0],
                 "dk": bwd[t[1]][1], "dv": bwd[t[1]][2]} for t in tiles}
    args = (qr, k, v, do, lse, delta, r)
    kernels = {"k1": lambda: A.flash_fwd(qr, k, v, r, True),
               "k2": lambda: A.flash_bwd_dkdv(*args, True),
               "k3": lambda: A.flash_bwd_dq(*args, p2, True)}

    def outputs():
        o, lse_k = kernels["k1"]()
        dk_k, dv_k = kernels["k2"]()
        return {"o": o, "lse": lse_k, "dq": kernels["k3"](), "dk": dk_k,
                "dv": dv_k}

    return kernels, outputs, wants


def f32_case(qr, k, v, do, p2, r, tiles):
    """K1 and K2 of the f32 bodies, and their plain outputs."""
    d = qr.shape[-1]
    o, lse = A._blockwise_fwd_impl(
        qr, k, v, True, r, block_size=A.fwd_key_tile(torch.float32, d))
    delta = A._delta(o, do)
    _, dk, dv = A._attention_bwd_impl(qr, k, v, lse, delta, do, True, r,
                                      block_size=A.bwd_key_tile(
                                          "split", torch.float32, d))
    args = (qr, k, v, do, lse, delta, r)
    kernels = {"k1": lambda: A.flash_fwd(qr, k, v, r, True),
               "k2": lambda: A.flash_bwd_dkdv(*args, True)}

    def outputs():
        o_k, lse_k = kernels["k1"]()
        dk_k, dv_k = kernels["k2"]()
        return {"o": o_k, "lse": lse_k, "dk": dk_k, "dv": dv_k}

    return kernels, outputs, {t: {"o": o, "lse": lse, "dk": dk, "dv": dv}
                              for t in tiles}


CASES = {"split": split_case, "wide": wide_case, "wide_f32": f32_case,
         "f32": f32_case}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", choices=sorted(FAMILIES), default="split")
    family = ap.parse_args().family
    fam = FAMILIES[family]
    if not torch.cuda.is_available():
        sys.exit("torch_split_variants: no CUDA device")
    stems, variants = fam["stem"], fam["variants"]
    stems = (stems,) if isinstance(stems, str) else stems
    info = _build.build_all(list(stems))
    built = build_variants(stems, variants)
    if fam["ptxas"]:
        ns = fam["ptxas"]
        cached = any(info[st]["cached"] for st in stems)
        print(json.dumps({"ptxas": {
            "checked_in": "cached build, no ptxas log" if cached else
            ptxas_summary("".join(info[st]["log"] for st in stems), ns),
            **{n: ptxas_summary(log, ns) for n, (_, log) in built.items()}}}),
            flush=True)
    libs = {"checked_in": {st: _build.load(st) for st in stems}}
    libs.update({n: {st: ctypes.CDLL(p) for st, p in paths.items()}
                 for n, (paths, _) in built.items()})
    tiles = {n: variants[n][1] if n in variants and variants[n][1]
             else (None, None) for n in libs}
    dtype = fam.get("dtype", torch.bfloat16)
    result, ok = {}, True
    for bh, s, d in fam["shapes"]:
        g = torch.Generator(device="cuda").manual_seed(
            s if family == "split" else s + d)
        q, k, v, do = (torch.randn(bh, s, d, device="cuda", generator=g)
                       .to(dtype) for _ in range(4))
        p2, r = A._split_scale(d ** -0.5)
        qr = (q * p2).to(dtype)
        kernels, outputs, wants = CASES[family](qr, k, v, do, p2, r,
                                                set(tiles.values()))
        worst, by_output = {}, {}
        for n, lib in libs.items():
            _build._libs.update(lib)
            errs = kernel_check.compare_outputs(outputs(), wants[tiles[n]])
            by_output[n] = {o: e["worst"] for o, e in errs.items()}
            worst[n] = max(by_output[n].values())
            ok &= worst[n] <= 1.0
        times = {kern: {n: [] for n in libs} for kern in kernels}
        for n in variants:
            for m in ("checked_in", n, n, "checked_in") * 2:
                _build._libs.update(libs[m])
                # On stderr, so that a fault names the build it hit.
                print(f"timing {bh}x{s}x{d} {m}", file=sys.stderr,
                      flush=True)
                for kern, fn in kernels.items():
                    times[kern][m].append(time_ms(fn))
        _build._libs.update(libs["checked_in"])
        result["x".join(map(str, (bh, s, d)))] = {
            "median_ms": {kern: {n: statistics.median(t)
                                 for n, t in ts.items()}
                          for kern, ts in times.items()},
            "worst": worst,
            **({"worst_by_output": by_output} if fam["ptxas"] else {})}
        del q, k, v, do, qr, kernels, outputs, wants
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "ok": ok, "shapes": result}),
          flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
