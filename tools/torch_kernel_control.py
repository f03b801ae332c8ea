"""Control for the kernels' tolerance: a kernel that drops work must fail.

Run from the repository root on a machine with one CUDA GPU::

    python3 tools/torch_kernel_control.py

Builds mutants of the attention kernels, each with one line changed so
that it skips part of its work.  K1's mutants change the forward body
that K1 and K4 share (``csrc/flash_fwd_sm90.cuh``, 128-key tiles); each
keeps the body's barrier protocol, so a mutant computes wrong and never
hangs:

* ``fwd_skip_key_tile``    — K1 masks out the second-to-last key tile;
* ``dkdv_skip_query_tile`` — K2 skips the last query tile (not its own);
* ``dq_skip_key_tile``     — K3 skips the second-to-last key tile;
* ``fwd_late_rows_skip_first_key_tile`` — K1, for query tiles from row
  512 on, masks out key tile 0;
* ``dkdv_late_keys_skip_next_query_tile`` — K2, for keys from 512 on,
  skips the query tile after the diagonal;
* ``dq_late_rows_skip_first_key_tile`` — K3, for query rows from 512 on,
  skips key tile 0;
* ``fwd_late_rows_5pct``, ``dkdv_late_keys_5pct``, ``dq_late_rows_5pct``
  — K1's o, K2's dv and K3's dq come out 5% small for rows (keys) from
  512 on: a mis-rescaled second half;
* ``fwd_pv_drops_last_k16_slice`` — K1's P V product leaves out the last
  16-key slice of every key tile (the wgmma k-loop one step short).

Mutants of the backward body that B2 and K5 share
(``csrc/flash_bwd_sm90.cuh``), read through B2 (``flash_bwd``):

* ``bwd_dq_drops_last_k16_slice`` — the dQ = dS K product leaves out the
  last 16-key slice of each warpgroup's share (the wgmma k-loop one step
  short);
* ``bwd_qt0_one_tile_late`` — every CTA starts its query loop one 64-row
  tile late (producer and consumers alike, so the barriers still match);
* ``bwd_dv_skips_6pct_of_rows`` — P^T as dV's operand drops the last 4
  of every 64 query rows (6%; dK and dQ keep them).

The K2/K3 mutants are read through the split pair, the others through
B2.

The first three drop most of the mass of some rows; the next three drop
a share of late rows only; the next three move late rows, whose values
are small against the largest, by less than the old rule's limit.

Mutants of the ring kernels, each read on a ring of 4 members of shard
(4, 8, 1024, 64) in bf16 on the card:

* ``k4_k_offset_one_tile`` — K4 takes its k offset one 128-key tile late
  (in the shared forward body; read: o and lse of a diagonal step, under
  ``kernel_check``'s rule);
* ``k5_copy_drops_last_chunk`` — the copy blocks skip their last chunk
  (the loop is shared by K4 and K5; read: the receive slots after a
  rotating round of K5, on the backward body above, alone, bit for bit);
* ``k6_wrong_slot`` — K6 writes into the slot of member my + shift + 1
  (read: the rotated shards, bit for bit).
The mutated sources are copies under ``horovod_tpu_torch/_build/control/``
(the checked-in sources are not touched), built with the same nvcc flags.
Each mutant, and first the unmutated kernels (the sound readings, B2 and
the split pair), is held against the plain versions (each backward mode
against the plain side that walks its own key tile) at the main path's
shape (bh 128, seq 1024, head_dim 64, causal) in bf16 and fp16, under the
rule of ``horovod_tpu_torch/ops/kernel_check.py`` and under the rule it
replaced (max error <= 2e-2 * max |ref|).  ``worst`` is the largest error
over its limit; a reading passes at ``worst <= 1``.  Prints one JSON line and
exits 1 unless the sound readings pass and every mutant fails (under
``kernel_check``'s rule, or its bit-exact check).
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from horovod_tpu_torch.ops import _build  # noqa: E402
from horovod_tpu_torch.ops import attention as A  # noqa: E402
from horovod_tpu_torch.ops import kernel_check  # noqa: E402

SHAPE = (128, 1024, 64)  # (batch*heads, seq, head_dim) of the LM step
# Heads of the backward's loops: over key tiles (K3 — flash_bwd.cu has
# this line only there) and over query tiles (K2).
KEY_LOOP = "    const int k0 = kt * BN;\n"
QUERY_LOOP = "    const int q0 = qt * BM;\n"
# Lines of the shared 16-bit forward body (K1, K4).
FWD_BODY = "flash_fwd_sm90.cuh"
KEY_END = "      const int key_end = sk - k0;\n"
FWD_INV = "const float inv = lt == 0.f ? 1.f : 1.f / lt;"
PV_LOOP = "for (int j = 0; j < PV_STEPS; ++j) {"
# Lines of the 16-bit backward body (B2, K5).
BWD_BODY = "flash_bwd_sm90.cuh"
DQ_LOOP = "for (int jj = 0; jj < JN; ++jj) {"
N_IT = "  const int n_it = max(0, n_qt - qt0);\n"
PT_PACK = ("              pack2<T>(s[4 * i + 2 * h], "
           "s[4 * i + 2 * h + 1]);\n")
# mutant: (source stem, file mutated, line, what replaces it, outputs held);
# flash_bwd.cu's mutants (K2, K3) are held through the split pair.
MUTANTS = {
    "fwd_skip_key_tile": (
        "flash_fwd", FWD_BODY, KEY_END,
        KEY_END + "      if (kt == n_kt - 2)\n"
        "        for (float& x : s) x = NEG_INF;\n", ("o", "lse")),
    "dkdv_skip_query_tile": (
        "flash_bwd", "flash_bwd.cu", QUERY_LOOP,
        QUERY_LOOP + "    if (qt == n_qt - 1 && qt > qt0) continue;\n",
        ("dk", "dv")),
    "dq_skip_key_tile": (
        "flash_bwd", "flash_bwd.cu", KEY_LOOP,
        KEY_LOOP + "    if (kt == n_kt - 2) continue;\n", ("dq",)),
    "fwd_late_rows_skip_first_key_tile": (
        "flash_fwd", FWD_BODY, KEY_END,
        KEY_END + "      if (q0 >= 512 && kt == 0)\n"
        "        for (float& x : s) x = NEG_INF;\n", ("o", "lse")),
    "dkdv_late_keys_skip_next_query_tile": (
        "flash_bwd", "flash_bwd.cu", QUERY_LOOP,
        QUERY_LOOP + "    if (k0 >= 512 && qt == qt0 + 1) continue;\n",
        ("dk", "dv")),
    "dq_late_rows_skip_first_key_tile": (
        "flash_bwd", "flash_bwd.cu", KEY_LOOP,
        KEY_LOOP + "    if (q0 >= 512 && kt == 0) continue;\n", ("dq",)),
    "fwd_late_rows_5pct": (
        "flash_fwd", FWD_BODY, FWD_INV,
        "const float inv = (lt == 0.f ? 1.f : 1.f / lt) * "
        "(q0 >= 512 ? 0.95f : 1.f);", ("o",)),
    "dkdv_late_keys_5pct": (
        "flash_bwd", "flash_bwd.cu",
        "store_rows<T, D, BN>(dv, S, L::LDO, k0, sk, 1.f);",
        "store_rows<T, D, BN>(dv, S, L::LDO, k0, sk, "
        "k0 >= 512 ? 0.95f : 1.f);", ("dv",)),
    "dq_late_rows_5pct": (
        "flash_bwd", "flash_bwd.cu",
        "store_rows<T, D, BM>(dq, S, L::LDO, q0, sq, dq_scale);",
        "store_rows<T, D, BM>(dq, S, L::LDO, q0, sq, "
        "q0 >= 512 ? 0.95f * dq_scale : dq_scale);", ("dq",)),
    "fwd_pv_drops_last_k16_slice": (
        "flash_fwd", FWD_BODY, PV_LOOP,
        "for (int j = 0; j < PV_STEPS - 1; ++j) {", ("o",)),
    "bwd_dq_drops_last_k16_slice": (
        "flash_bwd", BWD_BODY, DQ_LOOP,
        "for (int jj = 0; jj < JN - 1; ++jj) {", ("dq",)),
    "bwd_qt0_one_tile_late": (
        "flash_bwd", BWD_BODY, N_IT, "  qt0 += 1;\n" + N_IT,
        ("dq", "dk", "dv")),
    "bwd_dv_skips_6pct_of_rows": (
        "flash_bwd", BWD_BODY, PT_PACK,
        PT_PACK + "          if (i == BWD_BM / 8 - 1 && cq >= 4)\n"
        "            pa[i / 2][(i % 2) * 2 + h] = 0u;\n", ("dv",)),
}


# Ring mutants: (source stem, file mutated, line, what replaces it, reading)
RING_MUTANTS = {
    "k4_k_offset_one_tile": (
        "ring_flash", FWD_BODY, "  const int q_abs = q_off + q0;\n",
        "  const int q_abs = q_off + q0;\n  k_off += BN;\n", "k4"),
    "k5_copy_drops_last_chunk": (
        "ring_flash", "ring_common.cuh",
        "  for (int c = cta; c < n_chunks; c += n_copy) {\n",
        "  for (int c = cta; c < n_chunks; c += n_copy) {\n"
        "    if (c == n_chunks - 1) continue;\n", "k5_copy"),
    "k6_wrong_slot": (
        "ring_permute", "ring_permute.cu",
        "const int to = ((ring.my + shift) % ring.n + ring.n) % ring.n;",
        "const int to = ((ring.my + shift + 1) % ring.n + ring.n) % ring.n;",
        "k6"),
}
RING_SHARD = (4, 8, 1024, 64)


def ring_reading(kind):
    """The ring kernels as built now, read as ``kind`` says: ``ok`` is
    whether they pass (a sound build must, a mutant must not)."""
    from horovod_tpu_torch.ops import rdma
    from horovod_tpu_torch.ops import ring_flash as RF
    from horovod_tpu_torch.parallel import RingMesh

    mesh = RingMesh(4)  # loads (and prepares) the libraries now in place
    members, _, scale_r = kernel_check.ring_inputs(4, RING_SHARD,
                                                   torch.bfloat16, 3)
    if kind == "k4":
        rows = kernel_check.hold_ring_round(mesh, members, 0, scale_r,
                                            rotate=False)
        errs = {n: max((r["errors"][n] for r in rows),
                       key=lambda e: e["worst"]) for n in ("o", "lse")}
        return {"errors": errs,
                "ok": all(e["worst"] <= 1.0 for e in errs.values())}
    if kind == "k5_copy":
        ks, vs = mesh.slots(members[0]["k"].shape, torch.bfloat16)
        ks.zero_()
        vs.zero_()
        calls = []
        for i, m in enumerate(members):
            o, lse = A._blockwise_fwd_impl(m["qr"], m["k"], m["v"], True,
                                           scale_r, q_offset=0, k_offset=0)
            calls.append(dict(qr=m["qr"], k=m["k"], v=m["v"], do=m["do"],
                              lse=lse, delta=A._delta(o, m["do"]),
                              q_offset=0, k_offset=0, scale_r=scale_r,
                              causal=True, rotate=True, phase=0))
        caller = mesh.fork()
        RF.launch_round(mesh, RF.ring_flash_bwd, calls)
        mesh.join(caller)
        torch.cuda.synchronize()
        exact = all(torch.equal(ks[(i + 1) % 4, 0], m["k"])
                    and torch.equal(vs[(i + 1) % 4, 0], m["v"])
                    for i, m in enumerate(members))
        return {"slots_exact": exact, "ok": exact}
    xs = [m["k"] for m in members]
    outs = rdma.permute_shards(xs, mesh, 1, 0)
    torch.cuda.synchronize()
    exact = all(torch.equal(outs[(i + 1) % 4], x) for i, x in enumerate(xs))
    return {"rotation_exact": exact, "ok": exact}


def loose_compare(got, want):
    """The replaced rule, scaled by the largest reference value."""
    err = (got.float() - want.float()).abs().max().item()
    return {"max_abs_err": err,
            "worst": err / (2e-2 * want.float().abs().max().item())}


def build_mutants():
    """``{mutant: path of its shared library}``, nvcc runs in parallel."""
    procs = {}
    edits = {name: (stem, file, old, new)
             for name, (stem, file, old, new, _) in MUTANTS.items()}
    edits.update({name: (stem, file, old, new)
                  for name, (stem, file, old, new, _)
                  in RING_MUTANTS.items()})
    for name, (stem, file, old, new) in edits.items():
        d = os.path.join(_build.BUILD_DIR, "control", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        path = os.path.join(d, file)
        text = open(path).read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: line not found once in {file}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
        src = os.path.join(d, f"{stem}.cu")
        out = os.path.join(d, f"{stem}.so")
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    paths = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        paths[name] = out
    return paths


def reading(got, ref, names):
    return {n: {"strict": kernel_check.compare(got[n], ref[n]),
                "loose": loose_compare(got[n], ref[n])} for n in names}


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_kernel_control: no CUDA device")
    _build.build_all()
    paths = build_mutants()
    sound = {stem: _build.load(stem) for stem in ("flash_fwd", "flash_bwd")}
    result, ok = {}, True
    for dtype in (torch.bfloat16, torch.float16):
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn(*SHAPE, device="cuda", generator=g)
                       .to(dtype) for _ in range(4))
        p2, scale_r = A._split_scale(SHAPE[2] ** -0.5)
        qr = (q * p2).to(dtype)
        ref, delta = kernel_check.plain_outputs(qr, k, v, do, True, scale_r,
                                                p2)
        args = (qr, k, v, do, ref["lse"], delta, p2, scale_r, True)
        # Each backward mode against the plain side of its own key tile.
        refs = {mode: {**ref, **kernel_check.plain_bwd_outputs(*args, mode)}
                for mode in ("combined", "split")}
        rows = {f"sound_{mode}": reading(
            kernel_check.kernel_outputs(*args, mode), refs[mode], list(ref))
            for mode in ("combined", "split")}
        ok &= all(r["strict"]["worst"] <= 1.0
                  for mode in ("combined", "split")
                  for r in rows[f"sound_{mode}"].values())
        for name, (stem, file, _, _, names) in MUTANTS.items():
            mode = "split" if file == "flash_bwd.cu" else "combined"
            _build._libs[stem] = ctypes.CDLL(paths[name])
            try:
                rows[name] = reading(
                    kernel_check.kernel_outputs(*args, mode), refs[mode],
                    names)
            finally:
                _build._libs[stem] = sound[stem]
            ok &= any(r["strict"]["worst"] > 1.0
                      for r in rows[name].values())
        result[str(dtype)] = rows
    ring = {}
    for kind in ("k4", "k5_copy", "k6"):
        ring[f"sound_{kind}"] = ring_reading(kind)
        ok &= ring[f"sound_{kind}"]["ok"]
    for name, (stem, _, _, _, kind) in RING_MUTANTS.items():
        sound_lib = _build.load(stem)
        _build._libs[stem] = ctypes.CDLL(paths[name])
        try:
            ring[name] = ring_reading(kind)
        finally:
            _build._libs[stem] = sound_lib
        ok &= not ring[name]["ok"]
    print(json.dumps({"shape": list(SHAPE), "causal": True, "ok": ok,
                      "readings": result, "ring_shard": list(RING_SHARD),
                      "ring_readings": ring}), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
