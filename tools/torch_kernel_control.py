"""Control for the kernels' tolerance: a kernel that drops work must fail.

Run from the repository root on a machine with one CUDA GPU::

    python3 tools/torch_kernel_control.py              # every mutant
    python3 tools/torch_kernel_control.py --wide-only  # K3 above 256
    python3 tools/torch_kernel_control.py --f32        # K1-K5 in f32
    python3 tools/torch_kernel_control.py --f32-first-rows  # dq, row 0

Builds mutants of the attention kernels, each with one line changed so
that it skips part of its work.  K1's mutants change the forward body
that K1 and K4 share (``csrc/flash_fwd_sm90.cuh``, 128-key tiles); each
keeps the body's barrier protocol, so a mutant computes wrong and never
hangs:

* ``fwd_skip_key_tile``    — K1 masks out the second-to-last key tile;
* ``dkdv_skips_last_query_tile`` — K2 skips the last query tile of each
  key tile (producer and consumers alike);
* ``dq_skip_key_tile``     — K3 zeroes p of the second-to-last key tile;
* ``fwd_late_rows_skip_first_key_tile`` — K1, for query tiles from row
  512 on, masks out key tile 0;
* ``dkdv_late_keys_skip_next_query_tile`` — K2, for key tiles from 512
  on, zeroes p of the 64-row query step after the first that sees them;
* ``dq_late_rows_skip_first_key_tile`` — K3, for query tiles from row 512
  on, zeroes p of key tile 0;
* ``fwd_late_rows_5pct``, ``dkdv_late_keys_5pct``, ``dq_late_rows_5pct``
  — K1's o, K2's dv and K3's dq come out 5% small for rows (keys) from
  512 on: a mis-rescaled second half;
* ``fwd_pv_drops_last_k16_slice`` — K1's P V product leaves out the last
  16-key slice of every key tile (the wgmma k-loop one step short);
* ``dq_drops_last_k16_slice`` — K3's dQ += dS K leaves out the last 16-key
  slice of every key tile;
* ``dq_wrong_row_delta`` — K3 takes each row's delta from the row 8 away
  (the thread's other row).

K2 is the backward body B2 and K5 share (``csrc/flash_bwd_sm90.cuh``)
with its dQ product compiled out, so its mutants change that body and
are read through K2 (``flash_bwd_dkdv``, ``csrc/flash_bwd_split.cu``);
K3's change ``csrc/flash_dq_sm90.cuh``.  Mutants of the backward body
read through B2 (``flash_bwd``):

* ``bwd_dq_drops_last_k16_slice`` — the dQ = dS K product leaves out the
  last 16-key slice of each warpgroup's share (the wgmma k-loop one step
  short);
* ``bwd_qt0_one_tile_late`` — every CTA starts its query loop one 64-row
  tile late (producer and consumers alike, so the barriers still match);
* ``bwd_dv_skips_6pct_of_rows`` — P^T as dV's operand drops the last 4
  of every 64 query rows (6%; dK and dQ keep them).

The K2/K3 mutants are read through the split pair, the body's others
through B2.

Mutants of K3's 16-bit wide body (``csrc/flash_wide_sm90.cuh``, head
dims above 256), each read through ``flash_bwd_dq`` at head dims 288 and
1024 (``WIDE_SHAPES``) against the plain side of its own 64-key tile:

* ``dq_wide_drops_last_s_chunk`` — S = q' K^T leaves out the last
  head-dim chunk (one panel at 288, two at 1024) of every key tile;
* ``dq_wide_skip_key_tile`` — K3 zeroes p of the second-to-last key tile
  of each query tile;
* ``dq_wide_drops_last_k16_slice`` — dQ += dS K leaves out the last
  16-key slice of every key tile.

Beside the sound wide reading, the sound body's dq and the plain side's
are each read against ``dq_f64_scores`` (S and dP in float64), which
tells the kernel's own error from the plain side's float32 summation
order.

Mutants of the f32 bodies (``csrc/flash_wide_f32_sm90.cuh``, 3xTF32:
K1 and K2 at every head dim, K3 up to 256, B2 up to 128; built into
``flash_fwd``, ``flash_bwd_split``, ``flash_bwd`` and ``flash_wide``),
each read through ``flash_fwd`` (o, lse), ``flash_bwd_dkdv`` (dk, dv),
``flash_bwd_dq`` (dq) and ``flash_bwd`` (``b2_dq``, ``b2_dk``,
``b2_dv``) in float32 at ``F32_SHAPES`` (head dims 32 to 256) and
``WIDE_SHAPES`` (K1 and K2 alone) against the plain side of their own
key tiles, dq under its limit with its term:

* ``f32_plain_tf32`` — the lo half of every split is 0, so each product
  is hi.hi alone: one TF32 product (every body; K1's fourth product, P's
  hi against V's rest, then carries V's lo);
* ``f32_fwd_skip_key_tile`` — K1 masks out the second-to-last key tile
  of each query tile;
* ``f32_fwd_s_one_k8_short`` — K1's S = q' K^T leaves out the last k8
  slice of every head-dim chunk;
* ``f32_dkdv_dp_one_k8_short`` — K2's and B2's dP^T = V dO^T leaves out
  the last k8 slice of every head-dim chunk (its three products);
* ``f32_dkdv_dk_without_lo_hi`` — K2's and B2's dK += dS^T q' drops its
  lo.hi product;
* ``f32_bwd_ds_unmasked_on_diagonal`` — K2's and B2's dS^T keeps the keys
  past each query row on the tiles that straddle the diagonal (p, and
  so dV, stays masked);
* ``f32_b2_skip_key_tile`` — B2's CTAs of key tile 1 do nothing;
* ``f32_b2_dq_without_lo_hi`` — B2's dQ^T = K^T dS^T drops its lo.hi
  product;
* ``f32_dq_skip_key_tile`` — K3 zeroes dS of the second-to-last key tile
  of each query tile;
* ``f32_dq_dp_one_k8_short`` — K3's dP = dO V^T leaves out the last k8
  slice of every head-dim chunk;
* ``f32_dq_without_lo_hi`` — K3's dQ += dS K drops its lo.hi product;
* ``f32_dq_ds_unmasked_on_diagonal`` — K3's dS keeps the keys past each
  query row on the tiles that straddle the diagonal.

``--f32-first-rows`` reads dq at the causal first query rows in float32
(``f32_first_rows``): the float32 plain side, the f32 B2 and K3 and the
3xTF32 products emulated, each against a plain side whose products are
float64, under dq's limit with its term (``kernel_check``'s
``dq_noise``) and without it; it exits 1 unless the plain side and the
emulation read at most 0.5 of dq's limit on query rows 0-7.

Beside the plain-TF32 mutant's reading stands its prediction: the plain
side with every product hi.hi alone (``kernel_check.mm_3xtf32(...,
products=1)``, the split the bodies use), read against the same plain
side.

Mutants of the f32 ring kernels (the same header, K4 on ``fwd_tile`` and
K5 on ``dkdv_tile<NP, true>`` at a step's offsets; built into
``ring_flash`` alone), each read with ``--f32`` and without it on a ring
of 4 members of shard (4, 8, 1024, 64) in float32 (``ring_f32``: step 0,
every member on the diagonal, then step 1 rotating, member 0 wholly
masked and the others wholly visible; o, lse, dq, dk, dv, the slots bit
for bit, the flags balanced):

* ``f32_k4_k_offset_one_tile`` — K4 takes its k offset one 64-key tile
  late;
* ``f32_k5_q_offset_ignored`` — K5 masks as if its q offset were 0;
* ``f32_k5_dq_reduce_skipped`` — K5's second consumer warpgroup adds no
  dQ (its TMA reduces left out).

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
* ``k6_wrong_slot`` — K6 stores into the slot of member my + shift + 1
  (read: the rotated shards, bit for bit);
* ``k6_drops_last_piece`` — each K6 block leaves out the last bulk store
  of its share, one piece of at most 16 KB (read: the rotated shards, bit
  for bit).
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

import argparse
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
# Lines of the shared 16-bit forward body (K1, K4).
FWD_BODY = "flash_fwd_sm90.cuh"
KEY_END = "      const int key_end = sk - k0;\n"
FWD_INV = "const float inv = lt == 0.f ? 1.f : 1.f / lt;"
PV_LOOP = "for (int j = 0; j < PV_STEPS; ++j) {"
# Lines of the 16-bit backward body (B2, K5, and K2 without its dQ).
BWD_BODY = "flash_bwd_sm90.cuh"
DQ_LOOP = "for (int jj = 0; jj < JN; ++jj) {"
N_IT = "  const int n_it = max(0, n_qt - qt0);\n"
PT_PACK = ("              pack2<T>(s[4 * i + 2 * h], "
           "s[4 * i + 2 * h + 1]);\n")
BWD_P = "            float p = ex2(fmaf(s[e], scale_log2, -lse2));\n"
DV_PACK = "              pack2<T>(dv_acc[e], dv_acc[e + 1]);\n"
# Lines of K3's body.
DQ_BODY = "flash_dq_sm90.cuh"
DQ_P = "            float p = ex2(fmaf(s[e], scale_log2, -lse2[h]));\n"
DQ_STORE = ("            pack2<T>(dq_acc[4 * i + 2 * h] * dq_scale,\n"
            "                     dq_acc[4 * i + 2 * h + 1] * dq_scale);\n")
SPLIT = "flash_bwd_split"
# Lines of K3's 16-bit wide body.
WIDE_BODY = "flash_wide_sm90.cuh"
WIDE_CHUNK_LOOP = ("        if (panels - ch * CHUNK_PANELS < CHUNK_PANELS)\n"
                   "          issue_chunk(sa, ch == 0, One{});\n"
                   "        else\n"
                   "          issue_chunk(sa, ch == 0, Full{});\n"
                   "        pin(s);\n"
                   "        pin(dp);\n"
                   "        release(a_empty + 8 * st);\n"
                   "      }\n"
                   "      if (kt < n_plain)\n")
WIDE_P = "            float p = ex2(fmaf(s[e], scale_log2, -lse2[h]));\n"
# mutant: (source stem, file mutated, line, what replaces it, outputs held);
# the flash_bwd_split mutants (K2, K3) are held through the split pair.
MUTANTS = {
    "fwd_skip_key_tile": (
        "flash_fwd", FWD_BODY, KEY_END,
        KEY_END + "      if (kt == n_kt - 2)\n"
        "        for (float& x : s) x = NEG_INF;\n", ("o", "lse")),
    "dkdv_skips_last_query_tile": (
        SPLIT, BWD_BODY, N_IT,
        "  const int n_it = max(0, n_qt - qt0 - 1);\n", ("dk", "dv")),
    "dq_skip_key_tile": (
        SPLIT, DQ_BODY, DQ_P,
        DQ_P + "            if (kt == n_kt - 2) p = 0.f;\n", ("dq",)),
    "fwd_late_rows_skip_first_key_tile": (
        "flash_fwd", FWD_BODY, KEY_END,
        KEY_END + "      if (q0 >= 512 && kt == 0)\n"
        "        for (float& x : s) x = NEG_INF;\n", ("o", "lse")),
    "dkdv_late_keys_skip_next_query_tile": (
        SPLIT, BWD_BODY, BWD_P,
        BWD_P + "            if (k0 >= 512 && q0 == (qt0 + 1) * BWD_BM) "
        "p = 0.f;\n", ("dk", "dv")),
    "dq_late_rows_skip_first_key_tile": (
        SPLIT, DQ_BODY, DQ_P,
        DQ_P + "            if (q0 >= 512 && kt == 0) p = 0.f;\n", ("dq",)),
    "fwd_late_rows_5pct": (
        "flash_fwd", FWD_BODY, FWD_INV,
        "const float inv = (lt == 0.f ? 1.f : 1.f / lt) * "
        "(q0 >= 512 ? 0.95f : 1.f);", ("o",)),
    "dkdv_late_keys_5pct": (
        SPLIT, BWD_BODY, DV_PACK,
        "              pack2<T>(dv_acc[e] * (key >= 512 ? 0.95f : 1.f),\n"
        "                       dv_acc[e + 1] * (key >= 512 ? 0.95f : 1.f));"
        "\n", ("dv",)),
    "dq_late_rows_5pct": (
        SPLIT, DQ_BODY, DQ_STORE,
        "            pack2<T>(dq_acc[4 * i + 2 * h] * dq_scale *\n"
        "                         (row >= 512 ? 0.95f : 1.f),\n"
        "                     dq_acc[4 * i + 2 * h + 1] * dq_scale *\n"
        "                         (row >= 512 ? 0.95f : 1.f));\n", ("dq",)),
    "fwd_pv_drops_last_k16_slice": (
        "flash_fwd", FWD_BODY, PV_LOOP,
        "for (int j = 0; j < PV_STEPS - 1; ++j) {", ("o",)),
    "dq_drops_last_k16_slice": (
        SPLIT, DQ_BODY, "for (int j = 0; j < DQ_STEPS; ++j) {",
        "for (int j = 0; j < DQ_STEPS - 1; ++j) {", ("dq",)),
    "dq_wrong_row_delta": (
        SPLIT, DQ_BODY, "dp[e] = p * (dp[e] - dl[h]) * scale_r;",
        "dp[e] = p * (dp[e] - dl[1 - h]) * scale_r;", ("dq",)),
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


# K3 wide mutants: (file mutated, line, what replaces it), read as dq of
# flash_wide at WIDE_SHAPES.
WIDE_MUTANTS = {
    "dq_wide_drops_last_s_chunk": (
        WIDE_BODY, WIDE_CHUNK_LOOP,
        "        float keep[BN / 2];\n"
        "        for (int i = 0; i < BN / 2; ++i) keep[i] = s[i];\n"
        + WIDE_CHUNK_LOOP.replace(
            "        pin(s);\n",
            "        if (ch == n_ch - 1)\n"
            "          for (int i = 0; i < BN / 2; ++i) s[i] = keep[i];\n"
            "        pin(s);\n", 1)),
    "dq_wide_skip_key_tile": (
        WIDE_BODY, WIDE_P,
        WIDE_P + "            if (kt == n_kt - 2) p = 0.f;\n"),
    "dq_wide_drops_last_k16_slice": (
        WIDE_BODY, "for (int j = 0; j < DQ_STEPS; ++j)",
        "for (int j = 0; j < DQ_STEPS - 1; ++j)"),
}
WIDE_SHAPES = ((16, 1024, 288), (4, 1024, 1024))  # (bh, seq, head dim)
# The f32 bodies at and below 256: the main path's shape, head dims 32,
# 96, 128 (ragged) and 256 (two column CTAs).
F32_SHAPES = ((128, 1024, 64), (32, 1024, 32), (32, 1024, 96),
              (16, 1000, 128), (8, 1024, 256))
# dq's causal first query rows in float32 (--f32-first-rows): the main
# path's shape and head dim 128, (bh, seq, head dim).
FIRST_ROWS_SHAPES = ((128, 1024, 64), (32, 1024, 128))
# f32 mutants: (file mutated, line, what replaces it, outputs read, the
# largest head dim whose body it changes), built into every source that
# launches the bodies (F32_STEMS) and read in float32 at F32_SHAPES and
# WIDE_SHAPES (up to that head dim).
F32_BODY = "flash_wide_f32_sm90.cuh"
F32_STEMS = ("flash_fwd", "flash_bwd_split", "flash_bwd", "flash_wide")
F32_DP = ("        Wgmma<QB, float>::rs(dpc, vh[b], dh, kk != 0);\n"
          "        Wgmma<QB, float>::rs(dpc, vh[b], dl, 1);\n"
          "        Wgmma<QB, float>::rs(dpc, vl[b], dh, 1);\n")
F32_K3_DP = ("        Wgmma<BN, float>::rs(dpc, oh[b], vh, kk != 0);\n"
             "        Wgmma<BN, float>::rs(dpc, oh[b], vl, 1);\n"
             "        Wgmma<BN, float>::rs(dpc, ol[b], vh, 1);\n")
F32_BWD_MASK = (
    "            if constexpr (decltype(masked)::value) {\n"
    "              const int kr = k0 + r_lo + 8 * h;\n"
    "              if (kr >= sk || (causal && kr > q0 + qc)) p = 0.f;\n"
    "            }\n"
    "            dp[e] = p * (dp[e] - dl) * scale_r;\n")
F32_B2 = ("b2_dq", "b2_dk", "b2_dv")
F32_MUTANTS = {
    "f32_plain_tf32": (
        F32_BODY, "  lo = tf32(x - __uint_as_float(hi));\n", "  lo = 0u;\n",
        ("o", "dq", "dk", "dv") + F32_B2, None),
    "f32_fwd_skip_key_tile": (
        F32_BODY, "      if (kt < n_plain)\n        softmax(kt, Plain{});\n",
        "      if (kt == n_kt - 2)\n"
        "        for (float& x : s) x = NEG_INF;\n"
        "      if (kt < n_plain)\n        softmax(kt, Plain{});\n",
        ("o", "lse"), None),
    "f32_fwd_s_one_k8_short": (
        F32_BODY, "      for (int kk = 0; kk < 4; ++kk) {\n"
        "        load_a(gbase + off + L::A_Q,",
        "      for (int kk = 0; kk < 3; ++kk) {\n"
        "        load_a(gbase + off + L::A_Q,", ("o", "lse"), None),
    "f32_dkdv_dp_one_k8_short": (
        F32_BODY, F32_DP, "        if (kk < 3) {\n" + F32_DP + "        }\n",
        ("dk", "b2_dq", "b2_dk"), None),
    "f32_dkdv_dk_without_lo_hi": (
        F32_BODY, "          Wgmma<PW, float>::rs(pk, dal[j], qth, 1);\n",
        "", ("dk", "b2_dk"), None),
    "f32_bwd_ds_unmasked_on_diagonal": (
        F32_BODY, F32_BWD_MASK,
        "            dp[e] = p * (dp[e] - dl) * scale_r;\n"
        "            if constexpr (decltype(masked)::value) {\n"
        "              const int kr = k0 + r_lo + 8 * h;\n"
        "              if (kr >= sk || (causal && kr > q0 + qc)) p = 0.f;\n"
        "              if (kr >= sk) dp[e] = 0.f;\n"
        "            }\n", ("dk", "b2_dq", "b2_dk"), None),
    "f32_b2_skip_key_tile": (
        F32_BODY, "  const int kt = rest / n_cc;  // heavy (early) key tiles "
        "first\n  dkdv_tile<NP, true>(",
        "  const int kt = rest / n_cc;  // heavy (early) key tiles first\n"
        "  if (kt == 1) return;\n  dkdv_tile<NP, true>(", F32_B2, 128),
    "f32_b2_dq_without_lo_hi": (
        F32_BODY, "          Wgmma<F32_BWD_DQ_ROWS, float>::ss(dq_acc, ktl, "
        "dsh, 1);\n", "", ("b2_dq",), 128),
    "f32_dq_skip_key_tile": (
        F32_BODY, "      // K^T of the window, hi and lo, from the raw K "
        "window.\n",
        "      if (kt == n_kt - 2)\n"
        "        for (float& x : dp) x = 0.f;\n"
        "      // K^T of the window, hi and lo, from the raw K window.\n",
        ("dq",), 256),
    "f32_dq_dp_one_k8_short": (
        F32_BODY, F32_K3_DP,
        "        if (kk < 3) {\n" + F32_K3_DP + "        }\n", ("dq",), 256),
    "f32_dq_without_lo_hi": (
        F32_BODY, "          Wgmma<F32_PANEL, float>::rs(sc, dlo[j % 2], kth, "
        "1);\n", "", ("dq",), 256),
    "f32_dq_ds_unmasked_on_diagonal": (
        F32_BODY,
        "              if (key >= sk || (causal && key > row)) p = 0.f;\n",
        "              if (key >= sk) p = 0.f;\n", ("dq",), 256),
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
    "k6_drops_last_piece": (
        "ring_permute", "ring_permute.cu",
        "      bulk_store(out + (size_t)r * K6_HALF + p,",
        "      if (p + K6_PIECE < n || r + 1 < rounds)\n"
        "      bulk_store(out + (size_t)r * K6_HALF + p,", "k6"),
}
RING_SHARD = (4, 8, 1024, 64)
# Ring mutants of the f32 bodies K4 and K5 run (wide32::fwd_tile and
# dkdv_tile<NP, true> at a step's offsets): (file mutated, line, what
# replaces it), built into ring_flash alone and read as ``ring_f32``.
RING_F32_MUTANTS = {
    "f32_k4_k_offset_one_tile": (
        F32_BODY, "  using L = FwdSmem<NP>;\n",
        "  using L = FwdSmem<NP>;\n  k_off += F32_FWD_KEYS;\n"),
    "f32_k5_q_offset_ignored": (
        F32_BODY, "  using L = DkdvSmem<NP, WITH_DQ>;\n",
        "  using L = DkdvSmem<NP, WITH_DQ>;\n  q_off = 0;\n"),
    "f32_k5_dq_reduce_skipped": (
        F32_BODY, "        if (tid == 0) {\n"
        "          for (int p = cols.start - cols.w0;\n",
        "        if (tid == 0 && c == 0) {\n"
        "          for (int p = cols.start - cols.w0;\n"),
}


def ring_reading(kind):
    """The ring kernels as built now, read as ``kind`` says: ``ok`` is
    whether they pass (a sound build must, a mutant must not)."""
    from horovod_tpu_torch.ops import rdma
    from horovod_tpu_torch.ops import ring_flash as RF
    from horovod_tpu_torch.parallel import RingMesh

    mesh = RingMesh(4)  # loads (and prepares) the libraries now in place
    if kind == "ring_f32":
        return ring_f32_reading(mesh)
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


def ring_f32_reading(mesh):
    """K4 and K5 in float32 on a ring of 4 members of RING_SHARD: step 0
    (every member on the diagonal) without rotation, then step 1 (member 0
    wholly masked, the others wholly visible) rotating, each output's
    worst reading over the members under ``kernel_check``'s rule (dq with
    its term); ``ok`` also asks the slots bit-exact and the flags
    balanced."""
    members, _, scale_r = kernel_check.ring_inputs(4, RING_SHARD,
                                                   torch.float32, 4)
    rows = [dict(r, step=t) for t, rotate in ((0, False), (1, True))
            for r in kernel_check.hold_ring_round(mesh, members, t, scale_r,
                                                  rotate=rotate)]
    errs = {n: max((dict(r["errors"][n], step=r["step"]) for r in rows),
                   key=lambda e: e["worst"])
            for n in ("o", "lse", "dq", "dk", "dv")}
    exact = all(r.get("slot_exact", True) for r in rows)
    balanced = mesh.flags_balanced()
    return {"errors": errs, "slots_exact": exact, "flags_balanced": balanced,
            "ok": exact and balanced
            and all(e["worst"] <= 1.0 for e in errs.values())}


def loose_compare(got, want):
    """The replaced rule, scaled by the largest reference value."""
    err = (got.float() - want.float()).abs().max().item()
    return {"max_abs_err": err,
            "worst": err / (2e-2 * want.float().abs().max().item())}


def build_mutants(wide_only=False, f32=False):
    """``{mutant: {stem: path of its shared library}}``, nvcc runs in
    parallel."""
    jobs = []
    edits = {}
    if not f32:
        edits.update({name: (("flash_wide",), file, old, new)
                      for name, (file, old, new) in WIDE_MUTANTS.items()})
    if not wide_only:
        edits.update({name: (F32_STEMS, file, old, new)
                      for name, (file, old, new, _, _) in
                      F32_MUTANTS.items()})
        edits.update({name: (("ring_flash",), file, old, new)
                      for name, (file, old, new) in
                      RING_F32_MUTANTS.items()})
    if not (wide_only or f32):
        edits.update({name: ((stem,), file, old, new)
                      for name, (stem, file, old, new, _)
                      in MUTANTS.items()})
        edits.update({name: ((stem,), file, old, new)
                      for name, (stem, file, old, new, _)
                      in RING_MUTANTS.items()})
    for name, (stems, file, old, new) in edits.items():
        d = os.path.join(_build.BUILD_DIR, "control", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        path = os.path.join(d, file)
        text = open(path).read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: line not found once in {file}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
        for stem in stems:
            jobs.append((name, stem, os.path.join(d, f"{stem}.cu"),
                         os.path.join(d, f"{stem}.so")))
    # At most one nvcc a core at a time: there are dozens of builds.
    paths, running = {}, []

    def reap(proc, name, stem, out):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} ({stem}):\n{log}")
        paths.setdefault(name, {})[stem] = out

    for name, stem, src, out in jobs:
        if len(running) >= (os.cpu_count() or 8):
            reap(*running.pop(0))
        running.append((subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            name, stem, out))
    for job in running:
        reap(*job)
    return paths


def reading(got, ref, names):
    return {n: {"strict": kernel_check.compare(got[n], ref[n],
                                               noise=ref.get(n + "_noise")),
                "loose": loose_compare(got[n], ref[n])} for n in names}


def dq_f64_scores(qr, k, v, do, lse, delta, scale_r, p2, tile):
    """Causal dq with S = q' k^T and dP = dO v^T in float64, ds rounded to
    the storage dtype and dq summed in float64 over ``tile``-key blocks:
    the plain side without float32's summation order, so that a reading
    against it tells the kernel's own error from the plain side's."""
    dq = torch.zeros(qr.shape, dtype=torch.float64, device=qr.device)
    q64, do64 = qr.double(), do.double()
    rows = torch.arange(qr.shape[1], device=qr.device)[:, None]
    for k0 in range(0, k.shape[1], tile):
        kb, vb = k[:, k0:k0 + tile].double(), v[:, k0:k0 + tile].double()
        s = q64 @ kb.transpose(-1, -2) * scale_r
        keys = torch.arange(k0, k0 + kb.shape[1], device=qr.device)[None]
        p = torch.where(keys <= rows, torch.exp(s - lse.double()[..., None]),
                        0.0)
        dp = do64 @ vb.transpose(-1, -2)
        ds = p * (dp - delta.double()[..., None]) * scale_r
        dq = dq + ds.to(qr.dtype).double() @ kb
    return (dq * p2).to(qr.dtype)


def wide_readings(paths):
    """The sound K3 wide body and each of its mutants, as dq against the
    plain side of the split mode at each of WIDE_SHAPES, bf16 and fp16,
    and the sound body's and the plain side's dq against
    :func:`dq_f64_scores`: ``({reading: {shape: ...}}, ok)``."""
    sound = _build.load("flash_wide")
    rows, ok = {}, True
    for dtype in (torch.bfloat16, torch.float16):
        for bh, s, d in WIDE_SHAPES:
            g = torch.Generator(device="cuda").manual_seed(s + d)
            q, k, v, do = (torch.randn(bh, s, d, device="cuda", generator=g)
                           .to(dtype) for _ in range(4))
            p2, scale_r = A._split_scale(d ** -0.5)
            qr = (q * p2).to(dtype)
            ref, delta = kernel_check.plain_outputs(qr, k, v, do, True,
                                                    scale_r, p2, "split")
            args = (qr, k, v, do, ref["lse"], delta, scale_r)
            tag = f"{dtype}_{bh}x{s}x{d}"
            got = {"dq": A.flash_bwd_dq(*args, p2, True)}
            rows.setdefault("sound_wide", {})[tag] = reading(
                got, ref, ["dq"])
            exact = dq_f64_scores(qr, k, v, do, ref["lse"], delta, scale_r,
                                  p2, A.bwd_key_tile("split", dtype, d))
            rows["sound_wide"][tag]["dq"]["vs_f64_scores"] = \
                kernel_check.compare(got["dq"], exact)
            rows.setdefault("plain_vs_f64_scores", {})[tag] = \
                kernel_check.compare(ref["dq"], exact)
            ok &= rows["sound_wide"][tag]["dq"]["strict"]["worst"] <= 1.0
            for name in WIDE_MUTANTS:
                _build._libs["flash_wide"] = ctypes.CDLL(
                    paths[name]["flash_wide"])
                try:
                    got = {"dq": A.flash_bwd_dq(*args, p2, True)}
                finally:
                    _build._libs["flash_wide"] = sound
                rows.setdefault(name, {})[tag] = reading(got, ref, ["dq"])
                ok &= rows[name][tag]["dq"]["strict"]["worst"] > 1.0
            del q, k, v, do, qr, ref, delta, args, got
    return rows, ok


def f32_outputs(qr, k, v, do, lse, delta, p2, scale_r):
    """``{o, lse, dk, dv}`` of K1 and K2, and up to head dim 256 ``dq`` of
    K3 and up to 128 ``b2_dq``, ``b2_dk``, ``b2_dv`` of B2 (the libraries
    as loaded now)."""
    d = qr.shape[-1]
    o, lse_k = A.flash_fwd(qr, k, v, scale_r, True)
    dk, dv = A.flash_bwd_dkdv(qr, k, v, do, lse, delta, scale_r, True)
    out = {"o": o, "lse": lse_k, "dk": dk, "dv": dv}
    if d <= A.WIDE_HEAD_DIM:
        out["dq"] = A.flash_bwd_dq(qr, k, v, do, lse, delta, scale_r, p2,
                                   True)
    if d <= A.HEAD_DIMS[-1]:
        b2 = kernel_check.kernel_bwd_outputs(qr, k, v, do, lse, delta, p2,
                                             scale_r, True)
        out.update({f"b2_{n}": t for n, t in b2.items()})
    return out


def f32_readings(paths):
    """The sound f32 bodies and each of their mutants against the plain
    side of their own key tiles at each of F32_SHAPES and WIDE_SHAPES, in
    float32 (B2's outputs ``b2_*`` against the combined mode's, dq with
    its term), and the plain side with one TF32 product per product (the
    prediction for ``f32_plain_tf32``): ``({reading: {shape: ...}},
    ok)``."""
    sound = {stem: _build.load(stem) for stem in F32_STEMS}
    rows, ok = {}, True
    for bh, s, d in F32_SHAPES + WIDE_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(s + d)
        q, k, v, do = (torch.randn(bh, s, d, device="cuda", generator=g)
                       for _ in range(4))
        p2, scale_r = A._split_scale(d ** -0.5)
        qr = q * p2
        ref, delta = kernel_check.plain_outputs(qr, k, v, do, True, scale_r,
                                                p2, "split")
        args = (qr, k, v, do, ref["lse"], delta, p2, scale_r)
        if d <= A.HEAD_DIMS[-1]:
            b2 = kernel_check.plain_bwd_outputs(qr, k, v, do, ref["lse"],
                                                delta, p2, scale_r, True)
            ref.update({f"b2_{n}": t for n, t in b2.items()})
        tag = f"float32_{bh}x{s}x{d}"
        got = f32_outputs(*args)
        rows.setdefault("sound_f32", {})[tag] = reading(got, ref, list(got))
        ok &= all(r["strict"]["worst"] <= 1.0
                  for r in rows["sound_f32"][tag].values())
        mm = A._mm
        A._mm = lambda a, b: kernel_check.mm_3xtf32(a, b, products=1)
        try:
            one, _ = kernel_check.plain_outputs(qr, k, v, do, True, scale_r,
                                                p2, "split")
        finally:
            A._mm = mm
        rows.setdefault("predicted_plain_tf32", {})[tag] = \
            kernel_check.compare_outputs(
                {n: one[n] for n in ("o", "lse", "dq", "dk", "dv")}, ref)
        for name, (_, _, _, outs, max_d) in F32_MUTANTS.items():
            outs = [n for n in outs if n in got]
            if (max_d is not None and d > max_d) or not outs:
                continue
            _build._libs.update({stem: ctypes.CDLL(path)
                                 for stem, path in paths[name].items()})
            try:
                mutant = f32_outputs(*args)
            finally:
                _build._libs.update(sound)
            rows.setdefault(name, {})[tag] = reading(mutant, ref, outs)
            ok &= any(r["strict"]["worst"] > 1.0
                      for r in rows[name][tag].values())
        del q, k, v, do, qr, ref, delta, args, got
    return rows, ok


def ring_f32_readings(paths):
    """The sound f32 ring kernels and each of RING_F32_MUTANTS, read as
    :func:`ring_f32_reading`: ``({reading: ...}, ok)``, ok when the sound
    reading passes and every mutant fails."""
    rows = {"sound_ring_f32": ring_reading("ring_f32")}
    ok = rows["sound_ring_f32"]["ok"]
    sound = _build.load("ring_flash")
    for name in RING_F32_MUTANTS:
        _build._libs["ring_flash"] = ctypes.CDLL(paths[name]["ring_flash"])
        try:
            rows[name] = ring_reading("ring_f32")
        finally:
            _build._libs["ring_flash"] = sound
        ok &= not rows[name]["ok"]
    return rows, ok


def mm_6xtf32(a, b):
    """``a @ b`` from six TF32 products of the three-way split
    (:func:`kernel_check.tf32_split3`: hi.hi, hi.mid, mid.hi, hi.lo,
    mid.mid, lo.hi), summed in float32."""
    ah, am, al = kernel_check.tf32_split3(a)
    bh, bm, bl = kernel_check.tf32_split3(b)
    mm = torch.matmul
    return (mm(ah, bh) + (mm(ah, bm) + mm(am, bh))
            + (mm(ah, bl) + mm(am, bm) + mm(al, bh)))


def _plain_bwd_with(mm, args, dp_mm=None, **kw):
    """The combined mode's plain backward (``{dq, dk, dv}``) with every
    product by ``mm`` and, if given, dP = dO V^T by ``dp_mm``."""
    do = args[3]
    saved = A._mm
    A._mm = (mm if dp_mm is None else
             lambda a, b: dp_mm(a, b) if a is do else mm(a, b))
    try:
        if kw:
            qr, k, v, do, lse, delta, p2, scale_r, causal = args
            dq, dk, dv = A._attention_bwd_impl(
                qr, k, v, lse, delta, do, causal, scale_r,
                block_size=A.bwd_key_tile("combined", qr.dtype,
                                          qr.shape[-1]),
                dq_scale=p2, **kw)
            return {"dq": dq, "dk": dk, "dv": dv}
        return kernel_check.plain_bwd_outputs(*args)
    finally:
        A._mm = saved


def f32_first_rows():
    """dq at the causal first query rows in float32, read apart for rows
    0-7 and the rest: the float32 plain side, the f32 B2 and K3 as built
    (``kernel_b2``, ``kernel_k3``; dq alone for K3) and the 3xTF32 body
    emulated (every product hi.hi + hi.lo + lo.hi; and with dP from six
    products of a three-way split), each against a plain side whose
    products are float64 (same lse and delta) and against the float32
    plain side, the one the rule holds the kernels against.  dq's
    reading gives ``worst`` under the limit without its term and
    ``worst_new`` under dq's limit (``kernel_check``'s ``dq_noise``, from
    the float32 plain side).  ``(readings, ok)``: ok when the float32
    plain side and the emulation read at most 0.5 of dq's limit on rows
    0-7 at every shape."""
    out, ok = {}, True
    for bh, s, d in FIRST_ROWS_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn(bh, s, d, device="cuda", generator=g)
                       for _ in range(4))
        p2, scale_r = A._split_scale(d ** -0.5)
        qr = q * p2
        ref, delta = kernel_check.plain_outputs(qr, k, v, do, True, scale_r,
                                                p2)
        args = (qr, k, v, do, ref["lse"], delta, p2, scale_r, True)
        f64 = _plain_bwd_with(
            lambda a, b: torch.matmul(a.double(), b.double()), args,
            round_pds=False, grad_dtype=torch.float64)
        # Rounded to float32 at the end, so the rule's rtol is float32's.
        f64 = {n: t.float() for n, t in f64.items()}
        sides = {
            "f32_plain": {n: ref[n] for n in ("dq", "dk", "dv")},
            "kernel_b2": kernel_check.kernel_bwd_outputs(*args),
            "kernel_k3": {"dq": kernel_check.kernel_bwd_outputs(
                *args, "split")["dq"]},
            "emulated_3xtf32": _plain_bwd_with(kernel_check.mm_3xtf32, args),
            "emulated_3xtf32_dp6": _plain_bwd_with(kernel_check.mm_3xtf32,
                                                   args, dp_mm=mm_6xtf32),
        }
        tag = f"float32_{bh}x{s}x{d}"
        out[tag] = {}

        def first(got, want, n):
            return kernel_check.compare_first_rows(
                got, want, noise=ref["dq_noise"] if n == "dq" else None)
        for name, got in sides.items():
            got = {n: t for n, t in got.items() if n != "dq_noise"}
            row = {"vs_f64": {n: first(got[n], f64[n], n) for n in got}}
            if name != "f32_plain":
                row["vs_f32_plain"] = {n: first(got[n], ref[n], n)
                                       for n in got}
            out[tag][name] = row
            if name in ("f32_plain", "emulated_3xtf32"):
                ok &= row["vs_f64"]["dq"]["rows_0_7"]["worst_new"] <= 0.5
        del q, k, v, do, qr, ref, delta, args, f64, sides
    return out, ok


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--wide-only", action="store_true",
                    help="only K3's 16-bit wide body and its mutants")
    ap.add_argument("--f32", action="store_true",
                    help="only the f32 bodies (K1-K3, B2; K4 and K5 on "
                         "a ring) and their mutants")
    ap.add_argument("--f32-first-rows", action="store_true",
                    help="only dq's causal first query rows in float32: "
                         "the plain side, the f32 B2 and K3 and the "
                         "3xTF32 emulation against float64 products")
    args = ap.parse_args()
    wide_only, f32_only = args.wide_only, args.f32
    if not torch.cuda.is_available():
        sys.exit("torch_kernel_control: no CUDA device")
    _build.build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    if args.f32_first_rows:
        first, ok = f32_first_rows()
        print(json.dumps({"nvidia_smi": smi, "causal": True, "ok": ok,
                          "shapes": [list(x) for x in FIRST_ROWS_SHAPES],
                          "first_rows": first}), flush=True)
        sys.exit(0 if ok else 1)
    paths = build_mutants(wide_only, f32_only)
    if not wide_only:
        ring_f32, ring_ok = ring_f32_readings(paths)
    if f32_only:
        f32, ok = f32_readings(paths)
        print(json.dumps({"nvidia_smi": smi, "causal": True,
                          "ok": ok and ring_ok,
                          "f32_shapes": [list(x) for x in F32_SHAPES],
                          "wide_shapes": [list(x) for x in WIDE_SHAPES],
                          "f32_readings": f32,
                          "ring_shard": list(RING_SHARD),
                          "ring_f32_readings": ring_f32}), flush=True)
        sys.exit(0 if ok and ring_ok else 1)
    wide, ok = wide_readings(paths)
    if wide_only:
        print(json.dumps({"nvidia_smi": smi, "causal": True, "ok": ok,
                          "wide_shapes": [list(x) for x in WIDE_SHAPES],
                          "wide_readings": wide}), flush=True)
        sys.exit(0 if ok else 1)
    f32, f32_ok = f32_readings(paths)
    ok &= f32_ok and ring_ok
    sound = {stem: _build.load(stem)
             for stem in ("flash_fwd", "flash_bwd", SPLIT)}
    result = {}
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
        for name, (stem, _, _, _, names) in MUTANTS.items():
            mode = "split" if stem == SPLIT else "combined"
            _build._libs[stem] = ctypes.CDLL(paths[name][stem])
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
        _build._libs[stem] = ctypes.CDLL(paths[name][stem])
        try:
            ring[name] = ring_reading(kind)
        finally:
            _build._libs[stem] = sound_lib
        ok &= not ring[name]["ok"]
    print(json.dumps({"nvidia_smi": smi, "shape": list(SHAPE),
                      "causal": True, "ok": ok, "readings": result,
                      "ring_shard": list(RING_SHARD), "ring_readings": ring,
                      "wide_shapes": [list(x) for x in WIDE_SHAPES],
                      "wide_readings": wide,
                      "f32_readings": f32,
                      "ring_f32_readings": ring_f32}), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
