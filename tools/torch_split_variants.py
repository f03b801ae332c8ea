"""Design choices of kernel families, timed on the GPU: the split
backward pair (K2, K3) at head dim 64, K1 and K2 at head dim 256 in 16
bits, the 16-bit wide bodies of K1, K2 and K3 (head dims above 256), and
the f32 bodies.

Run from the repository root on a machine with one CUDA GPU::

    python3 tools/torch_split_variants.py                 # the split pair
    python3 tools/torch_split_variants.py --family d256   # K1, K2 at 256
    python3 tools/torch_split_variants.py --family wide   # K1-K3 above 256
    python3 tools/torch_split_variants.py --family wide_f32  # K1-K3 f32
    python3 tools/torch_split_variants.py --family f32   # the same, <= 256
    python3 tools/torch_split_variants.py --family b2    # B2's levers
    python3 tools/torch_split_variants.py --family wide \
        --only one_release_per_warpgroup   # a subset of the variants
    python3 tools/torch_split_variants.py --family d256 --only \
        --parent proof/parent --dtype float16  # against a parent checkout

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

``d256`` (K1 in ``csrc/flash_fwd_sm90.cuh``, K2's ``dkdv256_tile`` in
``csrc/flash_bwd_sm90.cuh``, K3's ``dq256_tile`` in
``csrc/flash_dq_sm90.cuh``; built into ``flash_fwd`` and
``flash_bwd_split``):

* ``fwd256_80_keys`` — K1 takes 80-key tiles instead of ``FWD256_KEYS``
  (S in 40 registers and P in 20, one fifth fewer trips through the
  online softmax; Q + 2 stages of K and V 64 + 160 KB; the plain side
  then walks 80 keys; the variant's copy of ``wgmma_sm90.cuh`` gains
  ``Wgmma<80, T>::ss``, which ``tools/torch_gen_wgmma.py`` does not
  generate);
* ``one_release_per_warpgroup`` — K1 and K2 at 256 release a stage by
  one thread per consumer warpgroup (the empty barriers counting 2)
  instead of by each consumer warp's lane 0 after its own wgmma wait;
* ``producer_warpgroup``, ``producer_warpgroup_240`` — K1 at 256 on 384
  threads, a producer warpgroup loading and the consumers raising their
  registers by ``setmaxnreg`` to ``CONSUMER_REGS`` (232), or to 240 with
  the producer at 24, instead of the two consumer warpgroups alone
  loading (``FOLD``): ptxas's registers and spills of the two show
  whether it allocates what ``setmaxnreg`` asks;
* ``head_fastest``, ``heads_together`` — K1's and K2's CTAs at 256 with
  the head fastest (heavy tiles of every head first), or each head's
  tiles adjacent, at every grid size, instead of by the grid's size
  (``tile_order``, ``HEADS_TOGETHER_MIN_CTAS``);
* ``dq_heads_together``, ``dq_head_fastest`` — K3's CTAs at 256 (its
  ``dq256_tile``, in ``csrc/flash_dq_sm90.cuh``) with each head's tiles
  adjacent, or the head fastest, at every grid size (K3 alone; K1 and K2
  keep ``tile_order``);
* ``dq256_64_rows`` — K3 at 256 in K2's layout instead of K1's: 64 query
  rows a CTA, each consumer warpgroup S^T and dP^T of 32 of them against
  64-key tiles, dS^T stored to shared memory behind one named barrier a
  tile, and dQ's 128 columns of the warpgroup from it
  (``tools/torch_split_variants_dq256_64_rows.cuh``; the variant's copy
  of ``wgmma_sm90.cuh`` gains ``Wgmma<128, T>::ss_t``; the plain side's
  dq then walks 64 keys);
* ``dq256_3_stages`` — K3 at 256 streams K and V through three stages
  instead of ``DQ256_STAGES`` (q' + dO + 3 stages, 224 KB).

``b2`` (B2's 16-bit body, ``csrc/flash_b2_sm90.cuh``, launched from
``csrc/flash_bwd.cu``; built into ``flash_bwd``): its four levers, each
taken alone and combined, against the checked-in body that combines
them.  The parent's body is B2's earlier one, ``bwd_ktile`` of
``csrc/flash_bwd_sm90.cuh``, which K5 and K2 keep: 384 threads, a
producer warpgroup, one dQ buffer per warpgroup, no pipelining, the head
fastest.

* ``parent_body`` — that body as the parent launched it (every lever
  off);
* ``grid_order_alone`` — that body in ``sm90::tile_order``;
* ``cta256_alone`` — the 256-thread CTA of the two consumer warpgroups
  that also load, unpipelined, one dQ buffer, the head fastest;
* ``cta256_pipelined`` — the same, software-pipelined (at head dims 32
  and 64, ``b2_pipelined``);
* ``cta256_two_dq_buffers`` — the same, two dQ buffers a warpgroup;
* ``head_fastest``, ``unpipelined``, ``one_dq_buffer`` — the checked-in
  body without one lever each;
* ``pipelined_everywhere`` — pipelined at head dims 96 and 128 too, which
  shows ptxas's registers and spills of the pipelined form there.

Each build is held against the plain side of the combined mode's key
tile (128 keys); at each shape SDPA's whole backward is timed under its
cuDNN and flash backends before and after the turns (``sdpa_bwd_ms``).

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
  stages instead of ``DQ_STAGES``;
* ``one_release_per_warpgroup`` — a stage is released by one thread per
  consumer warpgroup (the empty barriers counting 2) instead of by each
  consumer warp's lane 0 after its own wgmma wait (``EMPTY_ARRIVALS``,
  ``release``): the earlier rule, under which a stage could be refilled
  while another warp of the warpgroup still read it.

``wide_f32`` (``csrc/flash_wide_f32_sm90.cuh``, 3xTF32, float32 inputs;
K1, K2 and K3):

* ``dq_recompute`` — K3's column CTAs are separate CTAs that each sum S
  and dP over the whole head dim (``F32_DQ_CLUSTER_MAX`` 1, so every
  head dim above 256 takes ``launch_dq``'s body) instead of one thread
  block cluster per query tile whose CTAs each sum them over their own
  panels and add the partials through distributed shared memory;
* ``dq_exchange_reduce_scatter`` — K3's cluster CTAs exchange their
  partial S and dP as a reduce-scatter (each CTA sums its share of the
  pairs over the cluster, in place) and an all-gather of the sums,
  behind one more cluster barrier: 2 (n_cc - 1) / n_cc buffers of 32 KB
  read from the peers a key tile instead of n_cc - 1, each CTA reading
  every peer's whole partials;

* ``fwd_one_chain``, ``dkdv_one_chain`` — K1's S (K2's S^T and dP^T) is
  chained through one wgmma accumulator over the whole head dim (3 d / 8
  steps) instead of summed per 32-column chunk in f32 registers: 32
  fewer registers a thread, and the tensor cores' truncating accumulation
  drifts with the chain's length;
* ``fwd_pv_chained_over_keys``, ``dkdv_chained_over_queries`` — K1's O
  (K2's dV and dK) chained through one accumulator over the whole key
  (query) loop instead of each tile's (step's) product summed in a fresh
  accumulator, 32 or 64 columns at a time, and added in f32 registers:
  the truncating accumulation reads above 1 at seq 8192;
* ``fwd_2_stages`` — K1 streams two chunk stages instead of
  ``F32_FWD_STAGES`` (K2's two are fixed: its note says why).

``f32`` (the same header, the bodies at head dims 32-256: K1, K2, K3
and B2, built into ``flash_fwd``, ``flash_bwd_split`` and
``flash_bwd``): ``fwd_one_chain``, ``dkdv_one_chain`` (K2's and B2's
shared sums), ``fwd_pv_chained_over_keys``, ``dkdv_chained_over_queries``
(B2's too), ``fwd_2_stages`` as above, and

* ``fwd_three_pv_products`` — K1's P V without its fourth product (P's
  hi against V's rest): what o = v exactly where p = 1 costs;
* ``dq_one_chain`` — K3's S and dP chained through one accumulator each
  over the whole head dim instead of summed per 32-column chunk (32
  fewer registers a thread);
* ``dq_2_stages`` — K3 streams two (q', dO, K, V) chunk stages instead
  of ``F32_DQ_STAGES``;
* ``fwd_pv_one_panel`` — K1's fresh P V accumulators 32 columns wide at
  every head dim instead of 64 where the window allows (half the
  registers, twice the parts);
* ``dkdv_parts_of_16`` — K2's (B2's) fresh dV / dK accumulators 16
  columns wide instead of up to 32;
* ``fwd_32_keys`` — K1 takes 32-key tiles instead of ``F32_FWD_KEYS``
  (P in half the registers, so no spill beside the fresh accumulator;
  the plain side keeps its 64-key forward tile);
* ``dq_chained_over_keys`` — K3's dQ += dS K chained through one
  accumulator over the whole key loop instead of each key tile's product
  summed per 32-column panel in a fresh accumulator and added in f32
  registers (3 s / 8 wgmma steps against 12: the truncating accumulation
  shows at long sequences, ``--shapes 8x8192x64``).

Every build is held against the plain side that walks its own key tile
(``kernel_check``; ``worst`` <= 1 passes), then the family's kernels are
timed with the checked-in build and each variant in turns (checked-in,
variant, variant, checked-in, twice) at the family's shapes (bf16;
``wide_f32`` float32; ``--dtype`` in their place; causal), by CUDA
events, median of 15 after
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
from tools import torch_gen_wgmma as gen_wgmma  # noqa: E402

SLEEP_CYCLES = 2_000_000  # ≈1 ms at the H100's clock
WH = "flash_wide_sm90.cuh"
# family: stem (or stems: every source that launches the family's
# bodies), shapes (bh, s, d), the namespace whose kernels' ptxas lines are
# printed (or None), and variant: ([(file, line, replacement)],
# the key tiles the plain side walks where they change: (forward, dq), None
# for the checked-in tile).
FF, FB, SC = "flash_fwd_sm90.cuh", "flash_bwd_sm90.cuh", "sm90_common.cuh"
# Wgmma<80, T>::ss, which no checked-in kernel uses, added to the
# variant's copy of the generated header for K1's 80-key tiles.
_SS80 = ("wgmma_sm90.cuh", gen_wgmma.TAIL, "".join(
    f"\ntemplate <>\nstruct Wgmma<80, {ctype}> {{"
    f"{gen_wgmma.ss(80, ptx)}\n}};\n"
    for ctype, ptx in gen_wgmma.TYPES) + gen_wgmma.TAIL)
# K1 at 256 on 384 threads: a producer warpgroup and the consumers'
# setmaxnreg, as at head dims up to 128.
_PRODUCER_WG = [(FF, "  constexpr bool FOLD = D == 256;  // no producer warpgroup",
                 "  constexpr bool FOLD = false;"),
                (FF, "  return D == 256 ? 256 : NTHREADS;",
                 "  return NTHREADS;")]
SPLIT_CU, DQ = "flash_bwd_split.cu", "flash_dq_sm90.cuh"
# K3's grid order at head dim 256 (sm90::tile_order, by the grid's size).
_DQ256_ORDER = "sm90::tile_order(blockIdx.x, bh_total, n_qt);"
# K3 at 256 in K2's layout (64 query rows a CTA, 64-key tiles, dS^T shared
# through shared memory, each warpgroup 128 columns of dQ from it): the
# body in tools/torch_split_variants_dq256_64_rows.cuh, inserted into the
# copy of flash_dq_sm90.cuh and launched in place of dq256_tile, and the
# Wgmma<128, T>::ss_t it takes (dS^T and K both MN-major), which
# tools/torch_gen_wgmma.py does not generate, added to the copy of
# wgmma_sm90.cuh.
with open(os.path.join(ROOT, "tools",
                       "torch_split_variants_dq256_64_rows.cuh")) as _f:
    _DQ256_64_ROWS_BODY = _f.read()
_DQ_MAPS = ("// The four maps of one launch: q' and dO in boxes of "
            "dq_rows<D>() rows, k\n")
_DQ256_64_ROWS = [
    (DQ, "  return D == 256 ? DQ256_ROWS : DQ_BM;",
     "  return D == 256 ? 64 : DQ_BM;"),
    (DQ, "  return D == 256 ? DQ256_KEYS : 64;", "  return 64;"),
    (DQ, _DQ_MAPS, _DQ256_64_ROWS_BODY + _DQ_MAPS),
    (SPLIT_CU, "    sm90::dq256_tile<T>(", "    sm90::dq256_rows64_tile<T>("),
    (SPLIT_CU, "    return sm90::Dq256Smem::bytes;",
     "    return sm90::Dq256Rows64Smem::bytes;")] + [
    ("wgmma_sm90.cuh", gen_wgmma.ss_tb(128, ptx),
     gen_wgmma.ss_tb(128, ptx) + gen_wgmma.ss_t(128, ptx))
    for _, ptx in gen_wgmma.TYPES]
FAMILIES = {
    "d256": {
        "stem": ("flash_fwd", "flash_bwd_split"), "ptxas": "Li256E",
        "shapes": ((1040, 512, 256), (32, 1024, 256)),
        "variants": {
            "fwd256_80_keys": ([(FF, "constexpr int FWD256_KEYS = 64;",
                                 "constexpr int FWD256_KEYS = 80;"),
                                _SS80], (80, None)),
            "one_release_per_warpgroup": ([
                (FF, "  constexpr int EMPTY_ARRIVALS = FOLD ? 8 : 2;",
                 "  constexpr int EMPTY_ARRIVALS = 2;"),
                (FF, "      mbar_arrive_if(bar, FOLD ? lane == 0 : "
                 "tid == 0);", "      mbar_arrive_if(bar, tid == 0);"),
                (FB, "constexpr int DKDV256_EMPTY = 8;",
                 "constexpr int DKDV256_EMPTY = 2;"),
                (FB, "  auto release = [&](uint32_t bar) { "
                 "mbar_arrive_if(bar, lane == 0); };",
                 "  auto release = [&](uint32_t bar) { "
                 "mbar_arrive_if(bar, tid == 0); };")], None),
            "producer_warpgroup": (_PRODUCER_WG, None),
            "producer_warpgroup_240": (_PRODUCER_WG + [
                (SC, "constexpr int PRODUCER_REGS = 40;",
                 "constexpr int PRODUCER_REGS = 24;"),
                (SC, "constexpr int CONSUMER_REGS = 232;",
                 "constexpr int CONSUMER_REGS = 240;")], None),
            "head_fastest": ([(SC, "constexpr int HEADS_TOGETHER_MIN_CTAS "
                               "= 768;", "constexpr int "
                               "HEADS_TOGETHER_MIN_CTAS = 1 << 30;")], None),
            "heads_together": ([(SC, "constexpr int HEADS_TOGETHER_MIN_CTAS "
                                 "= 768;", "constexpr int "
                                 "HEADS_TOGETHER_MIN_CTAS = 0;")], None),
            "dq_heads_together": ([(SPLIT_CU, _DQ256_ORDER,
                                    "make_int2(blockIdx.x / n_qt, "
                                    "blockIdx.x % n_qt);")], None),
            "dq_head_fastest": ([(SPLIT_CU, _DQ256_ORDER,
                                  "make_int2(blockIdx.x % bh_total, "
                                  "blockIdx.x / bh_total);")], None),
            "dq256_64_rows": (_DQ256_64_ROWS, (None, 64)),
            "dq256_3_stages": ([(DQ, "constexpr int DQ256_STAGES = 2;",
                                 "constexpr int DQ256_STAGES = 3;")], None),
        }},
    "split": {
        "stem": "flash_bwd_split", "ptxas": None,
        "shapes": ((1040, 512, 64), (64, 8192, 64), (32, 16384, 64)),
        "variants": {
            "k2_two_stages": ([("flash_bwd_sm90.cuh",
                                "constexpr int DKDV_STAGES = 3;",
                                "constexpr int DKDV_STAGES = 2;")], None),
            "k3_128_keys": ([(DQ, "  return D == 256 ? DQ256_KEYS : 64;\n",
                              "  return D == 256 ? DQ256_KEYS : D <= 64 ? "
                              "128 : 64;\n")], (None, 128)),
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
            "one_release_per_warpgroup": ([
                (WH, "constexpr int EMPTY_ARRIVALS = 8;",
                 "constexpr int EMPTY_ARRIVALS = 2;"),
                (WH, "  mbar_arrive_if(bar, threadIdx.x % 32 == 0);\n",
                 "  mbar_arrive_if(bar, threadIdx.x % 128 == 0);\n")],
                None),
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
# K1's O += P V and K2's dV, dK +=: each tile's (step's) product in a
# fresh accumulator added in f32 registers (checked in), or chained
# through one accumulator over the whole key (query) loop.
_K1_PV = (
    '      constexpr int PW = CW % 64 == 0 ? 64 : F32_PANEL;\n'
    '      float(&pv)[PW / 2] = lead<PW / 2>(sc);\n'
    '      uint32_t ph[2][4], pl[2][4];\n'
    '#pragma unroll\n'
    '      for (int p = 0; p < CW / PW; ++p) {\n'
    '        // Split again (tf32() is a plain asm, which the compiler would\n'
    '        // otherwise keep for every slice across the parts: spills).\n'
    '        if (p > 0) pin(s);\n'
    '#pragma unroll\n'
    '        for (int j = 0; j < BN / 8; ++j) {\n'
    '          split_acc(s, j, ph[j % 2], pl[j % 2]);\n'
    '          const uint32_t kp =\n'
    '              p * PW * ROW_BYTES + (j / 4) * L::VT_PANEL + (j % 4) * 32;\n'
    '          const uint64_t vh = desc128(base + L::vt_hi + kp);\n'
    '          const uint64_t vl = desc128(base + L::vt_lo + kp);\n'
    '          const uint64_t vl2 = desc128(base + L::vt_lo2 + kp);\n'
    '          wg_fence();\n'
    '          Wgmma<PW, float>::rs(pv, ph[j % 2], vh, j != 0);\n'
    '          Wgmma<PW, float>::rs(pv, ph[j % 2], vl, 1);\n'
    '          Wgmma<PW, float>::rs(pv, pl[j % 2], vh, 1);\n'
    '          Wgmma<PW, float>::rs(pv, ph[j % 2], vl2, 1);\n'
    '          wg_commit();\n'
    '          wg_wait<1>();\n'
    '        }\n'
    '        wg_wait<0>();\n'
    '        pin(pv);\n'
    '#pragma unroll\n'
    '        for (int e = 0; e < PW / 2; ++e) acc[PW / 2 * p + e] += pv[e];\n'
    '      }\n'
    '      pin(ph);\n'
    '      pin(pl);\n'
)
_K1_PV_CHAINED = (
    '      pin(acc);\n'
    '      uint32_t ph[2][4], pl[2][4];\n'
    '#pragma unroll\n'
    '      for (int j = 0; j < BN / 8; ++j) {\n'
    '        split_acc(s, j, ph[j % 2], pl[j % 2]);\n'
    '        const uint32_t kp = (j / 4) * L::VT_PANEL + (j % 4) * 32;\n'
    '        const uint64_t vh = desc128(base + L::vt_hi + kp);\n'
    '        const uint64_t vl = desc128(base + L::vt_lo + kp);\n'
    '        const uint64_t vl2 = desc128(base + L::vt_lo2 + kp);\n'
    '        wg_fence();\n'
    '        Wgmma<CW, float>::rs(acc, ph[j % 2], vh, 1);\n'
    '        Wgmma<CW, float>::rs(acc, ph[j % 2], vl, 1);\n'
    '        Wgmma<CW, float>::rs(acc, pl[j % 2], vh, 1);\n'
    '        Wgmma<CW, float>::rs(acc, ph[j % 2], vl2, 1);\n'
    '        wg_commit();\n'
    '        wg_wait<1>();\n'
    '      }\n'
    '      wg_wait<0>();\n'
    '      pin(acc);\n'
    '      pin(ph);\n'
    '      pin(pl);\n'
)
_K2_DKDV = (
    '      constexpr int PW = CW <= 32 ? CW : CW % 32 == 0 ? 32 : 16;\n'
    '      float(&pv)[PW / 2] = lead<PW / 2>(sc);\n'
    '      float(&pk)[PW / 2] = lead<PW / 2>(dpc);\n'
    '      pin(dk_acc);\n'
    '      pin(dv_acc);\n'
    '      if constexpr (WITH_DQ) pin(dq_acc);\n'
    '      const uint32_t half = c * CW * ROW_BYTES;\n'
    '#pragma unroll\n'
    '      for (int p = 0; p < CW / PW; ++p) {\n'
    '        wg_fence();\n'
    '#pragma unroll\n'
    '        for (int j = 0; j < QB / 8; ++j) {\n'
    '          const uint32_t at = half + p * PW * ROW_BYTES + j * 32;\n'
    '          const uint64_t qth = desc128(base + L::t_hi + at);\n'
    '          const uint64_t qtl = desc128(base + L::t_lo + at);\n'
    '          const uint64_t dth = desc128(base + L::t_hi + L::T_PANEL + at);\n'
    '          const uint64_t dtl = desc128(base + L::t_lo + L::T_PANEL + at);\n'
    '          Wgmma<PW, float>::rs(pv, pah[j], dth, j != 0);\n'
    '          Wgmma<PW, float>::rs(pv, pah[j], dtl, 1);\n'
    '          Wgmma<PW, float>::rs(pv, pal[j], dth, 1);\n'
    '          Wgmma<PW, float>::rs(pk, dah[j], qth, j != 0);\n'
    '          Wgmma<PW, float>::rs(pk, dah[j], qtl, 1);\n'
    '          Wgmma<PW, float>::rs(pk, dal[j], qth, 1);\n'
    '        }\n'
    '        if (p + 1 < CW / PW) {\n'
    '          wg_commit();\n'
    '          wg_wait<0>();\n'
    '          pin(pv);\n'
    '          pin(pk);\n'
    '#pragma unroll\n'
    '          for (int e = 0; e < PW / 2; ++e) {\n'
    '            dv_acc[PW / 2 * p + e] += pv[e];\n'
    '            dk_acc[PW / 2 * p + e] += pk[e];\n'
    '          }\n'
    '        }\n'
    '      }\n'
)
_K2_DKDV_CHAINED = (
    '      pin(dk_acc);\n'
    '      pin(dv_acc);\n'
    '      if constexpr (WITH_DQ) pin(dq_acc);\n'
    '      wg_fence();\n'
    '      const uint32_t half = c * CW * ROW_BYTES;\n'
    '#pragma unroll\n'
    '      for (int j = 0; j < QB / 8; ++j) {\n'
    '        const uint32_t at = half + j * 32;\n'
    '        const uint64_t qth = desc128(base + L::t_hi + at);\n'
    '        const uint64_t qtl = desc128(base + L::t_lo + at);\n'
    '        const uint64_t dth = desc128(base + L::t_hi + L::T_PANEL + at);\n'
    '        const uint64_t dtl = desc128(base + L::t_lo + L::T_PANEL + at);\n'
    '        Wgmma<CW, float>::rs(dv_acc, pah[j], dth, 1);\n'
    '        Wgmma<CW, float>::rs(dv_acc, pah[j], dtl, 1);\n'
    '        Wgmma<CW, float>::rs(dv_acc, pal[j], dth, 1);\n'
    '        Wgmma<CW, float>::rs(dk_acc, dah[j], qth, 1);\n'
    '        Wgmma<CW, float>::rs(dk_acc, dah[j], qtl, 1);\n'
    '        Wgmma<CW, float>::rs(dk_acc, dal[j], qth, 1);\n'
    '      }\n'
)
_K2_DKDV_ADD = (
    '      wg_commit();\n'
    '      wg_wait<0>();\n'
    '      pin(pv);\n'
    '      pin(pk);\n'
    '#pragma unroll\n'
    '      for (int e = 0; e < PW / 2; ++e) {\n'
    '        dv_acc[CW / 2 - PW / 2 + e] += pv[e];\n'
    '        dk_acc[CW / 2 - PW / 2 + e] += pk[e];\n'
    '      }\n'
)
_K2_DKDV_ADD_CHAINED = (
    '      wg_commit();\n'
    '      wg_wait<0>();\n'
    '      pin(dk_acc);\n'
    '      pin(dv_acc);\n'
)
# K3 above 256: the cluster's exchange of partial S and dP, every CTA
# adding every peer's partials (checked in), or a reduce-scatter of the
# partials and an all-gather of the sums (one more cluster barrier,
# x_sum, between them).
_K3_EXCHANGE = (
    '        const uint32_t slot = base + L::x + 16 * threadIdx.x;\n'
    "        // Rank r's slots added into S (slots 0 to BN / 8 - 1) and dP;\n"
    "        // rank 0's assigned.\n"
    '        auto add4 = [](float(&y)[BN / 2], int i, float4 v, bool first) {\n'
    '          y[i] = first ? v.x : y[i] + v.x;\n'
    '          y[i + 1] = first ? v.y : y[i + 1] + v.y;\n'
    '          y[i + 2] = first ? v.z : y[i + 2] + v.z;\n'
    '          y[i + 3] = first ? v.w : y[i + 3] + v.w;\n'
    '        };\n'
    '        auto gather = [&](int r, bool first) {\n'
    '          const uint32_t at = peer_addr(slot, r);\n'
    '#pragma unroll\n'
    '          for (int j = 0; j < BN / 8; ++j) {\n'
    '            add4(s, 4 * j, ld_cluster(at + 4096 * j), first);\n'
    '            add4(dp, 4 * j, ld_cluster(at + 4096 * (BN / 8 + j)), first);\n'
    '          }\n'
    '        };\n'
    '        gather(0, true);\n'
    '        for (int r = 1; r < n_cc; ++r) gather(r, false);\n')
_K3_EXCHANGE_REDUCE_SCATTER = (
    '        float4* const x4 = reinterpret_cast<float4*>(gbase + L::x);\n'
    '        constexpr int XP = BN / 8 * 256;  // float4 pairs of S and dP\n'
    '        auto add4 = [](float4 a, float4 b) {\n'
    '          return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);\n'
    '        };\n'
    '        const uint32_t xs = base + L::x;\n'
    "        // Float4 `at` of every CTA's buffer, all loads in flight, summed\n"
    '        // in rank order.\n'
    '        auto cluster_sum = [&](uint32_t at) {\n'
    '          float4 v[F32_DQ_CLUSTER_MAX];\n'
    '#pragma unroll\n'
    '          for (int r = 0; r < F32_DQ_CLUSTER_MAX; ++r)\n'
    '            if (r < n_cc) v[r] = ld_cluster(peer_addr(at, r));\n'
    '          float4 y = v[0];\n'
    '#pragma unroll\n'
    '          for (int r = 1; r < F32_DQ_CLUSTER_MAX; ++r)\n'
    '            if (r < n_cc) y = add4(y, v[r]);\n'
    '          return y;\n'
    '        };\n'
    '        for (int g = cc * XP / n_cc + threadIdx.x; g < (cc + 1) * XP / n_cc;\n'
    '             g += 256) {\n'
    '          x4[g] = cluster_sum(xs + 16 * g);\n'
    '          x4[XP + g] = cluster_sum(xs + 16 * (XP + g));\n'
    '        }\n'
    '        __syncwarp();\n'
    '        if (lane == 0)\n'
    '          for (int r = 0; r < n_cc; ++r) mbar_arrive_peer(x_sum, r);\n'
    '        mbar_wait_cluster(x_sum, kt & 1);\n'
    '#pragma unroll\n'
    '        for (int j = 0; j < BN / 8; ++j) {\n'
    '          const int g = 256 * j + threadIdx.x;\n'
    '          // The CTA whose share holds pair g.\n'
    '          const uint32_t at =\n'
    '              peer_addr(xs + 16 * g, ((g + 1) * n_cc - 1) / XP);\n'
    '          const float4 sv = ld_cluster(at), dv = ld_cluster(at + 16 * XP);\n'
    '          s[4 * j] = sv.x;\n'
    '          s[4 * j + 1] = sv.y;\n'
    '          s[4 * j + 2] = sv.z;\n'
    '          s[4 * j + 3] = sv.w;\n'
    '          dp[4 * j] = dv.x;\n'
    '          dp[4 * j + 1] = dv.y;\n'
    '          dp[4 * j + 2] = dv.z;\n'
    '          dp[4 * j + 3] = dv.w;\n'
    '        }\n')
FAMILIES["wide_f32"] = {
    "stem": "flash_wide", "ptxas": "wide32", "dtype": torch.float32,
    "shapes": ((64, 1024, 288), (64, 1024, 512), (16, 1024, 1024)),
    "variants": {
        "dq_recompute": ([(WF, "constexpr int F32_DQ_CLUSTER_MAX = 8;",
                           "constexpr int F32_DQ_CLUSTER_MAX = 1;")], None),
        "dq_exchange_reduce_scatter": ([
            (WF, "  static constexpr uint32_t N_BARS = 2 * F32_DQ_STAGES + 2 "
             "+ 2 * CLUSTER;",
             "  static constexpr uint32_t N_BARS = 2 * F32_DQ_STAGES + 2 "
             "+ 3 * CLUSTER;"),
            (WF, "  const uint32_t x_full = kw_empty + 8, x_empty = x_full + "
             "8;\n",
             "  const uint32_t x_full = kw_empty + 8, x_sum = x_full + 8;\n"
             "  const uint32_t x_empty = x_sum + 8;\n"),
            (WF, "      mbar_init(x_empty, 8 * (n_cc - 1));\n",
             "      mbar_init(x_sum, 8 * n_cc);\n"
             "      mbar_init(x_empty, 8 * (n_cc - 1));\n"),
            (WF, _K3_EXCHANGE, _K3_EXCHANGE_REDUCE_SCATTER)], None),
        "fwd_one_chain": ([
            (WF, _K1_S, _K1_S.replace("(sc,", "(s,").replace(
                "kk != 0", "!(first && kk == 0)")),
            (WF, "      for (int i = 0; i < BN / 2; ++i) s[i] = first ? "
             "sc[i] : s[i] + sc[i];\n", "")], None),
        "dkdv_one_chain": ([
            (WF, _K2_S, _K2_S.replace("(sc,", "(s,").replace(
                "(dpc,", "(dp,").replace("kk != 0", "!(first && kk == 0)")),
            (WF, _K2_SUM, "")], None),
        "fwd_pv_chained_over_keys": ([(WF, _K1_PV, _K1_PV_CHAINED)], None),
        "dkdv_chained_over_queries": ([
            (WF, _K2_DKDV, _K2_DKDV_CHAINED),
            (WF, _K2_DKDV_ADD, _K2_DKDV_ADD_CHAINED)], None),
        "fwd_pv_one_panel": ([
            (WF, "      constexpr int PW = CW % 64 == 0 ? 64 : F32_PANEL;\n",
             "      constexpr int PW = F32_PANEL;\n")], None),
        "dkdv_parts_of_16": ([
            (WF, "      constexpr int PW = CW <= 32 ? CW : CW % 32 == 0 ? 32 "
             ": 16;\n", "      constexpr int PW = 16;\n")], None),
        "fwd_32_keys": ([
            (WF, "constexpr int F32_FWD_KEYS = 64;",
             "constexpr int F32_FWD_KEYS = 32;"),
            (WF, "      constexpr int PW = CW % 64 == 0 ? 64 : F32_PANEL;\n",
             "      constexpr int PW = F32_PANEL;\n")], None),
        "fwd_2_stages": ([(WF, "constexpr int F32_FWD_STAGES = 3;",
                           "constexpr int F32_FWD_STAGES = 2;")], None),
    }}
_K3_SD = ("        Wgmma<BN, float>::rs(sc, qh[b], kh, kk != 0);\n"
          "        Wgmma<BN, float>::rs(sc, qh[b], kl, 1);\n"
          "        Wgmma<BN, float>::rs(sc, ql[b], kh, 1);\n"
          "        Wgmma<BN, float>::rs(dpc, oh[b], vh, kk != 0);\n"
          "        Wgmma<BN, float>::rs(dpc, oh[b], vl, 1);\n"
          "        Wgmma<BN, float>::rs(dpc, ol[b], vh, 1);\n")
_K3_SUM = ("      for (int i = 0; i < BN / 2; ++i) {\n"
           "        s[i] = first ? sc[i] : s[i] + sc[i];\n"
           "        dp[i] = first ? dpc[i] : dp[i] + dpc[i];\n"
           "      }\n")
# K3's dQ += dS K: each panel of a key tile's product in a fresh
# accumulator added in f32 registers (checked in), or chained through one
# accumulator over the whole key loop.
_K3_DQ = (
    '      for (int p = 0; p < NP; ++p) {\n'
    '        // Split again (tf32() is a plain asm, which the compiler would\n'
    '        // otherwise keep for every slice across the parts: spills).\n'
    '        if (p > 0) pin(dp);\n'
    '#pragma unroll\n'
    '        for (int j = 0; j < BN / 8; ++j) {\n'
    '          split_acc(dp, j, dh[j % 2], dlo[j % 2]);\n'
    '          const uint32_t kp =\n'
    '              p * F32_PANEL * ROW_BYTES + (j / 4) * L::KT_PANEL + (j % 4) * 32;\n'
    '          const uint64_t kth = desc128(base + L::kt_hi + kp);\n'
    '          const uint64_t ktl = desc128(base + L::kt_lo + kp);\n'
    '          wg_fence();\n'
    '          Wgmma<F32_PANEL, float>::rs(sc, dh[j % 2], kth, j != 0);\n'
    '          Wgmma<F32_PANEL, float>::rs(sc, dh[j % 2], ktl, 1);\n'
    '          Wgmma<F32_PANEL, float>::rs(sc, dlo[j % 2], kth, 1);\n'
    '          wg_commit();\n'
    '          wg_wait<1>();\n'
    '        }\n'
    '        wg_wait<0>();\n'
    '        pin(sc);\n'
    '#pragma unroll\n'
    '        for (int e = 0; e < F32_PANEL / 2; ++e)\n'
    '          acc[F32_PANEL / 2 * p + e] += sc[e];\n'
    '      }\n'
)
_K3_DQ_CHAINED = (
    "      {\n"
    "        pin(acc);\n"
    "#pragma unroll\n"
    "        for (int j = 0; j < BN / 8; ++j) {\n"
    "          split_acc(dp, j, dh[j % 2], dlo[j % 2]);\n"
    "          const uint32_t kp = (j / 4) * L::KT_PANEL + (j % 4) * 32;\n"
    "          const uint64_t kth = desc128(base + L::kt_hi + kp);\n"
    "          const uint64_t ktl = desc128(base + L::kt_lo + kp);\n"
    "          wg_fence();\n"
    "          Wgmma<CW, float>::rs(acc, dh[j % 2], kth, 1);\n"
    "          Wgmma<CW, float>::rs(acc, dh[j % 2], ktl, 1);\n"
    "          Wgmma<CW, float>::rs(acc, dlo[j % 2], kth, 1);\n"
    "          wg_commit();\n"
    "          wg_wait<1>();\n"
    "        }\n"
    "        wg_wait<0>();\n"
    "        pin(acc);\n"
    "      }\n")
FAMILIES["f32"] = {
    "stem": ("flash_fwd", "flash_bwd_split", "flash_bwd"), "ptxas": "wide32",
    "dtype": torch.float32,
    "shapes": ((128, 1024, 64), (32, 1024, 128), (8, 1024, 256)),
    "variants": {
        **{n: v for n, v in FAMILIES["wide_f32"]["variants"].items()
           if not n.startswith(("dq_recompute", "dq_exchange"))},
        "fwd_three_pv_products": ([
            (WF, "          Wgmma<PW, float>::rs(pv, ph[j % 2], vl2, 1);\n",
             "")], None),
        "dq_one_chain": ([
            (WF, _K3_SD, _K3_SD.replace("(sc,", "(s,").replace(
                "(dpc,", "(dp,").replace("kk != 0", "!(first && kk == 0)")),
            (WF, _K3_SUM, "")], None),
        "dq_2_stages": ([(WF, "constexpr int F32_DQ_STAGES = 3;",
                          "constexpr int F32_DQ_STAGES = 2;")], None),
        "dq_chained_over_keys": ([(WF, _K3_DQ, _K3_DQ_CHAINED)], None),
    }}


# B2's levers (csrc/flash_b2_sm90.cuh, csrc/flash_bwd.cu).
B2H, B2CU = "flash_b2_sm90.cuh", "flash_bwd.cu"
_B2_TOGETHER = ("__host__ __device__ constexpr bool b2_heads_together() {\n"
                "  return D >= 64;\n")
_B2_HEAD_FASTEST = (B2H, _B2_TOGETHER, _B2_TOGETHER.replace("D >= 64",
                                                            "false"))
_B2_PIPELINED = ("__host__ __device__ constexpr bool b2_pipelined() {\n"
                 "  return D <= 64;\n")
_B2_UNPIPELINED = (B2H, _B2_PIPELINED,
                   _B2_PIPELINED.replace("D <= 64", "false"))
_B2_DQ_BUFS = ("__host__ __device__ constexpr int b2_dq_buffers() {\n"
               "  return D <= 64 ? 2 : 1;\n")
_B2_ONE_DQ_BUFFER = (B2H, _B2_DQ_BUFS,
                     _B2_DQ_BUFS.replace("D <= 64 ? 2 : 1;", "1;"))
# The parent's body, bwd_ktile of flash_bwd_sm90.cuh (which K5 and K2
# keep), launched from the same kernel, one CTA a work item.
_B2_PARENT_BODY = [
    (B2CU, "__global__ void __launch_bounds__(sm90::B2_THREADS, 1)",
     "__global__ void __launch_bounds__(sm90::NTHREADS, 1)"),
    (B2CU, "  sm90::b2_cta<T, D>(&mq, &mdo, &mk, &mv, &mdq, lse, delta, dk, "
     "dv, bh_total,\n                     sq, sk, scale_r, causal);\n",
     "  const sm90::B2Item w = sm90::b2_item<D>(blockIdx.x, bh_total, sq, "
     "sk, causal);\n  sm90::bwd_ktile<T, D, T>(&mq, &mdo, &mk, &mv, &mdq, lse, "
     "delta, dk, dv, w.bh,\n                           w.k0, sq, sk, 0, 0, "
     "scale_r, causal);\n"),
    (B2CU, "(int)sm90::B2Smem<D>::bytes);", "(int)sm90::BwdSmem<D>::bytes);"),
    (B2CU, "<<<blocks, sm90::B2_THREADS, sm90::B2Smem<D>::bytes, stream>>>(",
     "<<<blocks, sm90::NTHREADS, sm90::BwdSmem<D>::bytes, stream>>>("),
    (B2CU, "sm90::make_map<float>(&m[4], dq32, bh, sq, D, sm90::B2_DQ_ROWS);",
     "sm90::make_map<float>(&m[4], dq32, bh, sq, D, sm90::BWD_BM);")]
# B2's levers, each on in the checked-in body; pipelining and the dQ
# buffers are levers of the 256-thread CTA's body alone.
B2_LEVERS = ("grid_order", "cta256", "pipelining", "dq_buffers")
B2_NEEDS = {"pipelining": "cta256", "dq_buffers": "cta256"}
# variant: the levers it keeps on.
B2_VARIANTS = {
    "parent_body": (),
    "grid_order_alone": ("grid_order",),
    "cta256_alone": ("cta256",),
    "cta256_pipelined": ("cta256", "pipelining"),
    "cta256_two_dq_buffers": ("cta256", "dq_buffers"),
    "head_fastest": ("cta256", "pipelining", "dq_buffers"),
    "unpipelined": ("grid_order", "cta256", "dq_buffers"),
    "one_dq_buffer": ("grid_order", "cta256", "pipelining"),
}


def b2_edits(on):
    """The edits that turn every lever of B2's checked-in body not in
    ``on`` off."""
    edits = [] if "grid_order" in on else [_B2_HEAD_FASTEST]
    if "cta256" not in on:
        return _B2_PARENT_BODY + edits
    if "pipelining" not in on:
        edits.append(_B2_UNPIPELINED)
    if "dq_buffers" not in on:
        edits.append(_B2_ONE_DQ_BUFFER)
    return edits


FAMILIES["b2"] = {
    "stem": "flash_bwd", "ptxas": "flash_bwd_kernel",
    "shapes": ((128, 1024, 64), (32, 1024, 64), (64, 8192, 64),
               (32, 16384, 64), (128, 1024, 32), (128, 1024, 96),
               (128, 1024, 128)),
    "variants": {
        **{n: (b2_edits(on), None) for n, on in B2_VARIANTS.items()},
        "pipelined_everywhere": ([
            (B2H, _B2_PIPELINED, _B2_PIPELINED.replace("D <= 64", "true"))],
            None),
    }}


def build_variants(stems, variants, sources=None):
    """``{variant: ({stem: path of its shared library}, nvcc logs)}`` of
    each of ``stems``' sources under each of ``variants``' edits, nvcc
    runs in parallel; ``sources`` maps a variant to the source directory
    it copies in place of the checked-in one."""
    procs = {}
    for name, (edits, _) in variants.items():
        d = os.path.join(_build.BUILD_DIR, "variants", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree((sources or {}).get(name, _build.CSRC), d)
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
    """K1, K2 and K3 of the f32 bodies, up to head dim 128 B2 (``b2_dq``,
    ...), and their plain outputs per K3 key tile (B2's those of the
    combined mode's; dq with its term)."""
    d = qr.shape[-1]
    o, lse = A._blockwise_fwd_impl(
        qr, k, v, True, r, block_size=A.fwd_key_tile(torch.float32, d))
    delta = A._delta(o, do)
    args = (qr, k, v, do, lse, delta, r)
    kernels = {"k1": lambda: A.flash_fwd(qr, k, v, r, True),
               "k2": lambda: A.flash_bwd_dkdv(*args, True),
               "k3": lambda: A.flash_bwd_dq(*args, p2, True)}
    b2_want = {}
    if d <= A.HEAD_DIMS[-1]:
        kernels["b2"] = lambda: A.flash_bwd(*args, p2, True)
        b2_want = {f"b2_{n}": t for n, t in kernel_check.plain_bwd_outputs(
            qr, k, v, do, lse, delta, p2, r, True).items()}

    def outputs():
        o_k, lse_k = kernels["k1"]()
        dk_k, dv_k = kernels["k2"]()
        out = {"o": o_k, "lse": lse_k, "dk": dk_k, "dv": dv_k,
               "dq": kernels["k3"]()}
        if "b2" in kernels:
            out.update(zip(("b2_dk", "b2_dv", "b2_dq"), kernels["b2"]()))
        return out

    wants = {}
    for t in tiles:
        dq, dk, dv, noise = A._attention_bwd_impl(
            qr, k, v, lse, delta, do, True, r,
            block_size=t[1] or A.bwd_key_tile("split", torch.float32, d),
            dq_scale=p2, dq_noise=True)
        wants[t] = {"o": o, "lse": lse, "dq": dq, "dq_noise": noise,
                    "dk": dk, "dv": dv, **b2_want}
    return kernels, outputs, wants


def b2_case(qr, k, v, do, p2, r, tiles):
    """B2 alone, and its plain outputs over the combined mode's key tile
    (the variants keep it)."""
    o, lse = A._blockwise_fwd_impl(
        qr, k, v, True, r, block_size=A.fwd_key_tile(qr.dtype, qr.shape[-1]))
    delta = A._delta(o, do)
    args = (qr, k, v, do, lse, delta, r)
    kernels = {"b2": lambda: A.flash_bwd(*args, p2, True)}

    def outputs():
        dk, dv, dq = kernels["b2"]()
        return {"dq": dq, "dk": dk, "dv": dv}

    want = kernel_check.plain_bwd_outputs(qr, k, v, do, lse, delta, p2, r,
                                          True)
    return kernels, outputs, {t: want for t in tiles}


def sdpa_bwd_ms(bh, s, d, dtype):
    """``{backend: ms or None}`` of SDPA's whole causal backward (dq, dk,
    dv in one autograd call) at (bh / 8, 8, s, d) under its cuDNN and
    flash backends; None where a backend refuses the shape."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    g = torch.Generator(device="cuda").manual_seed(s + d)
    shape = (bh // 8, 8, s, d) if bh % 8 == 0 else (bh, 1, s, d)
    q, k, v = (torch.randn(shape, device="cuda", generator=g).to(dtype)
               .requires_grad_() for _ in range(3))
    do = torch.randn(shape, device="cuda", generator=g).to(dtype)
    out = {}
    for name in ("CUDNN_ATTENTION", "FLASH_ATTENTION"):
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                o = torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True)
                out[name] = time_ms(lambda: torch.autograd.grad(
                    o, (q, k, v), do, retain_graph=True))
        except RuntimeError:
            out[name] = None
    return out


CASES = {"split": split_case, "d256": wide_case, "wide": wide_case,
         "wide_f32": f32_case, "f32": f32_case, "b2": b2_case}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", choices=sorted(FAMILIES), default="split")
    ap.add_argument("--only", nargs="*", metavar="VARIANT",
                    help="time these of the family's variants alone (none: "
                         "with --parent, the parent alone)")
    ap.add_argument("--parent", metavar="CHECKOUT",
                    help="also build the kernel sources of another checkout "
                         "(an unpacked parent) and time them in turns, as "
                         "the variant 'parent', against the plain side of "
                         "the checked-in key tiles")
    ap.add_argument("--dtype", choices=("bfloat16", "float16", "float32"),
                    help="inputs in this dtype in place of the family's")
    ap.add_argument("--shapes", nargs="+", metavar="BHxSxD",
                    help="these shapes (batch-heads x seq x head dim) in "
                         "place of the family's")
    ap.add_argument("--turns", type=int, default=2,
                    help="turns (checked-in, variant, variant, checked-in) "
                         "of each variant at each shape (default 2); every "
                         "turn's time is printed under 'ms'")
    args = ap.parse_args()
    family = args.family
    fam = FAMILIES[family]
    if not torch.cuda.is_available():
        sys.exit("torch_split_variants: no CUDA device")
    stems, variants = fam["stem"], fam["variants"]
    if args.only is not None:
        unknown = set(args.only) - set(variants)
        if unknown:
            sys.exit(f"torch_split_variants: no variant {sorted(unknown)} "
                     f"in family {family}")
        variants = {n: variants[n] for n in args.only}
    stems = (stems,) if isinstance(stems, str) else stems
    info = _build.build_all(list(stems))
    sources = {}
    if args.parent:
        variants = dict(variants, parent=([], None))
        sources["parent"] = os.path.join(args.parent, "horovod_tpu_torch",
                                         "ops", "csrc")
    built = build_variants(stems, variants, sources)
    if fam["ptxas"]:
        ns = fam["ptxas"]
        print(json.dumps({"ptxas": {
            "checked_in":
            ptxas_summary("".join(info[st]["log"] for st in stems), ns),
            **{n: ptxas_summary(log, ns) for n, (_, log) in built.items()}}}),
            flush=True)
    libs = {"checked_in": {st: _build.load(st) for st in stems}}
    libs.update({n: {st: ctypes.CDLL(p) for st, p in paths.items()}
                 for n, (paths, _) in built.items()})
    tiles = {n: variants[n][1] if n in variants and variants[n][1]
             else (None, None) for n in libs}
    dtype = (getattr(torch, args.dtype) if args.dtype
             else fam.get("dtype", torch.bfloat16))
    result, ok = {}, True
    shapes = ([tuple(map(int, s.split("x"))) for s in args.shapes]
              if args.shapes else fam["shapes"])
    for bh, s, d in shapes:
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
        sdpa = ([sdpa_bwd_ms(bh, s, d, dtype)] if family == "b2" else [])
        for n in variants:
            for m in ("checked_in", n, n, "checked_in") * args.turns:
                _build._libs.update(libs[m])
                # On stderr, so that a fault names the build it hit.
                print(f"timing {bh}x{s}x{d} {m}", file=sys.stderr,
                      flush=True)
                for kern, fn in kernels.items():
                    times[kern][m].append(time_ms(fn))
        _build._libs.update(libs["checked_in"])
        if sdpa:
            sdpa.append(sdpa_bwd_ms(bh, s, d, dtype))
        result["x".join(map(str, (bh, s, d)))] = {
            **({"sdpa_bwd_ms": sdpa} if sdpa else {}),
            "median_ms": {kern: {n: statistics.median(t)
                                 for n, t in ts.items()}
                          for kern, ts in times.items()},
            "ms": times,
            "worst": worst,
            **({"worst_by_output": by_output} if fam["ptxas"] else {})}
        del q, k, v, do, qr, kernels, outputs, wants
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "dtype": str(dtype), "ok": ok,
                      "shapes": result}),
          flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
