"""Generate ``horovod_tpu_torch/ops/csrc/wgmma_sm90.cuh``.

Run from the repository root::

    python3 tools/torch_gen_wgmma.py

A ``wgmma.mma_async`` instruction names every accumulator register of the
thread as its own operand (``m64nNk16`` with an f32 accumulator: N / 2
registers), so each shape is one inline-assembly statement with N / 2
``"+f"`` operands.  This script writes them out for the shapes the flash
forward (``csrc/flash_fwd_sm90.cuh``) and backward
(``csrc/flash_bwd_sm90.cuh``) use:

* ``Wgmma<N, T>::ss`` — A and B from shared memory, both K-major (the
  forward's logits ``S = Q K^T``, N = 64 or 128 keys; the backward's
  ``S^T = K q'^T`` and ``dP^T = V dO^T``, N = 64 query rows, and 32
  for the 32-row query halves of K2 at head dim 256,
  csrc/flash_bwd_sm90.cuh, and of the wide K2 body's steps,
  csrc/flash_wide_sm90.cuh); ``scale_d`` 0 overwrites the accumulator, 1
  adds to it;
* ``Wgmma<N, T>::rs`` — A from registers, B from shared memory MN-major
  (``O += P V``, ``dV += P^T dO``, ``dK += dS^T q'`` with V, dO and q'
  stored as they arrive, rows by head dim), N = head dim 32/64/96/128;
  always adds;
* ``Wgmma<N, T>::ss_t`` — A and B from shared memory, both MN-major (the
  backward's ``dQ = dS K``: dS stored transposed, key rows by query
  columns, and K as it arrives), N = 32/64/96 head-dim columns;
  ``scale_d`` as for ``ss``;
* ``Wgmma<N, T>::ss_tb`` — A from shared memory K-major, B from shared
  memory MN-major (K2 at head dim 256: ``dV += P^T dO`` and ``dK += dS^T
  q'`` with P^T and dS^T stored key rows by query columns, dO and q' as
  they arrive), N = 128 head-dim columns; ``scale_d`` as for ``ss``.

T is ``__nv_bfloat16`` or ``__half``.  In float32 (the wide bodies'
3xTF32 products, ``csrc/flash_wide_f32_sm90.cuh``) one shape form:

* ``Wgmma<N, float>::rs`` — ``m64nNk8`` TF32, A from registers (four
  TF32 values a thread, split from f32 by the caller), B from shared
  memory K-major (TF32 has no transposed forms): ``S = q' K^T`` (N = 64
  keys) and ``O += P V`` (V^T staged; N = the window's 32, 64, 96 or 128
  columns) in K1, ``S^T = K q'^T``, ``dP^T = V dO^T`` (N = 32 query rows),
  ``dV += P^T dO`` and ``dK += dS^T q'`` (N = half the window: 16, 32, 48
  or 64 columns) in K2 and B2, ``S = q' K^T``, ``dP = dO V^T`` (N = 32
  keys) and ``dQ += dS K`` (K^T staged; N = the window's columns) in K3;
  ``scale_d`` as for ``ss``;
* ``Wgmma<16, float>::ss`` — ``m64n16k8`` TF32, A and B from shared
  memory, both K-major: B2's ``dQ^T = K^T dS^T`` (K^T staged once a CTA,
  dS stored query rows by keys; N = a warpgroup's 16 query rows).

The output is checked in, so the build needs no Python step; rerun this
after changing a shape (``tests/test_torch_head_dims.py`` holds the
checked-in header to :func:`generate`).
"""

from __future__ import annotations

import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "horovod_tpu_torch", "ops", "csrc",
                   "wgmma_sm90.cuh")
SS_N = (32, 64, 128)
RS_N = (32, 64, 96, 128)
SST_N = (32, 64, 96)
SSTB_N = (128,)
TYPES = (("__nv_bfloat16", "bf16"), ("__half", "f16"))
TF32_RS_N = (16, 32, 48, 64, 96, 128)
TF32_SS_N = (16,)

HEAD = """\
// Generated by tools/torch_gen_wgmma.py; do not edit by hand.
//
// Warpgroup matrix-multiply wrappers for the flash forward and backward
// (flash_fwd_sm90.cuh, flash_bwd_sm90.cuh) and the wide bodies
// (flash_wide_sm90.cuh; in float32, 3xTF32, flash_wide_f32_sm90.cuh): one
// inline-assembly statement per shape, since wgmma names each f32
// accumulator register of the thread as an operand.
// d[4 * i + 2 * h + j] of a thread t of the warpgroup holds row
// 16 * (t / 32) + (t % 32) / 4 + 8 * h, column 8 * i + 2 * (t % 4) + j.
// A TF32 A fragment (k8) a[v] holds row 16 * (t / 32) + (t % 32) / 4 +
// 8 * (v % 2), column t % 4 + 4 * (v / 2).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace hvdt {
namespace sm90 {

template <int N, typename T>
struct Wgmma;
"""

TAIL = """
}  // namespace sm90
}  // namespace hvdt
"""


def _regs(n, first=0):
    return ", ".join(f"%{first + i}" for i in range(n))


def _outs(n):
    return ", ".join(f'"+f"(d[{i}])' for i in range(n))


def ss(n, ptx):
    r = n // 2
    return f"""
  // S (64 x {n}) = or += A (64 x 16, K-major) B^T (B {n} x 16, K-major).
  __device__ static __forceinline__ void ss(float (&d)[{r}], uint64_t a,
                                            uint64_t b, int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.{ptx}.{ptx} "
        "{{{_regs(r)}}}, %{r}, %{r + 1}, p, 1, 1, 0, 0;\\n}}\\n"
        : {_outs(r)}
        : "l"(a), "l"(b), "r"(scale_d));
  }}"""


def rs(n, ptx):
    r = n // 2
    return f"""
  // D (64 x {n}) += A (64 x 16, registers) B (16 x {n}, MN-major).
  __device__ static __forceinline__ void rs(float (&d)[{r}],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.{ptx}.{ptx} "
        "{{{_regs(r)}}}, {{{_regs(4, r)}}}, %{r + 4}, p, 1, 1, 1;\\n}}\\n"
        : {_outs(r)}
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }}"""


def ss_t(n, ptx):
    r = n // 2
    return f"""
  // D (64 x {n}) = or += A (64 x 16, MN-major) B (16 x {n}, MN-major).
  __device__ static __forceinline__ void ss_t(float (&d)[{r}], uint64_t a,
                                              uint64_t b, int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.{ptx}.{ptx} "
        "{{{_regs(r)}}}, %{r}, %{r + 1}, p, 1, 1, 1, 1;\\n}}\\n"
        : {_outs(r)}
        : "l"(a), "l"(b), "r"(scale_d));
  }}"""


def ss_tb(n, ptx):
    r = n // 2
    return f"""
  // D (64 x {n}) = or += A (64 x 16, K-major) B (16 x {n}, MN-major).
  __device__ static __forceinline__ void ss_tb(float (&d)[{r}], uint64_t a,
                                               uint64_t b, int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.{ptx}.{ptx} "
        "{{{_regs(r)}}}, %{r}, %{r + 1}, p, 1, 1, 0, 1;\\n}}\\n"
        : {_outs(r)}
        : "l"(a), "l"(b), "r"(scale_d));
  }}"""


def rs_tf32(n):
    r = n // 2
    return f"""
  // D (64 x {n}) = or += A (64 x 8, registers, TF32) B (B {n} x 8,
  // K-major, TF32).
  __device__ static __forceinline__ void rs(float (&d)[{r}],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 "
        "{{{_regs(r)}}}, {{{_regs(4, r)}}}, %{r + 4}, p, 1, 1;\\n}}\\n"
        : {_outs(r)}
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d));
  }}"""


def ss_tf32(n):
    r = n // 2
    return f"""
  // D (64 x {n}) = or += A (64 x 8, K-major, TF32) B (B {n} x 8,
  // K-major, TF32), both from shared memory.
  __device__ static __forceinline__ void ss(float (&d)[{r}], uint64_t a,
                                            uint64_t b, int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 "
        "{{{_regs(r)}}}, %{r}, %{r + 1}, p, 1, 1;\\n}}\\n"
        : {_outs(r)}
        : "l"(a), "l"(b), "r"(scale_d));
  }}"""


def generate() -> str:
    """The text of ``wgmma_sm90.cuh``."""
    parts = [HEAD]
    for ctype, ptx in TYPES:
        for n in sorted(set(SS_N) | set(RS_N) | set(SST_N)):
            body = (ss(n, ptx) if n in SS_N else "") + \
                (rs(n, ptx) if n in RS_N else "") + \
                (ss_t(n, ptx) if n in SST_N else "") + \
                (ss_tb(n, ptx) if n in SSTB_N else "")
            parts.append(f"\ntemplate <>\nstruct Wgmma<{n}, {ctype}> {{"
                         f"{body}\n}};\n")
    for n in TF32_RS_N:
        body = rs_tf32(n) + (ss_tf32(n) if n in TF32_SS_N else "")
        parts.append(f"\ntemplate <>\nstruct Wgmma<{n}, float> {{"
                     f"{body}\n}};\n")
    parts.append(TAIL)
    return "".join(parts)


def main():
    with open(OUT, "w") as f:
        f.write(generate())


if __name__ == "__main__":
    main()
