"""Write ``wgmma_sm90.cuh``: one inline-PTX wrapper per ``wgmma.mma_async``
shape the kernels use (bf16 x bf16 -> f32, m64nNk16; s8 x s8 -> s32,
m64nNk32).

    python3 sdtpu_torch/csrc/gen_wgmma.py

The instruction names every accumulator register as its own operand, N / 2
of them a thread, so the wrappers are written by this script and not by
hand; the header is committed and ``tests/test_torch_hopper.py`` holds it
against this script's output. Four forms, each written only at the widths
(``FORMS``) at which a kernel instantiates it:

* ``Wgmma<N>::ss``: A and B from shared memory through matrix descriptors,
  both K-major (each row's K run contiguous);
* ``Wgmma<N>::rs_mn``: A from registers (the m16k16 fragment of
  ``mma.sync``, one a warp), B from shared memory, MN-major (each K index's
  N run contiguous: the transpose flag);
* ``Wgmma<N>::rs``: A from registers, B from shared memory, K-major (the
  fused conv: a tap of the input slab is an address offset of ``ldmatrix``,
  the weights lie K-major);
* ``Wgmma<N>::ss_s8``: int8 A and B from shared memory, both K-major (the
  integer instruction takes no transpose flag), 32 of K, int32 accumulators.
"""

from __future__ import annotations

from pathlib import Path

# accumulator widths by form. ss: the flash kernels' key and query tiles
# (32, 64) and the GEMM's column tiles (128, 160); rs_mn: the flash kernels'
# padded head dims (16 .. 128) and the halves of 256 and 512 (128, 256); rs:
# the fused conv's column tiles; ss_s8: the W8A8 GEMM's column tiles (256
# for its wide sites)
FORMS = {"ss": (32, 64, 128, 160), "rs_mn": (16, 32, 48, 64, 80, 128, 256),
         "rs": (128, 160), "ss_s8": (128, 160, 256)}
WIDTHS = tuple(sorted({n for widths in FORMS.values() for n in widths}))

HEADER = '''\
// wgmma.mma_async wrappers for sm_90a: bf16 x bf16 -> f32, m64nNk16, and
// s8 x s8 -> s32, m64nNk32.
// Written by gen_wgmma.py; do not edit by hand.
//
// The accumulator of a 64 x N tile lies over the warpgroup's 128 threads as
// N / 8 copies of mma.sync's m16n8 fragment: warp w holds rows 16w .. 16w +
// 15; d[4 j + e] of lane l is row 16w + l / 4 + 8 (e / 2), column 8 j + 2 (l
// % 4) + e % 2.

#pragma once

#include <stdint.h>

namespace wgmma {

// Shared-memory matrix descriptor for the 128-byte swizzle: rows of 128
// bytes, 8-row groups `sbo` bytes apart (1024 when the rows are dense),
// 16-byte chunk c of row r stored at chunk c ^ (r % 8); the tile starts on a
// 1024-byte boundary. `lbo` is the distance between 64-element column blocks
// of an MN-major operand and is not read for a K-major one.
__device__ __forceinline__ uint64_t descriptor(uint32_t smem_addr,
                                               uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr & 0x3FFFFu) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

// The same for the 64-byte swizzle of a K-major operand: rows of 64 bytes,
// 8-row groups `sbo` bytes apart (512 when dense), 16-byte chunk c of row r
// stored at chunk c ^ ((r / 2) % 4); the tile starts on a 512-byte boundary.
__device__ __forceinline__ uint64_t descriptor64(uint32_t smem_addr,
                                                 uint32_t sbo) {
  return (uint64_t)((smem_addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (2ull << 62);
}

// Before the first wgmma that reads registers or shared memory written by
// ordinary instructions.
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
}

// Until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\\n" ::"n"(N) : "memory");
}

// Pins accumulator registers in program order, so that no read or write of
// them moves across an asynchronous product's start or its wait.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Makes shared-memory writes of ordinary instructions (st.shared, cp.async
// once waited for) visible to wgmma's reads; before the barrier that hands
// the tile over.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
}

template <int N>
struct Wgmma;
'''


def operands(first: int, count: int) -> str:
    regs = [f"%{i}" for i in range(first, first + count)]
    lines = [", ".join(regs[i:i + 8]) for i in range(0, count, 8)]
    return ",\"\n        \" ".join(lines)


def ss(n: int) -> str:
    acc = n // 2
    return f'''
  // d (+)= A . B^T, A [64][16] and B [{n}][16] K-major in shared memory;
  // accumulate = 0 overwrites d
  __device__ static __forceinline__ void ss(float (&d)[{acc}], uint64_t da,
                                            uint64_t db, int accumulate) {{
    asm volatile(
        "{{\\n"
        ".reg .pred p;\\n"
        "setp.ne.b32 p, %{acc + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{{{operands(0, acc)}}}, "
        "%{acc}, %{acc + 1}, p, 1, 1, 0, 0;\\n"
        "}}\\n"
        : {outputs(acc)}
        : "l"(da), "l"(db), "r"(accumulate));
  }}
'''


def rs_mn(n: int) -> str:
    acc = n // 2
    return f'''
  // d (+)= A . B, A [64][16] in registers, B [16][{n}] MN-major in shared
  // memory
  __device__ static __forceinline__ void rs_mn(float (&d)[{acc}],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {{
    asm volatile(
        "{{\\n"
        ".reg .pred p;\\n"
        "setp.ne.b32 p, %{acc + 5}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{{{operands(0, acc)}}}, "
        "{{%{acc}, %{acc + 1}, %{acc + 2}, %{acc + 3}}}, %{acc + 4}, "
        "p, 1, 1, 1;\\n"
        "}}\\n"
        : {outputs(acc)}
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
  }}
'''


def rs(n: int) -> str:
    acc = n // 2
    return f'''
  // d (+)= A . B^T, A [64][16] in registers, B [{n}][16] K-major in shared
  // memory
  __device__ static __forceinline__ void rs(float (&d)[{acc}],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int accumulate) {{
    asm volatile(
        "{{\\n"
        ".reg .pred p;\\n"
        "setp.ne.b32 p, %{acc + 5}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{{{operands(0, acc)}}}, "
        "{{%{acc}, %{acc + 1}, %{acc + 2}, %{acc + 3}}}, %{acc + 4}, "
        "p, 1, 1, 0;\\n"
        "}}\\n"
        : {outputs(acc)}
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
  }}
'''


def ss_s8(n: int) -> str:
    acc = n // 2
    return f'''
  // d (+)= A . B^T in int32, A [64][32] and B [{n}][32] int8, K-major in
  // shared memory; accumulate = 0 overwrites d
  __device__ static __forceinline__ void ss_s8(int (&d)[{acc}], uint64_t da,
                                               uint64_t db, int accumulate) {{
    asm volatile(
        "{{\\n"
        ".reg .pred p;\\n"
        "setp.ne.b32 p, %{acc + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 "
        "{{{operands(0, acc)}}}, "
        "%{acc}, %{acc + 1}, p;\\n"
        "}}\\n"
        : {outputs(acc, "r")}
        : "l"(da), "l"(db), "r"(accumulate));
  }}
'''


def outputs(acc: int, kind: str = "f") -> str:
    return ",\n          ".join(f'"+{kind}"(d[{i}])' for i in range(acc))


def struct(n: int) -> str:
    body = "".join(form(n) for name, form in (
        ("ss", ss), ("rs_mn", rs_mn), ("rs", rs), ("ss_s8", ss_s8))
        if n in FORMS[name])
    return f'''
template <>
struct Wgmma<{n}> {{
  static constexpr int ACC = {n // 2};
{body}}};
'''


def render() -> str:
    return (HEADER + "".join(struct(n) for n in WIDTHS)
            + "\n}  // namespace wgmma\n")


def main() -> None:
    out = Path(__file__).with_name("wgmma_sm90.cuh")
    out.write_text(render())
    print(f"wrote {out} ({len(render())} bytes)")


if __name__ == "__main__":
    main()
