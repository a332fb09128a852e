// Weight-only-int8 GEMM for Hopper (sm_90a): bf16 activations, int8 weights
// with one float32 scale per output column, bf16 out.
//
// Replaces sdtpu/ops/matmul.py:_mm_kernel, the Pallas TPU kernel behind
// matmul_int8w. It computes the same function:
//   acc = sum over k of x[m, k] * bf16(w8[k, n]), in f32 (int8 -> bf16 is
//         exact, and the weight scale is NOT applied before the product);
//   y   = acc * scale[n] + bias[n] in f32, rounded to bf16 once.
//
// What bounds it on this card: at the UNet's 64x64 and 32x32 levels (M =
// 8192, 2048) the bytes of the activations and the output, which int8
// weights do not shrink, and at the widest sites the tensor cores; at the
// 16x16 and 8x8 levels (M = 512, 128) the number of output tiles, far fewer
// than the card's 132 SMs; at M of a few rows (the ResBlocks' time-embedding
// dense, M = 2) the weight bytes, which the int8 stream halves.
//
// What the design does about it. Three kernels, chosen by the wrapper's
// static rule (sdtpu_torch/ops/matmul.py:plan_int8w), which this file checks:
//  * The tile kernel: y = x . w with wgmma (m64nNk16, bf16 in, f32
//    accumulate), both operands from shared memory in the 128-byte-swizzled
//    K-major layout. A block is two warpgroups of 64 rows each (128 x BN
//    output, BN = 128, or 160 where that divides N and 128 does not: N = 320
//    is two exact tiles). The weights are read where they lie, [N][K] with K
//    contiguous, which is the K-major B operand. 64 of K a step: x (bf16)
//    and the raw int8 weights arrive by cp.async in rings; each thread widens
//    the int8 chunks it copied itself into one of three bf16 B tiles, then one
//    barrier a step hands the tile to both warpgroups. The products of step i
//    stay in flight (wgmma is asynchronous) under the widening of step i + 1,
//    and the copies run 3 steps ahead (one block an SM, 5 stages of x). The
//    output tile leaves through shared memory as whole 16-byte row chunks.
//    Widening in shared memory, once a tile, was chosen over widening into
//    the register operand of y^T = w^T . x^T: there each thread would fetch
//    its fragment's weights as 2-byte pieces and the output would have to be
//    transposed back, while here a 16-byte read widens into two 16-byte
//    swizzled writes and the product is the plain K-major one.
//  * The widening is bit work, not conversion: a byte b sits in a bf16 lane
//    as (b & 0x7f) | 0x4300 = 128 + (b & 0x7f), and 0x4300 | (b & 0x80) = 128
//    or 256 is subtracted (one sub.bf16x2): exact for all 256 values.
//  * Split-K where the tiles would leave half the card idle (M <= 512): the
//    grid's z axis takes runs of K steps, each block writes its f32 partial
//    tile, and a second kernel sums the partials in a fixed order, applies
//    scale and bias and rounds once. No atomics: the same inputs give the
//    same bytes.
//  * M <= 16 (the time-embedding dense): no tensor cores. A warp takes one
//    output column at a time, reads its K run of int8 as 16-byte vectors,
//    multiplies in f32 against up to 4 rows of x and reduces over the warp:
//    N / 8 blocks stream the weights.
// The scale stays out of the product and is applied to the f32 accumulator
// with the bias. Ragged M and N are zero-filled and masked; the K tail (K %
// 16 == 0) is zero-filled.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

using wgmma::Wgmma;

constexpr int BM = 128;          // output rows a block: 64 a warpgroup
constexpr int BK = 64;           // reduction depth a step: one swizzled row
constexpr int THREADS = 256;
constexpr int MAX_DEVICES = 64;
constexpr int SKINNY_ROWS = 4;   // rows of x a block of the skinny kernel
constexpr int SKINNY_COLS = 8;   // output columns a block of the skinny kernel

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void st_shared16(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// Two int8 (bytes `sel` picks out of `word`, each into the low byte of a
// 16-bit lane) to two bf16, exactly: 128 + (b & 0x7f) minus 128 or 256.
__device__ __forceinline__ uint32_t widen2(uint32_t word, uint32_t sel) {
  const uint32_t lanes = __byte_perm(word, 0u, sel);
  const uint32_t hi = (lanes & 0x007f007fu) | 0x43004300u;
  const uint32_t lo = (lanes & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&hi),
                                   *reinterpret_cast<const __nv_bfloat162*>(&lo));
  return *reinterpret_cast<const uint32_t*>(&r);
}

struct MmArgs {
  const __nv_bfloat16* x;   // [m, k]
  const int8_t* wt;         // [n][k]
  const float* scale;       // [n]
  const float* bias;        // [n] or null
  __nv_bfloat16* y;         // [m, n]
  float* partial;           // [splits][m][n], or null when splits == 1
  int m, k, n;
  int steps_per_split;      // 64-deep K steps a block of the tile kernel takes
};

// The rings. The copies run D = SA - 2 steps ahead. A stage of x is free
// again two steps after its products were started (the barrier of step i
// comes after every thread waited for the products of step i - 2), so x has
// D + 2 stages. A widened weight tile is written BEFORE the barrier of its
// step, while the other warpgroup may still have step i - 2 in flight, so
// there are 3 of them. A raw int8 chunk is widened by the thread that copied
// it, before that thread's next copy, so D stages do.
constexpr int NB = 3;
constexpr int SA = 5;                // stages of x

template <int BN>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)SA * BM * 128 + (size_t)(SA - 2) * BN * BK +
         (size_t)NB * BN * 128;
}

// grid: (ceil(m / 128), ceil(n / BN), splits)
template <int BN>
__global__ void __launch_bounds__(THREADS) mm_int8w_kernel(const MmArgs p) {
  constexpr int D = SA - 2;          // steps the copies run ahead
  constexpr int SW = D;              // stages of raw weights
  constexpr int NACC = BN / 2;
  constexpr int A_ITERS = BM * 8 / THREADS;                 // 4
  constexpr int W_ITERS = (BN * 4 + THREADS - 1) / THREADS; // 2 or 3
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t sA = base;                       // [SA][128 rows][128 B]
  const uint32_t sB = sA + SA * BM * 128;         // [NB][BN rows][128 B]
  const uint32_t sW = sB + NB * BN * 128;         // [SW][BN rows][64 B]

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int steps_all = (p.k + BK - 1) / BK;
  const int step0 = blockIdx.z * p.steps_per_split;
  const int steps = min(p.steps_per_split, steps_all - step0);

  // The copy and widening slots of a thread are fixed for the kernel, so
  // their addresses are computed once: 16-byte chunk tid % 8 of x rows tid /
  // 8 + 32 i, and chunk tid % 4 (16 int8) of weight rows tid / 4 + 64 j. The
  // swizzle of a row depends on row % 8, which i and j do not change.
  const int a_cc = tid % 8, a_r = tid / 8;
  const int w_cc = tid % 4, w_r = tid / 4;
  const uint32_t a_off = a_r * 128 + ((a_cc ^ (a_r & 7)) << 4);
  const uint32_t w_off = w_r * BK + w_cc * 16;
  const uint32_t b_lo = w_r * 128 + (((2 * w_cc) ^ (w_r & 7)) << 4);
  const uint32_t b_hi = w_r * 128 + (((2 * w_cc + 1) ^ (w_r & 7)) << 4);
  const __nv_bfloat16* a_src[A_ITERS];
  const int8_t* w_src[W_ITERS];
#pragma unroll
  for (int i = 0; i < A_ITERS; ++i) {
    const int row = m0 + a_r + 32 * i;   // null: past M, zero-filled
    a_src[i] = row < p.m ? p.x + (long long)row * p.k + step0 * BK + a_cc * 8
                         : nullptr;
  }
#pragma unroll
  for (int j = 0; j < W_ITERS; ++j) {
    const int row = n0 + w_r + 64 * j;   // null: past N or past the tile
    w_src[j] = w_r + 64 * j < BN && row < p.n
                   ? p.wt + (long long)row * p.k + step0 * BK + w_cc * 16
                   : nullptr;
  }
  const int a_k = step0 * BK + a_cc * 8, w_k = step0 * BK + w_cc * 16;

  // copies of reduction step `step` (of this block's run) into stages sa
  // and sw; rows past M or N and columns past K are zero-filled
  auto copy_step = [&](int step, int sa, int sw) {
    const bool a_in = a_k + step * BK < p.k, w_in = w_k + step * BK < p.k;
    const uint32_t a_dst = sA + sa * (BM * 128) + a_off;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const bool in = a_in && a_src[i] != nullptr;
      cp_async16(a_dst + i * (32 * 128),
                 in ? (const void*)(a_src[i] + step * BK) : (const void*)p.x,
                 in);
    }
    const uint32_t w_dst = sW + sw * (BN * BK) + w_off;
#pragma unroll
    for (int j = 0; j < W_ITERS; ++j) {
      if (w_r + 64 * j < BN) {
        const bool in = w_in && w_src[j] != nullptr;
        cp_async16(w_dst + j * (64 * BK),
                   in ? (const void*)(w_src[j] + step * BK) : (const void*)p.wt,
                   in);
      }
    }
  };

  // this block's columns of scale and bias, for the epilogue
  __shared__ float s_scale[BN], s_bias[BN];
  if (tid < BN) {
    const bool in = n0 + tid < p.n;
    s_scale[tid] = in ? p.scale[n0 + tid] : 0.f;
    s_bias[tid] = in && p.bias ? p.bias[n0 + tid] : 0.f;
  }

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < D; ++s) {
    if (s < steps) copy_step(s, s, s % SW);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // stages of step i: x in sa, raw weights in sw, widened weights in sb; the
  // copies of step i + D go to x stage sa_next and to sw, free by then
  int sa = 0, sw = 0, sb = 0, sa_next = D % SA;
  for (int i = 0; i < steps; ++i) {
    const uint32_t w_raw = sW + sw * (BN * BK) + w_off;
    const uint32_t b_dst = sB + sb * (BN * 128);
    cp_async_wait<D - 1>();   // this thread's copies of step i landed
    // this warpgroup's products of step i - 2 are done; those of step i - 1
    // stay in flight
    wgmma::wait<1>();
    // each thread widens the int8 chunks it copied itself: 16 int8 of a row
    // become the 16-byte chunks 2cc and 2cc + 1 of the swizzled bf16 row
#pragma unroll
    for (int j = 0; j < W_ITERS; ++j) {
      if (w_r + 64 * j < BN) {
        const uint4 q = ld_shared16(w_raw + j * (64 * BK));
        uint4 lo, hi;
        lo.x = widen2(q.x, 0x4140);
        lo.y = widen2(q.x, 0x4342);
        lo.z = widen2(q.y, 0x4140);
        lo.w = widen2(q.y, 0x4342);
        hi.x = widen2(q.z, 0x4140);
        hi.y = widen2(q.z, 0x4342);
        hi.z = widen2(q.w, 0x4140);
        hi.w = widen2(q.w, 0x4342);
        st_shared16(b_dst + b_lo + j * (64 * 128), lo);
        st_shared16(b_dst + b_hi + j * (64 * 128), hi);
      }
    }
    wgmma::fence_async_proxy();
    __syncthreads();   // step i is ready in full; step i - 2 is consumed
    if (i + D < steps) copy_step(i + D, sa_next, sw);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const uint64_t a_desc = wgmma::descriptor(
        sA + sa * (BM * 128) + wg * (64 * 128), 16, 1024);
    const uint64_t b_desc = wgmma::descriptor(b_dst, 16, 1024);
    wgmma::pin(acc);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<BN>::ss(acc, a_desc + ((kk * 32) >> 4), b_desc + ((kk * 32) >> 4),
                    1);
    wgmma::commit();
    sa = sa + 1 == SA ? 0 : sa + 1;
    sa_next = sa_next + 1 == SA ? 0 : sa_next + 1;
    sw = sw + 1 == SW ? 0 : sw + 1;
    sb = sb + 1 == NB ? 0 : sb + 1;
  }
  wgmma::wait<0>();
  wgmma::pin(acc);
  cp_async_wait<0>();

  const int row0 = m0 + wg * 64 + warp * 16 + g;
  if (p.partial != nullptr) {
    // this block's share of the K sum, f32, for the second pass
    float* part = p.partial + (long long)blockIdx.z * p.m * p.n;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + half * 8;
      if (row >= p.m) continue;
      float* prow = part + (long long)row * p.n;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + j * 8 + tg * 2;
        if (col >= p.n) continue;
        const float v0 = acc[4 * j + half * 2], v1 = acc[4 * j + half * 2 + 1];
        if (col + 1 < p.n && (p.n & 1) == 0) {
          *reinterpret_cast<float2*>(prow + col) = make_float2(v0, v1);
        } else {
          prow[col] = v0;
          if (col + 1 < p.n) prow[col + 1] = v1;
        }
      }
    }
    return;
  }
  // epilogue through shared memory: scale, then bias, in f32 (two
  // roundings, as the reference's two statements), one rounding to bf16,
  // the warpgroup's 64 x BN tile staged in rows padded by 16 bytes (so
  // the fragment's 4-byte writes miss each other's banks), then written
  // out as whole 16-byte chunks, a row's chunks by neighbouring threads
  // (element by element where N % 8 != 0 leaves the rows unaligned)
  constexpr int LDC = BN * 2 + 16;
  __syncthreads();   // both warpgroups are done reading the rings
  const uint32_t sC = sA + wg * (64 * LDC);
  const int t = tid % 128;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float s0 = s_scale[j * 8 + tg * 2], s1 = s_scale[j * 8 + tg * 2 + 1];
    const float b0 = s_bias[j * 8 + tg * 2], b1 = s_bias[j * 8 + tg * 2 + 1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float v0 = __fadd_rn(__fmul_rn(acc[4 * j + half * 2], s0), b0);
      const float v1 =
          __fadd_rn(__fmul_rn(acc[4 * j + half * 2 + 1], s1), b1);
      const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                       sC + (warp * 16 + g + half * 8) * LDC +
                       (j * 8 + tg * 2) * 2),
                   "r"(*reinterpret_cast<const uint32_t*>(&v))
                   : "memory");
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  constexpr int CPR = BN / 8;   // 16-byte chunks a row
  if (p.n % 8 == 0) {
#pragma unroll
    for (int c = t; c < 64 * CPR; c += 128) {
      const int r = c / CPR, cc = c % CPR;
      const int row = m0 + wg * 64 + r, col = n0 + cc * 8;
      if (row < p.m && col < p.n)
        *reinterpret_cast<uint4*>(p.y + (long long)row * p.n + col) =
            ld_shared16(sC + r * LDC + cc * 16);
    }
    return;
  }
  for (int c = t; c < 64 * CPR; c += 128) {
    const int r = c / CPR, cc = c % CPR;
    const int row = m0 + wg * 64 + r, col = n0 + cc * 8;
    if (row >= p.m || col >= p.n) continue;
    const uint4 v = ld_shared16(sC + r * LDC + cc * 16);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
    __nv_bfloat16* dst = p.y + (long long)row * p.n + col;
    for (int i = 0; i < 8 && col + i < p.n; ++i) dst[i] = e[i];
  }
}

// Second pass of split-K: y = (sum over splits, in order) * scale + bias.
__global__ void __launch_bounds__(THREADS)
mm_int8w_reduce_kernel(const MmArgs p, int splits) {
  const long long total = (long long)p.m * p.n;
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= total) return;
  const int col = (int)(e % p.n);
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum = __fadd_rn(sum, p.partial[s * total + e]);
  float v = __fmul_rn(sum, p.scale[col]);
  if (p.bias) v = __fadd_rn(v, p.bias[col]);
  p.y[e] = __float2bfloat16_rn(v);
}

// M <= 16. grid: (ceil(n / 8), ceil(m / 4)); 4 warps, 2 columns each.
__global__ void __launch_bounds__(128) mm_int8w_skinny_kernel(const MmArgs p) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = blockIdx.y * SKINNY_ROWS;
  const int chunks = p.k / 16;
  for (int ci = 0; ci < SKINNY_COLS / 4; ++ci) {
    const int col = blockIdx.x * SKINNY_COLS + ci * 4 + warp;
    if (col >= p.n) break;
    const int8_t* wcol = p.wt + (long long)col * p.k;
    float acc[SKINNY_ROWS];
#pragma unroll
    for (int r = 0; r < SKINNY_ROWS; ++r) acc[r] = 0.f;
    for (int ch = lane; ch < chunks; ch += 32) {
      const uint4 q = *reinterpret_cast<const uint4*>(wcol + ch * 16);
      const uint32_t words[4] = {q.x ^ 0x80808080u, q.y ^ 0x80808080u,
                                 q.z ^ 0x80808080u, q.w ^ 0x80808080u};
      // byte b + 128 in the mantissa of 2^23, minus 2^23 + 128: exact
      float w[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        w[i] = __uint_as_float(__byte_perm(words[i / 4], 0x4B000000u,
                                           0x7650u + (i % 4))) -
               8388736.f;
#pragma unroll
      for (int r = 0; r < SKINNY_ROWS; ++r) {
        if (r0 + r >= p.m) break;
        const uint4* xp = reinterpret_cast<const uint4*>(
            p.x + (long long)(r0 + r) * p.k + ch * 16);
        const uint4 xa = xp[0], xb = xp[1];
        const uint32_t xw[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[r] = fmaf(__uint_as_float(xw[i] << 16), w[2 * i], acc[r]);
          acc[r] = fmaf(__uint_as_float(xw[i] & 0xffff0000u), w[2 * i + 1],
                        acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < SKINNY_ROWS; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
      if (lane == 0 && r0 + r < p.m) {
        float v = __fmul_rn(acc[r], p.scale[col]);
        if (p.bias) v = __fadd_rn(v, p.bias[col]);
        p.y[(long long)(r0 + r) * p.n + col] = __float2bfloat16_rn(v);
      }
    }
  }
}

template <int BN>
cudaError_t launch(const MmArgs& a, int splits, cudaStream_t stream) {
  // raise the kernel's shared-memory cap on this device once (not again
  // inside a graph capture)
  static bool allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  constexpr size_t smem = smem_bytes<BN>();
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(mm_int8w_kernel<BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  const dim3 grid((a.m + BM - 1) / BM, (a.n + BN - 1) / BN, splits);
  mm_int8w_kernel<BN><<<grid, THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = (long long)a.m * a.n;
  mm_int8w_reduce_kernel<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS,
                           0, stream>>>(a, splits);
  return cudaGetLastError();
}

}  // namespace

// x: [m, k] bf16; wt: [n][k] int8 (the weight (k, n) with k contiguous);
// scale: [n] f32; bias: [n] f32 or null; y: [m, n] bf16. All contiguous, x
// and wt 16-byte aligned; k % 16 == 0; every tensor under 2^31 elements.
// path, bn, splits and steps_per_split are the wrapper's plan
// (ops/matmul.py:plan_int8w): path 1 is the skinny kernel (m <= 16; the rest
// is not read); path 0 the tile kernel with bn = 128 or 160 output columns a
// block and the K steps of 64 cut into `splits` runs of steps_per_split,
// every run non-empty. partial: f32 [splits][m][n] scratch where splits > 1,
// else null. Returns a cudaError_t (0 on success).
extern "C" int sdtpu_matmul_int8w(const void* x, const void* wt,
                                  const void* scale, const void* bias, void* y,
                                  void* partial, int m, int k, int n, int path,
                                  int bn, int splits, int steps_per_split,
                                  void* stream) {
  const long long big = 1LL << 31;
  if (m <= 0 || k <= 0 || n <= 0 || k % 16 != 0 || x == nullptr ||
      wt == nullptr || scale == nullptr || y == nullptr ||
      (long long)m * k >= big || (long long)m * n >= big ||
      (long long)k * n >= big)
    return (int)cudaErrorInvalidValue;
  MmArgs args{static_cast<const __nv_bfloat16*>(x),
              static_cast<const int8_t*>(wt),
              static_cast<const float*>(scale),
              static_cast<const float*>(bias),
              static_cast<__nv_bfloat16*>(y),
              static_cast<float*>(partial), m, k, n, steps_per_split};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if (m > 16) return (int)cudaErrorInvalidValue;
    const dim3 grid((n + SKINNY_COLS - 1) / SKINNY_COLS,
                    (m + SKINNY_ROWS - 1) / SKINNY_ROWS);
    mm_int8w_skinny_kernel<<<grid, 128, 0, s>>>(args);
    return (int)cudaGetLastError();
  }
  const int steps = (k + BK - 1) / BK;
  if (path != 0 || (bn != 128 && bn != 160) || splits < 1 || splits > 65535 ||
      steps_per_split < 1 ||
      (long long)(splits - 1) * steps_per_split >= steps ||
      (long long)splits * steps_per_split < steps ||
      (splits > 1) != (partial != nullptr) || (n + bn - 1) / bn > 65535 ||
      (long long)splits * m * n >= big)
    return (int)cudaErrorInvalidValue;
  if (bn == 160) return (int)launch<160>(args, splits, s);
  return (int)launch<128>(args, splits, s);
}
