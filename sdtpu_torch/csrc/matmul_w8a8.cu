// Static-scale W8A8 GEMM for Hopper (sm_90a): bf16 activations quantized to
// int8 inside the kernel, int8 weights, int32 accumulation on the int8
// tensor cores, bf16 out.
//
// Replaces sdtpu/ops/matmul.py:_mm_w8a8_kernel, the Pallas TPU kernel
// behind matmul_w8a8. It computes the same function:
//   inv = 1 / x_scale (one f32 division, x_scale a calibration constant
//         read from device memory);
//   xq  = clip(round_half_even(f32(x) * inv), -127, 127) as int8;
//   acc = sum over k of xq[m, k] * w8[k, n], exact in int32;
//   y   = f32(acc) * (x_scale * w_scale[n]) + bias[n] in f32, rounded to
//         bf16 once.
// Every f32 step is a single IEEE operation (no fused multiply-add), so the
// result equals the plain PyTorch version's bit for bit.
//
// What bounds it on this card: the layers send it the dense sites with N >=
// M (the UNet's 16x16 and 8x8 levels, M = 512 and 128, ff1 at 32x32, and the
// 154 text rows of attn2's k and v), where the weights are the larger stream
// and the output has fewer tiles than the card has SMs: the bytes, once
// enough blocks are in flight to stream them; only ff1 at 32x32 ([2048, 640]
// . [640, 5120]) comes near the int8 tensor cores' rate.
//
// What the design does about it: the skeleton of csrc/matmul_int8w.cu with
// the integer wgmma (m64nNk32, s8 x s8 -> s32, both operands K-major in
// 128-byte-swizzled shared memory, which is how x [M][K] and the weights
// [N][K] lie). A block is two warpgroups of 64 rows each, 128 x BN output
// (BN = 128, or 160 where that divides N and 128 does not), 128 of K a step:
// one swizzled row of int8. Quantizing an x tile costs a block more
// instruction issue than the int8 products of 128 columns take, and every
// column tile repeats it, so the wide sites (ff1: N = 5120, 10240) take BN =
// 256, where the products of a step outweigh its quantizing and x is read
// and quantized half as often; its tiles are 64 of K deep, in the 64-byte
// swizzle, so that the rings fit. The weights go by cp.async straight into
// the swizzled B tile (no widening). The bf16 x tile arrives by cp.async in a
// ring of its own; each thread quantizes the 32 bytes it copied itself
// (half to even, as jnp.round and torch.round do, by adding 1.5 * 2^23: the
// rounding and the float-to-int conversion cost no conversion instruction)
// into one 16-byte chunk of one of three swizzled int8 A tiles, before the step's one
// barrier, so the quantized activations never touch device memory and the
// products of step i stay in flight (wgmma is asynchronous) under the
// quantizing of step i + 1; the copies run 2 steps (256 of K) ahead, those
// of x into a ring one stage deeper, so that they go out before the step's
// quantizing and not after it. Split-K
// where the tiles would leave half the card idle, by the wrapper's static
// rule (sdtpu_torch/ops/matmul.py:plan_w8a8), which this file checks: the
// grid's z axis takes runs of K steps, each block writes its int32 partial
// tile, and a second kernel sums them (exact in any order) and applies the
// two f32 factors and the bias as single operations, so the result stays
// bit-equal to the plain version. The output tile leaves through shared
// memory as whole 16-byte row chunks. Ragged M and N are zero-filled and
// masked; the K tail (K % 16 == 0) is zero-filled (a zero activation
// quantizes to 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

using wgmma::Wgmma;

constexpr int BM = 128;          // output rows a block: 64 a warpgroup
constexpr int THREADS = 256;
constexpr int MAX_DEVICES = 64;
constexpr int NA = 3;            // quantized A tiles

// What follows from the column tile: BK, the reduction depth a step and the
// bytes of a tile row (128, or 64 at BN = 256), D, the steps the copies run
// ahead (256 or 192 of K), NB, the B tiles.
template <int BN>
struct Tile {
  static constexpr int BK = BN == 256 ? 64 : 128;
  static constexpr int D = BN == 256 ? 3 : 2;
  static constexpr int NB = D + 2;
  static constexpr int NX = D + 1;             // raw stages of x
  static constexpr int CPR = BK / 16;          // 16-byte chunks a tile row
  static constexpr int RSTEP = THREADS / CPR;  // rows between a thread's slots
};

// where 16-byte chunk c of tile row r lies: the 128-byte swizzle, or the
// 64-byte one
template <int BK>
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return r * BK + ((c ^ (BK == 128 ? r & 7 : (r >> 1) & 3)) << 4);
}

template <int BK>
__device__ __forceinline__ uint64_t tile_descriptor(uint32_t addr) {
  return BK == 128 ? wgmma::descriptor(addr, 16, 1024)
                   : wgmma::descriptor64(addr, 512);
}
// what a probe leaves out (sdtpu_torch/tools/probe.py), 0 in every other call
constexpr int PROBE_NO_PRODUCTS = 1, PROBE_NO_COPIES = 2;

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

// clip(round_half_even(v * inv), -127, 127) in the low byte of the result.
// The bounds are integers, so clipping first gives the same value; adding
// 1.5 * 2^23 then rounds to an integer, half to even (one f32 addition in
// round-to-nearest), and leaves it in the low mantissa bits, two's
// complement: no conversion instruction, which runs at a fraction of the
// f32 rate.
__device__ __forceinline__ uint32_t quantize(float v, float inv) {
  const float t = fminf(fmaxf(__fmul_rn(v, inv), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(t, 12582912.f));
}

// four bf16 (two words) to four int8 in one word
__device__ __forceinline__ uint32_t quantize4(uint32_t w0, uint32_t w1,
                                              float inv) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w0));
  const float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w1));
  const uint32_t lo = __byte_perm(quantize(a.x, inv), quantize(a.y, inv), 0x0040);
  const uint32_t hi = __byte_perm(quantize(b.x, inv), quantize(b.y, inv), 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

struct MmArgs {
  const __nv_bfloat16* x;   // [m, k]
  const int8_t* wt;         // [n][k]
  const float* wscale;      // [n]
  const float* xscale;      // [1]
  const float* bias;        // [n] or null
  __nv_bfloat16* y;         // [m, n]
  int* partial;             // [splits][m][n], or null when splits == 1
  int m, k, n;
  int steps_per_split;      // K steps (of BK) a block takes
  int probe;
};

// Shared memory from a 1024-byte boundary: NA quantized A tiles and NB B
// tiles (rows of BK bytes, swizzled), then NX stages of raw bf16 x, each
// thread's 16-byte chunks side by side.
template <int BN>
constexpr size_t smem_bytes() {
  using T = Tile<BN>;
  return 1024 + (size_t)NA * BM * T::BK + (size_t)T::NB * BN * T::BK +
         (size_t)T::NX * BM * T::BK * 2;
}

// y = f32(acc) * (x_scale * w_scale[n]) + bias[n], each a single operation
__device__ __forceinline__ float finish(int acc, float factor, float bias,
                                        bool has_bias) {
  const float v = __fmul_rn((float)acc, factor);
  return has_bias ? __fadd_rn(v, bias) : v;
}

// grid: (ceil(m / 128), ceil(n / BN), splits)
template <int BN>
__global__ void __launch_bounds__(THREADS) mm_w8a8_kernel(const MmArgs p) {
  using T = Tile<BN>;
  constexpr int BK = T::BK, D = T::D, NB = T::NB, NX = T::NX;
  constexpr int CPR = T::CPR, RSTEP = T::RSTEP;
  constexpr int NACC = BN / 2;
  constexpr int A_ITERS = BM / RSTEP;                  // 4, or 2
  constexpr int B_ITERS = (BN + RSTEP - 1) / RSTEP;    // 4 or 5, or 4
  constexpr uint32_t RAW_STAGE = BM * BK * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t sA = base;                       // [NA][128 rows][BK B]
  const uint32_t sB = sA + NA * BM * BK;          // [NB][BN rows][BK B]
  const uint32_t sX = sB + NB * BN * BK;          // [NX][A_ITERS][2][256][16 B]

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int steps_all = (p.k + BK - 1) / BK;
  const int step0 = blockIdx.z * p.steps_per_split;
  const int steps = min(p.steps_per_split, steps_all - step0);
  const bool products = p.probe != PROBE_NO_PRODUCTS;
  const bool copies = p.probe != PROBE_NO_COPIES;

  const float xs = *p.xscale;
  const float inv = __fdiv_rn(1.0f, xs);

  // A thread's slots are fixed for the kernel: the 16 values c = tid % CPR
  // of x rows tid / CPR + RSTEP i (32 bytes of bf16, two copies, one 16-byte
  // chunk of int8 once quantized), and the 16-byte chunk c of weight rows
  // tid / CPR + RSTEP j. The swizzle of a row depends on row % 8, which i
  // and j keep.
  const int cc = tid % CPR, r0 = tid / CPR;
  const uint32_t tile_off = swizzled<BK>(r0, cc);
  const uint32_t raw_off = tid * 16;
  const __nv_bfloat16* a_src[A_ITERS];
  const int8_t* b_src[B_ITERS];
#pragma unroll
  for (int i = 0; i < A_ITERS; ++i) {
    const int row = m0 + r0 + RSTEP * i;   // null: past M, zero-filled
    a_src[i] = row < p.m ? p.x + (long long)row * p.k + step0 * BK + cc * 16
                         : nullptr;
  }
#pragma unroll
  for (int j = 0; j < B_ITERS; ++j) {
    const int row = n0 + r0 + RSTEP * j;   // null: past N or past the tile
    b_src[j] = r0 + RSTEP * j < BN && row < p.n
                   ? p.wt + (long long)row * p.k + step0 * BK + cc * 16
                   : nullptr;
  }
  const int k_first = step0 * BK + cc * 16;

  // copies of reduction step `step` (of this block's run): x into raw stage
  // sx, the weights into B tile sb; rows past M or N and columns past K are
  // zero-filled
  auto copy_x = [&](int step, int sx) {
    const bool k_in = k_first + step * BK < p.k;
    const uint32_t x_dst = sX + sx * RAW_STAGE + raw_off;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const bool in = k_in && a_src[i] != nullptr;
      const __nv_bfloat16* src = in ? a_src[i] + step * BK : p.x;
      cp_async16(x_dst + (2 * i) * (THREADS * 16), src, in);
      cp_async16(x_dst + (2 * i + 1) * (THREADS * 16), in ? src + 8 : src, in);
    }
  };
  auto copy_w = [&](int step, int sb) {
    const bool k_in = k_first + step * BK < p.k;
    const uint32_t b_dst = sB + sb * (BN * BK) + tile_off;
#pragma unroll
    for (int j = 0; j < B_ITERS; ++j) {
      if (r0 + RSTEP * j < BN) {
        const bool in = k_in && b_src[j] != nullptr;
        cp_async16(b_dst + j * (RSTEP * BK),
                   in ? (const void*)(b_src[j] + step * BK) : (const void*)p.wt,
                   in);
      }
    }
  };

  // this block's columns of x_scale * w_scale and of the bias
  __shared__ float s_factor[BN], s_bias[BN];
  if (tid < BN) {
    const bool in = n0 + tid < p.n;
    s_factor[tid] = in ? __fmul_rn(xs, p.wscale[n0 + tid]) : 0.f;
    s_bias[tid] = in && p.bias ? p.bias[n0 + tid] : 0.f;
  }

  int acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0;

#pragma unroll
  for (int s = 0; s < D; ++s) {
    if (s < steps && copies) {
      copy_x(s, s);
      copy_w(s, s);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // stages of step i: raw x in sx, its quantized tile in sa, the weights in
  // sb; the copies of step i + D go to raw stage sx_next (this thread
  // quantized what it held a step ago) and, after the barrier, B tile sb_next
  int sx = 0, sa = 0, sb = 0, sx_next = D % NX, sb_next = D % NB;
  for (int i = 0; i < steps; ++i) {
    const uint32_t a_dst = sA + sa * (BM * BK);
    const uint32_t x_raw = sX + sx * RAW_STAGE + raw_off;
    cp_async_wait<D - 1>();   // this thread's copies of step i landed
    if (i + D < steps && copies) copy_x(i + D, sx_next);
    // this warpgroup's products of step i - 2 are done; those of step i - 1
    // stay in flight
    wgmma::wait<1>();
    // each thread quantizes the values it copied itself: 16 bf16 become one
    // 16-byte chunk of the swizzled int8 row
#pragma unroll
    for (int j = 0; j < A_ITERS; ++j) {
      const uint4 lo = ld_shared16(x_raw + (2 * j) * (THREADS * 16));
      const uint4 hi = ld_shared16(x_raw + (2 * j + 1) * (THREADS * 16));
      uint4 q;
      q.x = quantize4(lo.x, lo.y, inv);
      q.y = quantize4(lo.z, lo.w, inv);
      q.z = quantize4(hi.x, hi.y, inv);
      q.w = quantize4(hi.z, hi.w, inv);
      st_shared16(a_dst + tile_off + j * (RSTEP * BK), q);
    }
    wgmma::fence_async_proxy();
    __syncthreads();   // step i is ready in full; step i - 2 is consumed
    if (i + D < steps && copies) copy_w(i + D, sb_next);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    if (products) {
      const uint64_t a_desc = tile_descriptor<BK>(a_dst + wg * (64 * BK));
      const uint64_t b_desc = tile_descriptor<BK>(sB + sb * (BN * BK));
      wgmma::pin(acc);
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        Wgmma<BN>::ss_s8(acc, a_desc + ((kk * 32) >> 4),
                         b_desc + ((kk * 32) >> 4), 1);
      wgmma::commit();
    }
    sx = sx + 1 == NX ? 0 : sx + 1;
    sx_next = sx_next + 1 == NX ? 0 : sx_next + 1;
    sa = sa + 1 == NA ? 0 : sa + 1;
    sb = sb + 1 == NB ? 0 : sb + 1;
    sb_next = sb_next + 1 == NB ? 0 : sb_next + 1;
  }
  wgmma::wait<0>();
  wgmma::pin(acc);
  cp_async_wait<0>();

  const int row0 = m0 + wg * 64 + warp * 16 + g;
  if (p.partial != nullptr) {
    // this block's share of the K sum, int32, for the second pass
    int* part = p.partial + (long long)blockIdx.z * p.m * p.n;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + half * 8;
      if (row >= p.m) continue;
      int* prow = part + (long long)row * p.n;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + j * 8 + tg * 2;
        if (col >= p.n) continue;
        const int v0 = acc[4 * j + half * 2], v1 = acc[4 * j + half * 2 + 1];
        if (col + 1 < p.n && (p.n & 1) == 0) {
          *reinterpret_cast<int2*>(prow + col) = make_int2(v0, v1);
        } else {
          prow[col] = v0;
          if (col + 1 < p.n) prow[col + 1] = v1;
        }
      }
    }
    return;
  }
  // epilogue through shared memory: the factor, the bias, one rounding to
  // bf16; the warpgroup's 64 x BN tile staged in rows padded by 16 bytes (so
  // the fragment's 4-byte writes miss each other's banks), then written out
  // as whole 16-byte chunks, a row's chunks by neighbouring threads (element
  // by element where N % 8 != 0 leaves the rows unaligned)
  constexpr int LDC = BN * 2 + 16;
  const bool has_bias = p.bias != nullptr;
  __syncthreads();   // both warpgroups are done reading the tiles
  const uint32_t sC = sA + wg * (64 * LDC);
  const int t = tid % 128;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float f0 = s_factor[j * 8 + tg * 2], f1 = s_factor[j * 8 + tg * 2 + 1];
    const float b0 = s_bias[j * 8 + tg * 2], b1 = s_bias[j * 8 + tg * 2 + 1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(
          finish(acc[4 * j + half * 2], f0, b0, has_bias),
          finish(acc[4 * j + half * 2 + 1], f1, b1, has_bias));
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                       sC + (warp * 16 + g + half * 8) * LDC +
                       (j * 8 + tg * 2) * 2),
                   "r"(*reinterpret_cast<const uint32_t*>(&v))
                   : "memory");
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  constexpr int OUT_CPR = BN / 8;   // 16-byte chunks an output row
  if (p.n % 8 == 0) {
#pragma unroll
    for (int c = t; c < 64 * OUT_CPR; c += 128) {
      const int r = c / OUT_CPR, c8 = c % OUT_CPR;
      const int row = m0 + wg * 64 + r, col = n0 + c8 * 8;
      if (row < p.m && col < p.n)
        *reinterpret_cast<uint4*>(p.y + (long long)row * p.n + col) =
            ld_shared16(sC + r * LDC + c8 * 16);
    }
    return;
  }
  for (int c = t; c < 64 * OUT_CPR; c += 128) {
    const int r = c / OUT_CPR, c8 = c % OUT_CPR;
    const int row = m0 + wg * 64 + r, col = n0 + c8 * 8;
    if (row >= p.m || col >= p.n) continue;
    const uint4 v = ld_shared16(sC + r * LDC + c8 * 16);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
    __nv_bfloat16* dst = p.y + (long long)row * p.n + col;
    for (int i = 0; i < 8 && col + i < p.n; ++i) dst[i] = e[i];
  }
}

// Second pass of split-K: the int32 partials summed (exact in any order),
// then the factor and the bias as in the one-pass epilogue. V elements a
// thread: 4 (16-byte reads) where n % 4 == 0, else 1.
template <int V>
__global__ void __launch_bounds__(THREADS)
mm_w8a8_reduce_kernel(const MmArgs p, int splits) {
  const long long total = (long long)p.m * p.n;
  const long long e = ((long long)blockIdx.x * THREADS + threadIdx.x) * V;
  if (e >= total) return;
  const int col = (int)(e % p.n);
  int sum[V];
#pragma unroll
  for (int i = 0; i < V; ++i) sum[i] = 0;
  for (int s = 0; s < splits; ++s) {
    if (V == 4) {
      const int4 v = *reinterpret_cast<const int4*>(p.partial + s * total + e);
      sum[0] += v.x;
      sum[V > 1 ? 1 : 0] += v.y;
      sum[V > 2 ? 2 : 0] += v.z;
      sum[V > 3 ? 3 : 0] += v.w;
    } else {
      sum[0] += p.partial[s * total + e];
    }
  }
  const float xs = *p.xscale;
  __nv_bfloat16 out[V];
#pragma unroll
  for (int i = 0; i < V; ++i)
    out[i] = __float2bfloat16_rn(
        finish(sum[i], __fmul_rn(xs, p.wscale[col + i]),
               p.bias ? p.bias[col + i] : 0.f, p.bias != nullptr));
  if (V == 4)
    *reinterpret_cast<uint2*>(p.y + e) = *reinterpret_cast<const uint2*>(out);
  else
    p.y[e] = out[0];
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
    err = cudaFuncSetAttribute(mm_w8a8_kernel<BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  const dim3 grid((a.m + BM - 1) / BM, (a.n + BN - 1) / BN, splits);
  mm_w8a8_kernel<BN><<<grid, THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = (long long)a.m * a.n;
  if (a.n % 4 == 0)
    mm_w8a8_reduce_kernel<4><<<(unsigned)((total / 4 + THREADS - 1) / THREADS),
                               THREADS, 0, stream>>>(a, splits);
  else
    mm_w8a8_reduce_kernel<1><<<(unsigned)((total + THREADS - 1) / THREADS),
                               THREADS, 0, stream>>>(a, splits);
  return cudaGetLastError();
}

}  // namespace

// x: [m, k] bf16; wt: [n][k] int8 (the weight (k, n) with k contiguous);
// w_scale: [n] f32; x_scale: one f32 in device memory; bias: [n] f32 or
// null; y: [m, n] bf16. All contiguous, x and wt 16-byte aligned; k % 16 ==
// 0; every tensor under 2^31 elements. bn, splits and steps_per_split are the
// wrapper's plan (ops/matmul.py:plan_w8a8): bn = 128, 160 or 256 output
// columns a block and the K steps (of 128; of 64 at bn = 256) cut into
// `splits` runs of steps_per_split, every run non-empty. partial: int32 [splits][m][n] scratch where splits >
// 1, else null. probe: 0; 1 leaves out the products and 2 the copies inside
// the K loop (a measurement's stubs: the output is then not the product).
// Returns a cudaError_t (0 on success).
extern "C" int sdtpu_matmul_w8a8(const void* x, const void* wt,
                                 const void* w_scale, const void* x_scale,
                                 const void* bias, void* y, void* partial,
                                 int m, int k, int n, int bn, int splits,
                                 int steps_per_split, int probe,
                                 void* stream) {
  const long long big = 1LL << 31;
  const int bk = bn == 256 ? 64 : 128;
  const int steps = (k + bk - 1) / bk;
  if (m <= 0 || k <= 0 || n <= 0 || k % 16 != 0 || x == nullptr ||
      wt == nullptr || w_scale == nullptr || x_scale == nullptr ||
      y == nullptr || (long long)m * k >= big || (long long)m * n >= big ||
      (long long)k * n >= big || (bn != 128 && bn != 160 && bn != 256) ||
      splits < 1 ||
      splits > 65535 || steps_per_split < 1 ||
      (long long)(splits - 1) * steps_per_split >= steps ||
      (long long)splits * steps_per_split < steps ||
      (splits > 1) != (partial != nullptr) || (n + bn - 1) / bn > 65535 ||
      (long long)splits * m * n >= big || probe < 0 || probe > 2)
    return (int)cudaErrorInvalidValue;
  const MmArgs args{static_cast<const __nv_bfloat16*>(x),
                    static_cast<const int8_t*>(wt),
                    static_cast<const float*>(w_scale),
                    static_cast<const float*>(x_scale),
                    static_cast<const float*>(bias),
                    static_cast<__nv_bfloat16*>(y),
                    static_cast<int*>(partial), m, k, n, steps_per_split,
                    probe};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 256) return (int)launch<256>(args, splits, s);
  if (bn == 160) return (int)launch<160>(args, splits, s);
  return (int)launch<128>(args, splits, s);
}
