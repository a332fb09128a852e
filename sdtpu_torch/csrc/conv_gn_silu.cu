// Implicit-GEMM 3x3 / 1x1 convolution with a GroupNorm(+SiLU) prologue and
// a per-sample bias epilogue, for Hopper (sm_90a); bf16 activations, bf16
// or int8 weights, bf16 out.
//
// Replaces sdtpu/ops/conv.py:_conv_kernel and _conv_kernel_b, the two Pallas
// TPU kernels of the JAX package (their two grid orders are a TPU VMEM
// artefact; one source takes both here). It computes the same function:
//   z   = x * A[n, ci] + D[n, ci], then SiLU if asked (the GroupNorm folded
//         by the caller into per-(sample, channel) A and D), rounded to
//         bf16, the operand type of the product;
//   taps outside the image are zero AFTER the prologue (silu(D) != 0, so
//         padding before it would be wrong; conv.py:204-233);
//   acc = sum over taps and input channels of z * w, in f32;
//   out = acc * w_scale[co] (int8 weights only) + b[n, co], rounded to bf16
//         once.
//
// What bounds it on this card: the tensor cores at the large planes (the
// UNet's 64x64 convs are 15 GFLOP on 10 MB, the VAE's 512x512 convs 38
// GFLOP), but only once the prologue is out of their way: applied to every
// staged tap it is more special-function work than the products it feeds.
// At the small planes (16x16, 8x8: M = 512, 128 output pixels) the weights
// are the larger stream (29 MB at 1280 -> 1280) and the output has far fewer
// tiles than the card has SMs.
//
// What the design does about it. Two kernels, chosen by the wrapper's static
// rule (sdtpu_torch/ops/conv.py:plan_conv), which this file checks.
//
//  * The slab kernel (conv_slab_kernel), the TPU kernel's own idea (a padded
//    plane chunk staged once, normalised once in fast memory, the taps as
//    shifted products over it), for Cin % 64 == 0 and planes whose rows tile
//    128 pixels (W divides 128 or is a multiple of it). A block owns 128
//    consecutive output pixels, 64 a warpgroup, and BN = 128 or 160 output
//    channels, and walks Cin in chunks of 64. For a chunk it stages, by
//    cp.async with zero-fill outside the image, the input rows those pixels'
//    taps touch, halo included (4 x 66 pixels at W = 64, 3 x 130 at W >= 128,
//    two whole 10 x 10 planes at 8 x 8), in rows of 144 bytes (ldmatrix
//    without bank conflicts), and applies the prologue to it in shared
//    memory ONCE, skipping the positions outside the image, with A and D of
//    the chunk staged beside it and SiLU as h + h * tanh(h), h = z / 2 (one
//    special-function operation a value). A tap is then an offset of the
//    rows ldmatrix names: each warp loads its m16k16 fragments of the
//    shifted slab and issues wgmma (m64nBNk16, bf16 in, f32 accumulate) with
//    A from registers and B, one tap's [BN][64] weight tile, K-major in
//    128-byte-swizzled shared memory. The weight tiles run in a ring of
//    their own, 3 steps ahead by cp.async straight into the swizzle (int8
//    weights arrive raw and the thread that copied a chunk widens it into
//    the swizzled tile with one byte permute and one sub.bf16x2 a pair; the
//    scale stays in the epilogue). The slab is double-buffered, and a third
//    warpgroup that multiplies nothing keeps it ahead: it issues the copy of
//    chunk c + 1 at chunk c's first tap, waits for it three taps later and
//    spreads its prologue over the remaining taps, so that the pass costs
//    the multiplying warpgroups neither issue slots in their step nor its
//    latency before the step's barrier (done by them, between a step's
//    products and the next barrier, it cost 30% at 64x64). A multiplying
//    warpgroup loads its fragments only while it
//    has no product in flight (registers written inside an open wgmma stage
//    make the compiler serialize the products); the step's barrier does not
//    wait for the products, so the two warpgroups drift apart and one's
//    fragment loads fall under the other's products. A 1x1 conv is the
//    same kernel with one tap: its slab chunk holds three 64-channel groups
//    of the block's 128 pixels, which take the taps' place.
//  * Where the output tiles would leave half the card idle (16x16, 8x8), the
//    grid's z axis takes runs of slab chunks, each block writes its f32
//    partial tile, and conv_sum_kernel sums them in a fixed order, applies
//    scale and bias and rounds once: no atomics, the same bytes every run.
//  * The output tile leaves through shared memory as whole 16-byte row
//    chunks, scale and bias applied in f32.
//  * The general kernel (conv_general_kernel) takes what the slab does not:
//    odd planes, Cin % 8 == 0. A GEMM tiled 128 x 128 x 32 over 8 warps in
//    mma.sync m16n8k16, A gathered per (pixel, tap) by cp.async in a 4-stage
//    ring, the prologue applied to every staged chunk before the step's one
//    barrier, split-K with a deterministic reduction by a tile's last block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

constexpr int PRO_NONE = 0, PRO_AFFINE = 1, PRO_SILU = 2;
constexpr int MAX_DEVICES = 64;
constexpr size_t SMEM_CAP = 227 * 1024;   // a block's shared memory on sm_90

// ---------------------------------------------------------------------------
// the general kernel
// ---------------------------------------------------------------------------

constexpr int BM = 128;          // output pixels per block
constexpr int BN = 128;          // output channels per block
constexpr int BK = 32;           // reduction depth per stage
constexpr int STAGES = 4;        // shared-memory pipeline depth
constexpr int THREADS = 256;     // 8 warps: 2 along M x 4 along N
constexpr int LDS = BK + 8;      // padded shared row: conflict-free fragments

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct ConvArgs {
  const __nv_bfloat16* x;   // [n, h, w, cin]
  const void* wt;           // [cout][ks][ks][cin], bf16 or int8
  const float* bias;        // row n at bias + n * bias_stride, [cout]
  const float* pa;          // [n, cin] prologue scale (or null)
  const float* pd;          // [n, cin] prologue shift (or null)
  const float* wscale;      // [cout] int8 weight scale (or null)
  __nv_bfloat16* y;         // [n, h, w, cout]
  float* ws;                // [splits][n*h*w][cout] f32 partials (splits > 1)
  int* counters;            // one per output tile, 0 between launches
  int n, h, w, cin, cout, ks, bias_stride, splits;
  int ad_rows;              // samples of A, D staged in shared memory (0: none)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4],
                                            const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Asynchronous global -> shared copies; with pred false nothing is read and
// the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Two int8 (bytes `sel` picks out of `word`, each into the low byte of a
// 16-bit lane) to two bf16, exactly: 128 + (b & 0x7f) minus 128 or 256, one
// byte permute and one sub.bf16x2 (as csrc/matmul_int8w.cu widens).
__device__ __forceinline__ uint32_t widen2(uint32_t word, uint32_t sel) {
  const uint32_t lanes = __byte_perm(word, 0u, sel);
  const uint32_t hi = (lanes & 0x007f007fu) | 0x43004300u;
  const uint32_t lo = (lanes & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&hi),
                                   *reinterpret_cast<const __nv_bfloat162*>(&lo));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The rows one thread stages: rows srow and srow + 64 of the A and B
// tiles, reduction columns skc .. skc + 7; and the reduction step it
// issues next, as a cursor (k, its input channel and tap) that advances by
// addition, so the K loop divides nothing. Offsets are 32-bit: every
// tensor is under 2^31 elements.
struct Rows {
  int an[2], aoh[2], aow[2];   // sample and output pixel of each A row
  int abase[2];                // x offset of that pixel's channel 0
  int bbase[2];                // wt offset of the B row's output channel
  bool arow[2], brow[2];       // the A row is a pixel, the B row a channel
  int srow, skc;
  int k, ci, dy, dx;           // the cursor
};

// Issue the copies of the cursor's reduction step into one stage and
// advance the cursor. Returns what the prologue needs later about this
// thread's A chunks: their first input channel in the low bits, and one
// bit each (30, 31) for a chunk that is a tap inside the image.
template <bool Q8>
__device__ __forceinline__ uint32_t issue_stage(const ConvArgs& p, Rows& r,
                                                int K, __nv_bfloat16* sA,
                                                __nv_bfloat16* sB,
                                                int8_t* sQ) {
  const int pad = p.ks / 2;
  const bool kin = r.k < K;
  const int tap_off = ((r.dy - pad) * p.w + (r.dx - pad)) * p.cin + r.ci;
  uint32_t info = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r.srow + i * 64;
    const int ih = r.aoh[i] + r.dy - pad, iw = r.aow[i] + r.dx - pad;
    // a tap outside the image (or past M or K) is the conv's zero padding
    const bool in = r.arow[i] && kin && ih >= 0 && ih < p.h && iw >= 0 &&
                    iw < p.w;
    if (in) info |= (uint32_t)r.ci | (1u << (30 + i));
    cp_async16(sA + row * LDS + r.skc, in ? p.x + (r.abase[i] + tap_off) : p.x,
               in);
    const bool bin = r.brow[i] && kin;
    if (Q8)
      cp_async8(sQ + row * BK + r.skc,
                bin ? static_cast<const int8_t*>(p.wt) + (r.bbase[i] + r.k)
                    : p.wt,
                bin);
    else
      cp_async16(sB + row * LDS + r.skc,
                 bin ? static_cast<const __nv_bfloat16*>(p.wt) +
                           (r.bbase[i] + r.k)
                     : p.wt,
                 bin);
  }
  r.k += BK;
  r.ci += BK;
  while (r.ci >= p.cin) {
    r.ci -= p.cin;
    if (++r.dx == p.ks) {
      r.dx = 0;
      ++r.dy;
    }
  }
  return info;
}

// A[n, ci..ci+7] or D[n, ci..ci+7]: from the block's shared copy when it
// holds the block's samples (ad_rows > 0), else from device memory.
__device__ __forceinline__ void load8(float* v, const float* smem_ad,
                                      const float* global, int sl, int n,
                                      int ci, int cin, int ad_rows) {
  const float* src = ad_rows > 0 ? smem_ad + (long long)sl * cin + ci
                                 : global + (long long)n * cin + ci;
  const float4 lo = *reinterpret_cast<const float4*>(src);
  const float4 hi = *reinterpret_cast<const float4*>(src + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// In shared memory, on the chunks this thread copied for a landed stage
// (`info` from issue_stage): the prologue on the A taps inside the image
// (the zero padding stays zero: silu(D) != 0), and int8 weights widened to
// bf16.
template <int PRO, bool Q8>
__device__ __forceinline__ void transform_stage(
    const ConvArgs& p, const Rows& r, uint32_t info, const float* sAD,
    int ad_rows, int n_lo, __nv_bfloat16* sA, __nv_bfloat16* sB,
    const int8_t* sQ) {
  const int ci = (int)(info & 0x3fffffffu);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r.srow + i * 64;
    if (PRO != PRO_NONE && (info >> (30 + i)) & 1u) {
      float av[8], dv[8];
      const int sl = r.an[i] - n_lo;
      load8(av, sAD, p.pa, sl, r.an[i], ci, p.cin, ad_rows);
      load8(dv, sAD + (long long)ad_rows * p.cin, p.pd, sl, r.an[i], ci,
            p.cin, ad_rows);
      uint4* slot = reinterpret_cast<uint4*>(sA + row * LDS + r.skc);
      uint4 va = *slot;
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&va);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 v = __bfloat1622float2(h2[j]);
        float z0 = v.x * av[2 * j] + dv[2 * j];
        float z1 = v.y * av[2 * j + 1] + dv[2 * j + 1];
        if (PRO == PRO_SILU) {
          z0 = __fdividef(z0, 1.f + __expf(-z0));
          z1 = __fdividef(z1, 1.f + __expf(-z1));
        }
        h2[j] = __floats2bfloat162_rn(z0, z1);
      }
      *slot = va;
    }
    if (Q8) {
      const uint2 q = *reinterpret_cast<const uint2*>(sQ + row * BK + r.skc);
      uint4 vb;
      vb.x = widen2(q.x, 0x4140);
      vb.y = widen2(q.x, 0x4342);
      vb.z = widen2(q.y, 0x4140);
      vb.w = widen2(q.y, 0x4342);
      *reinterpret_cast<uint4*>(sB + row * LDS + r.skc) = vb;
    }
  }
}

// Dynamic shared memory of one block: STAGES A and B tiles, the raw int8
// B tiles for int8 weights, and the prologue's A and D for ad_rows samples.
__host__ __device__ constexpr size_t tiles_bytes(bool q8) {
  return (size_t)STAGES * (BM + BN) * LDS * sizeof(__nv_bfloat16) +
         (q8 ? (size_t)STAGES * BN * BK : 0);
}

constexpr size_t MAX_SMEM = 200 * 1024;

// grid: (ceil(M / BM), ceil(cout / BN), splits), M = n * h * w. With
// splits > 1 each block takes an even share of the K loop and writes its
// partial tile to ws; the last block of a tile to arrive (a counter per
// tile) sums the partials in split order, so the result does not depend on
// which block came last, and runs the epilogue.
template <int PRO, bool Q8>
__global__ void __launch_bounds__(THREADS) conv_general_kernel(const ConvArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + STAGES * BM * LDS;
  int8_t* sQ = reinterpret_cast<int8_t*>(sB + STAGES * BN * LDS);
  float* sAD = reinterpret_cast<float*>(smem + tiles_bytes(Q8));
  __shared__ uint32_t tap_info[STAGES][THREADS];
  __shared__ int last_split;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int hw = p.h * p.w;
  const int M = p.n * hw;
  const int K = p.ks * p.ks * p.cin;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // the rows this thread stages keep their pixel coordinates for the
  // whole K loop
  Rows r;
  r.srow = tid / 4;
  r.skc = (tid % 4) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + r.srow + i * 64;
    r.arow[i] = m < M;
    const int mm = r.arow[i] ? m : 0;
    r.an[i] = mm / hw;
    const int rem = mm - r.an[i] * hw;
    r.aoh[i] = rem / p.w;
    r.aow[i] = rem - r.aoh[i] * p.w;
    r.abase[i] = mm * p.cin;
    const int co = n0 + r.srow + i * 64;
    r.brow[i] = co < p.cout;
    r.bbase[i] = r.brow[i] ? co * K : 0;
  }

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int nk = (K + BK - 1) / BK;
  const int kb0 = (int)((long long)nk * blockIdx.z / p.splits);
  const int kb1 = (int)((long long)nk * (blockIdx.z + 1) / p.splits);
  const int steps = kb1 - kb0;
  r.k = kb0 * BK + r.skc;
  const int tap = r.k / p.cin;
  r.ci = r.k - tap * p.cin;
  r.dy = tap / p.ks;
  r.dx = tap - r.dy * p.ks;

  // STAGES - 1 reduction steps in flight ahead of the one being multiplied
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps)
      tap_info[s][tid] = issue_stage<Q8>(p, r, K, sA + s * BM * LDS,
                                         sB + s * BN * LDS, sQ + s * BN * BK);
    cp_async_commit();
  }
  // the prologue's A and D of the block's samples, staged once
  const int n_lo = m0 / hw;
  if (PRO != PRO_NONE && p.ad_rows > 0) {
    const int rows = min(p.ad_rows, p.n - n_lo);
    const int n4 = rows * p.cin / 4;
    float4* dst = reinterpret_cast<float4*>(sAD);
    const float4* a4 = reinterpret_cast<const float4*>(p.pa + (long long)n_lo * p.cin);
    const float4* d4 = reinterpret_cast<const float4*>(p.pd + (long long)n_lo * p.cin);
    const int stride4 = p.ad_rows * p.cin / 4;
    for (int j = tid; j < n4; j += THREADS) {
      dst[j] = a4[j];
      dst[stride4 + j] = d4[j];
    }
    __syncthreads();
  }

  for (int i = 0; i < steps; ++i) {
    const int slot = i % STAGES;
    __nv_bfloat16* A = sA + slot * BM * LDS;
    __nv_bfloat16* B = sB + slot * BN * LDS;
    cp_async_wait<STAGES - 2>();   // this thread's copies of step i landed
    // each thread transforms the chunks it copied itself, so no barrier is
    // needed first: its loads and arithmetic overlap the tensor-core work
    // still in flight from step i - 1, in this warp and the others
    if (PRO != PRO_NONE || Q8)
      transform_stage<PRO, Q8>(p, r, tap_info[slot][tid], sAD, p.ad_rows, n_lo,
                               A, B, sQ + slot * BN * BK);
    __syncthreads();   // step i is ready in full; step i - 1 is consumed
    // refill the stage that step i - 1 used
    const int next = i + STAGES - 1;
    if (next < steps) {
      const int ns = next % STAGES;
      tap_info[ns][tid] = issue_stage<Q8>(p, r, K, sA + ns * BM * LDS,
                                          sB + ns * BN * LDS,
                                          sQ + ns * BN * BK);
    }
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], A + (wm + mt * 16 + (lane % 16)) * LDS + kk +
                                (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t q[4];
        ldmatrix_x4(q, B + (wn + np * 16 + (lane % 8) + (lane / 16) * 8) * LDS +
                           kk + ((lane / 8) % 2) * 8);
        bfr[2 * np][0] = q[0];
        bfr[2 * np][1] = q[1];
        bfr[2 * np + 1][0] = q[2];
        bfr[2 * np + 1][1] = q[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_16816(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
    }
  }
  cp_async_wait<0>();

  if (p.splits > 1) {
    const long long mc = (long long)M * p.cout;
    float* part = p.ws + blockIdx.z * mc;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mt * 16 + g + half * 8;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + wn + nt * 8 + tg * 2 + e;
            if (row < M && col < p.cout)
              part[(long long)row * p.cout + col] = acc[mt][nt][half * 2 + e];
          }
      }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* counter = p.counters + blockIdx.y * gridDim.x + blockIdx.x;
      last_split = atomicAdd(counter, 1) == p.splits - 1;
      if (last_split) *counter = 0;   // every split has arrived: reset
    }
    __syncthreads();
    if (!last_split) return;
    __threadfence();
    // the tile's partials summed in split order, one output element per
    // thread and step (coalesced, independent of the accumulator registers)
#pragma unroll 2
    for (int idx = tid; idx < BM * BN; idx += THREADS) {
      const int row = m0 + idx / BN, col = n0 + idx % BN;
      if (row >= M || col >= p.cout) continue;
      const float* src = p.ws + (long long)row * p.cout + col;
      float v = __ldcg(src);
#pragma unroll 4
      for (int s = 1; s < p.splits; ++s) v += __ldcg(src + s * mc);
      if (Q8) v *= p.wscale[col];
      v += p.bias[(long long)(row / hw) * p.bias_stride + col];
      p.y[(long long)row * p.cout + col] = __float2bfloat16_rn(v);
    }
    return;
  }

  // epilogue: scale (int8 weights), per-sample bias, one rounding to bf16
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + mt * 16 + g + half * 8;
      if (row >= M) continue;
      const float* brow_p = p.bias + (long long)(row / hw) * p.bias_stride;
      __nv_bfloat16* yrow = p.y + (long long)row * p.cout;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn + nt * 8 + tg * 2;
        if (col >= p.cout) continue;
        float v0 = acc[mt][nt][half * 2];
        float v1 = acc[mt][nt][half * 2 + 1];
        if (Q8) v0 *= p.wscale[col];
        v0 += brow_p[col];
        if (col + 1 < p.cout) {
          if (Q8) v1 *= p.wscale[col + 1];
          v1 += brow_p[col + 1];
          if ((p.cout & 1) == 0) {
            *reinterpret_cast<__nv_bfloat162*>(yrow + col) =
                __floats2bfloat162_rn(v0, v1);
            continue;
          }
          yrow[col + 1] = __float2bfloat16_rn(v1);
        }
        yrow[col] = __float2bfloat16_rn(v0);
      }
    }
  }
}

template <int PRO, bool Q8>
cudaError_t launch_general(ConvArgs a, cudaStream_t stream) {
  // a tile of BM rows spans at most this many samples; their A and D go to
  // shared memory when they fit, else the prologue reads device memory
  const int hw = a.h * a.w;
  const int rows = min(a.n, (BM - 1) / hw + 2);
  const size_t ad = 2 * (size_t)rows * a.cin * sizeof(float);
  a.ad_rows = PRO != PRO_NONE && tiles_bytes(Q8) + ad <= MAX_SMEM ? rows : 0;
  const size_t smem = tiles_bytes(Q8) + (a.ad_rows > 0 ? ad : 0);
  // raise the kernel's shared-memory cap on this device to the most this
  // instantiation has needed there, once (not again inside a graph capture)
  static size_t allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > allowed[dev]) {
    err = cudaFuncSetAttribute(conv_general_kernel<PRO, Q8>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    allowed[dev] = smem;
  }
  const long long m = (long long)a.n * a.h * a.w;
  const dim3 grid((unsigned)((m + BM - 1) / BM), (a.cout + BN - 1) / BN,
                  a.splits);
  conv_general_kernel<PRO, Q8><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the slab kernel
// ---------------------------------------------------------------------------

using wgmma::Wgmma;

constexpr int SLAB_PITCH = 144;    // bytes of a slab row: 64 bf16 and 16 spare
constexpr int SLAB_MAX_ROWS = 400; // rows of one 64-channel group of a slab
constexpr int SLAB_MAX_SAMPLES = 8;
constexpr int SLAB_CONSUMERS = 256;  // two warpgroups that multiply
constexpr int SLAB_THREADS = 384;    // and one that stages and normalises

struct SlabArgs {
  ConvArgs c;
  int prologue;           // PRO_*
  int ph, pw, ns;         // the block's pixels: ns samples x ph rows x pw
  int rpg;                // slab rows of one group: ns (ph + 2 pad)(pw + 2 pad)
  int chunks_per_split;   // slab chunks a block of the grid's z axis takes
};

// The constants that follow from the kernel size. A slab chunk holds G
// groups of 64 input channels and is multiplied in up to T steps, one weight
// tile each: the 9 taps of its one group (3x3), or its 3 groups (1x1). The
// weight copies run D steps ahead.
template <int KS>
struct Shape {
  static constexpr int G = KS == 3 ? 1 : 3;
  static constexpr int T = KS == 3 ? 9 : 3;
  static constexpr int D = KS == 3 ? 3 : 2;
};

// Shared memory of a block, from a 1024-byte boundary: the weight tiles wgmma
// reads (D + 2 of bf16 weights; 3 widened ones and D raw stages of int8),
// two slabs, two stages of the chunk's A and D, the table of the slab rows'
// pixels, the block's bias rows and scales.
struct SlabSmem {
  uint32_t tiles, raw, slab, ad, table, bias, scale, total;
};

__host__ __device__ inline SlabSmem slab_smem(int bn, bool q8, int ks, int rpg,
                                              int ns) {
  const int g = ks == 3 ? 1 : 3, d = ks == 3 ? 3 : 2;
  SlabSmem s;
  s.tiles = 0;
  s.raw = (q8 ? 3 : d + 2) * bn * 128;
  s.slab = s.raw + (q8 ? d * bn * 64 : 0);
  s.ad = s.slab + 2 * g * rpg * SLAB_PITCH;
  s.table = s.ad + 2 * (2 * ns * g * 64 * 4);
  s.bias = s.table + ((rpg * 4 + 15) & ~15);
  s.scale = s.bias + ns * bn * 4;
  s.total = 1024 + s.scale + bn * 4;
  return s;
}

__device__ __forceinline__ void cp_async16_to(uint32_t dst, const void* src,
                                              bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// The slab kernel's block-wide barrier, with its thread count spelled out:
// the helper and the multiplying warpgroups reach it from different loops.
__device__ __forceinline__ void slab_barrier() {
  asm volatile("bar.sync 0, %0;\n" ::"n"(SLAB_THREADS) : "memory");
}

__device__ __forceinline__ void cp_async_commit_mem() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_mem() {
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

__device__ __forceinline__ void ldmatrix_x4_at(uint32_t (&r)[4],
                                               uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// silu(z) = z / (1 + exp(-z)) = h + h tanh(h), h = z / 2: one
// special-function operation
__device__ __forceinline__ float silu_tanh(float z) {
  const float h = 0.5f * z;
  float t;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(t) : "f"(h));
  return fmaf(h, t, h);
}

// grid: (ceil(M / 128), ceil(cout / BN), splits), M = n h w; 384 threads:
// warpgroups 0 and 1 copy the weights and multiply, 64 pixels each;
// warpgroup 2, the helper, copies the slabs and applies the prologue.
template <int BN, bool Q8, int KS>
__global__ void __launch_bounds__(SLAB_THREADS)
conv_slab_kernel(const SlabArgs a) {
  using S = Shape<KS>;
  constexpr int G = S::G, T = S::T, D = S::D;
  constexpr int PAD = KS / 2;
  constexpr int NT = Q8 ? 3 : D + 2;     // weight tiles wgmma reads
  constexpr int NACC = BN / 2;
  constexpr int W_ITERS = ((Q8 ? BN * 4 : BN * 8) + 255) / 256;
  const ConvArgs& p = a.c;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_addr = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  unsigned char* gen = smem_raw + (base - raw_addr);
  const SlabSmem L = slab_smem(BN, Q8, KS, a.rpg, a.ns);
  const uint32_t slab_bytes = G * a.rpg * SLAB_PITCH;
  const uint32_t ad_floats = 2 * a.ns * G * 64;   // A then D of one stage
  int* table = reinterpret_cast<int*>(gen + L.table);
  float* s_bias = reinterpret_cast<float*>(gen + L.bias);
  float* s_scale = reinterpret_cast<float*>(gen + L.scale);

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  // from a shuffle, so that the compiler sees the roles as warp-uniform
  const bool helper = __shfl_sync(0xffffffffu, tid / 128, 0) == 2;
  const int g = lane / 4, tg = lane % 4;
  const int hw = p.h * p.w;
  const int M = p.n * hw;
  const int K = KS * KS * p.cin;
  const int m0 = blockIdx.x * 128, n0 = blockIdx.y * BN;
  // the block's first sample and the pixel its patch starts at
  const int nb0 = m0 / hw;
  const int oh0 = (m0 - nb0 * hw) / p.w;
  const int ow0 = m0 - nb0 * hw - oh0 * p.w;
  const int sw = a.pw + 2 * PAD;             // slab row of pixels
  const int plane = sw * (a.ph + 2 * PAD);   // slab rows of one sample

  // the pixel each slab row holds, as (pixel index << 3) | local sample, or
  // -1 outside the image or past the last sample: the conv's zero padding
  for (int q = tid; q < a.rpg; q += SLAB_THREADS) {
    const int s = q / plane, r2 = q - s * plane;
    const int r = r2 / sw, c = r2 - r * sw;
    const int n = nb0 + s, ih = oh0 - PAD + r, iw = ow0 - PAD + c;
    const bool in = n < p.n && ih >= 0 && ih < p.h && iw >= 0 && iw < p.w;
    table[q] = in ? ((((n * p.h + ih) * p.w + iw) << 3) | s) : -1;
  }
  // the block's columns of each of its samples' bias rows, and of the scale
  for (int i = tid; i < a.ns * BN; i += SLAB_THREADS) {
    const int s = i / BN, col = i - s * BN;
    const bool in = nb0 + s < p.n && n0 + col < p.cout;
    s_bias[i] =
        in ? p.bias[(long long)(nb0 + s) * p.bias_stride + n0 + col] : 0.f;
  }
  if (tid < BN)
    s_scale[tid] = Q8 && n0 + tid < p.cout ? p.wscale[n0 + tid] : 1.f;

  // this block's run of slab chunks, and its steps
  const int groups_all = p.cin / 64;
  const int chunks_all = (groups_all + G - 1) / G;
  const int c_begin = blockIdx.z * a.chunks_per_split;
  const int c_end = min(c_begin + a.chunks_per_split, chunks_all);
  const int nsteps =
      KS == 3 ? (c_end - c_begin) * T : min(c_end * G, groups_all) - c_begin * G;
  auto steps_in = [&](int c) {
    return KS == 3 ? T : min(G, groups_all - c * G);
  };

  // a multiplying thread's copy slots of a weight tile: 16-byte chunk tid %
  // 8 (8 bf16) of rows tid / 8 + 32 j, or chunk tid % 4 (16 int8) of rows tid
  // / 4 + 64 j
  constexpr int W_CPR = Q8 ? 4 : 8, W_RSTEP = 256 / W_CPR;
  const int w_cc = tid % W_CPR, w_r = tid / W_CPR;
  int w_src[W_ITERS];      // element offset of the slot at k = 0, -1: none
#pragma unroll
  for (int j = 0; j < W_ITERS; ++j) {
    const int r = w_r + W_RSTEP * j;
    w_src[j] = r < BN && n0 + r < p.cout
                   ? (n0 + r) * K + w_cc * (Q8 ? 16 : 8)
                   : -1;
  }
  const uint32_t w_dst =
      Q8 ? w_r * 64 + w_cc * 16 : w_r * 128 + ((w_cc ^ (w_r & 7)) << 4);
  const uint32_t b_lo = w_r * 128 + (((2 * w_cc) ^ (w_r & 7)) << 4);
  const uint32_t b_hi = w_r * 128 + (((2 * w_cc + 1) ^ (w_r & 7)) << 4);

  // the weight tile of step (chunk c, step t of it): its first K index
  auto copy_weights = [&](int c, int t, int stage) {
    const int k0 = KS == 3 ? t * p.cin + c * 64 : (c * G + t) * 64;
    const uint32_t dst = base + (Q8 ? L.raw + stage * (BN * 64)
                                    : L.tiles + stage * (BN * 128)) + w_dst;
#pragma unroll
    for (int j = 0; j < W_ITERS; ++j) {
      if (w_r + W_RSTEP * j < BN) {
        const bool in = w_src[j] >= 0;
        const void* src =
            !in ? p.wt
            : Q8 ? (const void*)(static_cast<const int8_t*>(p.wt) + w_src[j] + k0)
                 : (const void*)(static_cast<const __nv_bfloat16*>(p.wt) +
                                 w_src[j] + k0);
        cp_async16_to(dst + j * (W_RSTEP * (Q8 ? 64 : 128)), src, in);
      }
    }
  };

  // slab chunk c into buffer buf: every row's 64 channels of each group, and
  // the chunk's A and D of the block's samples; by the threads first, first
  // + stride, ...
  const int slots = G * a.rpg * 8;
  auto copy_slab = [&](int c, int buf, int first, int stride) {
    const uint32_t dst = base + L.slab + buf * slab_bytes;
    for (int slot = first; slot < slots; slot += stride) {
      const int row = slot >> 3, j = slot & 7;
      const int gq = G > 1 ? row / a.rpg : 0;
      const int e = table[row - gq * a.rpg];
      const int cb = (c * G + gq) * 64;
      const bool in = e >= 0 && cb < p.cin;
      cp_async16_to(dst + row * SLAB_PITCH + j * 16,
                    in ? p.x + ((long long)(e >> 3) * p.cin + cb + j * 8) : p.x,
                    in);
    }
    if (a.prologue != PRO_NONE) {
      const int per = a.ns * G * 16;     // 16-byte copies of A, then of D
      const uint32_t ad = base + L.ad + buf * (ad_floats * 4);
      for (int i = first; i < 2 * per; i += stride) {
        const int which = i / per, r = i - which * per;
        const int s = r / (G * 16), r2 = r - s * (G * 16);
        const int gq = r2 / 16, j = r2 - gq * 16;
        const int cb = (c * G + gq) * 64;
        const bool in = nb0 + s < p.n && cb < p.cin;
        const float* src = (which ? p.pd : p.pa) +
                           ((long long)(nb0 + s) * p.cin + cb + j * 4);
        cp_async16_to(ad + i * 16, in ? (const void*)src : (const void*)p.x,
                      in);
      }
    }
  };

  // the prologue on slots first + stride k, k in [k0, k1), in shared memory,
  // on the positions inside the image only: the zero padding stays zero
  auto transform = [&](int buf, int k0, int k1, int first, int stride) {
    unsigned char* slab = gen + L.slab + buf * slab_bytes;
    const float* ad = reinterpret_cast<const float*>(gen + L.ad) + buf * ad_floats;
    for (int k = k0; k < k1; ++k) {
      const int slot = first + stride * k;
      if (slot >= slots) break;
      const int row = slot >> 3, j = slot & 7;
      const int gq = G > 1 ? row / a.rpg : 0;
      const int e = table[row - gq * a.rpg];
      if (e < 0) continue;
      const int s = e & 7;
      const float* av = ad + (s * G + gq) * 64 + j * 8;
      const float* dv = av + a.ns * G * 64;
      const float4 a0 = *reinterpret_cast<const float4*>(av);
      const float4 a1 = *reinterpret_cast<const float4*>(av + 4);
      const float4 d0 = *reinterpret_cast<const float4*>(dv);
      const float4 d1 = *reinterpret_cast<const float4*>(dv + 4);
      const float aa[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float dd[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
      uint4* ptr = reinterpret_cast<uint4*>(slab + row * SLAB_PITCH + j * 16);
      uint4 v = *ptr;
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h2[i]);
        float z0 = f.x * aa[2 * i] + dd[2 * i];
        float z1 = f.y * aa[2 * i + 1] + dd[2 * i + 1];
        if (a.prologue == PRO_SILU) {
          z0 = silu_tanh(z0);
          z1 = silu_tanh(z1);
        }
        h2[i] = __floats2bfloat162_rn(z0, z1);
      }
      *ptr = v;
    }
  };
  // Slots a thread when the whole block shares a slab's prologue, and when
  // the helper warpgroup takes it alone; of the latter a step's share. A 1x1
  // conv leaves the pass one step (T - D), so there the whole block shares
  // every slab's, once the helper's copies are behind a barrier.
  constexpr bool SHARED = KS == 1;
  const int nslots_all = (slots + SLAB_THREADS - 1) / SLAB_THREADS;
  const int nslots = (slots + 127) / 128;
  const int sps = SHARED ? nslots_all : (nslots + T - D - 1) / (T - D);
  const int pro_first = SHARED ? tid : tid - SLAB_CONSUMERS;
  const int pro_stride = SHARED ? SLAB_THREADS : 128;

  __syncthreads();   // the table is written
  // the first slab is the whole block's work
  copy_slab(c_begin, 0, tid, SLAB_THREADS);
  cp_async_commit_mem();
  // the weight copies' cursor: the chunk and the step of it copied next
  int pc = c_begin, pt = 0;
#pragma unroll
  for (int s = 0; s < D; ++s) {
    if (s < nsteps && !helper) {
      copy_weights(pc, pt, s);
      if (++pt == steps_in(pc)) {
        pt = 0;
        ++pc;
      }
    }
    cp_async_commit_mem();
  }
  cp_async_wait_mem<D>();    // the first slab has landed
  __syncthreads();
  if (a.prologue != PRO_NONE) transform(0, 0, nslots_all, tid, SLAB_THREADS);

  // the slab row of this lane's fragment row, pixel wg 64 + warp 16 + lane %
  // 16 of the block, at tap (0, 0); a tap adds a row offset
  const int frag_p = wg * 64 + warp * 16 + (lane & 15);
  const int frag_s = frag_p / (a.ph * a.pw);
  const int frag_r = frag_p / a.pw - frag_s * a.ph;
  const int frag_c = frag_p - (frag_p / a.pw) * a.pw;
  const uint32_t frag_off =
      (frag_s * plane + frag_r * sw + frag_c) * SLAB_PITCH + (lane >> 4) * 16;

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  // the consumer's cursor, and the stages of step i: the weight tile in st,
  // raw int8 in sr; the copies of step i + D go to tile st_next (or to sr)
  int cc = c_begin, ct = 0, buf = 0;
  int st = 0, sr = 0, st_next = Q8 ? 0 : D % NT;
  if (helper) {
    // The helper warpgroup's whole loop (the roles never meet again: the
    // compiler serializes products it finds behind a divergent branch). The
    // next chunk's slab: copied at this chunk's first step into the buffer
    // the last chunk has left, waited for D steps later, and normalised, a
    // share a step, over the chunk's remaining steps, under the other
    // warpgroups' products; each barrier is the block's.
    for (int i = 0; i < nsteps; ++i) {
      const bool next = cc + 1 < c_end;
      if (ct == D && next) cp_async_wait_mem<0>();
      slab_barrier();
      if (ct == 0 && next) {
        copy_slab(cc + 1, buf ^ 1, tid - SLAB_CONSUMERS, 128);
        cp_async_commit_mem();
      }
      if (a.prologue != PRO_NONE && ct >= D && next)
        transform(buf ^ 1, (ct - D) * sps, (ct - D + 1) * sps, pro_first,
                  pro_stride);
      if (++ct == steps_in(cc)) {
        ct = 0;
        ++cc;
        buf ^= 1;
      }
    }
    return;
  }

  uint32_t frag[4][4];
  for (int i = 0; i < nsteps; ++i) {
    const uint32_t tile = base + L.tiles + st * (BN * 128);
    cp_async_wait_mem<D - 1>();   // this thread's copies of step i landed
    if (Q8) {
      // each thread widens the int8 chunks it copied itself: 16 int8 of a
      // row become the 16-byte chunks 2cc and 2cc + 1 of the swizzled row
      const uint32_t w_raw = base + L.raw + sr * (BN * 64) + w_dst;
#pragma unroll
      for (int j = 0; j < W_ITERS; ++j) {
        if (w_r + 64 * j < BN) {
          const uint4 q = ld_shared16(w_raw + j * (64 * 64));
          uint4 lo, hi;
          lo.x = widen2(q.x, 0x4140);
          lo.y = widen2(q.x, 0x4342);
          lo.z = widen2(q.y, 0x4140);
          lo.w = widen2(q.y, 0x4342);
          hi.x = widen2(q.z, 0x4140);
          hi.y = widen2(q.z, 0x4342);
          hi.z = widen2(q.w, 0x4140);
          hi.w = widen2(q.w, 0x4342);
          st_shared16(tile + b_lo + j * (64 * 128), lo);
          st_shared16(tile + b_hi + j * (64 * 128), hi);
        }
      }
    }
    wgmma::fence_async_proxy();
    // step i is ready in full; step i - 2 is consumed by both warpgroups
    // (each waited for it before its products of step i - 1), while the
    // products of step i - 1 may still run: the barrier does not wait for
    // them, so the warpgroups drift apart and one's fragment loads fall
    // under the other's products
    slab_barrier();
    if (i + D < nsteps) {
      copy_weights(pc, pt, Q8 ? sr : st_next);
      if (++pt == steps_in(pc)) {
        pt = 0;
        ++pc;
      }
    }
    cp_async_commit_mem();

    // the fragment registers are written only while this warpgroup has no
    // product in flight (the compiler serializes the products otherwise)
    wgmma::wait<0>();
    const uint32_t rows = KS == 3 ? (ct / 3) * sw + ct % 3 : ct * a.rpg;
    const uint32_t a_addr =
        base + L.slab + buf * slab_bytes + rows * SLAB_PITCH + frag_off;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldmatrix_x4_at(frag[kk], a_addr + kk * 32);
    const uint64_t b_desc = wgmma::descriptor(tile, 16, 1024);
    wgmma::pin(acc);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<BN>::rs(acc, frag[kk], b_desc + ((kk * 32) >> 4), 1);
    wgmma::commit();
    if (SHARED && a.prologue != PRO_NONE && ct >= D && cc + 1 < c_end)
      transform(buf ^ 1, (ct - D) * sps, (ct - D + 1) * sps, pro_first,
                pro_stride);

    if (++ct == steps_in(cc)) {
      ct = 0;
      ++cc;
      buf ^= 1;
    }
    st = st + 1 == NT ? 0 : st + 1;
    st_next = st_next + 1 == NT ? 0 : st_next + 1;
    sr = sr + 1 == D ? 0 : sr + 1;
  }
  wgmma::wait<0>();
  wgmma::pin(acc);
  cp_async_wait_mem<0>();

  const int prow = wg * 64 + warp * 16 + g;   // and prow + 8
  if (p.ws != nullptr) {
    // this block's share of the K sum, f32, for conv_sum_kernel
    float* part = p.ws + (long long)blockIdx.z * M * p.cout;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + prow + half * 8;
      if (row >= M) continue;
      float* dst = part + (long long)row * p.cout;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + j * 8 + tg * 2;
        if (col >= p.cout) continue;
        const float v0 = acc[4 * j + half * 2], v1 = acc[4 * j + half * 2 + 1];
        if (col + 1 < p.cout && (p.cout & 1) == 0) {
          *reinterpret_cast<float2*>(dst + col) = make_float2(v0, v1);
        } else {
          dst[col] = v0;
          if (col + 1 < p.cout) dst[col + 1] = v1;
        }
      }
    }
    return;
  }
  // epilogue through shared memory: scale (1 for bf16 weights), the row's
  // sample's bias, one rounding to bf16; the warpgroup's 64 x BN tile staged
  // in rows padded by 16 bytes, then written out as whole 16-byte chunks, a
  // row's chunks by neighbouring threads (element by element where cout % 8
  // != 0 leaves the rows unaligned)
  constexpr int LDC = BN * 2 + 16;
  // both multiplying warpgroups are done reading the tiles
  asm volatile("bar.sync 3, %0;\n" ::"n"(SLAB_CONSUMERS) : "memory");
  const uint32_t sC = base + wg * (64 * LDC);
  const int t = tid % 128;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    // a block of several samples holds whole planes of ph x pw pixels
    const float* brow =
        s_bias + (a.ns > 1 ? (prow + half * 8) / (a.ph * a.pw) : 0) * BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = j * 8 + tg * 2;
      const float v0 = acc[4 * j + half * 2] * s_scale[c] + brow[c];
      const float v1 = acc[4 * j + half * 2 + 1] * s_scale[c + 1] + brow[c + 1];
      const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                       sC + (warp * 16 + g + half * 8) * LDC + c * 2),
                   "r"(*reinterpret_cast<const uint32_t*>(&v))
                   : "memory");
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  constexpr int CPR = BN / 8;   // 16-byte chunks a row
  if (p.cout % 8 == 0) {
#pragma unroll 4
    for (int c = t; c < 64 * CPR; c += 128) {
      const int r = c / CPR, cc8 = c % CPR;
      const int row = m0 + wg * 64 + r, col = n0 + cc8 * 8;
      if (row < M && col < p.cout)
        *reinterpret_cast<uint4*>(p.y + (long long)row * p.cout + col) =
            ld_shared16(sC + r * LDC + cc8 * 16);
    }
    return;
  }
  for (int c = t; c < 64 * CPR; c += 128) {
    const int r = c / CPR, cc8 = c % CPR;
    const int row = m0 + wg * 64 + r, col = n0 + cc8 * 8;
    if (row >= M || col >= p.cout) continue;
    const uint4 v = ld_shared16(sC + r * LDC + cc8 * 16);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
    __nv_bfloat16* dst = p.y + (long long)row * p.cout + col;
    for (int i = 0; i < 8 && col + i < p.cout; ++i) dst[i] = e[i];
  }
}

// Second pass of the slab kernel's split: y = (sum over splits, in order) *
// w_scale + the sample's bias. V elements a thread: 4 (16-byte reads) where
// cout % 4 == 0, else 1.
template <int V>
__global__ void __launch_bounds__(256)
conv_sum_kernel(const ConvArgs p, int splits) {
  const long long total = (long long)p.n * p.h * p.w * p.cout;
  const long long e = ((long long)blockIdx.x * 256 + threadIdx.x) * V;
  if (e >= total) return;
  const int col = (int)(e % p.cout);
  const long long row = e / p.cout;
  float sum[V];
#pragma unroll
  for (int i = 0; i < V; ++i) sum[i] = 0.f;
  for (int s = 0; s < splits; ++s) {
    if (V == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p.ws + s * total + e);
      sum[0] += v.x;
      sum[V > 1 ? 1 : 0] += v.y;
      sum[V > 2 ? 2 : 0] += v.z;
      sum[V > 3 ? 3 : 0] += v.w;
    } else {
      sum[0] += p.ws[s * total + e];
    }
  }
  const float* bias = p.bias + (row / (p.h * p.w)) * p.bias_stride + col;
  __nv_bfloat16 out[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float v = sum[i];
    if (p.wscale != nullptr) v *= p.wscale[col + i];
    out[i] = __float2bfloat16_rn(v + bias[i]);
  }
  if (V == 4)
    *reinterpret_cast<uint2*>(p.y + e) = *reinterpret_cast<const uint2*>(out);
  else
    p.y[e] = out[0];
}

template <int BN, bool Q8, int KS>
cudaError_t launch_slab(const SlabArgs& a, cudaStream_t stream) {
  const size_t smem = slab_smem(BN, Q8, KS, a.rpg, a.ns).total;
  // raise the kernel's shared-memory cap on this device to the most this
  // instantiation has needed there (not again inside a graph capture)
  static size_t allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > allowed[dev]) {
    err = cudaFuncSetAttribute(conv_slab_kernel<BN, Q8, KS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    allowed[dev] = smem;
  }
  const long long m = (long long)a.c.n * a.c.h * a.c.w;
  const dim3 grid((unsigned)((m + 127) / 128), (a.c.cout + BN - 1) / BN,
                  a.c.splits);
  conv_slab_kernel<BN, Q8, KS><<<grid, SLAB_THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.c.splits == 1) return err;
  const long long total = m * a.c.cout;
  if (a.c.cout % 4 == 0)
    conv_sum_kernel<4><<<(unsigned)((total / 4 + 255) / 256), 256, 0, stream>>>(
        a.c, a.c.splits);
  else
    conv_sum_kernel<1><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        a.c, a.c.splits);
  return cudaGetLastError();
}

template <int BN, bool Q8>
cudaError_t launch_slab_ks(const SlabArgs& a, cudaStream_t stream) {
  return a.c.ks == 3 ? launch_slab<BN, Q8, 3>(a, stream)
                     : launch_slab<BN, Q8, 1>(a, stream);
}

template <int PRO>
cudaError_t launch_general_q(const ConvArgs& a, bool q8, cudaStream_t stream) {
  return q8 ? launch_general<PRO, true>(a, stream)
            : launch_general<PRO, false>(a, stream);
}

}  // namespace

// x: [n, h, w, cin] bf16; wt: [cout][ks][ks][cin], bf16, or int8 with
// w_scale [cout] f32; bias: f32, row s at bias + s * bias_stride
// (bias_stride 0 for one bias row, cout for one per sample); a, d: [n, cin]
// f32 when prologue is 1 (affine) or 2 (affine + SiLU); y: [n, h, w, cout]
// bf16. All contiguous, x, wt, a and d 16-byte aligned. ks 3 pads by 1, ks
// 1 by 0; stride 1; cin % 8 == 0; every tensor under 2^31 elements.
//
// The rest is the wrapper's plan (ops/conv.py:plan_conv), checked here.
// design 0, the general kernel: splits > 1 splits the K loop over blocks; ws
// then holds splits * n*h*w * cout f32 and counters one int per output tile,
// all 0 (the kernel leaves them 0); bn, chunks, ph, pw and ns are not read.
// design 1, the slab kernel: cin % 64 == 0; a block's 128 pixels are ns
// samples of ph rows of pw pixels (pw = min(w, 128) dividing w; ph rows
// dividing h, or ns whole planes); bn = 128 or 160 output channels a block;
// the slab chunks (64 input channels for ks 3, 192 for ks 1) cut into
// `splits` runs of `chunks`, every run non-empty; ws holds the partials
// where splits > 1, else it is null; counters is not read.
// Returns a cudaError_t (0 on success).
extern "C" int sdtpu_conv_gn_silu(const void* x, const void* wt,
                                  const void* bias, const void* a,
                                  const void* d, const void* w_scale, void* y,
                                  void* ws, void* counters, int n, int h,
                                  int w, int cin, int cout, int ks,
                                  int bias_stride, int prologue, int quantized,
                                  int design, int bn, int splits, int chunks,
                                  int ph, int pw, int ns, void* stream) {
  const long long big = 1LL << 31;
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || cin % 8 != 0 ||
      (ks != 1 && ks != 3) || prologue < PRO_NONE || prologue > PRO_SILU ||
      (prologue != PRO_NONE && (a == nullptr || d == nullptr)) ||
      (quantized && w_scale == nullptr) || bias == nullptr ||
      (long long)n * h * w * cin >= big || (long long)n * h * w * cout >= big ||
      (long long)cout * ks * ks * cin >= big || (cout + BN - 1) / BN > 65535 ||
      splits < 1 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const ConvArgs args{static_cast<const __nv_bfloat16*>(x), wt,
                      static_cast<const float*>(bias),
                      static_cast<const float*>(a), static_cast<const float*>(d),
                      quantized ? static_cast<const float*>(w_scale) : nullptr,
                      static_cast<__nv_bfloat16*>(y), static_cast<float*>(ws),
                      static_cast<int*>(counters), n, h, w, cin, cout, ks,
                      bias_stride, splits, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool q8 = quantized != 0;
  if (design == 0) {
    if (splits > 64 || (splits > 1 && counters == nullptr))
      return (int)cudaErrorInvalidValue;
    if (prologue == PRO_SILU) return (int)launch_general_q<PRO_SILU>(args, q8, s);
    if (prologue == PRO_AFFINE)
      return (int)launch_general_q<PRO_AFFINE>(args, q8, s);
    return (int)launch_general_q<PRO_NONE>(args, q8, s);
  }
  const int pad = ks / 2, groups = ks == 3 ? 1 : 3;
  if (design != 1 || cin % 64 != 0 || (bn != 128 && bn != 160) || ph < 1 ||
      pw < 1 || ns < 1 || ns > SLAB_MAX_SAMPLES || ns * ph * pw != 128 ||
      pw != (w < 128 ? w : 128) || w % pw != 0 ||
      (ns == 1 ? h % ph != 0 : ph != h) || (ws != nullptr) != (splits > 1) ||
      chunks < 1 || splits > 65535 || (long long)splits * n * h * w * cout >= big)
    return (int)cudaErrorInvalidValue;
  const int rpg = ns * (ph + 2 * pad) * (pw + 2 * pad);
  const int chunks_all = (cin / 64 + groups - 1) / groups;
  if (rpg > SLAB_MAX_ROWS || (long long)(splits - 1) * chunks >= chunks_all ||
      (long long)splits * chunks < chunks_all ||
      slab_smem(bn, q8, ks, rpg, ns).total > SMEM_CAP)
    return (int)cudaErrorInvalidValue;
  const SlabArgs sa{args, prologue, ph, pw, ns, rpg, chunks};
  if (bn == 160)
    return (int)(q8 ? launch_slab_ks<160, true>(sa, s)
                    : launch_slab_ks<160, false>(sa, s));
  return (int)(q8 ? launch_slab_ks<128, true>(sa, s)
                  : launch_slab_ks<128, false>(sa, s));
}
