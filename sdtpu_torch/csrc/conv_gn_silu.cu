// Implicit-GEMM 3x3 / 1x1 convolution with a GroupNorm(+SiLU) prologue and
// a per-sample bias epilogue, for Hopper (sm_90a); bf16 activations, bf16
// or int8 weights, bf16 out.
//
// Replaces sdtpu/ops/conv.py:_conv_kernel and _conv_kernel_b, the two Pallas
// TPU kernels of the JAX package (their two grid orders are a TPU VMEM
// artefact; one kernel takes both here). It computes the same function:
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
// GFLOP), and the number of output tiles at the small ones: the 8x8 level
// has M = 128 output pixels, one row of tiles, while K = 9 x 2560 is deep.
//
// What the design does about it: a GEMM with M = N*H*W output pixels, N =
// Cout and K = kh*kw*Cin, tiled 128 x 128 x 32 over 8 warps, each warp 64 x
// 32 outputs in mma.sync m16n8k16 (bf16 in, f32 accumulate). The A tile is
// gathered from the NHWC input (contiguous Cin, so a 16-byte vector never
// crosses a tap since Cin % 8 == 0); the B tile reads the port's OIHW
// weights in channels_last memory, [Cout][kh][kw][Cin]: each output
// channel's K run is contiguous, the column-major operand the mma wants.
// Both arrive by cp.async in a 4-stage shared-memory ring, three reduction
// steps in flight ahead of the one being multiplied, with taps outside the
// image zero-filled by the copy itself. When a step lands, each thread
// applies the prologue to the A chunks it copied, in shared memory, once
// per element and before the step's one barrier, so that work overlaps
// the previous step's products and the normalised tensor never exists in
// device memory; int8
// weights widen to bf16 there too (exact for |v| <= 127) and their scale is
// applied once to the accumulator. Where the output has fewer tiles than
// the card has SMs (the 8x8 and 16x16 levels), the K loop is split over up
// to 16 blocks per tile (split-K), with a deterministic reduction of the
// partials by the tile's last block. Ragged M, Cout and K tails are masked
// in the kernel. wgmma and TMA are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // output pixels per block
constexpr int BN = 128;          // output channels per block
constexpr int BK = 32;           // reduction depth per stage
constexpr int STAGES = 4;        // shared-memory pipeline depth
constexpr int THREADS = 256;     // 8 warps: 2 along M x 4 along N
constexpr int LDS = BK + 8;      // padded shared row: conflict-free fragments
constexpr int PRO_NONE = 0, PRO_AFFINE = 1, PRO_SILU = 2;
constexpr int MAX_DEVICES = 64;

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

__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t word, int shift) {
  const float lo = (float)(int8_t)((word >> shift) & 0xffu);
  const float hi = (float)(int8_t)((word >> (shift + 8)) & 0xffu);
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
      vb.x = int8x2_to_bf16x2(q.x, 0);
      vb.y = int8x2_to_bf16x2(q.x, 16);
      vb.z = int8x2_to_bf16x2(q.y, 0);
      vb.w = int8x2_to_bf16x2(q.y, 16);
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
__global__ void __launch_bounds__(THREADS) conv_kernel(const ConvArgs p) {
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
cudaError_t launch(ConvArgs a, cudaStream_t stream) {
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
    err = cudaFuncSetAttribute(conv_kernel<PRO, Q8>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    allowed[dev] = smem;
  }
  const long long m = (long long)a.n * a.h * a.w;
  const dim3 grid((unsigned)((m + BM - 1) / BM), (a.cout + BN - 1) / BN,
                  a.splits);
  conv_kernel<PRO, Q8><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int PRO>
cudaError_t launch_q(const ConvArgs& a, bool q8, cudaStream_t stream) {
  return q8 ? launch<PRO, true>(a, stream) : launch<PRO, false>(a, stream);
}

}  // namespace

// x: [n, h, w, cin] bf16; wt: [cout][ks][ks][cin], bf16, or int8 with
// w_scale [cout] f32; bias: f32, row s at bias + s * bias_stride
// (bias_stride 0 for one bias row, cout for one per sample); a, d: [n, cin]
// f32 when prologue is 1 (affine) or 2 (affine + SiLU); y: [n, h, w, cout]
// bf16. All contiguous, x and wt 16-byte aligned. ks 3 pads by 1, ks 1 by
// 0; stride 1; cin % 8 == 0; every tensor under 2^31 elements. splits > 1
// splits the K loop over blocks: ws then holds splits * n*h*w * cout f32
// and counters one int per output tile, all 0 (the kernel leaves them 0).
// Returns a cudaError_t (0 on success).
extern "C" int sdtpu_conv_gn_silu(const void* x, const void* wt,
                                  const void* bias, const void* a,
                                  const void* d, const void* w_scale, void* y,
                                  void* ws, void* counters, int n, int h,
                                  int w, int cin, int cout, int ks,
                                  int bias_stride, int prologue, int quantized,
                                  int splits, void* stream) {
  const long long big = 1LL << 31;
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || cin % 8 != 0 ||
      (ks != 1 && ks != 3) || prologue < PRO_NONE || prologue > PRO_SILU ||
      (prologue != PRO_NONE && (a == nullptr || d == nullptr)) ||
      (quantized && w_scale == nullptr) || bias == nullptr ||
      (long long)n * h * w * cin >= big || (long long)n * h * w * cout >= big ||
      (long long)cout * ks * ks * cin >= big || (cout + BN - 1) / BN > 65535 ||
      splits < 1 || splits > 64 ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const ConvArgs args{static_cast<const __nv_bfloat16*>(x), wt,
                      static_cast<const float*>(bias),
                      static_cast<const float*>(a), static_cast<const float*>(d),
                      static_cast<const float*>(w_scale),
                      static_cast<__nv_bfloat16*>(y), static_cast<float*>(ws),
                      static_cast<int*>(counters), n, h, w, cin, cout, ks,
                      bias_stride, splits, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool q8 = quantized != 0;
  if (prologue == PRO_SILU) return (int)launch_q<PRO_SILU>(args, q8, s);
  if (prologue == PRO_AFFINE) return (int)launch_q<PRO_AFFINE>(args, q8, s);
  return (int)launch_q<PRO_NONE>(args, q8, s);
}
