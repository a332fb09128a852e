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
// weights do not shrink; at the 16x16 and 8x8 levels (M = 512, 128) the
// number of output tiles, far fewer than the card's 132 SMs at a 128 x 128
// tile. Only at M of a few rows (the ResBlocks' time-embedding dense, M = 2)
// do the weight bytes dominate, which is where the int8 stream halves the
// traffic.
//
// What the design does about it: the weights are read in the layout the
// port keeps them in, [N][K] with K contiguous (a dense weight (in, out) in
// column-major memory, a 1x1 conv weight OIHW in channels_last memory), the
// column-major B operand mma.sync wants, so device memory only ever sees
// int8 weights and no copy of them is made per call. A and the raw int8 B
// tile arrive by cp.async in a 4-stage shared-memory ring; when a stage
// lands each thread widens the 16 int8 it copied to bf16 in shared memory
// (before the step's one barrier, overlapping the previous step's
// products), then ldmatrix + mma.sync m16n8k16 (bf16 in, f32 accumulate) as
// in conv_gn_silu.cu. Two tiles, 128 x 128 and 64 x 64 (8 warps either
// way): the launcher's caller asks for the small one where the large one
// would leave SMs without a block. Ragged M and N and the K tail (K % 16 ==
// 0, any number of 32-deep steps) are masked or zero-filled in the kernel.
// Split-K, wgmma and TMA are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;           // reduction depth per stage
constexpr int STAGES = 4;        // shared-memory pipeline depth
constexpr int THREADS = 256;     // 8 warps: 2 along M x 4 along N
constexpr int LDS = BK + 8;      // padded bf16 row: conflict-free fragments
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// Asynchronous 16-byte global -> shared copy; with pred false nothing is
// read and the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
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

struct MmArgs {
  const __nv_bfloat16* x;   // [m, k]
  const int8_t* wt;         // [n][k]
  const float* scale;       // [n]
  const float* bias;        // [n] or null
  __nv_bfloat16* y;         // [m, n]
  int m, k, n;
};

template <int BM, int BN>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)STAGES * (BM + BN) * LDS * sizeof(__nv_bfloat16) +
         (size_t)STAGES * BN * BK;
}

// grid: (ceil(m / BM), ceil(n / BN)). Each thread stages BM / 64 16-byte
// chunks of A (8 bf16 of row tid / 4 [+ 64]) and, for tid < 2 * BN, one
// 16-byte chunk of B (16 int8 of row tid / 2).
template <int BM, int BN>
__global__ void __launch_bounds__(THREADS) mm_int8w_kernel(const MmArgs p) {
  constexpr int MT = BM / 2 / 16;   // 16-row mma tiles per warp
  constexpr int NT = BN / 4 / 8;    // 8-column mma tiles per warp
  constexpr int A_ITERS = BM / 64;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + STAGES * BM * LDS;
  int8_t* sQ = reinterpret_cast<int8_t*>(sB + STAGES * BN * LDS);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  const int arow = tid / 4, akc = (tid % 4) * 8;
  const int brow = tid / 2, bkc = (tid % 2) * 16;
  const bool bthread = brow < BN;
  const bool bin_row = bthread && n0 + brow < p.n;
  const int8_t* bsrc = p.wt + (bin_row ? (long long)(n0 + brow) * p.k : 0);
  const __nv_bfloat16* asrc[A_ITERS];
  bool ain_row[A_ITERS];
#pragma unroll
  for (int i = 0; i < A_ITERS; ++i) {
    const int row = m0 + arow + i * 64;
    ain_row[i] = row < p.m;
    asrc[i] = p.x + (ain_row[i] ? (long long)row * p.k : 0);
  }

  // copies of reduction step `step` into stage `s`; rows past M or N and
  // columns past K are zero-filled
  auto issue = [&](int step, int s) {
    const int k0 = step * BK;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const bool in = ain_row[i] && k0 + akc < p.k;
      cp_async16(sA + (s * BM + arow + i * 64) * LDS + akc,
                 in ? asrc[i] + k0 + akc : p.x, in);
    }
    if (bthread) {
      const bool in = bin_row && k0 + bkc < p.k;
      cp_async16(sQ + (s * BN + brow) * BK + bkc,
                 in ? bsrc + k0 + bkc : p.wt, in);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int wm = (warp / 4) * (BM / 2), wn = (warp % 4) * (BN / 4);
  const int steps = (p.k + BK - 1) / BK;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) issue(s, s);
    cp_async_commit();
  }

  for (int i = 0; i < steps; ++i) {
    const int slot = i % STAGES;
    __nv_bfloat16* A = sA + slot * BM * LDS;
    __nv_bfloat16* B = sB + slot * BN * LDS;
    cp_async_wait<STAGES - 2>();   // this thread's copies of step i landed
    // each thread widens the int8 chunk it copied itself, so no barrier is
    // needed first
    if (bthread) {
      const uint4 q =
          *reinterpret_cast<const uint4*>(sQ + (slot * BN + brow) * BK + bkc);
      uint4 lo, hi;
      lo.x = int8x2_to_bf16x2(q.x, 0);
      lo.y = int8x2_to_bf16x2(q.x, 16);
      lo.z = int8x2_to_bf16x2(q.y, 0);
      lo.w = int8x2_to_bf16x2(q.y, 16);
      hi.x = int8x2_to_bf16x2(q.z, 0);
      hi.y = int8x2_to_bf16x2(q.z, 16);
      hi.z = int8x2_to_bf16x2(q.w, 0);
      hi.w = int8x2_to_bf16x2(q.w, 16);
      uint4* dst = reinterpret_cast<uint4*>(B + brow * LDS + bkc);
      dst[0] = lo;
      dst[1] = hi;
    }
    __syncthreads();   // step i is ready in full; step i - 1 is consumed
    const int next = i + STAGES - 1;
    if (next < steps) issue(next, next % STAGES);
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4], bfr[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(af[mt], A + (wm + mt * 16 + (lane % 16)) * LDS + kk +
                                (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t q[4];
        ldmatrix_x4(q, B + (wn + np * 16 + (lane % 8) + (lane / 16) * 8) * LDS +
                           kk + ((lane / 8) % 2) * 8);
        bfr[2 * np][0] = q[0];
        bfr[2 * np][1] = q[1];
        bfr[2 * np + 1][0] = q[2];
        bfr[2 * np + 1][1] = q[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_16816(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: scale, then bias, in f32 (two roundings, as the reference's
  // two statements), then one rounding to bf16
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + mt * 16 + g + half * 8;
      if (row >= p.m) continue;
      __nv_bfloat16* yrow = p.y + (long long)row * p.n;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + wn + nt * 8 + tg * 2;
        if (col >= p.n) continue;
        float v0 = __fmul_rn(acc[mt][nt][half * 2], p.scale[col]);
        if (p.bias) v0 = __fadd_rn(v0, p.bias[col]);
        if (col + 1 < p.n) {
          float v1 = __fmul_rn(acc[mt][nt][half * 2 + 1], p.scale[col + 1]);
          if (p.bias) v1 = __fadd_rn(v1, p.bias[col + 1]);
          if ((p.n & 1) == 0) {
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

template <int BM, int BN>
cudaError_t launch(const MmArgs& a, cudaStream_t stream) {
  // raise the kernel's shared-memory cap on this device once (not again
  // inside a graph capture)
  static bool allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  constexpr size_t smem = smem_bytes<BM, BN>();
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(mm_int8w_kernel<BM, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  const dim3 grid((a.m + BM - 1) / BM, (a.n + BN - 1) / BN);
  mm_int8w_kernel<BM, BN><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x: [m, k] bf16; wt: [n][k] int8 (the weight (k, n) with k contiguous);
// scale: [n] f32; bias: [n] f32 or null; y: [m, n] bf16. All contiguous, x
// and wt 16-byte aligned; k % 16 == 0; every tensor under 2^31 elements.
// tile is 128 or 64, the output tile's side. Returns a cudaError_t (0 on
// success).
extern "C" int sdtpu_matmul_int8w(const void* x, const void* wt,
                                  const void* scale, const void* bias, void* y,
                                  int m, int k, int n, int tile, void* stream) {
  const long long big = 1LL << 31;
  if (m <= 0 || k <= 0 || n <= 0 || k % 16 != 0 || x == nullptr ||
      wt == nullptr || scale == nullptr || y == nullptr ||
      (tile != 128 && tile != 64) || (long long)m * k >= big ||
      (long long)m * n >= big || (long long)k * n >= big ||
      (n + tile - 1) / tile > 65535)
    return (int)cudaErrorInvalidValue;
  const MmArgs args{static_cast<const __nv_bfloat16*>(x),
                    static_cast<const int8_t*>(wt),
                    static_cast<const float*>(scale),
                    static_cast<const float*>(bias),
                    static_cast<__nv_bfloat16*>(y), m, k, n};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 128) return (int)launch<128, 128>(args, s);
  return (int)launch<64, 64>(args, s);
}
