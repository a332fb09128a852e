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
// M (the UNet's 16x16 and 8x8 levels, M = 512 and 128, and ff1 at 32x32),
// where the output has few tiles for 132 SMs and the weights are the larger
// stream: time is set by how many blocks are in flight and by the latency
// of each block's K loop, not by the int8 tensor-core rate.
//
// What the design does about it: the quantized activations never touch
// device memory. The bf16 A tile and the int8 B tile arrive by cp.async in
// a 4-stage shared-memory ring, 64 of K per stage; when a stage lands each
// thread quantizes the A chunks it copied (rintf rounds half to even, as
// jnp.round and torch.round do) into a double-buffered int8 tile, before
// the step's one barrier, so that pass overlaps the previous step's
// products. The weights are read in the layout the port keeps them in,
// [N][K] with K contiguous (a dense weight (in, out) in column-major
// memory), the column-major B operand of mma.sync m16n8k32 (s8 x s8 ->
// s32); fragments come by ldmatrix, which moves 16-byte rows whatever the
// element type. Two tiles, 128 x 128 and 64 x 64 (8 warps either way): the
// launcher's caller asks for the small one where the large one would leave
// SMs without a block. Ragged M and N and the K tail (K % 16 == 0) are
// masked or zero-filled in the kernel. Split-K, wgmma and TMA are left for
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;           // reduction depth per stage (two mma steps)
constexpr int STAGES = 4;        // shared-memory pipeline depth
constexpr int THREADS = 256;     // 8 warps: 2 along M x 4 along N
constexpr int LDQ = BK + 16;     // padded int8 row: conflict-free fragments
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ void mma_s8_16832(int c[4], const uint32_t a[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8 x 16-byte matrices: for int8 operands, 8 rows of 16 k values each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const int8_t* p) {
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

// clip(round_half_even(v * inv), -127, 127) as the low byte of the result
__device__ __forceinline__ uint32_t quantize(float v, float inv) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);
  return (uint32_t)(int)q & 0xffu;
}

__device__ __forceinline__ uint32_t quantize4(uint32_t w0, uint32_t w1,
                                              float inv) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w0));
  const float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w1));
  return quantize(a.x, inv) | (quantize(a.y, inv) << 8) |
         (quantize(b.x, inv) << 16) | (quantize(b.y, inv) << 24);
}

struct MmArgs {
  const __nv_bfloat16* x;   // [m, k]
  const int8_t* wt;         // [n][k]
  const float* wscale;      // [n]
  const float* xscale;      // [1]
  const float* bias;        // [n] or null
  __nv_bfloat16* y;         // [m, n]
  int m, k, n;
};

template <int BM, int BN>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)STAGES * BM * BK * sizeof(__nv_bfloat16)   // raw bf16 A
         + (size_t)2 * BM * LDQ                              // quantized A
         + (size_t)STAGES * BN * LDQ;                        // int8 B
}

// grid: (ceil(m / BM), ceil(n / BN)). Each thread stages BM / 32 16-byte
// chunks of A (8 bf16 of row tid / 8 [+ 32, ...]) and BN / 64 16-byte
// chunks of B (16 int8 of row tid / 4 [+ 64]).
template <int BM, int BN>
__global__ void __launch_bounds__(THREADS) mm_w8a8_kernel(const MmArgs p) {
  constexpr int MT = BM / 2 / 16;   // 16-row mma tiles per warp
  constexpr int NT = BN / 4 / 8;    // 8-column mma tiles per warp
  constexpr int A_ITERS = BM / 32;
  constexpr int B_ITERS = BN / 64;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem);
  int8_t* sA = reinterpret_cast<int8_t*>(sX + STAGES * BM * BK);
  int8_t* sB = sA + 2 * BM * LDQ;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  const float xs = *p.xscale;
  const float inv = __fdiv_rn(1.0f, xs);

  const int arow = tid / 8, akc = (tid % 8) * 8;
  const int brow = tid / 4, bkc = (tid % 4) * 16;
  const __nv_bfloat16* asrc[A_ITERS];
  bool ain_row[A_ITERS];
#pragma unroll
  for (int i = 0; i < A_ITERS; ++i) {
    const int row = m0 + arow + i * 32;
    ain_row[i] = row < p.m;
    asrc[i] = p.x + (ain_row[i] ? (long long)row * p.k : 0);
  }
  const int8_t* bsrc[B_ITERS];
  bool bin_row[B_ITERS];
#pragma unroll
  for (int i = 0; i < B_ITERS; ++i) {
    const int col = n0 + brow + i * 64;
    bin_row[i] = col < p.n;
    bsrc[i] = p.wt + (bin_row[i] ? (long long)col * p.k : 0);
  }

  // copies of reduction step `step` into stage `s`; rows past M or N and
  // columns past K are zero-filled (a zero activation quantizes to 0)
  auto issue = [&](int step, int s) {
    const int k0 = step * BK;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const bool in = ain_row[i] && k0 + akc < p.k;
      cp_async16(sX + (s * BM + arow + i * 32) * BK + akc,
                 in ? asrc[i] + k0 + akc : p.x, in);
    }
#pragma unroll
    for (int i = 0; i < B_ITERS; ++i) {
      const bool in = bin_row[i] && k0 + bkc < p.k;
      cp_async16(sB + (s * BN + brow + i * 64) * LDQ + bkc,
                 in ? bsrc[i] + k0 + bkc : p.wt, in);
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  const int wm = (warp / 4) * (BM / 2), wn = (warp % 4) * (BN / 4);
  const int steps = (p.k + BK - 1) / BK;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) issue(s, s);
    cp_async_commit();
  }

  for (int i = 0; i < steps; ++i) {
    const int slot = i % STAGES;
    // the quantized tile of step i: step i - 1's may still be read by
    // other warps, step i - 2's is consumed (the barrier of step i - 1)
    int8_t* A = sA + (i % 2) * BM * LDQ;
    const int8_t* B = sB + slot * BN * LDQ;
    cp_async_wait<STAGES - 2>();   // this thread's copies of step i landed
    // each thread quantizes the chunks it copied itself, so no barrier is
    // needed first
#pragma unroll
    for (int j = 0; j < A_ITERS; ++j) {
      const int row = arow + j * 32;
      const uint4 v =
          *reinterpret_cast<const uint4*>(sX + (slot * BM + row) * BK + akc);
      uint2 q;
      q.x = quantize4(v.x, v.y, inv);
      q.y = quantize4(v.z, v.w, inv);
      *reinterpret_cast<uint2*>(A + row * LDQ + akc) = q;
    }
    __syncthreads();   // step i is ready in full; step i - 1 is consumed
    const int next = i + STAGES - 1;
    if (next < steps) issue(next, next % STAGES);
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[MT][4], bfr[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(af[mt], A + (wm + mt * 16 + (lane % 16)) * LDQ + kk +
                                (lane / 16) * 16);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t q[4];
        ldmatrix_x4(q, B + (wn + np * 16 + (lane % 8) + (lane / 16) * 8) * LDQ +
                           kk + ((lane / 8) % 2) * 16);
        bfr[2 * np][0] = q[0];
        bfr[2 * np][1] = q[1];
        bfr[2 * np + 1][0] = q[2];
        bfr[2 * np + 1][1] = q[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_s8_16832(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: one f32 factor x_scale * w_scale[n], then bias, then one
  // rounding to bf16
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
        float v0 = __fmul_rn((float)acc[mt][nt][half * 2],
                             __fmul_rn(xs, p.wscale[col]));
        if (p.bias) v0 = __fadd_rn(v0, p.bias[col]);
        if (col + 1 < p.n) {
          float v1 = __fmul_rn((float)acc[mt][nt][half * 2 + 1],
                               __fmul_rn(xs, p.wscale[col + 1]));
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
    err = cudaFuncSetAttribute(mm_w8a8_kernel<BM, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  const dim3 grid((a.m + BM - 1) / BM, (a.n + BN - 1) / BN);
  mm_w8a8_kernel<BM, BN><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x: [m, k] bf16; wt: [n][k] int8 (the weight (k, n) with k contiguous);
// w_scale: [n] f32; x_scale: one f32 in device memory; bias: [n] f32 or
// null; y: [m, n] bf16. All contiguous, x and wt 16-byte aligned; k % 16 ==
// 0; every tensor under 2^31 elements. tile is 128 or 64, the output tile's
// side. Returns a cudaError_t (0 on success).
extern "C" int sdtpu_matmul_w8a8(const void* x, const void* wt,
                                 const void* w_scale, const void* x_scale,
                                 const void* bias, void* y, int m, int k,
                                 int n, int tile, void* stream) {
  const long long big = 1LL << 31;
  if (m <= 0 || k <= 0 || n <= 0 || k % 16 != 0 || x == nullptr ||
      wt == nullptr || w_scale == nullptr || x_scale == nullptr ||
      y == nullptr || (tile != 128 && tile != 64) ||
      (long long)m * k >= big || (long long)m * n >= big ||
      (long long)k * n >= big || (n + tile - 1) / tile > 65535)
    return (int)cudaErrorInvalidValue;
  const MmArgs args{static_cast<const __nv_bfloat16*>(x),
                    static_cast<const int8_t*>(wt),
                    static_cast<const float*>(w_scale),
                    static_cast<const float*>(x_scale),
                    static_cast<const float*>(bias),
                    static_cast<__nv_bfloat16*>(y), m, k, n};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == 128) return (int)launch<128, 128>(args, s);
  return (int)launch<64, 64>(args, s);
}
