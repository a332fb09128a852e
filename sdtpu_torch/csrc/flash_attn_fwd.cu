// Flash attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces sdtpu/ops/attention.py:_flash_kernel, the Pallas TPU kernel of the
// JAX package. It computes the same function: s = (q . k^T) in f32 times
// 1/sqrt(d); a running row max m, row sum l and f32 accumulator; p cast to
// bf16 before P.V with f32 accumulation; out = acc / l (l == 0 -> 1). Keys
// past the end of the sequence are masked in the kernel.
//
// What bounds it on this card: at the UNet's 64x64 level (S = 4096, d = 40,
// 16 batch-heads) one call is about 43 GFLOP on about 21 MB of q, k, v and o,
// some 2,000 operations per byte, so it is bound by the tensor cores and by
// the exponentials of the softmax (S^2 per head), not by device memory.
//
// What the design does about it: both products run on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate); the S x S scores never leave
// registers; the softmax runs in registers on the accumulator fragments with
// exp2 of pre-scaled logits, and P is repacked from the S fragments straight
// into the A operand of P.V. One block of 4 warps takes 64 query rows of one
// (batch, head) and loops over 64-key tiles staged in shared memory (K
// row-major, V transposed, rows padded so the fragment loads are free of bank
// conflicts). Head dims that are not a multiple of 16 (40) are zero-padded in
// shared memory only. For d > 128 (the VAE's d = 512) the output columns are
// split over blocks of 128, each recomputing the scores, so the accumulator
// stays in registers. wgmma, TMA, cp.async pipelining and warp
// specialisation are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;             // query rows per block, 16 per warp
constexpr int BK = 64;             // keys per kv tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;             // bf16 row padding in shared memory
constexpr float NEG_INF = -0.7f * 3.402823466e38f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo, low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// q, o: [B, sq, heads*d]; k, v: [B, sk, heads*d]; all row-major bf16.
// grid: (ceil(sq/BQ), B*heads, number of output column chunks).
// NO: output column tiles of 8 per block (the chunk is NO*8 wide).
template <int NO>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o,
                 int heads, int sq, int sk, int d, int dp, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldq = dp + PAD;          // row stride of sQ and sK
  constexpr int LDV = BK + PAD;      // row stride of sVt
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * ldq;
  __nv_bfloat16* sVt = sK + BK * ldq;  // [NO*8][LDV]: V transposed

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;            // fragment row group
  const int tg = lane % 4;           // thread in group

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = blockIdx.x * BQ;
  const int c0 = blockIdx.z * (NO * 8);      // first output column (in head)
  const int dv = min(NO * 8, d - c0);        // valid output columns here
  const long long ld = (long long)heads * d; // row stride in global memory

  const __nv_bfloat16* qb = q + (long long)b * sq * ld + (long long)h * d;
  const __nv_bfloat16* kb = k + (long long)b * sk * ld + (long long)h * d;
  const __nv_bfloat16* vb = v + (long long)b * sk * ld + (long long)h * d;
  __nv_bfloat16* ob = o + (long long)b * sq * ld + (long long)h * d;

  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  const int dp8 = dp / 8;

  // Q tile; rows past sq and columns past d (up to dp) are zero
  for (int i = tid; i < BQ * dp8; i += THREADS) {
    const int r = i / dp8, c = (i % dp8) * 8;
    uint4 val = zero4;
    if (q0 + r < sq && c < d)
      val = *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * ld + c);
    *reinterpret_cast<uint4*>(sQ + r * ldq + c) = val;
  }

  float acc[NO][4];
#pragma unroll
  for (int t = 0; t < NO; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;  // running max, rows g and g+8
  float l0 = 0.f, l1 = 0.f;          // running sums (this thread's columns)

  const int wr = warp * 16;          // this warp's first row in the tile

  for (int k0 = 0; k0 < sk; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < BK * dp8; i += THREADS) {
      const int r = i / dp8, c = (i % dp8) * 8;
      uint4 val = zero4;
      if (k0 + r < sk && c < d)
        val = *reinterpret_cast<const uint4*>(kb + (long long)(k0 + r) * ld + c);
      *reinterpret_cast<uint4*>(sK + r * ldq + c) = val;
    }
    for (int i = tid; i < BK * NO; i += THREADS) {
      const int r = i / NO, c = (i % NO) * 8;
      uint4 val = zero4;
      if (k0 + r < sk && c < dv)
        val = *reinterpret_cast<const uint4*>(vb + (long long)(k0 + r) * ld + c0 + c);
      const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int e = 0; e < 8; ++e) sVt[(c + e) * LDV + r] = e8[e];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int kk = 0; kk < dp; kk += 16) {
      uint32_t a[4];
      const __nv_bfloat16* qa = sQ + (wr + g) * ldq + kk + tg * 2;
      a[0] = ld32(qa);
      a[1] = ld32(qa + 8 * ldq);
      a[2] = ld32(qa + 8);
      a[3] = ld32(qa + 8 * ldq + 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* kp = sK + (j * 8 + g) * ldq + kk + tg * 2;
        mma_16816(s[j], a, ld32(kp), ld32(kp + 8));
      }
    }

    // online softmax in the log2 domain; masked keys get p = 0
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + tg * 2 + (e & 1);
        s[j][e] = col < sk ? s[j][e] * scale_log2 : NEG_INF;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + tg * 2 + (e & 1);
        const float mrow = e < 2 ? mn0 : mn1;
        s[j][e] = col < sk ? exp2f(s[j][e] - mrow) : 0.f;
      }
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int t = 0; t < NO; ++t) {
      acc[t][0] *= alpha0;
      acc[t][1] *= alpha0;
      acc[t][2] *= alpha1;
      acc[t][3] *= alpha1;
    }

    // acc += P V: the S accumulator fragments of key tiles 2kk, 2kk+1 are
    // exactly the A fragment of the kk-th 16-key step
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int t = 0; t < NO; ++t) {
        const __nv_bfloat16* vp = sVt + (t * 8 + g) * LDV + kk * 16 + tg * 2;
        mma_16816(acc[t], a, ld32(vp), ld32(vp + 8));
      }
    }
  }

  // the four threads of a group hold disjoint columns of the same rows
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 == 0.f ? 1.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 1.f : 1.f / l1;

  const int r0 = q0 + wr + g, r1 = r0 + 8;
#pragma unroll
  for (int t = 0; t < NO; ++t) {
    const int c = t * 8 + tg * 2;
    if (c >= dv) continue;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * ld + c0 + c) =
          pack_bf16(acc[t][0] * inv0, acc[t][1] * inv0);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r1 * ld + c0 + c) =
          pack_bf16(acc[t][2] * inv1, acc[t][3] * inv1);
  }
}

template <int NO>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int heads, int sq, int sk, int d,
                   cudaStream_t stream) {
  const int dp = (d + 15) / 16 * 16;
  const int chunks = d > 8 * NO ? (d + 8 * NO - 1) / (8 * NO) : 1;
  const size_t smem = (size_t)(BQ + BK) * (dp + PAD) * sizeof(__nv_bfloat16) +
                      (size_t)NO * 8 * (BK + PAD) * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<NO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((sq + BQ - 1) / BQ, batch * heads, chunks);
  const float scale_log2 = LOG2E / sqrtf((float)d);
  flash_fwd_kernel<NO><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      heads, sq, sk, d, dp, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q, o: [batch, sq, heads*d]; k, v: [batch, sk, heads*d]; bf16, contiguous.
// d % 8 == 0 and d <= 512. Returns a cudaError_t (0 on success).
extern "C" int sdtpu_flash_attn_fwd(const void* q, const void* k,
                                    const void* v, void* o, int batch,
                                    int heads, int sq, int sk, int d,
                                    void* stream) {
  if (d <= 0 || d % 8 != 0 || d > 512 || batch <= 0 || heads <= 0 ||
      sq <= 0 || sk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // output column tiles per block: exact for the dims on the main path
  // (40 -> 5, 64 -> 8, 80 -> 10), chunks of 128 columns above 128
  if (d <= 32) return (int)launch<4>(q, k, v, o, batch, heads, sq, sk, d, s);
  if (d <= 40) return (int)launch<5>(q, k, v, o, batch, heads, sq, sk, d, s);
  if (d <= 64) return (int)launch<8>(q, k, v, o, batch, heads, sq, sk, d, s);
  if (d <= 80) return (int)launch<10>(q, k, v, o, batch, heads, sq, sk, d, s);
  return (int)launch<16>(q, k, v, o, batch, heads, sq, sk, d, s);
}

extern "C" const char* sdtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
