// Flash attention backward for Hopper (sm_90a): dq, dk, dv from q, k, v, the
// forward's output o and its per-row log-sum-exp, and do. bf16 in and out,
// f32 arithmetic.
//
// Replaces sdtpu/ops/attention.py:_chunked_attn_bwd, the backward that the
// JAX package attaches to its Pallas forward through jax.custom_vjp
// (_flash_self, :192-210). That function recomputes the softmax of each
// chunk of 512 queries over all keys in f32 and accumulates dk and dv across
// the chunks. This file computes the same gradients with another design:
//
//   D  = rowsum(do * o)                         (a pre-pass, f32)
//   P  = exp(q.k^T / sqrt(d) - lse)             (recomputed, f32)
//   dv = P^T . do
//   dP = do . v^T
//   dS = P * (dP - D)
//   dq = dS . k / sqrt(d),  dk = dS^T . q / sqrt(d)
//
// rowsum(do * o) equals the reference's rowsum(dP * P), since o = P . v.
// The forward saves lse (flash_attn_fwd.cu's statistics output), so no pass
// recomputes the softmax's max and sum.
//
// What bounds it on this card: five products of 2 S^2 d operations a head
// (q.k^T and do.v^T are each recomputed once more here, seven in all), and
// S^2 exponentials (twice here). At the UNet's 64x64 level (S = 4096, d =
// 40, 16 batch-heads) the five products are 107 GFLOP, 0.109 ms of the
// tensor cores at the published bf16 rate: the products, not the 26 MB of
// operands, are the limit.
//
// The design is the simple one that is right:
//  * three kernels, no atomics, so two runs give the same bits: the pre-pass
//    for D; a dk/dv kernel whose block owns 64 keys and loops over the query
//    tiles; a dq kernel whose block owns 64 queries and loops over the key
//    tiles. Each block writes its own rows of its outputs once;
//  * every product is mma.sync m16n8k16 (bf16 in, f32 accumulate) on
//    operands loaded from shared memory with ldmatrix; a warp owns 16 rows
//    of the block's 64. P and dS pass from the accumulator fragments of one
//    product to the A fragments of the next in registers (the m16n8
//    accumulator of two neighbouring column tiles is the m16k16 A fragment),
//    rounded to bf16 there, as the forward rounds P before P.v;
//  * the streamed tiles (q and do, or k and v) arrive by cp.async in a
//    two-stage ring, zero-filled past the sequence and past d; rows of
//    shared memory are padded by 16 bytes so that ldmatrix's eight row
//    addresses fall in eight different bank groups;
//  * a head dim is padded to DPAD (of 16, 32, 48, 64, 80, 128) in shared
//    memory only. The streamed tile is 64 rows up to DPAD 64 and 32 rows
//    above, where the two f32 accumulators of 16 x DPAD a warp already take
//    DPAD registers a thread.
//
// wgmma and TMA, the card's fast path for the products, are left to a
// redesign; the wrapper's static rule (sdtpu_torch/ops/attention.py:
// plan_bwd) chooses DPAD and the streamed tile, and this file checks it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;           // a block: 4 warps of 16 rows
constexpr int ROWS = 16 * WARPS;   // the rows a block owns
constexpr int MAX_DEVICES = 64;
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo, low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Asynchronous 16-byte global -> shared copy; with pred false nothing is
// read and the destination is zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a . b: m16n8k16, bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [row0, row0 + rows) of a [limit][ld] bf16 matrix, columns [0, DPAD),
// into a [rows][DPAD + 8] tile of shared memory; rows past `limit` and
// columns past `d` are zero.
template <int DPAD>
__device__ __forceinline__ void load_tile(bf16* dst, int rows,
                                          const bf16* src, long long ld,
                                          int row0, int limit, int d,
                                          int tid) {
  constexpr int C8 = DPAD / 8;
  constexpr int LDS = DPAD + 8;
  for (int i = tid; i < rows * C8; i += 32 * WARPS) {
    const int r = i / C8, c = i - r * C8;
    const bool in = row0 + r < limit && c * 8 < d;
    cp_async16(smem_u32(dst + r * LDS + c * 8),
               in ? src + (long long)(row0 + r) * ld + c * 8 : src, in);
  }
}

// acc[16 x 8 NT] += A[16 rows of `a`, k = 0 .. 16 KS) . B^T, where `b` holds
// B's rows as [n][k] (k contiguous): both operands K-major in shared
// memory, rows `lds` elements apart. A's rows start at `a`, B's at `b`.
template <int KS, int NT>
__device__ __forceinline__ void mma_kk(float (&acc)[NT][4], const bf16* a,
                                       const bf16* b, int lds, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, smem_u32(a + (lane % 16) * lds + kk * 16 + (lane / 16) * 8));
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t bf[4];
      ldsm_x4(bf, smem_u32(b + (16 * j + (lane % 8) + (lane / 16) * 8) * lds +
                           kk * 16 + ((lane / 8) % 2) * 8));
      mma(acc[2 * j], af, bf[0], bf[1]);
      mma(acc[2 * j + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[16 x 8 NT] += A . B, A from registers (the bf16 A fragments of KS
// k-steps), B as [k][n] (n contiguous) in shared memory, rows `lds`
// elements apart: loaded transposed.
template <int KS, int NT>
__device__ __forceinline__ void mma_rk(float (&acc)[NT][4],
                                       const uint32_t (&a)[KS][4],
                                       const bf16* b, int lds, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t bf[4];
      ldsm_x4_t(bf, smem_u32(b + (kk * 16 + (lane % 8) +
                                  ((lane / 8) % 2) * 8) * lds +
                             16 * j + (lane / 16) * 8));
      mma(acc[2 * j], a[kk], bf[0], bf[1]);
      mma(acc[2 * j + 1], a[kk], bf[2], bf[3]);
    }
  }
}

// The A fragments of the 16 x (16 KS) matrix whose m16n8 accumulators are
// `c` (2 KS column tiles), rounded to bf16.
template <int KS>
__device__ __forceinline__ void to_a(uint32_t (&a)[KS][4],
                                     const float (&c)[2 * KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// 16 rows x DPAD accumulators of a warp, times `scale`, to rows [row0,
// row0 + 16) of a [limit][ld] bf16 matrix, columns below d.
template <int NT>
__device__ __forceinline__ void store_rows(bf16* dst, long long ld,
                                           const float (&acc)[NT][4],
                                           float scale, int row0, int limit,
                                           int d, int lane) {
  const int g = lane / 4, tg = lane % 4;
  const int r0 = row0 + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = 8 * j + 2 * tg;
    if (c >= d) continue;
    if (r0 < limit)
      *reinterpret_cast<uint32_t*>(dst + (long long)r0 * ld + c) =
          pack_bf16(acc[j][0] * scale, acc[j][1] * scale);
    if (r1 < limit)
      *reinterpret_cast<uint32_t*>(dst + (long long)r1 * ld + c) =
          pack_bf16(acc[j][2] * scale, acc[j][3] * scale);
  }
}

// delta[bh][i] = sum_c do[b, i, h d + c] * o[b, i, h d + c], one warp a
// row; lse2[bh][i] = lse * log2(e), the log2 domain the other kernels use.
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       float* __restrict__ delta, float* __restrict__ lse2,
                       int batch, int heads, int s, int d) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)batch * heads * s) return;
  const int bh = (int)(row / s), i = (int)(row % s);
  const int b = bh / heads, h = bh % heads;
  const long long off = ((long long)b * s + i) * heads * d + (long long)h * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32)
    acc += __bfloat162float(o[off + c]) * __bfloat162float(dout[off + c]);
#pragma unroll
  for (int m = 16; m > 0; m /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) {
    delta[row] = acc;
    lse2[row] = lse[row] * LOG2E;
  }
}

// dk and dv of 64 keys: grid (ceil(s / 64), B*heads), 128 threads; warp w
// owns keys 16w .. 16w + 15 of the block and works on the transposed
// products (keys as rows): S^T = k . q^T, dP^T = v . do^T.
template <int DPAD, int BQ>
__global__ void __launch_bounds__(32 * WARPS)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse2,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int heads, int s, int d,
                      float scale_log2, float scale) {
  constexpr int LDS = DPAD + 8;
  constexpr int NT = DPAD / 8;     // accumulator column tiles along d
  constexpr int KD = DPAD / 16;    // k-steps along d
  constexpr int NQ = BQ / 8;       // column tiles along the query tile
  constexpr int KQ = BQ / 16;      // k-steps along the query tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + ROWS * LDS;
  bf16* sQ = sV + ROWS * LDS;            // [2][BQ][LDS]
  bf16* sO = sQ + 2 * BQ * LDS;          // do, [2][BQ][LDS]
  float* sL = reinterpret_cast<float*>(sO + 2 * BQ * LDS);  // [2][BQ]
  float* sD = sL + 2 * BQ;                                  // [2][BQ]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tg = lane % 4;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int k0 = blockIdx.x * ROWS;
  const long long ld = (long long)heads * d;
  const long long base = (long long)b * s * ld + (long long)h * d;
  const float* lse_bh = lse2 + (long long)bh * s;
  const float* d_bh = delta + (long long)bh * s;

  auto load_q = [&](int t) {
    const int st = t % 2, q0 = t * BQ;
    load_tile<DPAD>(sQ + st * BQ * LDS, BQ, q + base, ld, q0, s, d, tid);
    load_tile<DPAD>(sO + st * BQ * LDS, BQ, dout + base, ld, q0, s, d, tid);
    for (int i = tid; i < BQ; i += 32 * WARPS) {
      const bool in = q0 + i < s;
      // a query past the sequence gets P = exp2(-inf) = 0
      sL[st * BQ + i] = in ? lse_bh[q0 + i] : INFINITY;
      sD[st * BQ + i] = in ? d_bh[q0 + i] : 0.f;
    }
  };

  load_tile<DPAD>(sK, ROWS, k + base, ld, k0, s, d, tid);
  load_tile<DPAD>(sV, ROWS, v + base, ld, k0, s, d, tid);
  load_q(0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  float acc_k[NT][4], acc_v[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  const bf16* wK = sK + warp * 16 * LDS;
  const bf16* wV = sV + warp * 16 * LDS;
  const int ntiles = (s + BQ - 1) / BQ;
  for (int t = 0; t < ntiles; ++t) {
    // tile t has landed (this thread's copies, then everyone's), and every
    // warp is done with tile t - 1, whose stage the next copies take
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (t + 1 < ntiles) load_q(t + 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const int st = t % 2;
    const bf16* tQ = sQ + st * BQ * LDS;
    const bf16* tO = sO + st * BQ * LDS;
    const float* tL = sL + st * BQ;
    const float* tD = sD + st * BQ;

    // P^T = exp2(k . q^T * scale log2(e) - lse2[query]): 16 keys x BQ
    float p[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = 0.f;
    mma_kk<KD, NQ>(p, wK, tQ, LDS, lane);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float l0 = tL[8 * j + 2 * tg], l1 = tL[8 * j + 2 * tg + 1];
      p[j][0] = ex2(fmaf(p[j][0], scale_log2, -l0));
      p[j][1] = ex2(fmaf(p[j][1], scale_log2, -l1));
      p[j][2] = ex2(fmaf(p[j][2], scale_log2, -l0));
      p[j][3] = ex2(fmaf(p[j][3], scale_log2, -l1));
    }
    uint32_t pa[KQ][4];
    to_a<KQ>(pa, p);
    // dv += P^T . do
    mma_rk<KQ, NT>(acc_v, pa, tO, LDS, lane);

    // dP^T = v . do^T, then dS^T = P^T * (dP^T - D[query])
    float ds[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = 0.f;
    mma_kk<KD, NQ>(ds, wV, tO, LDS, lane);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float d0 = tD[8 * j + 2 * tg], d1 = tD[8 * j + 2 * tg + 1];
      ds[j][0] = p[j][0] * (ds[j][0] - d0);
      ds[j][1] = p[j][1] * (ds[j][1] - d1);
      ds[j][2] = p[j][2] * (ds[j][2] - d0);
      ds[j][3] = p[j][3] * (ds[j][3] - d1);
    }
    uint32_t da[KQ][4];
    to_a<KQ>(da, ds);
    // dk += dS^T . q (times the scale at the end)
    mma_rk<KQ, NT>(acc_k, da, tQ, LDS, lane);
  }

  const int row0 = k0 + warp * 16;
  store_rows<NT>(dk + base, ld, acc_k, scale, row0, s, d, lane);
  store_rows<NT>(dv + base, ld, acc_v, 1.f, row0, s, d, lane);
}

// dq of 64 queries: grid (ceil(s / 64), B*heads), 128 threads; warp w owns
// queries 16w .. 16w + 15 of the block.
template <int DPAD, int BK>
__global__ void __launch_bounds__(32 * WARPS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse2,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int heads, int s, int d, float scale_log2, float scale) {
  constexpr int LDS = DPAD + 8;
  constexpr int NT = DPAD / 8;
  constexpr int KD = DPAD / 16;
  constexpr int NK = BK / 8;       // column tiles along the key tile
  constexpr int KK = BK / 16;      // k-steps along the key tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + ROWS * LDS;            // do
  bf16* sK = sO + ROWS * LDS;            // [2][BK][LDS]
  bf16* sV = sK + 2 * BK * LDS;          // [2][BK][LDS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * ROWS;
  const long long ld = (long long)heads * d;
  const long long base = (long long)b * s * ld + (long long)h * d;

  auto load_kv = [&](int t) {
    const int st = t % 2;
    load_tile<DPAD>(sK + st * BK * LDS, BK, k + base, ld, t * BK, s, d, tid);
    load_tile<DPAD>(sV + st * BK * LDS, BK, v + base, ld, t * BK, s, d, tid);
  };
  load_tile<DPAD>(sQ, ROWS, q + base, ld, q0, s, d, tid);
  load_tile<DPAD>(sO, ROWS, dout + base, ld, q0, s, d, tid);
  load_kv(0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // this thread's two rows: their lse2 and D (a row past the sequence gets
  // P = 0; its dq is not stored)
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float* lse_bh = lse2 + (long long)bh * s;
  const float* d_bh = delta + (long long)bh * s;
  const float l0 = r0 < s ? lse_bh[r0] : INFINITY;
  const float l1 = r1 < s ? lse_bh[r1] : INFINITY;
  const float d0 = r0 < s ? d_bh[r0] : 0.f;
  const float d1 = r1 < s ? d_bh[r1] : 0.f;

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const bf16* wQ = sQ + warp * 16 * LDS;
  const bf16* wO = sO + warp * 16 * LDS;
  const int ntiles = (s + BK - 1) / BK;
  for (int t = 0; t < ntiles; ++t) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (t + 1 < ntiles) load_kv(t + 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const int st = t % 2;
    const bf16* tK = sK + st * BK * LDS;
    const bf16* tV = sV + st * BK * LDS;

    // P = exp2(q . k^T * scale log2(e) - lse2[row]); keys past the sequence
    // (the last tile's zero rows) get P = 0
    float p[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = 0.f;
    mma_kk<KD, NK>(p, wQ, tK, LDS, lane);
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      p[j][0] = ex2(fmaf(p[j][0], scale_log2, -l0));
      p[j][1] = ex2(fmaf(p[j][1], scale_log2, -l0));
      p[j][2] = ex2(fmaf(p[j][2], scale_log2, -l1));
      p[j][3] = ex2(fmaf(p[j][3], scale_log2, -l1));
    }
    if (t == ntiles - 1 && s % BK != 0) {
      const int keys_left = s - t * BK;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const int c = 8 * j + 2 * tg;
        if (c >= keys_left) p[j][0] = p[j][2] = 0.f;
        if (c + 1 >= keys_left) p[j][1] = p[j][3] = 0.f;
      }
    }
    // dP = do . v^T, dS = P * (dP - D[row])
    float ds[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = 0.f;
    mma_kk<KD, NK>(ds, wO, tV, LDS, lane);
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      ds[j][0] = p[j][0] * (ds[j][0] - d0);
      ds[j][1] = p[j][1] * (ds[j][1] - d0);
      ds[j][2] = p[j][2] * (ds[j][2] - d1);
      ds[j][3] = p[j][3] * (ds[j][3] - d1);
    }
    uint32_t da[KK][4];
    to_a<KK>(da, ds);
    // dq += dS . k (times the scale at the end)
    mma_rk<KK, NT>(acc, da, tK, LDS, lane);
  }

  store_rows<NT>(dq + base, ld, acc, scale, q0 + warp * 16, s, d, lane);
}

constexpr size_t dkdv_smem(int dpad, int bq) {
  return (size_t)(2 * ROWS + 4 * bq) * (dpad + 8) * sizeof(bf16) +
         4 * bq * sizeof(float);
}

constexpr size_t dq_smem(int dpad, int bk) {
  return (size_t)(2 * ROWS + 4 * bk) * (dpad + 8) * sizeof(bf16);
}

struct Args {
  const bf16 *q, *k, *v, *o, *dout;
  const float* lse;
  bf16 *dq, *dk, *dv;
  float *delta, *lse2;
  int batch, heads, s, d;
};

template <int DPAD, int BT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  // raise the kernels' shared-memory caps on this device once (not again
  // inside a graph capture)
  static bool allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<DPAD, BT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dkdv_smem(DPAD, BT));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DPAD, BT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dq_smem(DPAD, BT));
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  const long long rows = (long long)a.batch * a.heads * a.s;
  flash_bwd_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      a.o, a.dout, a.lse, a.delta, a.lse2, a.batch, a.heads, a.s, a.d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float scale = 1.f / sqrtf((float)a.d);
  const float scale_log2 = LOG2E * scale;
  const dim3 grid((a.s + ROWS - 1) / ROWS, a.batch * a.heads);
  flash_bwd_dkdv_kernel<DPAD, BT>
      <<<grid, 32 * WARPS, dkdv_smem(DPAD, BT), stream>>>(
          a.q, a.k, a.v, a.dout, a.lse2, a.delta, a.dk, a.dv, a.heads, a.s,
          a.d, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<DPAD, BT>
      <<<grid, 32 * WARPS, dq_smem(DPAD, BT), stream>>>(
          a.q, a.k, a.v, a.dout, a.lse2, a.delta, a.dq, a.heads, a.s, a.d,
          scale_log2, scale);
  return cudaGetLastError();
}

}  // namespace

// Self-attention's gradients. q, k, v, o, dout, dq, dk, dv: [batch, s,
// heads*d] bf16, contiguous, 16-byte aligned; lse: [batch*heads, s] f32, the
// forward's natural-log log-sum-exp of each row of the scaled logits;
// delta and lse2: [batch*heads, s] f32 scratch. d % 8 == 0, d <= 128. dpad
// and bt are the wrapper's plan (ops/attention.py:plan_bwd), the only place
// the rule is written: the padded head dim (of 16, 32, 48, 64, 80, 128) and
// the rows of a streamed tile (64 up to dpad 64, 32 above). Any other
// combination is refused. Three launches on
// `stream`: the pre-pass, dk/dv, dq. Returns a cudaError_t (0 on success).
extern "C" int sdtpu_flash_attn_bwd(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* lse, const void* dout,
                                    void* dq, void* dk, void* dv, void* delta,
                                    void* lse2, int batch, int heads, int s,
                                    int d, int dpad, int bt, void* stream) {
  if (d <= 0 || d % 8 != 0 || d > 128 || batch <= 0 || heads <= 0 ||
      s <= 0 || (long long)heads * d > (1 << 24) ||
      (long long)batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  // the rule: the least padded head dim that holds d, and its tile
  const int want = d <= 80 ? (d + 15) / 16 * 16 : 128;
  if (dpad != want || bt != (want <= 64 ? 64 : 32))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(q),    static_cast<const bf16*>(k),
               static_cast<const bf16*>(v),    static_cast<const bf16*>(o),
               static_cast<const bf16*>(dout), static_cast<const float*>(lse),
               static_cast<bf16*>(dq),         static_cast<bf16*>(dk),
               static_cast<bf16*>(dv),         static_cast<float*>(delta),
               static_cast<float*>(lse2),      batch, heads, s, d};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the instantiations that exist, by dpad * 1000 + bt
  switch (dpad * 1000 + bt) {
    case 16064: return (int)launch<16, 64>(a, st);
    case 32064: return (int)launch<32, 64>(a, st);
    case 48064: return (int)launch<48, 64>(a, st);
    case 64064: return (int)launch<64, 64>(a, st);
    case 80032: return (int)launch<80, 32>(a, st);
    case 128032: return (int)launch<128, 32>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
