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
// some 2,000 operations per byte, so device memory is not the limit. The
// tensor cores are one (both products through wgmma), and the softmax the
// other: S^2 exponentials a head run on the SM's special-function units at a
// sixteenth of the f32 rate, about as long as the products themselves at d =
// 40. At d = 512 (the VAE, one head) there are 64 row tiles for 132 SMs, and
// each block streams all of K and V from L2: half the card is the limit.
//
// What the design does about it:
//  * Both products are wgmma (m64nNk16, bf16 in, f32 accumulate). s = q.k^T
//    reads Q and the K tile from shared memory, both as they lie in device
//    memory (each row's d values contiguous: the K-major operand). acc += p.v
//    takes P from registers (the accumulator fragments of s, packed to bf16,
//    are exactly the A fragments of the next product) and the V tile as it
//    lies in memory, [keys][d], through the descriptor's transpose flag, so
//    nothing is transposed through shared memory.
//  * K and V tiles arrive by cp.async (16 bytes a copy, zero-filled past the
//    sequence and past d) straight into the 128-byte-swizzled layout wgmma
//    reads, in a two-stage ring: the copies of tile t + 1 run under the
//    products and the softmax of tile t. A head dim is padded to DPAD (a
//    multiple of 16) in shared memory only, in column blocks of 64.
//  * d <= 128: a block is one or two warpgroups of 64 query rows each,
//    sharing the ring. Up to d = 64 the launcher takes two (128 rows, each
//    K/V tile read from L2 serves both) unless that leaves half the SMs
//    without a block; from d = 80 on one, since the accumulator's registers
//    would hold an SM to one 256-thread block. Either way two or three
//    blocks fit an SM and the warpgroups run on their own between a block's
//    one barrier a tile, so one warpgroup's exponentials overlap another's
//    products.
//  * The instruction stream, not a unit, was the first limit: every
//    thread's K/V copy slots (rows, offsets, swizzled addresses) are worked
//    out once before the loop, and the accumulator is rescaled only in
//    steps where some row's max moved.
//  * d > 128 (the VAE's 512): the two warpgroups share one 64-row Q tile and
//    split the output columns, 64 x d/2 f32 accumulators each. Both compute
//    the same s and p (the same instructions on the same data): recomputing
//    the smaller product costs half of the products' minimum again, where
//    sharing p through shared memory would put a block-wide barrier between
//    the softmax and p.v in every step.
//  * Softmax: exp2 (one ex2.approx a value) of logits scaled by log2(e) /
//    sqrt(d) inside one fma; only the last, ragged key tile is masked.
//  * Training (LSE = true, d <= 128): each row's natural-log log-sum-exp of
//    the scaled logits, (m + log2 l) ln 2 from the running max and sum the
//    kernel holds at its end, goes to an f32 [B*heads, sq] output, which
//    the backward (flash_attn_bwd.cu) reads in place of recomputing the
//    softmax's statistics. Inference instantiates LSE = false, whose code
//    has no such store.
//
// The wrapper's static rule (sdtpu_torch/ops/attention.py:plan) chooses DPAD,
// the rows a block takes and the keys a step takes; this file checks it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

using wgmma::Wgmma;

constexpr int WG = 128;            // threads of a warpgroup, 64 query rows
constexpr int STAGES = 2;
constexpr int MAX_DEVICES = 64;
constexpr float NEG_INF = -0.7f * 3.402823466e38f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo, low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Asynchronous 16-byte global -> shared copy; with pred false nothing is
// read and the destination is zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// Rows [row0, row0 + rows) of a [limit][ld] matrix, columns [0, DPAD), into
// column blocks of [rows][64] bf16 with the 128-byte swizzle. Rows past
// `limit` and columns past `d` are zero.
template <int DPAD>
__device__ __forceinline__ void load_rows(uint32_t dst, int rows,
                                          const __nv_bfloat16* src,
                                          long long ld, int row0, int limit,
                                          int d, int tid, int nthreads) {
  constexpr int C8 = DPAD / 8;     // 16-byte chunks a row
  const int total = rows * C8;
  for (int i = tid; i < total; i += nthreads) {
    const int r = i / C8, c = i - r * C8;
    const bool in = row0 + r < limit && c * 8 < d;
    const uint32_t a = dst + (c >> 3) * (rows * 128) + r * 128 +
                       (((c & 7) ^ (r & 7)) << 4);
    cp_async16(a, in ? src + (long long)(row0 + r) * ld + c * 8 : src, in);
  }
}

template <int DPAD, int BKV, bool SPLIT>
struct Tile {
  static constexpr int CH = (DPAD + 63) / 64;        // column blocks of 64
  static constexpr int KS = DPAD / 16;               // k steps of q.k^T
  static constexpr int NV = SPLIT ? DPAD / 2 : DPAD; // p.v columns a warpgroup
  static constexpr uint32_t KV_BYTES = CH * BKV * 128;  // a K or a V tile
  static constexpr size_t smem(int qrows) {
    return 1024 + (size_t)CH * qrows * 128 + (size_t)STAGES * 2 * KV_BYTES;
  }
};

// q, o: [B, sq, heads*d]; k, v: [B, sk, heads*d]; all row-major bf16.
// lse (LSE only): [B*heads, sq] f32. grid: (ceil(sq / rows), B*heads); rows
// = 64 for SPLIT, else 64 a warpgroup of the block (blockDim.x = 128 or
// 256).
template <int DPAD, int BKV, bool SPLIT, bool LSE>
__global__ void __launch_bounds__(2 * WG)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int heads, int sq, int sk, int d, float scale_log2) {
  using T = Tile<DPAD, BKV, SPLIT>;
  constexpr int CH = T::CH, KS = T::KS, NV = T::NV;
  constexpr int NS = BKV / 2;        // s values a thread
  constexpr int NA = NV / 2;         // accumulator values a thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int wg = tid / WG;
  const int warp = (tid % WG) / 32;
  const int lane = tid % 32;
  const int g = lane / 4;            // fragment row group
  const int tg = lane % 4;           // thread in group

  const int qrows = SPLIT ? 64 : nthreads / 2;   // query rows of the block
  const uint32_t sQ = base;
  const uint32_t sKV = base + CH * qrows * 128;  // stage s: K, then V

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int q0 = blockIdx.x * qrows;
  const long long ld = (long long)heads * d;     // row stride in global memory
  const __nv_bfloat16* qb = q + (long long)b * sq * ld + (long long)h * d;
  const __nv_bfloat16* kb = k + (long long)b * sk * ld + (long long)h * d;
  const __nv_bfloat16* vb = v + (long long)b * sk * ld + (long long)h * d;
  __nv_bfloat16* ob = o + (long long)b * sq * ld + (long long)h * d;

  // A thread copies the same 16-byte chunks of every K and V tile, so their
  // places are worked out once: chunk idx = tid + i * nthreads of the tile's
  // BKV x DPAD/8, at row kv_row (-1: no such chunk), element offset kv_src
  // from the tile's first row (-1: a padding column, zero-filled), byte
  // offset kv_dst in the swizzled tile.
  constexpr int C8 = DPAD / 8;
  constexpr int SLOTS = (BKV * C8 + WG - 1) / WG;
  int kv_row[SLOTS], kv_src[SLOTS];
  uint32_t kv_dst[SLOTS];
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const int idx = tid + i * nthreads;
    const int r = idx / C8, c = idx - r * C8;
    kv_row[i] = idx < BKV * C8 ? r : -1;
    kv_src[i] = c * 8 < d ? r * (int)ld + c * 8 : -1;
    kv_dst[i] = (c >> 3) * (BKV * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
  }
  auto load_kv = [&](int t) {
    const uint32_t dst = sKV + (t % STAGES) * 2 * T::KV_BYTES;
    const long long tile = (long long)t * BKV * ld;
    const int rows_left = sk - t * BKV;
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      if (kv_row[i] < 0) continue;
      const bool in = kv_row[i] < rows_left && kv_src[i] >= 0;
      const long long off = in ? tile + kv_src[i] : 0;
      cp_async16(dst + kv_dst[i], kb + off, in);
      cp_async16(dst + T::KV_BYTES + kv_dst[i], vb + off, in);
    }
  };

  load_rows<DPAD>(sQ, qrows, qb, ld, q0, sq, d, tid, nthreads);
  load_kv(0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // this warpgroup's Q rows in the block's tile, its first output column
  const int qrow_wg = SPLIT ? 0 : wg * 64;
  const int col_wg = SPLIT ? wg * NV : 0;
  const uint64_t q_desc = wgmma::descriptor(sQ + qrow_wg * 128, 16, 1024);

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;  // running max of the scaled logits
  float l0 = 0.f, l1 = 0.f;          // running sums (this thread's columns)

  const int ntiles = (sk + BKV - 1) / BKV;
  for (int t = 0; t < ntiles; ++t) {
    // tile t has landed (this thread's copies, then everyone's), and every
    // warpgroup is done with tile t - 1, whose stage the next copies take
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    wgmma::fence_async_proxy();
    __syncthreads();
    if (t + 1 < ntiles) load_kv(t + 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const uint32_t sK = sKV + (t % STAGES) * 2 * T::KV_BYTES;
    const uint32_t sV = sK + T::KV_BYTES;

    // s = q . k^T: 64 rows x BKV keys
    float s[NS];
    const uint64_t k_desc = wgmma::descriptor(sK, 16, 1024);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      // k step kk: column block kk / 4, 32 bytes a step inside its rows
      const uint32_t qo = (kk / 4) * (qrows * 128) + (kk % 4) * 32;
      const uint32_t ko = (kk / 4) * (BKV * 128) + (kk % 4) * 32;
      Wgmma<BKV>::ss(s, q_desc + (qo >> 4), k_desc + (ko >> 4), kk != 0);
    }
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::pin(s);

    // online softmax in the log2 domain; masked keys get p = 0
    if (t == ntiles - 1 && sk % BKV != 0) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int col = t * BKV + (i / 4) * 8 + tg * 2 + (i & 1);
        if (col >= sk) s[i] = NEG_INF;
      }
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0 * scale_log2);
    const float mn1 = fmaxf(m1, mx1 * scale_log2);
    const float alpha0 = ex2(m0 - mn0), alpha1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
      s[4 * j] = ex2(fmaf(s[4 * j], scale_log2, -mn0));
      s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], scale_log2, -mn0));
      s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], scale_log2, -mn1));
      s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], scale_log2, -mn1));
      sum0 += s[4 * j] + s[4 * j + 1];
      sum1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    // the accumulator is rescaled only where some row's max moved (alpha is
    // exactly 1 otherwise): after the first tiles that is rare
    if (__any_sync(0xffffffffu, alpha0 != 1.f || alpha1 != 1.f)) {
#pragma unroll
      for (int j = 0; j < NA / 4; ++j) {
        acc[4 * j] *= alpha0;
        acc[4 * j + 1] *= alpha0;
        acc[4 * j + 2] *= alpha1;
        acc[4 * j + 3] *= alpha1;
      }
    }

    // acc += p . v: the s fragments of key tiles 2kk, 2kk+1 are exactly the
    // A fragment of the kk-th 16-key step; V [keys][d] is the MN-major B
    uint32_t p[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    // column block c of V starts BKV rows of 128 bytes after block c - 1;
    // 16 keys down is 2 groups of 8 rows
    const uint64_t v_desc = wgmma::descriptor(
        sV + (col_wg / 64) * (BKV * 128), BKV * 128, 1024);
    wgmma::pin(acc);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      Wgmma<NV>::rs_mn(acc, p[kk], v_desc + ((kk * 2048) >> 4), 1);
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::pin(acc);
  }

  // the four threads of a group hold disjoint columns of the same rows
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 == 0.f ? 1.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 1.f : 1.f / l1;

  const int r0 = q0 + qrow_wg + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    const int c = col_wg + j * 8 + tg * 2;
    if (c >= d) continue;
    if (r0 < sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * ld + c) =
          pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (r1 < sq)
      *reinterpret_cast<uint32_t*>(ob + (long long)r1 * ld + c) =
          pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
  // one thread of each row's group writes its statistic (under SPLIT both
  // warpgroups hold the same rows: the first writes)
  if (LSE && tg == 0 && (!SPLIT || wg == 0)) {
    float* lb = lse + (long long)blockIdx.y * sq;
    if (r0 < sq) lb[r0] = (m0 + log2f(l0)) * LN2;
    if (r1 < sq) lb[r1] = (m1 + log2f(l1)) * LN2;
  }
}

struct Args {
  const __nv_bfloat16 *q, *k, *v;
  __nv_bfloat16* o;
  float* lse;
  int batch, heads, sq, sk, d, rows;
};

template <int DPAD, int BKV, bool SPLIT, bool LSE = false>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using T = Tile<DPAD, BKV, SPLIT>;
  // raise the kernel's shared-memory cap on this device once (not again
  // inside a graph capture)
  static bool allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<DPAD, BKV, SPLIT, LSE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)T::smem(DPAD > 64 ? 64 : 128));
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  const int rows = SPLIT ? 64 : a.rows;
  const int threads = SPLIT ? 2 * WG : 2 * rows;
  const dim3 grid((a.sq + rows - 1) / rows, a.batch * a.heads);
  const float scale_log2 = LOG2E / sqrtf((float)a.d);
  flash_fwd_kernel<DPAD, BKV, SPLIT, LSE>
      <<<grid, threads, T::smem(rows), stream>>>(
          a.q, a.k, a.v, a.o, a.lse, a.heads, a.sq, a.sk, a.d, scale_log2);
  return cudaGetLastError();
}

bool bad_args(int batch, int heads, int sq, int sk, int d, int dpad,
              int rows) {
  return d <= 0 || d % 8 != 0 || d > 512 || batch <= 0 || heads <= 0 ||
         sq <= 0 || sk <= 0 || d > dpad || (rows != 64 && rows != 128) ||
         (long long)heads * d > (1 << 24) || (dpad > 64 && rows != 64) ||
         (long long)batch * heads > 65535;
}

}  // namespace

// q, o: [batch, sq, heads*d]; k, v: [batch, sk, heads*d]; bf16, contiguous,
// 16-byte aligned. d % 8 == 0, d <= 512 and heads*d <= 2^24. dpad, rows and
// bkv are the wrapper's plan (ops/attention.py:plan), the only place the rule
// is written: the padded head dim (of 16, 32, 48, 64, 80, 128, 256, 512), the
// query rows a block takes (64, or 128 up to dpad 64) and the keys a step
// takes (64, and 32 at dpad 512). Any other combination has no instantiation
// and is refused. Returns a cudaError_t (0 on success).
extern "C" int sdtpu_flash_attn_fwd(const void* q, const void* k,
                                    const void* v, void* o, int batch,
                                    int heads, int sq, int sk, int d,
                                    int dpad, int rows, int bkv,
                                    void* stream) {
  if (bad_args(batch, heads, sq, sk, d, dpad, rows))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v),
               static_cast<__nv_bfloat16*>(o), nullptr, batch, heads, sq, sk,
               d, rows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the instantiations that exist, by dpad * 1000 + bkv
  switch (dpad * 1000 + bkv) {
    case 16064: return (int)launch<16, 64, false>(a, s);
    case 32064: return (int)launch<32, 64, false>(a, s);
    case 48064: return (int)launch<48, 64, false>(a, s);
    case 64064: return (int)launch<64, 64, false>(a, s);
    case 80064: return (int)launch<80, 64, false>(a, s);
    case 128064: return (int)launch<128, 64, false>(a, s);
    case 256064: return (int)launch<256, 64, true>(a, s);
    case 512032: return (int)launch<512, 32, true>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The training forward: sdtpu_flash_attn_fwd's function, and each row's
// log-sum-exp into lse ([batch*heads, sq] f32). Instantiated where the
// backward's contract lies, d <= 128 (dpad up to 128).
extern "C" int sdtpu_flash_attn_fwd_lse(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int batch, int heads, int sq, int sk,
                                        int d, int dpad, int rows, int bkv,
                                        void* stream) {
  if (bad_args(batch, heads, sq, sk, d, dpad, rows) || d > 128)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v),
               static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
               batch, heads, sq, sk, d, rows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dpad * 1000 + bkv) {
    case 16064: return (int)launch<16, 64, false, true>(a, s);
    case 32064: return (int)launch<32, 64, false, true>(a, s);
    case 48064: return (int)launch<48, 64, false, true>(a, s);
    case 64064: return (int)launch<64, 64, false, true>(a, s);
    case 80064: return (int)launch<80, 64, false, true>(a, s);
    case 128064: return (int)launch<128, 64, false, true>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* sdtpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
