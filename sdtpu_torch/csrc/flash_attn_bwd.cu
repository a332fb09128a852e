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
//   D  = rowsum(do * o)                         (f32)
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
// and S^2 exponentials. At the UNet's 64x64 level (S = 4096, d = 40, 16
// batch-heads) the five products are 107 GFLOP, 0.109 ms of the tensor
// cores at the published bf16 rate, and the exponentials 0.069 ms of the
// special-function units; the 26 MB of operands are no limit. Measured,
// the first limit is each warpgroup's own chain of instructions, products
// and waits (PERF.md, PR 16): fewer instructions a tile and more blocks an
// SM moved the time; splitting a tile to overlap its exponentials with its
// products, or holding a second tile's products in flight, cost registers
// and blocks and lost.
//
// The design:
//  * every product is wgmma (m64nNk16, bf16 in, f32 accumulate), the
//    card's only path to its full tensor-core rate, through the generated
//    wrappers of wgmma_sm90.cuh in two forms. The dk/dv kernel holds a
//    block's keys and values and streams the queries: S^T = k.q^T and
//    dP^T = v.do^T are `ss` products over a tile of queries (both operands
//    K-major, as they lie in memory); dv += P^T.do and dk += dS^T.q are
//    `rs_mn` products, P^T and dS^T passing from the accumulators into A
//    fragments in registers (a 64 x N accumulator is N/8 m16n8 fragments a
//    warp, and two neighbouring ones are an m16k16 A fragment), rounded to
//    bf16 there, as the forward rounds P before P.v; do and q are the
//    MN-major B, read through the descriptor's transpose flag. The dq
//    kernel is the mirror: it holds a block's queries and do and streams
//    keys and values, S = q.k^T and dP = do.v^T `ss`, dq += dS.k `rs_mn`.
//  * the two `ss` products of a tile are issued together: the
//    exponentials of S run while dP is on the tensor cores, and dS^T is
//    formed while dv's product runs. Where a block is one warpgroup, the
//    tile's last product (dq, or dv and dk) also finishes under the next
//    tile's S and dP, a second barrier a tile handing the stage over.
//  * dq without atomics: two kernels, each writing its own rows once, so
//    two runs give the same bits. The dq kernel recomputes S and dP: seven
//    products where five suffice, and the exponentials twice. The other
//    way, dq added from every key block into an f32 workspace in a fixed
//    order, saves those but chains each key block's adds behind the one
//    before it, a wait that holds only in the order in which the hardware
//    happens to launch blocks (PERF.md, PR 16, has the reckoning).
//  * the dq kernel runs first and also forms D and lse2 = lse log2(e) of
//    its rows (the four threads of a row's quad over its columns), padded
//    to a multiple of 64 with 0 and +inf, for the dk/dv kernel, which
//    streams them beside its query tiles: no pre-pass, and the copies need
//    no bounds (a query past the sequence gets P = 0).
//  * the streamed tiles arrive by cp.async (16 bytes a copy, zero-filled
//    past the sequence and past d) straight into the 128-byte-swizzled
//    layout the descriptors expect, in a ring of three stages (two where a
//    row is two column blocks of 64): tile t + 2 is in flight while tile t
//    is computed. Each thread's copy slots (rows, offsets, swizzled
//    addresses) are worked out once, before the loop.
//  * rows and tiles (the rule below): up to a padded head dim of 48 a
//    block is two warpgroups (128 rows, sharing each streamed tile) and the
//    dk/dv kernel streams 32 queries a tile, so that both kernels keep to
//    128 registers a thread and two blocks share an SM; above, one
//    warpgroup (64 rows), where dk and dv's f32 accumulators take DPAD
//    registers a thread, with tiles of 64 (32 at DPAD 128, so that nothing
//    spills). A head dim is padded to DPAD (of 16, 32, 48, 64, 80, 128) in
//    shared memory only.
//
// The wrapper's static rule (sdtpu_torch/ops/attention.py:plan_bwd)
// chooses DPAD, the rows a block owns and both kernels' streamed tiles;
// this file computes the same rule and refuses any other plan.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;
using wgmma::Wgmma;

constexpr int WG = 128;            // threads of a warpgroup, 64 rows
constexpr int SPAD = 64;           // lse2 and D rows padded to a multiple
constexpr int MAX_DEVICES = 64;
constexpr float LOG2E = 1.4426950408889634f;

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

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + rows) of a [limit][ld] matrix, columns [0, DPAD), into
// column blocks of [rows][64] bf16 with the 128-byte swizzle. Rows past
// `limit` and columns past `d` are zero.
template <int DPAD>
__device__ __forceinline__ void load_rows(uint32_t dst, int rows,
                                          const bf16* src, long long ld,
                                          int row0, int limit, int d,
                                          int tid, int nthreads) {
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

// The P (or P^T) fragments of a 64 x N accumulator as the A fragments of
// the N / 16 k steps of the next product, rounded to bf16.
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4],
                                     const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// A warpgroup's 64 x DPAD accumulator, times `scale`, to rows [row0, row0 +
// 64) of a [limit][ld] bf16 matrix, columns below d.
template <int DPAD>
__device__ __forceinline__ void store_rows(bf16* dst, long long ld,
                                           const float (&acc)[DPAD / 2],
                                           float scale, int row0, int limit,
                                           int d) {
  const int warp = (threadIdx.x % WG) / 32, lane = threadIdx.x % 32;
  const int r0 = row0 + warp * 16 + lane / 4, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < DPAD / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4);
    if (c >= d) continue;
    if (r0 < limit)
      *reinterpret_cast<uint32_t*>(dst + (long long)r0 * ld + c) =
          pack_bf16(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    if (r1 < limit)
      *reinterpret_cast<uint32_t*>(dst + (long long)r1 * ld + c) =
          pack_bf16(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
}

// The shared-memory plan of a block: its own two tiles of ROWS rows (k and
// v, or q and do), STAGES stages of two streamed tiles of BT rows (q and
// do, or k and v), then each stage's lse2 and D (dk/dv blocks). Every tile
// starts on a 1024-byte boundary, as the swizzle wants.
template <int DPAD, int BT, int WGS>
struct Plan {
  static constexpr int CH = (DPAD + 63) / 64;   // column blocks of 64
  static constexpr int ROWS = 64 * WGS;
  static constexpr int THREADS = WG * WGS;
  static constexpr int STAGES = CH == 1 ? 3 : 2;
  // one warpgroup a block: a tile's last product finishes under the next
  // tile's S and dP, and a second barrier a tile hands its stage over;
  // with two warpgroups that barrier cost more than the overlap gained
  static constexpr bool OVERLAP = WGS == 1;
  static constexpr uint32_t OWN = CH * ROWS * 128;
  static constexpr uint32_t TILE = CH * BT * 128;
  static constexpr uint32_t RING = 2 * OWN;
  static constexpr uint32_t STATS = RING + STAGES * 2 * TILE;
  static constexpr size_t smem() {
    return 1024 + STATS + (size_t)STAGES * 2 * BT * sizeof(float);
  }
};

// The 16-byte chunks of a streamed tile that this thread copies, worked out
// once (the instruction stream, not a unit, limits these loops): chunk tid +
// i * THREADS of the tile's BT x DPAD / 8 at row row[i] (-1: no such chunk),
// element offset src[i] from the tile's first row (-1: a padding column,
// zero-filled), byte offset dst[i] in the swizzled tile.
template <int DPAD, int BT, int THREADS>
struct Slots {
  static constexpr int C8 = DPAD / 8;
  static constexpr int N = (BT * C8 + THREADS - 1) / THREADS;
  int row[N], src[N];
  uint32_t dst[N];

  __device__ __forceinline__ Slots(int tid, int ld, int d) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = tid + i * THREADS;
      const int r = idx / C8, c = idx - r * C8;
      row[i] = idx < BT * C8 ? r : -1;
      src[i] = c * 8 < d ? r * ld + c * 8 : -1;
      dst[i] = (c >> 3) * (BT * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
    }
  }

  // rows [row0, row0 + BT) of x into the tile at `tile`; rows past `limit`
  // are zero
  __device__ __forceinline__ void copy(uint32_t tile, const bf16* x,
                                       long long ld, int row0,
                                       int limit) const {
    const long long first = (long long)row0 * ld;
    const int left = limit - row0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (row[i] < 0) continue;
      const bool in = row[i] < left && src[i] >= 0;
      cp_async16(tile + dst[i], in ? x + first + src[i] : x, in);
    }
  }
};

struct Args {
  const bf16 *q, *k, *v, *o, *dout;
  const float* lse;
  bf16 *dq, *dk, *dv;
  float *delta, *lse2;
  int batch, heads, s, spad, d;
  float scale_log2, scale;
};

// acc (64 x BT) = A . B^T over d: A this warpgroup's 64 rows of the block's
// own tile `own` (ROWS rows), B the streamed tile `tile` (BT rows); one
// committed group.
template <int DPAD, int BT, int ROWS>
__device__ __forceinline__ void product_s(float (&acc)[BT / 2], uint32_t own,
                                          uint32_t tile) {
  const int wg = threadIdx.x / WG;
  const uint64_t a_desc = wgmma::descriptor(own + wg * 64 * 128, 16, 1024);
  const uint64_t b_desc = wgmma::descriptor(tile, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < DPAD / 16; ++kk) {
    // k step kk: column block kk / 4, 32 bytes a step inside its rows
    const uint32_t ao = (kk / 4) * (ROWS * 128) + (kk % 4) * 32;
    const uint32_t bo = (kk / 4) * (BT * 128) + (kk % 4) * 32;
    Wgmma<BT>::ss(acc, a_desc + (ao >> 4), b_desc + (bo >> 4), kk != 0);
  }
  wgmma::commit();
}

// dq of the block's ROWS queries, and D and lse2 of those rows for the dk/dv
// kernel, which runs after this one; warpgroup w owns queries 64w .. 64w +
// 63. grid: (ceil(s / ROWS), B*heads).
template <int DPAD, int BT, int WGS, int MINB>
__global__ void __launch_bounds__(WG * WGS, MINB)
flash_bwd_dq_kernel(const Args a) {
  using P = Plan<DPAD, BT, WGS>;
  constexpr int ROWS = P::ROWS, STAGES = P::STAGES;
  constexpr int NS = BT / 2;         // S values a thread
  constexpr int KK = BT / 16;        // k steps along the key tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int wg = tid / WG, warp = (tid % WG) / 32, lane = tid % 32;
  const int tg = lane % 4;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const long long ld = (long long)a.heads * a.d;
  const long long off = (long long)b * a.s * ld + (long long)h * a.d;
  const int q0 = blockIdx.x * ROWS;
  const uint32_t sQ = base, sO = base + P::OWN;
  const bf16* kb = a.k + off;
  const bf16* vb = a.v + off;
  const Slots<DPAD, BT, P::THREADS> slots(tid, (int)ld, a.d);

  auto load_kv = [&](int t) {
    const uint32_t dst = base + P::RING + (t % STAGES) * 2 * P::TILE;
    slots.copy(dst, kb, ld, t * BT, a.s);
    slots.copy(dst + P::TILE, vb, ld, t * BT, a.s);
  };

  load_rows<DPAD>(sQ, ROWS, a.q + off, ld, q0, a.s, a.d, tid, P::THREADS);
  load_rows<DPAD>(sO, ROWS, a.dout + off, ld, q0, a.s, a.d, tid, P::THREADS);
  const int ntiles = (a.s + BT - 1) / BT;
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) load_kv(t);
    cp_commit();
  }

  // this thread's two rows: D = rowsum(do * o) over the quad's columns, and
  // lse2 = lse log2(e); a row past the sequence gets P = 0 (lse2 = +inf),
  // D = 0, and its dq is not stored
  const int r0 = q0 + wg * 64 + warp * 16 + lane / 4, r1 = r0 + 8;
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int j = 0; j < DPAD / 8; ++j) {
    const int c = 8 * j + 2 * tg;
    if (c >= a.d) continue;
    if (r0 < a.s) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const bf162*>(
          a.o + off + r0 * ld + c));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const bf162*>(
          a.dout + off + r0 * ld + c));
      d0 += x.x * y.x + x.y * y.y;
    }
    if (r1 < a.s) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const bf162*>(
          a.o + off + r1 * ld + c));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const bf162*>(
          a.dout + off + r1 * ld + c));
      d1 += x.x * y.x + x.y * y.y;
    }
  }
#pragma unroll
  for (int m = 1; m < 4; m *= 2) {
    d0 += __shfl_xor_sync(0xffffffffu, d0, m);
    d1 += __shfl_xor_sync(0xffffffffu, d1, m);
  }
  const float* lse_bh = a.lse + (long long)bh * a.s;
  const float l0 = r0 < a.s ? lse_bh[r0] * LOG2E : INFINITY;
  const float l1 = r1 < a.s ? lse_bh[r1] * LOG2E : INFINITY;
  if (tg == 0) {
    const long long row = (long long)bh * a.spad;
    if (r0 < a.spad) {
      a.delta[row + r0] = d0;
      a.lse2[row + r0] = l0;
    }
    if (r1 < a.spad) {
      a.delta[row + r1] = d1;
      a.lse2[row + r1] = l1;
    }
  }

  float acc[DPAD / 2];
  zero(acc);

  for (int t = 0; t < ntiles; ++t) {
    // tile t has landed (this thread's copies, then everyone's); without
    // the overlap, every warpgroup is also done with tile t - 1, whose
    // stage the next copies take
    cp_wait<STAGES - 2>();
    wgmma::fence_async_proxy();
    __syncthreads();
    if constexpr (!P::OVERLAP) {
      if (t + STAGES - 1 < ntiles) load_kv(t + STAGES - 1);
      cp_commit();
    }

    const uint32_t tK = base + P::RING + (t % STAGES) * 2 * P::TILE;
    const uint32_t tV = tK + P::TILE;

    // S = q . k^T and dP = do . v^T: 64 queries x BT keys each, issued
    // together (with the overlap, while tile t - 1's dq product finishes)
    float sc[NS], dp[NS];
    wgmma::fence();
    product_s<DPAD, BT, ROWS>(sc, sQ, tK);
    product_s<DPAD, BT, ROWS>(dp, sO, tV);
    if constexpr (P::OVERLAP) {
      wgmma::wait<2>();
      wgmma::pin(acc);
      __syncthreads();
      if (t + STAGES - 1 < ntiles) load_kv(t + STAGES - 1);
      cp_commit();
    }
    wgmma::wait<1>();
    wgmma::pin(sc);

    // P = exp2(S scale log2(e) - lse2[row]) while dP runs; keys past the
    // sequence (the last tile's zero rows) get P = 0
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
      sc[4 * j] = ex2(fmaf(sc[4 * j], a.scale_log2, -l0));
      sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], a.scale_log2, -l0));
      sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], a.scale_log2, -l1));
      sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], a.scale_log2, -l1));
    }
    const int keys_left = a.s - t * BT;
    if (keys_left < BT) {
#pragma unroll
      for (int j = 0; j < NS / 4; ++j) {
        const int c = 8 * j + 2 * tg;
        if (c >= keys_left) sc[4 * j] = sc[4 * j + 2] = 0.f;
        if (c + 1 >= keys_left) sc[4 * j + 1] = sc[4 * j + 3] = 0.f;
      }
    }
    wgmma::wait<0>();
    wgmma::pin(dp);

    // dS = P (dP - D[row])
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
      dp[4 * j] = sc[4 * j] * (dp[4 * j] - d0);
      dp[4 * j + 1] = sc[4 * j + 1] * (dp[4 * j + 1] - d0);
      dp[4 * j + 2] = sc[4 * j + 2] * (dp[4 * j + 2] - d1);
      dp[4 * j + 3] = sc[4 * j + 3] * (dp[4 * j + 3] - d1);
    }
    uint32_t da[KK][4];
    to_a<BT>(da, dp);

    // dq += dS . k (times the scale at the end): k [keys][d] is the
    // MN-major B; 16 keys down is 2048 bytes
    const uint64_t k_mn = wgmma::descriptor(tK, BT * 128, 1024);
    wgmma::pin(acc);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      Wgmma<DPAD>::rs_mn(acc, da[kk], k_mn + ((kk * 2048) >> 4), 1);
    wgmma::commit();
    if constexpr (!P::OVERLAP) {
      wgmma::wait<0>();
      wgmma::pin(acc);
    }
  }
  wgmma::wait<0>();
  wgmma::pin(acc);

  store_rows<DPAD>(a.dq + off, ld, acc, a.scale, q0 + wg * 64, a.s, a.d);
}

// dk and dv of the block's ROWS keys; warpgroup w owns keys 64w .. 64w + 63
// and works on the transposed products (keys as rows). grid: (ceil(s /
// ROWS), B*heads).
template <int DPAD, int BT, int WGS, int MINB>
__global__ void __launch_bounds__(WG * WGS, MINB)
flash_bwd_dkdv_kernel(const Args a) {
  using P = Plan<DPAD, BT, WGS>;
  constexpr int ROWS = P::ROWS, STAGES = P::STAGES;
  constexpr int NS = BT / 2;         // S^T values a thread
  constexpr int KQ = BT / 16;        // k steps along the query tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const float* stats =
      reinterpret_cast<const float*>(smem_raw + (base - raw) + P::STATS);
  const int tid = threadIdx.x;
  const int wg = tid / WG, tg = tid % 4;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const long long ld = (long long)a.heads * a.d;
  const long long off = (long long)b * a.s * ld + (long long)h * a.d;
  const int k0 = blockIdx.x * ROWS;
  const uint32_t sK = base, sV = base + P::OWN;
  const bf16* qb = a.q + off;
  const bf16* ob = a.dout + off;
  const float* lse_bh = a.lse2 + (long long)bh * a.spad;
  const float* d_bh = a.delta + (long long)bh * a.spad;
  const Slots<DPAD, BT, P::THREADS> slots(tid, (int)ld, a.d);

  auto load_q = [&](int t) {
    const int st = t % STAGES;
    const uint32_t dst = base + P::RING + st * 2 * P::TILE;
    slots.copy(dst, qb, ld, t * BT, a.s);
    slots.copy(dst + P::TILE, ob, ld, t * BT, a.s);
    // lse2 then D of the tile's queries, BT / 4 chunks each
    const uint32_t sdst = base + P::STATS + st * 2 * BT * 4;
    for (int i = tid; i < BT / 2; i += P::THREADS) {
      const int c = i % (BT / 4);
      cp_async16(sdst + i * 16,
                 (i < BT / 4 ? lse_bh : d_bh) + t * BT + c * 4, true);
    }
  };

  load_rows<DPAD>(sK, ROWS, a.k + off, ld, k0, a.s, a.d, tid, P::THREADS);
  load_rows<DPAD>(sV, ROWS, a.v + off, ld, k0, a.s, a.d, tid, P::THREADS);
  const int ntiles = (a.s + BT - 1) / BT;
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) load_q(t);
    cp_commit();
  }

  float acc_k[DPAD / 2], acc_v[DPAD / 2];
  zero(acc_k);
  zero(acc_v);

  for (int t = 0; t < ntiles; ++t) {
    cp_wait<STAGES - 2>();
    wgmma::fence_async_proxy();
    __syncthreads();
    if constexpr (!P::OVERLAP) {
      if (t + STAGES - 1 < ntiles) load_q(t + STAGES - 1);
      cp_commit();
    }

    const int st = t % STAGES;
    const uint32_t tQ = base + P::RING + st * 2 * P::TILE;
    const uint32_t tO = tQ + P::TILE;
    const float* tL = stats + st * 2 * BT;
    const float* tD = tL + BT;

    // S^T = k . q^T and dP^T = v . do^T: 64 keys x BT queries each (with
    // the overlap, while tile t - 1's dv and dk products finish)
    float sT[NS], dpT[NS];
    wgmma::fence();
    product_s<DPAD, BT, ROWS>(sT, sK, tQ);
    product_s<DPAD, BT, ROWS>(dpT, sV, tO);
    if constexpr (P::OVERLAP) {
      wgmma::wait<2>();
      wgmma::pin(acc_v);
      wgmma::pin(acc_k);
      __syncthreads();
      if (t + STAGES - 1 < ntiles) load_q(t + STAGES - 1);
      cp_commit();
    }
    wgmma::wait<1>();
    wgmma::pin(sT);

    // P^T = exp2(S^T scale log2(e) - lse2[query]), while dP^T runs; a
    // query past the sequence has lse2 = +inf, so P = 0
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(tL + 8 * j + 2 * tg);
      sT[4 * j] = ex2(fmaf(sT[4 * j], a.scale_log2, -l.x));
      sT[4 * j + 1] = ex2(fmaf(sT[4 * j + 1], a.scale_log2, -l.y));
      sT[4 * j + 2] = ex2(fmaf(sT[4 * j + 2], a.scale_log2, -l.x));
      sT[4 * j + 3] = ex2(fmaf(sT[4 * j + 3], a.scale_log2, -l.y));
    }
    uint32_t pa[KQ][4];
    to_a<BT>(pa, sT);

    // dv += P^T . do: do [queries][d] is the MN-major B; 16 queries down
    // is 2048 bytes
    const uint64_t o_mn = wgmma::descriptor(tO, BT * 128, 1024);
    wgmma::pin(acc_v);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk)
      Wgmma<DPAD>::rs_mn(acc_v, pa[kk], o_mn + ((kk * 2048) >> 4), 1);
    wgmma::commit();
    wgmma::wait<1>();
    wgmma::pin(dpT);

    // dS^T = P^T (dP^T - D[query]), while dv's product runs
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
      const float2 dd = *reinterpret_cast<const float2*>(tD + 8 * j + 2 * tg);
      dpT[4 * j] = sT[4 * j] * (dpT[4 * j] - dd.x);
      dpT[4 * j + 1] = sT[4 * j + 1] * (dpT[4 * j + 1] - dd.y);
      dpT[4 * j + 2] = sT[4 * j + 2] * (dpT[4 * j + 2] - dd.x);
      dpT[4 * j + 3] = sT[4 * j + 3] * (dpT[4 * j + 3] - dd.y);
    }
    uint32_t da[KQ][4];
    to_a<BT>(da, dpT);

    // dk += dS^T . q (times the scale at the end)
    const uint64_t q_mn = wgmma::descriptor(tQ, BT * 128, 1024);
    wgmma::pin(acc_k);
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk)
      Wgmma<DPAD>::rs_mn(acc_k, da[kk], q_mn + ((kk * 2048) >> 4), 1);
    wgmma::commit();
    if constexpr (!P::OVERLAP) {
      wgmma::wait<0>();
      wgmma::pin(acc_v);
      wgmma::pin(acc_k);
    }
  }
  wgmma::wait<0>();
  wgmma::pin(acc_v);
  wgmma::pin(acc_k);

  const int row0 = k0 + wg * 64;
  store_rows<DPAD>(a.dk + off, ld, acc_k, a.scale, row0, a.s, a.d);
  store_rows<DPAD>(a.dv + off, ld, acc_v, 1.f, row0, a.s, a.d);
}

// DPAD, ROWS (= 64 WGS) of both kernels, the streamed tiles of the dk/dv
// (BKV) and the dq (BQ) kernel, and the blocks an SM must hold (MINB).
template <int DPAD, int WGS, int BKV, int BQ, int MINB>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using PQ = Plan<DPAD, BQ, WGS>;
  using PKV = Plan<DPAD, BKV, WGS>;
  // raise the kernels' shared-memory caps on this device once (not again
  // inside a graph capture)
  static bool allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DPAD, BQ, WGS, MINB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)PQ::smem());
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<DPAD, BKV, WGS, MINB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)PKV::smem());
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  const dim3 grid((a.s + 64 * WGS - 1) / (64 * WGS), a.batch * a.heads);
  flash_bwd_dq_kernel<DPAD, BQ, WGS, MINB>
      <<<grid, WG * WGS, PQ::smem(), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<DPAD, BKV, WGS, MINB>
      <<<grid, WG * WGS, PKV::smem(), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Self-attention's gradients. q, k, v, o, dout, dq, dk, dv: [batch, s,
// heads*d] bf16, contiguous, 16-byte aligned; lse: [batch*heads, s] f32, the
// forward's natural-log log-sum-exp of each row of the scaled logits;
// delta and lse2: [batch*heads, ceil(s / 64) * 64] f32 scratch, 16-byte
// aligned. d % 8 == 0, d <= 128. dpad, rows, bkv and bq are the wrapper's
// plan (ops/attention.py:plan_bwd), the only place the rule is written: the
// padded head dim (of 16, 32, 48, 64, 80, 128), the rows a block owns (128
// up to dpad 48, 64 above) and the streamed tiles of the dk/dv kernel (32
// up to dpad 48 and at 128, else 64) and of the dq kernel (64, 32 at 128).
// Any other combination is refused. Two launches on `stream`: dq (with D
// and lse2 into the scratch), then dk/dv. Returns a cudaError_t (0 on
// success).
extern "C" int sdtpu_flash_attn_bwd(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* lse, const void* dout,
                                    void* dq, void* dk, void* dv, void* delta,
                                    void* lse2, int batch, int heads, int s,
                                    int d, int dpad, int rows, int bkv,
                                    int bq, void* stream) {
  if (d <= 0 || d % 8 != 0 || d > 128 || batch <= 0 || heads <= 0 ||
      s <= 0 || (long long)heads * d > (1 << 24) ||
      (long long)batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  // the rule: the least padded head dim that holds d, its rows and tiles
  const int want = d <= 80 ? (d + 15) / 16 * 16 : 128;
  if (dpad != want || rows != (want <= 48 ? 128 : 64) ||
      bkv != (want <= 48 || want == 128 ? 32 : 64) ||
      bq != (want == 128 ? 32 : 64))
    return (int)cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf((float)d);
  const Args a{static_cast<const bf16*>(q),    static_cast<const bf16*>(k),
               static_cast<const bf16*>(v),    static_cast<const bf16*>(o),
               static_cast<const bf16*>(dout), static_cast<const float*>(lse),
               static_cast<bf16*>(dq),         static_cast<bf16*>(dk),
               static_cast<bf16*>(dv),         static_cast<float*>(delta),
               static_cast<float*>(lse2),      batch,
               heads,                          s,
               (s + SPAD - 1) / SPAD * SPAD,   d,
               LOG2E * scale,                  scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the instantiations that exist, by dpad: <DPAD, WGS, BKV, BQ, MINB>
  switch (dpad) {
    case 16: return (int)launch<16, 2, 32, 64, 2>(a, st);
    case 32: return (int)launch<32, 2, 32, 64, 2>(a, st);
    case 48: return (int)launch<48, 2, 32, 64, 2>(a, st);
    case 64: return (int)launch<64, 1, 64, 64, 1>(a, st);
    case 80: return (int)launch<80, 1, 64, 64, 1>(a, st);
    case 128: return (int)launch<128, 1, 32, 32, 1>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
