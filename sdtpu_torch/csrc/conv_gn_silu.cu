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
// GFLOP), but only once the prologue is out of their way: applied to every
// staged tap it is more special-function work than the products it feeds.
// At the small planes (16x16, 8x8: M = 512, 128 output pixels) the weights
// are the larger stream (29 MB at 1280 -> 1280) and the output has far fewer
// tiles than the card has SMs.
//
// What the design does about it: one kernel (conv_slab_kernel), the TPU
// kernel's own idea (a padded plane chunk staged once, normalised once in
// fast memory, the taps as shifted products over it), for any plane and Cin
// % 8 == 0, with the tiling chosen by the wrapper's static rule
// (sdtpu_torch/ops/conv.py:plan_conv), which this file checks.
//
//  * A block owns 128 output pixels, 64 a warpgroup, and BN = 128 or 160
//    output channels, and walks Cin in chunks of 64. The 128 pixels are one
//    of three tilings of the plane: a ph x pw patch (1x128 .. 16x8), ns
//    whole planes of up to 8 samples, or a run of 128 consecutive pixels of
//    one sample that wraps its rows (ph rows of the whole width). Pixels of
//    a patch or a run that fall outside the plane are computed on a slab
//    row like any other and not stored; a pixel table in shared memory
//    names each pixel's output row.
//  * For a chunk the block stages, by cp.async with zero-fill outside the
//    image and past Cin (the last chunk may be short), the input rows its
//    pixels' taps touch, halo included (ns (ph + 2)(pw + 2) pixels, at most
//    400), in rows of 144 bytes (ldmatrix without bank conflicts), and
//    applies the prologue to it in shared memory ONCE, skipping the
//    positions outside the image, with A and D of the chunk staged beside
//    it and SiLU as h + h * tanh(h), h = z / 2 (one special-function
//    operation a value). A tap is then an offset of the rows ldmatrix
//    names: each warp loads its m16k16 fragments of the shifted slab and
//    issues wgmma (m64nBNk16, bf16 in, f32 accumulate) with A from registers
//    and B, one tap's [BN][64] weight tile, K-major in 128-byte-swizzled
//    shared memory. The weight tiles run in a ring of their own, 3 steps
//    ahead (4 for a 1x1 conv) by cp.async straight into the swizzle (int8
//    weights arrive raw,
//    in 8-byte pieces where Cin % 16 != 0 leaves their rows 8-byte aligned,
//    and the thread that copied a chunk widens it into the swizzled tile
//    with one byte permute and one sub.bf16x2 a pair; the scale stays in the
//    epilogue). The slab is double-buffered, and a third warpgroup that
//    multiplies nothing keeps it ahead: it issues the copy of chunk c + 1 at
//    chunk c's first tap, waits for it three taps later and spreads its
//    prologue over the remaining taps, so that the pass costs the
//    multiplying warpgroups neither issue slots in their step nor its
//    latency before the step's barrier (done by them, between a step's
//    products and the next barrier, it cost 30% at 64x64). A 1x1 conv is
//    the same kernel with one tap: a chunk is one step, so its slabs run in
//    a ring of five, four chunks ahead, and the whole block normalises
//    chunk c + 1 during chunk c's step. A multiplying warpgroup loads its
//    fragments only while it has no product in flight
//    (registers written inside an open wgmma stage make the compiler
//    serialize the products); the step's barrier does not wait for the
//    products, so the two warpgroups drift apart and one's fragment loads
//    fall under the other's products.
//  * Where that saves waves of blocks (the 8x8 level's ten output tiles on
//    132 SMs), the grid's z axis takes runs of slab chunks, each block
//    writes its f32 partial tile, and conv_sum_kernel sums them in a fixed
//    order, applies scale and bias and rounds once: no atomics, the same
//    bytes every run.
//  * The output tile leaves through shared memory as whole 16-byte row
//    chunks, scale and bias applied in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

constexpr int PRO_NONE = 0, PRO_AFFINE = 1, PRO_SILU = 2;
constexpr int MAX_DEVICES = 64;
constexpr size_t SMEM_CAP = 227 * 1024;   // a block's shared memory on sm_90

struct ConvArgs {
  const __nv_bfloat16* x;   // [n, h, w, cin]
  const void* wt;           // [cout][ks][ks][cin], bf16 or int8
  const float* bias;        // row n at bias + n * bias_stride, [cout]
  const float* pa;          // [n, cin] prologue scale (or null)
  const float* pd;          // [n, cin] prologue shift (or null)
  const float* wscale;      // [cout] int8 weight scale (or null)
  __nv_bfloat16* y;         // [n, h, w, cout]
  float* ws;                // [splits][n*h*w][cout] f32 partials (splits > 1)
  int n, h, w, cin, cout, ks, bias_stride, splits;
};

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
  int ph, pw, ns;         // the block's slab: ns samples x ph rows x pw
  int wrap;               // 1: a run of 128 consecutive pixels of a sample
  int tiles_w;            // patches along a row (0 for a run)
  int tiles;              // blocks of one group of ns samples
  int rpg;                // slab rows of one group: ns (ph + 2 pad)(pw + 2 pad)
  int chunks_per_split;   // slab chunks a block of the grid's z axis takes
  int w8;                 // int8 weight rows only 8-byte aligned (Cin % 16)
};

// The rows of a sample's plane that a run of 128 consecutive pixels may
// span: a run starts at a multiple of 128, so at a column that is a multiple
// of gcd(w, 128), at most w - gcd(w, 128).
__host__ __device__ inline int run_rows(int w) {
  int a = w, b = 128;
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return (w - a + 127) / w + 1;
}

// The constants that follow from the kernel size. A slab chunk holds 64
// input channels and is multiplied in T steps, one weight tile each: its 9
// taps (3x3), or its one (1x1). The weight copies run D steps ahead; the
// slabs run in a ring of NB buffers: the next chunk lands during a 3x3
// chunk's taps, NB - 1 = 4 chunks ahead for a 1x1 conv, whose chunk is one
// step.
template <int KS>
struct Shape {
  static constexpr int T = KS == 3 ? 9 : 1;
  static constexpr int D = KS == 3 ? 3 : 4;
  static constexpr int NB = KS == 3 ? 2 : 5;
};

// Shared memory of a block, from a 1024-byte boundary: the weight tiles wgmma
// reads (D + 2 of bf16 weights; 3 widened ones and D raw stages of int8),
// NB slabs, NB stages of the chunk's A and D, the table of the slab rows'
// pixels, the block's bias rows and scales, the table of its 128 output
// pixels.
struct SlabSmem {
  uint32_t tiles, raw, slab, ad, table, bias, scale, pix, total;
};

__host__ __device__ inline SlabSmem slab_smem(int bn, bool q8, int ks, int rpg,
                                              int ns) {
  const int d = ks == 3 ? 3 : 4, nb = ks == 3 ? 2 : 5;
  SlabSmem s;
  s.tiles = 0;
  s.raw = (q8 ? 3 : d + 2) * bn * 128;
  s.slab = s.raw + (q8 ? d * bn * 64 : 0);
  s.ad = s.slab + nb * rpg * SLAB_PITCH;
  s.table = s.ad + nb * (2 * ns * 64 * 4);
  s.bias = s.table + ((rpg * 4 + 15) & ~15);
  s.scale = s.bias + ns * bn * 4;
  s.pix = s.scale + bn * 4;
  s.total = 1024 + s.pix + 128 * 4;
  return s;
}

__device__ __forceinline__ void cp_async16_to(uint32_t dst, const void* src,
                                              bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// 8 bytes, by cp.async.ca (the .cg form copies 16 only)
__device__ __forceinline__ void cp_async8_to(uint32_t dst, const void* src,
                                             bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 8 : 0)
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

// grid: (ceil(n / ns) * tiles, ceil(cout / BN), splits); 384 threads:
// warpgroups 0 and 1 copy the weights and multiply, 64 pixels each;
// warpgroup 2, the helper, copies the slabs and applies the prologue.
template <int BN, bool Q8, int KS>
__global__ void __launch_bounds__(SLAB_THREADS)
conv_slab_kernel(const SlabArgs a) {
  using S = Shape<KS>;
  constexpr int T = S::T, D = S::D, NB = S::NB;
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
  const uint32_t slab_bytes = a.rpg * SLAB_PITCH;
  const uint32_t ad_floats = 2 * a.ns * 64;   // A then D of one stage
  int* table = reinterpret_cast<int*>(gen + L.table);
  float* s_bias = reinterpret_cast<float*>(gen + L.bias);
  float* s_scale = reinterpret_cast<float*>(gen + L.scale);
  int* s_pix = reinterpret_cast<int*>(gen + L.pix);

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  // from a shuffle, so that the compiler sees the roles as warp-uniform
  const bool helper = __shfl_sync(0xffffffffu, tid / 128, 0) == 2;
  const int g = lane / 4, tg = lane % 4;
  const int hw = p.h * p.w;
  const int M = p.n * hw;
  const int K = KS * KS * p.cin;
  const int n0 = blockIdx.y * BN;
  // the block's first sample, the pixel its slab's first row of pixels
  // starts at (y0, x0), and where in that row its 128 pixels start (off,
  // a run's first column; 0 for a patch or whole planes)
  const int grp = blockIdx.x / a.tiles, tile = blockIdx.x - grp * a.tiles;
  const int nb0 = grp * a.ns;
  int y0, x0 = 0, off = 0;
  if (a.wrap) {
    y0 = tile * 128 / p.w;
    off = tile * 128 - y0 * p.w;
  } else {
    const int ty = tile / a.tiles_w;
    y0 = ty * a.ph;
    x0 = (tile - ty * a.tiles_w) * a.pw;
  }
  const int sw = a.pw + 2 * PAD;             // slab row of pixels
  const int plane = sw * (a.ph + 2 * PAD);   // slab rows of one sample
  // local pixel i of the block: its slab row at tap (0, 0) (row 0 for a
  // pixel outside the plane, whose result is not stored), and its output
  // pixel as (index << 3) | local sample, or -1
  auto locate = [&](int i, int& srow) {
    const int q = i + off, per = a.ph * a.pw;
    const int s = q / per, rem = q - s * per;
    const int r = rem / a.pw, c = rem - r * a.pw;
    const int n = nb0 + s, oh = y0 + r, ow = x0 + c;
    const bool in = s < a.ns && n < p.n && oh < p.h && ow < p.w;
    srow = in ? s * plane + r * sw + c : 0;
    return in ? (((n * p.h + oh) * p.w + ow) << 3) | s : -1;
  };

  // the pixel each slab row holds, as (pixel index << 3) | local sample, or
  // -1 outside the image or past the last sample: the conv's zero padding
  for (int q = tid; q < a.rpg; q += SLAB_THREADS) {
    const int s = q / plane, r2 = q - s * plane;
    const int r = r2 / sw, c = r2 - r * sw;
    const int n = nb0 + s, ih = y0 - PAD + r, iw = x0 - PAD + c;
    const bool in = n < p.n && ih >= 0 && ih < p.h && iw >= 0 && iw < p.w;
    table[q] = in ? ((((n * p.h + ih) * p.w + iw) << 3) | s) : -1;
  }
  if (tid < 128) {
    int unused;
    s_pix[tid] = locate(tid, unused);
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
  const int chunks_all = (p.cin + 63) / 64;   // the last may be short
  const int c_begin = blockIdx.z * a.chunks_per_split;
  const int c_end = min(c_begin + a.chunks_per_split, chunks_all);
  const int nsteps = (c_end - c_begin) * T;

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

  // the weight tile of step (chunk c, step t of it): its first K index, and
  // the input channels left from this thread's slot on (none or part of
  // one 16-byte slot past Cin: zero-filled)
  auto copy_weights = [&](int c, int t, int stage) {
    const int k0 = t * p.cin + c * 64;
    const int left = p.cin - c * 64 - w_cc * (Q8 ? 16 : 8);
    const uint32_t dst = base + (Q8 ? L.raw + stage * (BN * 64)
                                    : L.tiles + stage * (BN * 128)) + w_dst;
#pragma unroll
    for (int j = 0; j < W_ITERS; ++j) {
      if (w_r + W_RSTEP * j < BN) {
        const bool in = w_src[j] >= 0 && left > 0;
        const uint32_t d = dst + j * (W_RSTEP * (Q8 ? 64 : 128));
        if (Q8) {
          const int8_t* src =
              static_cast<const int8_t*>(p.wt) + (in ? w_src[j] + k0 : 0);
          if (a.w8) {
            cp_async8_to(d, src, in);
            cp_async8_to(d + 8, in ? src + 8 : src, in && left > 8);
          } else {
            cp_async16_to(d, src, in);
          }
        } else {
          cp_async16_to(d,
                        static_cast<const __nv_bfloat16*>(p.wt) +
                            (in ? w_src[j] + k0 : 0),
                        in);
        }
      }
    }
  };

  // slab chunk c into buffer buf: every row's 64 channels, and the chunk's
  // A and D of the block's samples; by the threads first, first + stride, ...
  // Both passes over a thread's slots below take them BATCH at a time, the
  // table and slab reads of a batch first, so that their latencies overlap
  // (a 3x3 step's share of the prologue is two slots a helper thread; wider
  // batches cost 3x3 steps 10%, H100).
  constexpr int BATCH = KS == 3 ? 2 : 4;
  const int slots = a.rpg * 8;
  auto copy_slab = [&](int c, int buf, int first, int stride) {
    const uint32_t dst = base + L.slab + buf * slab_bytes;
    const int cb = c * 64;
    for (int s0 = first; s0 < slots; s0 += BATCH * stride) {
      int e[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int slot = s0 + u * stride;
        e[u] = slot < slots ? table[slot >> 3] : -1;
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int slot = s0 + u * stride;
        if (slot >= slots) break;
        const int row = slot >> 3, j = slot & 7;
        const bool in = e[u] >= 0 && cb + j * 8 < p.cin;
        cp_async16_to(
            dst + row * SLAB_PITCH + j * 16,
            in ? p.x + ((long long)(e[u] >> 3) * p.cin + cb + j * 8) : p.x,
            in);
      }
    }
    if (a.prologue != PRO_NONE) {
      const int per = a.ns * 16;     // 16-byte copies of A, then of D
      const uint32_t ad = base + L.ad + buf * (ad_floats * 4);
      for (int i = first; i < 2 * per; i += stride) {
        const int which = i / per, r = i - which * per;
        const int s = r / 16, j = r - s * 16;
        const bool in = nb0 + s < p.n && cb + j * 4 < p.cin;
        const float* src = (which ? p.pd : p.pa) +
                           ((long long)(nb0 + s) * p.cin + cb + j * 4);
        cp_async16_to(ad + i * 16, in ? (const void*)src : (const void*)p.x,
                      in);
      }
    }
  };

  // the prologue on slots first + stride k, k in [k0, k1), in shared memory,
  // on the positions inside the image only: the zero padding stays zero. A
  // thread's slots are one 8-channel column (stride % 8 == 0): its A and D
  // are read again only where the sample changes.
  auto transform = [&](int buf, int k0, int k1, int first, int stride) {
    unsigned char* slab = gen + L.slab + buf * slab_bytes;
    const float* ad = reinterpret_cast<const float*>(gen + L.ad) +
                      buf * ad_floats + (first & 7) * 8;
    const int k_end = min(k1, (slots - first + stride - 1) / stride);
    float aa[8], dd[8];
    int have = -1;
    for (int k = k0; k < k_end; k += BATCH) {
      int e[BATCH];
      uint4 v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int row = (first + stride * (k + u)) >> 3;
        e[u] = k + u < k_end ? table[row] : -1;
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int slot = first + stride * (k + u);
        if (e[u] >= 0)
          v[u] = *reinterpret_cast<const uint4*>(
              slab + (slot >> 3) * SLAB_PITCH + (slot & 7) * 16);
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        if (e[u] < 0) continue;
        if ((e[u] & 7) != have) {
          have = e[u] & 7;
          const float* av = ad + have * 64;
          const float* dv = av + a.ns * 64;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            aa[i] = av[i];
            dd[i] = dv[i];
          }
        }
        __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&v[u]);
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
        const int slot = first + stride * (k + u);
        *reinterpret_cast<uint4*>(slab + (slot >> 3) * SLAB_PITCH +
                                  (slot & 7) * 16) = v[u];
      }
    }
  };
  // Slots a thread when the whole block shares a slab's prologue (the first
  // chunk's, each 1x1 chunk's), and when the helper warpgroup takes a 3x3
  // chunk's alone; of the latter a step's share
  const int nslots_all = (slots + SLAB_THREADS - 1) / SLAB_THREADS;
  const int hf = tid - SLAB_CONSUMERS;   // the helper's first slot

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
      if (++pt == T) {
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
  int frag_row;
  locate(wg * 64 + warp * 16 + (lane & 15), frag_row);
  const uint32_t frag_off = frag_row * SLAB_PITCH + (lane >> 4) * 16;

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  // the consumer's cursor, and the stages of step i: the weight tile in st,
  // raw int8 in sr; the copies of step i + D go to tile st_next (or to sr)
  int cc = c_begin, ct = 0, buf = 0;
  int st = 0, sr = 0, st_next = Q8 ? 0 : D % NT;
  if (helper) {
    // The helper warpgroup's whole loop (the roles never meet again: the
    // compiler serializes products it finds behind a divergent branch); each
    // barrier is the block's.
    if constexpr (KS == 3) {
      // The next chunk's slab: copied at this chunk's first step into the
      // buffer the last chunk has left, waited for D steps later, and
      // normalised, a share a step, over the chunk's remaining steps, under
      // the other warpgroups' products.
      const int sps = ((slots + 127) / 128 + T - D - 1) / (T - D);
      for (int i = 0; i < nsteps; ++i) {
        const bool next = cc + 1 < c_end;
        if (ct == D && next) cp_async_wait_mem<0>();
        slab_barrier();
        if (ct == 0 && next) {
          copy_slab(cc + 1, buf ^ 1, hf, 128);
          cp_async_commit_mem();
        }
        if (a.prologue != PRO_NONE && ct >= D && next)
          transform(buf ^ 1, (ct - D) * sps, (ct - D + 1) * sps, hf, 128);
        if (++ct == T) {
          ct = 0;
          ++cc;
          buf ^= 1;
        }
      }
    } else {
      // A 1x1 chunk is one step: the ring runs NB - 1 chunks ahead. At
      // chunk c's step the copy of chunk c + NB - 1 goes to the buffer
      // chunk c - 1 has left, and the whole block normalises chunk c + 1,
      // which this warpgroup waited for before the step's barrier (alone,
      // the helper took 2x the products' time at 48x48x640, H100).
      for (int k = 1; k < NB - 1; ++k) {
        if (c_begin + k < c_end) copy_slab(c_begin + k, k, hf, 128);
        cp_async_commit_mem();
      }
      cp_async_wait_mem<NB - 3>();   // chunk c_begin + 1 has landed
      for (int c = c_begin; c < c_end; ++c) {
        slab_barrier();
        if (c + NB - 1 < c_end)
          copy_slab(c + NB - 1, (c - c_begin + NB - 1) % NB, hf, 128);
        cp_async_commit_mem();
        if (a.prologue != PRO_NONE && c + 1 < c_end)
          transform((c - c_begin + 1) % NB, 0, nslots_all, tid, SLAB_THREADS);
        cp_async_wait_mem<NB - 3>();   // chunk c + 2, for the next step
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
      if (++pt == T) {
        pt = 0;
        ++pc;
      }
    }
    cp_async_commit_mem();

    // the fragment registers are written only while this warpgroup has no
    // product in flight (the compiler serializes the products otherwise)
    wgmma::wait<0>();
    const uint32_t rows = (ct / 3) * sw + ct % 3;   // the tap's offset
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
    // a 1x1 conv's next chunk: this thread's share of its prologue, under
    // the products just issued
    if (KS == 1 && a.prologue != PRO_NONE && i + 1 < nsteps)
      transform(buf + 1 == NB ? 0 : buf + 1, 0, nslots_all, tid,
                SLAB_THREADS);

    if (++ct == T) {
      ct = 0;
      buf = buf + 1 == NB ? 0 : buf + 1;
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
      const int e = s_pix[prow + half * 8];
      if (e < 0) continue;   // a pixel outside the plane
      float* dst = part + (long long)(e >> 3) * p.cout;
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
    // the bias row of the pixel's sample (any for one not stored)
    const int e = s_pix[prow + half * 8];
    const float* brow = s_bias + (e < 0 ? 0 : e & 7) * BN;
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
      const int e = s_pix[wg * 64 + r], col = n0 + cc8 * 8;
      if (e >= 0 && col < p.cout)
        *reinterpret_cast<uint4*>(p.y + (long long)(e >> 3) * p.cout + col) =
            ld_shared16(sC + r * LDC + cc8 * 16);
    }
    return;
  }
  for (int c = t; c < 64 * CPR; c += 128) {
    const int r = c / CPR, cc8 = c % CPR;
    const int e = s_pix[wg * 64 + r], col = n0 + cc8 * 8;
    if (e < 0 || col >= p.cout) continue;
    const uint4 v = ld_shared16(sC + r * LDC + cc8 * 16);
    const __nv_bfloat16* h8 = reinterpret_cast<const __nv_bfloat16*>(&v);
    __nv_bfloat16* dst = p.y + (long long)(e >> 3) * p.cout + col;
    for (int i = 0; i < 8 && col + i < p.cout; ++i) dst[i] = h8[i];
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
  const dim3 grid((unsigned)((a.c.n + a.ns - 1) / a.ns * a.tiles),
                  (a.c.cout + BN - 1) / BN, a.c.splits);
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

}  // namespace

// x: [n, h, w, cin] bf16; wt: [cout][ks][ks][cin], bf16, or int8 with
// w_scale [cout] f32; bias: f32, row s at bias + s * bias_stride
// (bias_stride 0 for one bias row, cout for one per sample); a, d: [n, cin]
// f32 when prologue is 1 (affine) or 2 (affine + SiLU); y: [n, h, w, cout]
// bf16. All contiguous, x, wt, a and d 16-byte aligned. ks 3 pads by 1, ks
// 1 by 0; stride 1; cin % 8 == 0; every tensor under 2^31 elements.
//
// The rest is the wrapper's plan (ops/conv.py:plan_conv), checked here. A
// block's 128 output pixels: with wrap 0, a ph x pw patch of one sample (ns
// 1, ph pw = 128; the patches at the plane's edge are cut by it) or ns whole
// planes (ph = h, pw = w, ns h w <= 128, ns <= 8); with wrap 1, a run of 128
// consecutive pixels of one sample (ns 1, pw = w, ph = run_rows(w)). The
// slab, ns (ph + 2 pad)(pw + 2 pad) rows, at most SLAB_MAX_ROWS; bn = 128
// or 160 output channels a block; the slab chunks (64 input channels; the
// last may be short) cut into `splits` runs of `chunks`, every run
// non-empty; ws holds the partials where splits > 1,
// else it is null. Returns a cudaError_t (0 on success).
extern "C" int sdtpu_conv_gn_silu(const void* x, const void* wt,
                                  const void* bias, const void* a,
                                  const void* d, const void* w_scale, void* y,
                                  void* ws, int n, int h, int w, int cin,
                                  int cout, int ks, int bias_stride,
                                  int prologue, int quantized, int wrap,
                                  int bn, int splits, int chunks, int ph,
                                  int pw, int ns, void* stream) {
  const long long big = 1LL << 31;
  if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || cin % 8 != 0 ||
      (ks != 1 && ks != 3) || prologue < PRO_NONE || prologue > PRO_SILU ||
      (prologue != PRO_NONE && (a == nullptr || d == nullptr)) ||
      (quantized && w_scale == nullptr) || bias == nullptr ||
      (long long)n * h * w * cin >= big || (long long)n * h * w * cout >= big ||
      (long long)cout * ks * ks * cin >= big || (cout + 127) / 128 > 65535 ||
      splits < 1 || splits > 65535 || (ws != nullptr) != (splits > 1) ||
      (long long)splits * n * h * w * cout >= big)
    return (int)cudaErrorInvalidValue;
  const int pad = ks / 2;
  bool tiled;
  if (wrap == 1)
    tiled = ns == 1 && pw == w && ph == run_rows(w);
  else
    tiled = wrap == 0 && ph >= 1 && pw >= 1 && ns >= 1 &&
            ns <= SLAB_MAX_SAMPLES &&
            ((ns == 1 && ph * pw == 128) ||
             (ph == h && pw == w && ns * h * w <= 128));
  const bool q8 = quantized != 0;
  if (!tiled || (bn != 128 && bn != 160) || chunks < 1)
    return (int)cudaErrorInvalidValue;
  const int rpg = ns * (ph + 2 * pad) * (pw + 2 * pad);
  const int chunks_all = (cin + 63) / 64;
  if (rpg > SLAB_MAX_ROWS || (long long)(splits - 1) * chunks >= chunks_all ||
      (long long)splits * chunks < chunks_all ||
      slab_smem(bn, q8, ks, rpg, ns).total > SMEM_CAP)
    return (int)cudaErrorInvalidValue;
  const int tiles_w = wrap ? 0 : (w + pw - 1) / pw;
  const int tiles = wrap ? (h * w + 127) / 128 : (h + ph - 1) / ph * tiles_w;
  const ConvArgs args{static_cast<const __nv_bfloat16*>(x), wt,
                      static_cast<const float*>(bias),
                      static_cast<const float*>(a), static_cast<const float*>(d),
                      q8 ? static_cast<const float*>(w_scale) : nullptr,
                      static_cast<__nv_bfloat16*>(y), static_cast<float*>(ws),
                      n, h, w, cin, cout, ks, bias_stride, splits};
  const SlabArgs sa{args, prologue, ph, pw, ns, wrap, tiles_w, tiles, rpg,
                    chunks, (int)(q8 && cin % 16 != 0)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 160)
    return (int)(q8 ? launch_slab_ks<160, true>(sa, s)
                    : launch_slab_ks<160, false>(sa, s));
  return (int)(q8 ? launch_slab_ks<128, true>(sa, s)
                  : launch_slab_ks<128, false>(sa, s));
}
