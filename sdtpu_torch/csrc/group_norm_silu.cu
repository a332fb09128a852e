// GroupNorm (+SiLU) over channels-last activations for Hopper (sm_90a),
// bf16 in and out, and its statistics mode.
//
// Replaces sdtpu/ops/groupnorm.py:_gn_kernel, the Pallas TPU kernel of the
// JAX package. It computes the same function: per (sample, group), the mean
// and variance in f32 over the group's HW x C/G slab; the affine folded into
// one multiply-add per channel, a = rstd * scale and b = bias - mean * a;
// SiLU when asked; one rounding to bf16 at the single store. The variance is
// free of the E[x^2] - mean^2 cancellation the TPU kernel accepts: each
// block takes two passes over its tile in shared memory (the mean, then the
// centred squares), and the blocks' (count, mean, M2) are combined with
// Chan's formula. The statistics mode writes the GroupNorm folded into
// per-(sample, channel) A and D instead of y (the prologue operands of
// conv_gn_silu.cu), in place of sdtpu/ops/conv.py:gn_affine (XLA work in the
// reference).
//
// What bounds it on this card: device memory, and at the small planes
// latency. At the UNet's 64x64 level ([2, 4096, 320]) one call reads and
// writes 5.2 MB each and does about ten operations per element, far below
// the ~295 operations per byte at which the tensor cores would be the
// limit. At the 8x8 level a call moves 0.3 MB: a launch, one load, a chain
// of barriers and reductions, one store.
//
// What the design does about it (the plan is the wrapper's static rule,
// sdtpu_torch/ops/groupnorm.py:plan_gn, checked here):
// * A block takes `rows` rows of one sample times a span of whole groups, a
//   multiple of lcm(C/G, 8) channels, so every load and store is a 16-byte
//   vector and no vector crosses the span (C % 8 != 0 takes 4- or 2-byte
//   vectors in the same code). A thread keeps one vector column of the span
//   for a whole pass, so the channels it sums and the group of each are
//   fixed: no division in the element loops.
// * x is read once from device memory: the block's tile is copied by
//   cp.async into shared memory, both statistics passes run there (the
//   group means, then the centred squares; each pass's per-thread partials
//   folded by neighbouring lanes into channels, then by one warp a group
//   into groups), and where the rows fit
//   (the resident variant, every UNet site) the normalising pass reads the
//   tile too and y is written once.
// * The blocks of one (sample, span) form a cluster of up to 16 and combine
//   their partials in one exchange through distributed shared memory: one
//   barrier, every thread of a group reading all partials at once; the
//   barrier that keeps a block's shared memory alive until the others have
//   read it is split, its wait at the very end, behind the normalising
//   pass. A plane too large for a cluster's shared memory (the VAE's) is
//   streamed through two buffers per block, the next chunk landing while
//   one is reduced, the chunks' statistics combined with Chan's formula,
//   and the normalising pass reads x again; the statistics mode reads x
//   once at every size.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace coop = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CLUSTER = 16;     // blocks of one (sample, span)
constexpr int MAX_BUFS = 2;         // a block's tile buffers
constexpr int MAX_CPG = 4096;       // channels per group
constexpr int MAX_GRID_Y = 65535;
constexpr size_t SMEM_CAP = 227 * 1024;
constexpr int MAX_DEVICES = 64;
// what the kernel writes: the normalised x, the same through SiLU, or only
// the GroupNorm folded into per-(sample, channel) A and D, y = x * A + D
constexpr int NORM = 0, NORM_SILU = 1, AFFINE = 2;

// The dynamic shared memory of a block, as byte offsets: `bufs` tile buffers
// of `chunk` rows x `span` bf16, the reduction scratch (a float per vector
// lane of each thread), the channels' sums, their folded scale and shift,
// and six floats per group (ops/groupnorm.py:gn_smem_bytes).
struct Layout {
  size_t red, chs, ab, gst, total;
};

__host__ __device__ inline Layout gn_layout(int span, int cpg, int chunk,
                                            int bufs) {
  Layout l;
  const size_t buf = ((size_t)chunk * span * 2 + 15) / 16 * 16;
  l.red = bufs * buf;
  l.chs = l.red + (size_t)THREADS * 8 * sizeof(float);
  l.ab = l.chs + (size_t)span * sizeof(float);
  l.gst = l.ab + 2 * (size_t)span * sizeof(float);
  l.total = l.gst + 6 * (size_t)(span / cpg) * sizeof(float);
  return l;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int VEC>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* p, float* v) {
  if constexpr (VEC == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else if constexpr (VEC == 2) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = f.x;
    v[1] = f.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* p, const float* v) {
  if constexpr (VEC == 8) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n (0 or 1) of this thread's copy groups are in flight
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n == 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// the halves of a cluster barrier: arrive releases this block's shared
// memory writes, wait acquires the other blocks'
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// silu(z) = z / (1 + exp(-z)) = h + h tanh(h), h = z / 2: one
// special-function operation (as conv_gn_silu.cu's prologue)
__device__ __forceinline__ float silu_tanh(float z) {
  const float h = 0.5f * z;
  float t;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(t) : "f"(h));
  return fmaf(h, t, h);
}

struct GnArgs {
  const __nv_bfloat16* x;
  const void* scale;
  const void* bias;
  __nv_bfloat16* y;
  float* a_out;
  float* d_out;
  int hw, c, cpg;
  int span, cl, rows, chunk, bufs;   // the plan
  float eps;
};

// Which vector column of the span and which rows a thread takes: `cols`
// consecutive threads cover `cols` vectors of one row (all of the span's
// `vpr` where they fit in the block), `rpp` such rows side by side; a span
// wider than the block is walked in column blocks of `cols`.
struct Geo {
  int span, c, vpr, cols, rpp, jj, r0;
  bool on;
};

template <int VEC>
__device__ __forceinline__ Geo make_geo(int span, int c) {
  Geo g;
  g.span = span;
  g.c = c;
  g.vpr = span / VEC;
  g.cols = g.vpr < THREADS ? g.vpr : THREADS;
  g.rpp = THREADS / g.cols;
  g.jj = threadIdx.x % g.cols;
  g.r0 = threadIdx.x / g.cols;
  g.on = g.r0 < g.rpp;
  return g;
}

// Copy `rows` rows of the span from x (row pitch c) into a tile (row pitch
// span): asynchronous 16-byte copies, or plain loads for narrower vectors.
template <int VEC>
__device__ __forceinline__ void stage(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, int rows,
                                      const Geo& g) {
  if (!g.on) return;
  for (int j = g.jj; j < g.vpr; j += g.cols)
    for (int r = g.r0; r < rows; r += g.rpp) {
      __nv_bfloat16* d = dst + r * g.span + j * VEC;
      const __nv_bfloat16* s = src + (long long)r * g.c + j * VEC;
      if constexpr (VEC == 8) {
        cp_async16(d, s);
      } else if constexpr (VEC == 2) {
        *reinterpret_cast<__nv_bfloat162*>(d) =
            *reinterpret_cast<const __nv_bfloat162*>(s);
      } else {
        *d = *s;
      }
    }
}

// the sum over each aligned run of `width` lanes (a power of two up to 32),
// in every lane of the run
__device__ __forceinline__ float warp_sum(float v, int width) {
  for (int o = width / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Per-group sums over a tile's rows into out[gps]: of x, or with SQ of
// (x - its group's mean)^2, the means gsum[g] * inv. Each thread sums its
// column over its rows into `red` (rows of `cols` vectors); `lanes`
// neighbouring lanes add a channel's partials into chs, then one warp a
// group adds its channels; shuffles and fixed orders throughout. Ends on a
// barrier.
template <int VEC, bool SQ>
__device__ __forceinline__ void group_sums(const __nv_bfloat16* tile,
                                           int rows, const Geo& g, int cpg,
                                           const float* gsum, float inv,
                                           float* red, float* chs,
                                           float* out) {
  for (int jb = 0; jb < g.vpr; jb += g.cols) {
    const int j = jb + g.jj;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    if (g.on && j < g.vpr) {
      float mu[VEC];
      if constexpr (SQ) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) mu[e] = gsum[(j * VEC + e) / cpg] * inv;
      }
      for (int r = g.r0; r < rows; r += g.rpp) {
        float v[VEC];
        load_bf16<VEC>(tile + r * g.span + j * VEC, v);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          if constexpr (SQ) {
            const float d = v[e] - mu[e];
            acc[e] = fmaf(d, d, acc[e]);
          } else {
            acc[e] += v[e];
          }
        }
      }
    }
    if (g.on) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) red[threadIdx.x * VEC + e] = acc[e];
    }
    __syncthreads();
    // red holds rpp rows of w channel partials; this column block's width
    // channels, `lanes` lanes a channel (a power of two up to 32 that keeps
    // width * lanes within the block)
    const int w = g.cols * VEC, width = min(g.cols, g.vpr - jb) * VEC;
    int lanes = 1;
    while (lanes < 32 && width * lanes * 2 <= THREADS) lanes *= 2;
    for (int i0 = 0; i0 < width * lanes; i0 += THREADS) {
      const int i = i0 + threadIdx.x;
      const int c = i / lanes, part = i - c * lanes;
      float s = 0.f;
      if (c < width)
        for (int rr = part; rr < g.rpp; rr += lanes) s += red[rr * w + c];
      s = warp_sum(s, lanes);
      if (c < width && part == 0) chs[jb * VEC + c] = s;
    }
    __syncthreads();
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int gi = warp; gi < g.span / cpg; gi += THREADS / 32) {
    float s = 0.f;
    for (int k = lane; k < cpg; k += 32) s += chs[gi * cpg + k];
    s = warp_sum(s, 32);
    if (lane == 0) out[gi] = s;
  }
  __syncthreads();
}

// x, y: [N, hw, c] bf16; scale, bias: [c] of type P; a_out, d_out: [N, c]
// f32 (AFFINE only, which writes no y). grid: (cl, N * c / span), clusters
// of (cl, 1, 1): block `rank` of a cluster takes rows [rank * rows, (rank +
// 1) * rows) of sample blockIdx.y / spans, span blockIdx.y % spans, in
// chunks of `chunk` rows through `bufs` buffers (with two, the next chunk
// lands while one is reduced).
template <int VEC, int MODE, typename P>
__global__ void __launch_bounds__(THREADS) gn_kernel(const GnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = gn_layout(a.span, a.cpg, a.chunk, a.bufs);
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);
  const int buf = (int)((lay.red / a.bufs) / sizeof(__nv_bfloat16));
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* chs = reinterpret_cast<float*>(smem + lay.chs);
  float* ab = reinterpret_cast<float*>(smem + lay.ab);
  const int gps = a.span / a.cpg;
  float* g_sum = reinterpret_cast<float*>(smem + lay.gst);  // a chunk's
  float* g_m2 = g_sum + gps;
  float* run_mean = g_sum + 2 * gps;   // the block's, read by the cluster
  float* run_m2 = g_sum + 3 * gps;
  float* fin_mean = g_sum + 4 * gps;   // the (sample, group)'s
  float* fin_rstd = g_sum + 5 * gps;

  const Geo geo = make_geo<VEC>(a.span, a.c);
  const int rank = blockIdx.x;
  const int spans = a.c / a.span;
  const int n = blockIdx.y / spans, s = blockIdx.y - n * spans;
  const int r_begin = min(a.hw, rank * a.rows);
  const int my_rows = min(a.hw, r_begin + a.rows) - r_begin;
  const long long base = ((long long)n * a.hw + r_begin) * a.c +
                         (long long)s * a.span;
  const __nv_bfloat16* xs = a.x + base;
  const int chunks = (my_rows + a.chunk - 1) / a.chunk;

  const int first = min(a.bufs, chunks);
  for (int k = 0; k < first; ++k) {
    stage<VEC>(tile + k * buf, xs + (long long)k * a.chunk * a.c,
               min(a.chunk, my_rows - k * a.chunk), geo);
    cp_async_commit();
  }
  float run_n = 0.f;   // elements of a group this block has seen
  for (int k = 0; k < chunks; ++k) {
    const int rows_k = min(a.chunk, my_rows - k * a.chunk);
    const __nv_bfloat16* t = tile + (k % a.bufs) * buf;
    cp_async_wait(min(chunks, k + a.bufs) - k - 1);   // chunk k has landed
    __syncthreads();
    const float nb = (float)rows_k * a.cpg;
    group_sums<VEC, false>(t, rows_k, geo, a.cpg, nullptr, 0.f, red, chs,
                           g_sum);
    group_sums<VEC, true>(t, rows_k, geo, a.cpg, g_sum, 1.f / nb, red, chs,
                          g_m2);
    for (int g = threadIdx.x; g < gps; g += THREADS) {
      // Chan's combination of the running (run_n, mean, M2) and the chunk's
      const float mb = g_sum[g] / nb;
      if (k == 0) {
        run_mean[g] = mb;
        run_m2[g] = g_m2[g];
      } else {
        const float tot = run_n + nb, d = mb - run_mean[g];
        run_mean[g] += d * (nb / tot);
        run_m2[g] += g_m2[g] + d * d * (run_n * nb / tot);
      }
    }
    run_n += nb;
    __syncthreads();   // chunk k's buffer is free for chunk k + bufs
    if (k + a.bufs < chunks) {
      const int r1 = (k + a.bufs) * a.chunk;
      stage<VEC>(tile + (k % a.bufs) * buf, xs + (long long)r1 * a.c,
                 min(a.chunk, my_rows - r1), geo);
      cp_async_commit();
    }
  }
  if (chunks == 0) {   // a block past the plane's last row
    for (int g = threadIdx.x; g < gps; g += THREADS) {
      run_mean[g] = 0.f;
      run_m2[g] = 0.f;
    }
  }

  // the one exchange: every block of the cluster folds all partials, in
  // rank order, so all get the same statistics
  const float total = (float)a.hw * a.cpg;
  if (a.cl > 1) {
    cluster_arrive();
    cluster_wait();
    coop::cluster_group cluster = coop::this_cluster();
    for (int g = threadIdx.x; g < gps; g += THREADS) {
      float mean = 0.f;
      for (int r = 0; r < a.cl; ++r) {
        const int rb = min(a.hw, r * a.rows);
        const float cnt = (float)(min(a.hw, rb + a.rows) - rb) * a.cpg;
        mean = fmaf(cnt / total, *cluster.map_shared_rank(run_mean + g, r),
                    mean);
      }
      float m2 = 0.f;
      for (int r = 0; r < a.cl; ++r) {
        const int rb = min(a.hw, r * a.rows);
        const float cnt = (float)(min(a.hw, rb + a.rows) - rb) * a.cpg;
        const float d = *cluster.map_shared_rank(run_mean + g, r) - mean;
        m2 += *cluster.map_shared_rank(run_m2 + g, r) + cnt * d * d;
      }
      fin_mean[g] = mean;
      fin_rstd[g] = rsqrtf(m2 / total + a.eps);
    }
    // the remote reads are done; the wait that keeps this block's shared
    // memory alive for the others' comes at the end
    cluster_arrive();
  } else {
    for (int g = threadIdx.x; g < gps; g += THREADS) {
      fin_mean[g] = run_mean[g];
      fin_rstd[g] = rsqrtf(run_m2[g] / total + a.eps);
    }
  }
  __syncthreads();

  const P* scale = static_cast<const P*>(a.scale) + s * a.span;
  const P* bias = static_cast<const P*>(a.bias) + s * a.span;
  if (MODE == AFFINE) {
    if (rank == 0) {
      const long long o = (long long)n * a.c + (long long)s * a.span;
      for (int ch = threadIdx.x; ch < a.span; ch += THREADS) {
        const int g = ch / a.cpg;
        const float av = fin_rstd[g] * to_float(scale[ch]);
        a.a_out[o + ch] = av;
        a.d_out[o + ch] = to_float(bias[ch]) - fin_mean[g] * av;
      }
    }
  } else {
    for (int i = threadIdx.x; i < a.span; i += THREADS) {
      const int g = i / a.cpg;
      const float av = fin_rstd[g] * to_float(scale[i]);
      ab[i] = av;
      ab[a.span + i] = to_float(bias[i]) - fin_mean[g] * av;
    }
    __syncthreads();
    // normalise (+ SiLU), one store: from the tile where all of the block's
    // chunks are resident (row r in buffer r / chunk), else from x again
    const bool resident = chunks <= a.bufs;
    __nv_bfloat16* ys = a.y + base;
    for (int jb = 0; jb < geo.vpr; jb += geo.cols) {
      const int j = jb + geo.jj;
      if (!geo.on || j >= geo.vpr) continue;
      float av[VEC], bv[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        av[e] = ab[j * VEC + e];
        bv[e] = ab[a.span + j * VEC + e];
      }
      int rb = geo.r0 / a.chunk, ro = geo.r0 - rb * a.chunk;
      for (int r = geo.r0; r < my_rows; r += geo.rpp) {
        float v[VEC];
        load_bf16<VEC>(resident ? tile + rb * buf + ro * a.span + j * VEC
                                : xs + (long long)r * a.c + j * VEC,
                       v);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float z = fmaf(v[e], av[e], bv[e]);
          v[e] = MODE == NORM_SILU ? silu_tanh(z) : z;
        }
        store_bf16<VEC>(ys + (long long)r * a.c + j * VEC, v);
        for (ro += geo.rpp; ro >= a.chunk; ro -= a.chunk) ++rb;
      }
    }
  }
  if (a.cl > 1) cluster_wait();
}

template <int VEC, int MODE, typename P>
cudaError_t prepare(size_t smem, int cl) {
  // raise the kernel's shared-memory cap on this device to the most this
  // instantiation has needed there, and allow clusters above the portable 8,
  // once (not again inside a graph capture)
  static size_t allowed[MAX_DEVICES] = {};
  static bool wide[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > allowed[dev]) {
    err = cudaFuncSetAttribute(gn_kernel<VEC, MODE, P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    allowed[dev] = smem;
  }
  if (cl > 8 && !wide[dev]) {
    err = cudaFuncSetAttribute(gn_kernel<VEC, MODE, P>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
    wide[dev] = true;
  }
  return cudaSuccess;
}

// The launch configuration of a plan: grid (cl, n * spans), clusters of
// (cl, 1, 1) where cl > 1. `attr` must outlive the config.
cudaLaunchConfig_t config(const GnArgs& a, int n, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cl, n * (a.c / a.span), 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = gn_layout(a.span, a.cpg, a.chunk, a.bufs).total;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.cl > 1 ? 1 : 0;
  return cfg;
}

template <int VEC, int MODE, typename P>
cudaError_t launch(const GnArgs& a, int n, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(a, n, stream, attr);
  cudaError_t err = prepare<VEC, MODE, P>(cfg.dynamicSmemBytes, a.cl);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, gn_kernel<VEC, MODE, P>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of this plan the device holds at once.
template <int VEC, int MODE, typename P>
cudaError_t clusters(const GnArgs& a, int n, int* out) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(a, n, nullptr, attr);
  cudaError_t err = prepare<VEC, MODE, P>(cfg.dynamicSmemBytes, a.cl);
  if (err != cudaSuccess) return err;
  if (a.cl == 1) {
    int blocks = 0, sms = 0, dev = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, gn_kernel<VEC, MODE, P>, THREADS, cfg.dynamicSmemBytes);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    *out = blocks * sms;
    return err;
  }
  return cudaOccupancyMaxActiveClusters(
      out, reinterpret_cast<const void*>(gn_kernel<VEC, MODE, P>), &cfg);
}

template <int MODE, typename P>
cudaError_t dispatch_vec(const GnArgs& a, int n, cudaStream_t stream,
                         int* occupancy) {
  if (a.c % 8 == 0)
    return occupancy ? clusters<8, MODE, P>(a, n, occupancy)
                     : launch<8, MODE, P>(a, n, stream);
  if (a.c % 2 == 0)
    return occupancy ? clusters<2, MODE, P>(a, n, occupancy)
                     : launch<2, MODE, P>(a, n, stream);
  return occupancy ? clusters<1, MODE, P>(a, n, occupancy)
                   : launch<1, MODE, P>(a, n, stream);
}

template <int MODE>
cudaError_t dispatch(const GnArgs& a, int n, bool param_bf16,
                     cudaStream_t stream, int* occupancy = nullptr) {
  return param_bf16 ? dispatch_vec<MODE, __nv_bfloat16>(a, n, stream, occupancy)
                    : dispatch_vec<MODE, float>(a, n, stream, occupancy);
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// The contract, then the plan (ops/groupnorm.py:plan_gn): a span of whole
// groups and whole vectors (a multiple of lcm(c / groups, vec), vec = 8, 2
// or 1 as c allows) dividing c; 1 <= cl <= 16 blocks of ceil(hw / cl) rows;
// chunks of 1 <= chunk <= rows rows, one buffer where the chunk holds the
// block's rows (resident), else two; shared memory within the cap.
bool valid(int n, int hw, int c, int groups, int span, int cl, int chunk,
           int bufs, GnArgs* a) {
  if (n <= 0 || hw <= 0 || c <= 0 || groups <= 0 || c % groups != 0 ||
      c / groups > MAX_CPG || (long long)n * groups > MAX_GRID_Y ||
      (long long)hw * c >= (1LL << 31))
    return false;
  const int cpg = c / groups;
  const int vec = c % 8 == 0 ? 8 : c % 2 == 0 ? 2 : 1;
  const long long unit = (long long)cpg / gcd(cpg, vec) * vec;
  if (span <= 0 || span % unit != 0 || c % span != 0 || cl < 1 ||
      cl > MAX_CLUSTER)
    return false;
  const int rows = (hw + cl - 1) / cl;
  if (chunk < 1 || chunk > rows || bufs != (chunk == rows ? 1 : MAX_BUFS))
    return false;
  if (gn_layout(span, cpg, chunk, bufs).total > SMEM_CAP) return false;
  a->hw = hw;
  a->c = c;
  a->cpg = cpg;
  a->span = span;
  a->cl = cl;
  a->rows = rows;
  a->chunk = chunk;
  a->bufs = bufs;
  return true;
}

}  // namespace

// x, y: [n, hw, c] bf16, contiguous, 16-byte aligned; scale, bias: [c],
// bf16 if param_bf16 else f32. c % groups == 0, c / groups <= 4096,
// n * groups <= 65535, hw * c < 2^31; span, cl, chunk and bufs as valid()
// takes them. Returns a cudaError_t (0 on success).
extern "C" int sdtpu_group_norm_silu(const void* x, const void* scale,
                                     const void* bias, void* y, int n, int hw,
                                     int c, int groups, int span, int cl,
                                     int chunk, int bufs, float eps, int silu,
                                     int param_bf16, void* stream) {
  GnArgs a{static_cast<const __nv_bfloat16*>(x), scale, bias,
           static_cast<__nv_bfloat16*>(y), nullptr, nullptr};
  if (!valid(n, hw, c, groups, span, cl, chunk, bufs, &a))
    return (int)cudaErrorInvalidValue;
  a.eps = eps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(silu ? dispatch<NORM_SILU>(a, n, param_bf16 != 0, s)
                    : dispatch<NORM>(a, n, param_bf16 != 0, s));
}

// The statistics mode: a, d: [n, c] f32 with GroupNorm(x) = x * a + d per
// sample; the rest as sdtpu_group_norm_silu.
extern "C" int sdtpu_group_norm_affine(const void* x, const void* scale,
                                       const void* bias, void* a, void* d,
                                       int n, int hw, int c, int groups,
                                       int span, int cl, int chunk, int bufs,
                                       float eps, int param_bf16,
                                       void* stream) {
  GnArgs args{static_cast<const __nv_bfloat16*>(x), scale, bias, nullptr,
              static_cast<float*>(a), static_cast<float*>(d)};
  if (!valid(n, hw, c, groups, span, cl, chunk, bufs, &args))
    return (int)cudaErrorInvalidValue;
  args.eps = eps;
  return (int)dispatch<AFFINE>(args, n, param_bf16 != 0,
                               static_cast<cudaStream_t>(stream));
}

// How many of a plan's clusters (blocks, where cl is 1) the current device
// holds at once, into *out, for the normalising kernel with bf16 scale and
// bias; the rest as sdtpu_group_norm_silu.
extern "C" int sdtpu_group_norm_clusters(int n, int hw, int c, int groups,
                                         int span, int cl, int chunk,
                                         int bufs, int silu, void* out) {
  GnArgs a{};
  if (out == nullptr || !valid(n, hw, c, groups, span, cl, chunk, bufs, &a))
    return (int)cudaErrorInvalidValue;
  int* o = static_cast<int*>(out);
  return (int)(silu ? dispatch<NORM_SILU>(a, n, true, nullptr, o)
                    : dispatch<NORM>(a, n, true, nullptr, o));
}
