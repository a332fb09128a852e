// GroupNorm (+SiLU) over channels-last activations for Hopper (sm_90a),
// bf16 in and out.
//
// Replaces sdtpu/ops/groupnorm.py:_gn_kernel, the Pallas TPU kernel of the
// JAX package. It computes the same function: per (sample, group), the mean
// and variance in f32 over the group's HW x C/G slab; the affine folded into
// one multiply-add per channel, a = rstd * scale and b = bias - mean * a;
// SiLU when asked; one rounding to bf16 at the single store. The variance is
// two-pass (the mean first, then the centred squares), where the TPU kernel
// takes E[x^2] - mean^2: both compute GroupNorm, the two-pass form without
// the cancellation.
//
// What bounds it on this card: device memory. At the UNet's 64x64 level
// ([2, 4096, 320]) one call reads and writes 5.2 MB each and does about ten
// operations per element, far below the ~295 operations per byte at which
// the tensor cores, not the memory, would be the limit.
//
// What the design does about it: one launch reads x from device memory
// once and writes y once. A group's statistics need the whole plane, and
// blocks cannot wait on each other, so each (sample, group) is one cluster
// of 8 blocks: each block sums its eighth of the rows, and the blocks of the
// cluster exchange their partial sums through distributed shared memory.
// At SD1.5's 2 x 32 (sample, group) pairs that gives 512 blocks for the 132
// SMs, where one block per group would leave half of them idle. The second
// and third passes over the slab (centred squares, then normalise and
// store) find it in the 50 MB L2: the largest UNet plane is 10.5 MB. Loads
// are vectors along C of 8, 2 or 1 bf16s, the widest that divides C/G (the
// group widths 10-80 of SD1.5 are not all multiples of 8); a thread walks a
// flattened (row, channel) index of its block's slab, so a group narrower
// than a vector row needs no ragged tail.
//
// A statistics-only mode writes the GroupNorm folded into per-(sample,
// channel) A and D instead of y: the prologue operands of conv_gn_silu.cu.
// It replaces sdtpu/ops/conv.py:gn_affine (XLA work in the reference, a
// dozen small kernels in eager PyTorch) by one launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace coop = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;          // blocks per (sample, group)
constexpr int THREADS = 256;
constexpr int MAX_CPG = 4096;       // channels per group (shared scale/shift)
constexpr int MAX_GRID_Y = 65535;
// what the kernel writes: the normalised x, the same through SiLU, or only
// the GroupNorm folded into per-(sample, channel) A and D, y = x * A + D
// (the prologue of the fused conv, conv_gn_silu.cu)
constexpr int NORM = 0, NORM_SILU = 1, AFFINE = 2;

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

// Sum over the block; the result is valid in thread 0. The caller puts a
// barrier between two uses of `red`.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) t += red[i];
  return t;
}

// x, y: [N, hw, c] bf16, contiguous; scale, bias: [c] of type P; a_out,
// d_out: [N, c] f32 (AFFINE only, which writes no y).
// grid: (CLUSTER, N * groups); the CLUSTER blocks of one (sample, group)
// form a cluster and split its rows evenly.
template <int VEC, int MODE, typename P>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
gn_kernel(const __nv_bfloat16* __restrict__ x, const P* __restrict__ scale,
          const P* __restrict__ bias, __nv_bfloat16* __restrict__ y,
          float* __restrict__ a_out, float* __restrict__ d_out, int hw, int c,
          int cpg, float eps) {
  extern __shared__ float ab[];       // [2][cpg]: folded scale, then shift
  __shared__ float red[THREADS / 32];
  __shared__ float part[2];           // this block's partial sums
  __shared__ float stat[2];           // the group's mean and rstd

  coop::cluster_group cluster = coop::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int groups = c / cpg;
  const int n = blockIdx.y / groups;
  const int g = blockIdx.y % groups;
  const int r0 = (int)((long long)hw * rank / CLUSTER);
  const int r1 = (int)((long long)hw * (rank + 1) / CLUSTER);
  const int nv = cpg / VEC;           // vectors per row of the group
  const int total = (r1 - r0) * nv;   // vectors in this block's slab
  const long long base = (long long)n * hw * c + (long long)g * cpg;
  const __nv_bfloat16* xg = x + base + (long long)r0 * c;
  const float count = (float)hw * (float)cpg;

  // pass 1: the group's mean
  float s = 0.f;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int row = i / nv, col = (i - row * nv) * VEC;
    float v[VEC];
    load_bf16<VEC>(xg + (long long)row * c + col, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) s += v[e];
  }
  s = block_sum(s, red);
  if (threadIdx.x == 0) part[0] = s;
  cluster.sync();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int r = 0; r < CLUSTER; ++r) t += *cluster.map_shared_rank(&part[0], r);
    stat[0] = t / count;
  }
  __syncthreads();
  const float mean = stat[0];

  // pass 2: the centred sum of squares
  float q = 0.f;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int row = i / nv, col = (i - row * nv) * VEC;
    float v[VEC];
    load_bf16<VEC>(xg + (long long)row * c + col, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float dv = v[e] - mean;
      q += dv * dv;
    }
  }
  q = block_sum(q, red);
  if (threadIdx.x == 0) part[1] = q;
  cluster.sync();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int r = 0; r < CLUSTER; ++r) t += *cluster.map_shared_rank(&part[1], r);
    stat[1] = rsqrtf(t / count + eps);
  }
  // no block may exit, freeing its shared memory, while another block of
  // the cluster still reads it; this is the last remote read
  cluster.sync();
  const float rstd = stat[1];

  if (MODE == AFFINE) {
    if (rank == 0) {
      for (int j = threadIdx.x; j < cpg; j += THREADS) {
        const int ch = g * cpg + j;
        const float a = rstd * to_float(scale[ch]);
        a_out[(long long)n * c + ch] = a;
        d_out[(long long)n * c + ch] = to_float(bias[ch]) - mean * a;
      }
    }
    return;
  }

  for (int j = threadIdx.x; j < cpg; j += THREADS) {
    const float a = rstd * to_float(scale[g * cpg + j]);
    ab[j] = a;
    ab[cpg + j] = to_float(bias[g * cpg + j]) - mean * a;
  }
  __syncthreads();

  // pass 3: normalise (+ SiLU), one store
  __nv_bfloat16* yg = y + base + (long long)r0 * c;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int row = i / nv, col = (i - row * nv) * VEC;
    float v[VEC];
    load_bf16<VEC>(xg + (long long)row * c + col, v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float z = v[e] * ab[col + e] + ab[cpg + col + e];
      if (MODE == NORM_SILU) z = z / (1.f + __expf(-z));
      v[e] = z;
    }
    store_bf16<VEC>(yg + (long long)row * c + col, v);
  }
}

struct GnArgs {
  const void* x;
  const void* scale;
  const void* bias;
  void* y;
  float* a_out;
  float* d_out;
  int n, hw, c, groups;
  float eps;
  cudaStream_t stream;
};

template <int VEC, int MODE, typename P>
cudaError_t launch(const GnArgs& a) {
  const int cpg = a.c / a.groups;
  const dim3 grid(CLUSTER, a.n * a.groups);
  gn_kernel<VEC, MODE, P><<<grid, THREADS, 2 * cpg * sizeof(float), a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.x), static_cast<const P*>(a.scale),
      static_cast<const P*>(a.bias), static_cast<__nv_bfloat16*>(a.y), a.a_out,
      a.d_out, a.hw, a.c, cpg, a.eps);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mode(const GnArgs& a, bool param_bf16) {
  const int cpg = a.c / a.groups;
  if (cpg % 8 == 0)
    return param_bf16 ? launch<8, MODE, __nv_bfloat16>(a)
                      : launch<8, MODE, float>(a);
  if (cpg % 2 == 0)
    return param_bf16 ? launch<2, MODE, __nv_bfloat16>(a)
                      : launch<2, MODE, float>(a);
  return param_bf16 ? launch<1, MODE, __nv_bfloat16>(a)
                    : launch<1, MODE, float>(a);
}

bool valid(int n, int hw, int c, int groups) {
  return n > 0 && hw > 0 && c > 0 && groups > 0 && c % groups == 0 &&
         c / groups <= MAX_CPG && (long long)n * groups <= MAX_GRID_Y &&
         (long long)hw * c < (1LL << 31);
}

}  // namespace

// x, y: [n, hw, c] bf16, contiguous, 16-byte aligned; scale, bias: [c],
// bf16 if param_bf16 else f32. c % groups == 0, c / groups <= 4096,
// n * groups <= 65535, hw * c < 2^31. Returns a cudaError_t (0 on success).
extern "C" int sdtpu_group_norm_silu(const void* x, const void* scale,
                                     const void* bias, void* y, int n, int hw,
                                     int c, int groups, float eps, int silu,
                                     int param_bf16, void* stream) {
  if (!valid(n, hw, c, groups)) return (int)cudaErrorInvalidValue;
  const GnArgs a{x, scale, bias, y, nullptr, nullptr, n, hw, c, groups, eps,
                 static_cast<cudaStream_t>(stream)};
  return (int)(silu ? launch_mode<NORM_SILU>(a, param_bf16 != 0)
                    : launch_mode<NORM>(a, param_bf16 != 0));
}

// The statistics pass alone: a, d: [n, c] f32 with GroupNorm(x) = x * a + d
// per sample; the rest as sdtpu_group_norm_silu.
extern "C" int sdtpu_group_norm_affine(const void* x, const void* scale,
                                       const void* bias, void* a, void* d,
                                       int n, int hw, int c, int groups,
                                       float eps, int param_bf16,
                                       void* stream) {
  if (!valid(n, hw, c, groups)) return (int)cudaErrorInvalidValue;
  const GnArgs args{x, scale, bias, nullptr, static_cast<float*>(a),
                    static_cast<float*>(d), n, hw, c, groups, eps,
                    static_cast<cudaStream_t>(stream)};
  return (int)launch_mode<AFFINE>(args, param_bf16 != 0);
}
