// Training-mode batch norm over channels_last maps, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package's batch norm is flax's
// nn.BatchNorm, plain jnp that XLA fuses into the convolutions' epilogues
// on the TPU. The port's plain PyTorch version of the same maths
// (models/layers.py: _FlaxTrainingNorm) makes a dozen float32 passes over
// every map each way and keeps two float32 maps of each call for the
// backward, and so held half of every training step on the card. These
// kernels compute what it computes, flax's training batch norm:
//
//   mean = E[x], var = max(E[x^2] - mean^2, 0), r = rsqrt(var + eps),
//   y = (x - mean) * (r * w) + b,
//
// per channel over the N = B * H * W positions, with flax's running
// statistics moved as keep * old + momentum * batch (the biased
// variance), and its gradient
//
//   dbias = sum dy, dweight = r * sum dy * (x - mean),
//   dx = (w * r / N) * (N * dy - sum dy - xhat * sum dy * xhat),
//   xhat = (x - mean) * r,
//
// with the variance term dropped where the variance was clamped (the
// clamp then passes no gradient). Every statistic and every arithmetic
// step is float32 in registers (the sums across blocks float64); the
// maps are read and written in their own type, bf16 or float32. Each
// elementwise step is written with the _rn intrinsics in the plain
// version's order (no FMA contraction), so a map's output differs from
// the plain version's only through the statistics' summation order.
//
// What bounds it: bytes. A map is NCHW in channels_last memory, so it is
// M = B * H * W rows of C contiguous channels; the work needs one read of
// x and one write of y forward (4 bytes an element in bf16) and one read
// of dy and x and one write of dx backward (6 bytes), against a handful
// of operations an element. Each direction is two passes over the map
// and one small launch between them:
//
//   reduce_kernel      one read of x (forward: sum x, sum x^2) or of dy
//                      and x (backward: sum dy, sum dy * (x - mean)),
//                      float32 sums per thread, a float32 row of partial
//                      sums per block;
//   fwd_finalize_kernel, bwd_finalize_kernel
//                      the blocks' rows summed per channel in float64 in
//                      a fixed order, then the per-channel work (the
//                      variance, running statistics, r, r * w; or the
//                      parameter gradients and dx's coefficients);
//   apply_kernel, dx_kernel
//                      one read and one write of the map.
//
// No float map is ever written to device memory: the backward reads the
// forward's own input x again, and the per-channel vectors (mean, r,
// r * w, the clamp flag) are all it keeps beside it.
//
// Layout: a block's threads form a (groups, rows) grid. Thread (g, r)
// owns V neighbouring channels, (chunk * groups + g) * V, with V = 8
// where C % 8 == 0 and the maps are 16-byte aligned (one 16-byte load of
// 8 bf16 values, two of 8 floats), else V = 1; and the rows r +
// (block * rows) + k * (blocks * rows), k = 0, 1, .... A warp so reads
// whole rows of neighbouring channels, contiguous in memory. The plan
// (ops/batch_norm.py: plan) depends on M, C and V alone, so the partial
// sums, and so the statistics, have the same bits on every run and card:
// no float atomics. Each thread keeps its channels' per-channel values in
// registers and loads kUnroll rows before it sums or stores any.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
// the most blocks of a pass over the map (BLOCKS of ops/batch_norm.py):
// four blocks of 256 threads an SM of the 132 of an H100 SXM
constexpr int kMaxBlocks = 528;
// rows each thread loads before it sums or stores
constexpr int kUnroll = 4;
// channels a finalize block takes, and its threads along the partials
constexpr int kFinChannels = 32;
constexpr int kFinSlices = 32;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// V values of T at p as floats: 16-byte loads where V == 8 (p is then
// 16-byte aligned).
template <typename T, int V>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 8 && sizeof(T) == 2) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else if constexpr (V == 8 && sizeof(T) == 4) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = to_float(p[k]);
  }
}

// V floats stored at p as T, each rounded to nearest even.
template <typename T, int V>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&v)[V]) {
  if constexpr (V == 8 && sizeof(T) == 2) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else if constexpr (V == 8 && sizeof(T) == 4) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = from_float<T>(v[k]);
  }
}

// Per-channel sums over the map, one float32 row of partials a block:
// part[(block * 2 + s) * C + c], s = 0: sum x (BWD: sum dy), s = 1: sum
// x^2 (BWD: sum dy * (x - mean)). A thread sums its rows in order, kUnroll
// at a time; the block sums its threads' rows r = 0 .. rows - 1 in order.
template <bool BWD, typename TX, typename TD, int V>
__global__ void __launch_bounds__(kThreads, BWD ? 2 : 4)
reduce_kernel(const TX* __restrict__ x, const TD* __restrict__ dy,
              const float* __restrict__ stats, float* __restrict__ part,
              int64_t M, int C) {
  __shared__ float sh[2 * kThreads * V];
  const int groups = blockDim.x, rows = blockDim.y;
  const int cb = groups * V;
  const int c0 = (blockIdx.y * groups + threadIdx.x) * V;
  float mean[V], s[V], q[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    mean[k] = BWD ? stats[c0 + k] : 0.0f;
    s[k] = 0.0f;
    q[k] = 0.0f;
  }
  const int64_t stride = (int64_t)gridDim.x * rows;
  for (int64_t row = (int64_t)blockIdx.x * rows + threadIdx.y; row < M;
       row += kUnroll * stride) {
    float a[kUnroll][V], d[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t at = row + u * stride;
      if (at < M) {
        load<TX, V>(x + at * C + c0, a[u]);
        if constexpr (BWD) load<TD, V>(dy + at * C + c0, d[u]);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          a[u][k] = 0.0f;
          d[u][k] = 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if constexpr (BWD) {
          s[k] += d[u][k];
          q[k] += d[u][k] * (a[u][k] - mean[k]);
        } else {
          s[k] += a[u][k];
          q[k] += a[u][k] * a[u][k];
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    sh[threadIdx.y * cb + threadIdx.x * V + k] = s[k];
    sh[(rows + threadIdx.y) * cb + threadIdx.x * V + k] = q[k];
  }
  __syncthreads();
  for (int i = threadIdx.y * groups + threadIdx.x; i < 2 * cb;
       i += groups * rows) {
    const int which = i / cb, j = i - which * cb;
    float t = 0.0f;
    for (int r = 0; r < rows; ++r) t += sh[(which * rows + r) * cb + j];
    part[((int64_t)blockIdx.x * 2 + which) * C + blockIdx.y * cb + j] = t;
  }
}

// The per-channel sums of the blocks' partial rows, in float64: thread
// (x, y) of a (kFinChannels, kFinSlices) block sums rows y, y +
// kFinSlices, ... of its channel, then thread (x, 0) the slices in order.
// Every thread of the block calls it; the sums land in thread (x, 0)'s
// s0 and s1.
__device__ __forceinline__ void sum_partials(const float* __restrict__ part,
                                             int blocks, int C, int c,
                                             double& s0, double& s1) {
  __shared__ double sh[2][kFinSlices][kFinChannels + 1];
  double a = 0.0, b = 0.0;
  if (c < C) {
    for (int p = threadIdx.y; p < blocks; p += kFinSlices) {
      a += part[(int64_t)(2 * p) * C + c];
      b += part[(int64_t)(2 * p + 1) * C + c];
    }
  }
  sh[0][threadIdx.y][threadIdx.x] = a;
  sh[1][threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  s0 = 0.0;
  s1 = 0.0;
  if (threadIdx.y == 0) {
    for (int y = 0; y < kFinSlices; ++y) {
      s0 += sh[0][y][threadIdx.x];
      s1 += sh[1][y][threadIdx.x];
    }
  }
}

// The forward's per-channel work. With part: E[x] and E[x^2] from the
// partial rows (sums / n); written to moments_out (2 * C: E[x], E[x^2])
// and nothing else where moments_out is given. Else E[x] and E[x^2] from
// moments_in where part is null. Then var = max(E[x^2] - E[x]^2, 0), the
// running statistics moved (where update; num_batches_tracked + 1),
// r = rsqrt(var + eps), and stats (4 * C) = [mean, r, r * w, clamped].
__global__ void __launch_bounds__(kFinChannels * kFinSlices)
fwd_finalize_kernel(const float* __restrict__ part, int blocks, double n,
                    const float* __restrict__ moments_in,
                    float* __restrict__ moments_out,
                    const float* __restrict__ weight, float* __restrict__ running_mean,
                    float* __restrict__ running_var, long long* __restrict__ tracked,
                    int update, float eps, float keep, float momentum,
                    float* __restrict__ stats, int C) {
  const int c = blockIdx.x * kFinChannels + threadIdx.x;
  float mean, mean_sq;
  if (part != nullptr) {
    double s0, s1;
    sum_partials(part, blocks, C, c, s0, s1);
    if (threadIdx.y != 0 || c >= C) return;
    mean = (float)(s0 / n);
    mean_sq = (float)(s1 / n);
    if (moments_out != nullptr) {
      moments_out[c] = mean;
      moments_out[C + c] = mean_sq;
      return;
    }
  } else {
    if (threadIdx.y != 0 || c >= C) return;
    mean = moments_in[c];
    mean_sq = moments_in[C + c];
  }
  const float var_raw = __fsub_rn(mean_sq, __fmul_rn(mean, mean));
  const bool clamped = var_raw < 0.0f;
  const float var = clamped ? 0.0f : var_raw;
  if (update) {
    running_mean[c] = __fadd_rn(__fmul_rn(keep, running_mean[c]),
                                __fmul_rn(momentum, mean));
    running_var[c] = __fadd_rn(__fmul_rn(keep, running_var[c]),
                               __fmul_rn(momentum, var));
    if (c == 0) *tracked += 1;
  }
  const float r = __frsqrt_rn(__fadd_rn(var, eps));
  stats[c] = mean;
  stats[C + c] = r;
  stats[2 * C + c] = __fmul_rn(r, weight[c]);
  stats[3 * C + c] = clamped ? 1.0f : 0.0f;
}

// y = (x - mean) * (r * w) + b, in float32, stored as TY.
template <typename TX, typename TY, int V>
__global__ void __launch_bounds__(kThreads, 2)
apply_kernel(const TX* __restrict__ x, const float* __restrict__ stats,
             const float* __restrict__ bias, TY* __restrict__ y, int64_t M,
             int C) {
  const int rows = blockDim.y;
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  float mean[V], mul[V], b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    mean[k] = stats[c0 + k];
    mul[k] = stats[2 * C + c0 + k];
    b[k] = bias[c0 + k];
  }
  const int64_t stride = (int64_t)gridDim.x * rows;
  for (int64_t row = (int64_t)blockIdx.x * rows + threadIdx.y; row < M;
       row += kUnroll * stride) {
    float a[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t at = row + u * stride;
      if (at < M) load<TX, V>(x + at * C + c0, a[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t at = row + u * stride;
      if (at < M) {
        float o[V];
#pragma unroll
        for (int k = 0; k < V; ++k)
          o[k] = __fadd_rn(__fmul_rn(__fsub_rn(a[u][k], mean[k]), mul[k]), b[k]);
        store<TY, V>(y + at * C + c0, o);
      }
    }
  }
}

// The backward's per-channel work. With part: the local sums S0 = sum dy
// and S1 = sum dy * (x - mean) from the partial rows, dbias = S0 and
// dweight = r * S1, and (where sums_out is given) [S0, S1] in sums_out
// (2 * C). Where coef is given: dx's coefficients from the sums over the
// whole batch, sums_in (2 * C) where given, else the local ones:
// coef (3 * C) = [w * r / n, S0, r * S1 (0 where the variance was
// clamped)].
__global__ void __launch_bounds__(kFinChannels * kFinSlices)
bwd_finalize_kernel(const float* __restrict__ part, int blocks,
                    const float* __restrict__ sums_in, float* __restrict__ sums_out,
                    const float* __restrict__ stats, const float* __restrict__ weight,
                    float n, float* __restrict__ dweight, float* __restrict__ dbias,
                    float* __restrict__ coef, int C) {
  const int c = blockIdx.x * kFinChannels + threadIdx.x;
  float s0 = 0.0f, s1 = 0.0f;
  if (part != nullptr) {
    double d0, d1;
    sum_partials(part, blocks, C, c, d0, d1);
    s0 = (float)d0;
    s1 = (float)d1;
  }
  if (threadIdx.y != 0 || c >= C) return;
  const float r = stats[C + c];
  if (part != nullptr) {
    dbias[c] = s0;
    dweight[c] = __fmul_rn(r, s1);
    if (sums_out != nullptr) {
      sums_out[c] = s0;
      sums_out[C + c] = s1;
    }
  }
  if (coef != nullptr) {
    const float g0 = sums_in != nullptr ? sums_in[c] : s0;
    const float g1 = sums_in != nullptr ? sums_in[C + c] : s1;
    const bool clamped = stats[3 * C + c] != 0.0f;
    coef[c] = __fdiv_rn(__fmul_rn(weight[c], r), n);
    coef[C + c] = g0;
    coef[2 * C + c] = clamped ? 0.0f : __fmul_rn(r, g1);
  }
}

// dx = k * ((n * dy - S0) - xhat * r * S1), xhat = (x - mean) * r, in
// float32, stored as TX.
template <typename TX, typename TD, int V>
__global__ void __launch_bounds__(kThreads, 2)
dx_kernel(const TX* __restrict__ x, const TD* __restrict__ dy,
          const float* __restrict__ stats, const float* __restrict__ coef,
          float n, TX* __restrict__ dx, int64_t M, int C) {
  const int rows = blockDim.y;
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  float mean[V], r[V], k_[V], g0[V], g1[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    mean[k] = stats[c0 + k];
    r[k] = stats[C + c0 + k];
    k_[k] = coef[c0 + k];
    g0[k] = coef[C + c0 + k];
    g1[k] = coef[2 * C + c0 + k];
  }
  const int64_t stride = (int64_t)gridDim.x * rows;
  for (int64_t row = (int64_t)blockIdx.x * rows + threadIdx.y; row < M;
       row += kUnroll * stride) {
    float a[kUnroll][V], d[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t at = row + u * stride;
      if (at < M) {
        load<TX, V>(x + at * C + c0, a[u]);
        load<TD, V>(dy + at * C + c0, d[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t at = row + u * stride;
      if (at < M) {
        float o[V];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xhat = __fmul_rn(__fsub_rn(a[u][k], mean[k]), r[k]);
          const float t = __fsub_rn(__fsub_rn(__fmul_rn(n, d[u][k]), g0[k]),
                                    __fmul_rn(xhat, g1[k]));
          o[k] = __fmul_rn(k_[k], t);
        }
        store<TX, V>(dx + at * C + c0, o);
      }
    }
  }
}

// A pass's launch geometry, checked against the map: blocks x chunks
// blocks of (groups, rows) threads, groups * V channels a chunk.
struct Pass {
  dim3 grid, block;
  int64_t M;
  int C;
  cudaStream_t stream;
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int make_pass(int vec, int64_t M, int C, int groups, int rows, int chunks,
              int blocks, void* stream, std::initializer_list<const void*> maps,
              Pass& pass) {
  if (M < 0 || C <= 0 || (vec != 1 && vec != 8) || groups <= 0 || rows <= 0 ||
      groups * rows > kThreads || chunks <= 0 || chunks > 65535 || blocks <= 0 ||
      blocks > kMaxBlocks || (int64_t)groups * chunks * vec != C)
    return (int)cudaErrorInvalidValue;
  if (vec == 8)
    for (const void* p : maps)
      if (p != nullptr && !aligned16(p)) return (int)cudaErrorInvalidValue;
  pass.grid = dim3(blocks, chunks);
  pass.block = dim3(groups, rows);
  pass.M = M;
  pass.C = C;
  pass.stream = static_cast<cudaStream_t>(stream);
  return 0;
}

// Calls f.template run<TA, TB, V>() for the dtypes a and b (kF32 or
// kBF16) and V = vec (1 or 8).
template <typename TA, typename F>
int with_b(int b, int vec, F& f) {
  if (b == kF32) return vec == 8 ? f.template run<TA, float, 8>() : f.template run<TA, float, 1>();
  if (b == kBF16) return vec == 8 ? f.template run<TA, bf16, 8>() : f.template run<TA, bf16, 1>();
  return (int)cudaErrorInvalidValue;
}

template <typename F>
int dispatch(int a, int b, int vec, F& f) {
  if (a == kF32) return with_b<float>(b, vec, f);
  if (a == kBF16) return with_b<bf16>(b, vec, f);
  return (int)cudaErrorInvalidValue;
}

struct Reduce {
  const Pass& p;
  int bwd;
  const void *x, *dy, *stats;
  float* part;
  template <typename TX, typename TD, int V>
  int run() {
    if (bwd)
      reduce_kernel<true, TX, TD, V><<<p.grid, p.block, 0, p.stream>>>(
          static_cast<const TX*>(x), static_cast<const TD*>(dy),
          static_cast<const float*>(stats), part, p.M, p.C);
    else
      reduce_kernel<false, TX, TD, V><<<p.grid, p.block, 0, p.stream>>>(
          static_cast<const TX*>(x), nullptr, nullptr, part, p.M, p.C);
    return (int)cudaGetLastError();
  }
};

struct Apply {
  const Pass& p;
  const void *x, *stats, *bias;
  void* y;
  template <typename TX, typename TY, int V>
  int run() {
    apply_kernel<TX, TY, V><<<p.grid, p.block, 0, p.stream>>>(
        static_cast<const TX*>(x), static_cast<const float*>(stats),
        static_cast<const float*>(bias), static_cast<TY*>(y), p.M, p.C);
    return (int)cudaGetLastError();
  }
};

struct Dx {
  const Pass& p;
  const void *x, *dy, *stats, *coef;
  float n;
  void* dx;
  template <typename TX, typename TD, int V>
  int run() {
    dx_kernel<TX, TD, V><<<p.grid, p.block, 0, p.stream>>>(
        static_cast<const TX*>(x), static_cast<const TD*>(dy),
        static_cast<const float*>(stats), static_cast<const float*>(coef), n,
        static_cast<TX*>(dx), p.M, p.C);
    return (int)cudaGetLastError();
  }
};

dim3 finalize_grid(int C) { return dim3((C + kFinChannels - 1) / kFinChannels); }

}  // namespace

extern "C" {

// The maps are channels_last (B, C, H, W) device buffers of M = B * H * W
// rows of C channels, of dtype x_dtype / dy_dtype (0 float32, 1
// bfloat16); the plan (ops/batch_norm.py: plan) gives vec (1 or 8:
// channels a thread, 8 only where every map is 16-byte aligned), groups,
// rows, chunks and blocks (at most kMaxBlocks), with groups * chunks *
// vec == C. part holds blocks * 2 * C floats. Forward (bwd 0): the sums
// of x and x^2; backward (bwd 1): of dy and dy * (x - mean), mean the
// first C floats of stats. Returns the launch's error.
int cadepth_bn_reduce(int bwd, int x_dtype, int dy_dtype, int vec,
                      const void* x, const void* dy, const void* stats,
                      void* part, long long M, int C, int groups, int rows,
                      int chunks, int blocks, void* stream) {
  Pass p;
  int err = make_pass(vec, M, C, groups, rows, chunks, blocks, stream,
                      {x, bwd ? dy : nullptr}, p);
  if (err) return err;
  if (bwd && (dy == nullptr || stats == nullptr)) return (int)cudaErrorInvalidValue;
  Reduce f{p, bwd, x, dy, stats, static_cast<float*>(part)};
  return dispatch(x_dtype, bwd ? dy_dtype : x_dtype, vec, f);
}

// The forward's per-channel launch (fwd_finalize_kernel above): part
// (blocks rows of 2 * C floats, the sums over n positions) or
// moments_in (2 * C floats: E[x], E[x^2]) with part null; moments_out
// (2 * C floats) given: E[x] and E[x^2] written there and nothing else.
// weight, running_mean, running_var (C floats), tracked (one int64) and
// stats (4 * C floats). Returns the launch's error.
int cadepth_bn_fwd_finalize(const void* part, int blocks, double n,
                            const void* moments_in, void* moments_out,
                            const void* weight, void* running_mean,
                            void* running_var, void* tracked, int update,
                            float eps, float keep, float momentum, void* stats,
                            int C, void* stream) {
  if (C <= 0 || (part == nullptr) == (moments_in == nullptr) ||
      (part != nullptr && (blocks <= 0 || blocks > kMaxBlocks)) ||
      (moments_out == nullptr &&
       (weight == nullptr || stats == nullptr ||
        (update && (running_mean == nullptr || running_var == nullptr ||
                    tracked == nullptr)))))
    return (int)cudaErrorInvalidValue;
  fwd_finalize_kernel<<<finalize_grid(C), dim3(kFinChannels, kFinSlices), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), blocks, n,
      static_cast<const float*>(moments_in), static_cast<float*>(moments_out),
      static_cast<const float*>(weight), static_cast<float*>(running_mean),
      static_cast<float*>(running_var), static_cast<long long*>(tracked), update,
      eps, keep, momentum, static_cast<float*>(stats), C);
  return (int)cudaGetLastError();
}

// y (dtype y_dtype) = (x - mean) * (r * w) + bias from stats (4 * C
// floats: mean, r, r * w, clamped) and bias (C floats); the plan as for
// cadepth_bn_reduce. Returns the launch's error.
int cadepth_bn_apply(int x_dtype, int y_dtype, int vec, const void* x,
                     const void* stats, const void* bias, void* y, long long M,
                     int C, int groups, int rows, int chunks, int blocks,
                     void* stream) {
  Pass p;
  int err = make_pass(vec, M, C, groups, rows, chunks, blocks, stream, {x, y}, p);
  if (err) return err;
  Apply f{p, x, stats, bias, y};
  return dispatch(x_dtype, y_dtype, vec, f);
}

// The backward's per-channel launch (bwd_finalize_kernel above): part
// (blocks rows of 2 * C floats) gives the local sums, dweight and dbias
// (C floats each) and, where sums_out (2 * C floats) is given, the sums
// there; coef (3 * C floats), where given, from sums_in (2 * C floats,
// the sums over every rank) or the local sums. n: the positions of the
// whole batch. Returns the launch's error.
int cadepth_bn_bwd_finalize(const void* part, int blocks, const void* sums_in,
                            void* sums_out, const void* stats,
                            const void* weight, float n, void* dweight,
                            void* dbias, void* coef, int C, void* stream) {
  if (C <= 0 || stats == nullptr ||
      (part != nullptr && (blocks <= 0 || blocks > kMaxBlocks ||
                           dweight == nullptr || dbias == nullptr)) ||
      (part == nullptr && (sums_in == nullptr || coef == nullptr)) ||
      (coef != nullptr && weight == nullptr))
    return (int)cudaErrorInvalidValue;
  bwd_finalize_kernel<<<finalize_grid(C), dim3(kFinChannels, kFinSlices), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), blocks, static_cast<const float*>(sums_in),
      static_cast<float*>(sums_out), static_cast<const float*>(stats),
      static_cast<const float*>(weight), n, static_cast<float*>(dweight),
      static_cast<float*>(dbias), static_cast<float*>(coef), C);
  return (int)cudaGetLastError();
}

// dx (x's dtype) from x, dy, stats (4 * C floats) and coef (3 * C floats:
// w * r / n, S0, r * S1); the plan as for cadepth_bn_reduce. Returns the
// launch's error.
int cadepth_bn_dx(int x_dtype, int dy_dtype, int vec, const void* x,
                  const void* dy, const void* stats, const void* coef, float n,
                  void* dx, long long M, int C, int groups, int rows, int chunks,
                  int blocks, void* stream) {
  Pass p;
  int err = make_pass(vec, M, C, groups, rows, chunks, blocks, stream,
                      {x, dy, dx}, p);
  if (err) return err;
  Dx f{p, x, dy, stats, coef, n, dx};
  return dispatch(x_dtype, dy_dtype, vec, f);
}

const char* cadepth_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
