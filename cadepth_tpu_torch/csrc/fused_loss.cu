// Fused masked depth-loss statistics and their gradient, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels `_stats_kernel` (launched by `_stats_fwd_impl`)
// and `_grad_kernel` (launched by `_grad_impl`) of
// cadepth_tpu/ops/pallas/fused_loss.py. Over the pixels with gt > eps,
// with d = log clip(pred) - log clip(gt) (clip to [eps, 1000]) and the
// back-projection coordinates xs = (u - cx) / (fx + eps),
// ys = (v - cy) / (fy + eps) of pixel (row v, column u), K in pixels:
//
//   stats = [sum d, sum d^2, count, sum sqrt((xs*e)^2 + (ys*e)^2 + e^2 + eps)],
//   e = pred - gt,
//
// and, given the cotangents (c_d, c_d2, c_rep) of sums 0, 1 and 3,
//
//   dpred = c_d * inv + c_d2 * 2 * d * inv + c_rep * geom * e / sqrt(geom * e^2 + eps)
//
// on those pixels (0 elsewhere), geom = xs^2 + ys^2 + 1, inv = 1 / clip(pred)
// strictly inside (eps, 1000), else 0. The forward and the backward write
// the distance with different expressions, as the reference does; each
// is mirrored with the _rn intrinsics (no FMA contraction), true
// divisions and the accurate logf and sqrt (the build sets no fast-math
// flag), as in the plain versions of cadepth_tpu_torch/ops/fused_loss.py.
//
// Design: one pass over pred and gt, a thread per element in a
// grid-stride loop. The statistics kernel sums its four values per
// thread, then per block in a fixed order, and writes one row of four
// per block; the host adds the rows (torch.sum), so there are no float
// atomics and two runs give the same bits. The number of blocks depends
// on the element count alone. The gradient kernel reads the cotangents
// from device memory, so the backward never waits on the host.
//
// What bounds it: memory, 8 bytes read per element (12 with dpred
// written) against ~30 f32 operations and two logs; at the flagship's
// (4, 240, 320) that is 2.46 MB, under a microsecond at 3.35 TB/s, so a
// launch's fixed cost sets the time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;
constexpr float kEps = 1e-6f;
constexpr float kClampMax = 1000.0f;

__device__ __forceinline__ float clip(float x) {
  return fminf(fmaxf(x, kEps), kClampMax);
}

// xs, ys of flat element idx of a (B, H, W) map; k4 is (B, 4) [fx, fy, cx, cy].
__device__ __forceinline__ void backproj(int64_t idx, int H, int W,
                                         const float* __restrict__ k4,
                                         float& xs, float& ys) {
  const int64_t hw = (int64_t)H * W;
  const int64_t b = idx / hw;
  const int64_t rem = idx - b * hw;
  const int v = (int)(rem / W);
  const int u = (int)(rem - (int64_t)v * W);
  const float* kb = k4 + 4 * b;
  xs = __fdiv_rn(__fsub_rn((float)u, kb[2]), __fadd_rn(kb[0], kEps));
  ys = __fdiv_rn(__fsub_rn((float)v, kb[3]), __fadd_rn(kb[1], kEps));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
stats_kernel(const float* __restrict__ pred, const float* __restrict__ gt,
             const float* __restrict__ k4, float* __restrict__ partials, int B,
             int H, int W) {
  const int64_t n = (int64_t)B * H * W;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const float g = gt[idx];
    if (!(g > kEps)) continue;
    const float p = pred[idx];
    float xs, ys;
    backproj(idx, H, W, k4, xs, ys);
    const float d = __fsub_rn(logf(clip(p)), logf(clip(g)));
    const float e = __fsub_rn(p, g);
    const float ex = __fmul_rn(xs, e), ey = __fmul_rn(ys, e);
    const float rep = __fsqrt_rn(__fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)), __fmul_rn(e, e)),
        kEps));
    s[0] += d;
    s[1] += d * d;
    s[2] += 1.0f;
    s[3] += rep;
  }
  __shared__ float sh[4][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float t = warp_sum(s[m]);
    if (lane == 0) sh[m][warp] = t;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    float t = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) t += sh[threadIdx.x][w];
    partials[(int64_t)blockIdx.x * 4 + threadIdx.x] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
grad_kernel(const float* __restrict__ pred, const float* __restrict__ gt,
            const float* __restrict__ k4, const float* __restrict__ coefs,
            float* __restrict__ dpred, int B, int H, int W) {
  const int64_t n = (int64_t)B * H * W;
  const float c_d = coefs[0], c_d2 = coefs[1], c_rep = coefs[2];
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const float g = gt[idx];
    if (!(g > kEps)) {
      dpred[idx] = 0.0f;
      continue;
    }
    const float p = pred[idx];
    float xs, ys;
    backproj(idx, H, W, k4, xs, ys);
    const float pc = clip(p);
    const float d = __fsub_rn(logf(pc), logf(clip(g)));
    const float inv = (p > kEps && p < kClampMax) ? __fdiv_rn(1.0f, pc) : 0.0f;
    const float e = __fsub_rn(p, g);
    const float geom = __fadd_rn(__fadd_rn(__fmul_rn(xs, xs), __fmul_rn(ys, ys)), 1.0f);
    const float ge = __fmul_rn(geom, e);
    const float rep = __fsqrt_rn(__fadd_rn(__fmul_rn(ge, e), kEps));
    const float drep = __fdiv_rn(ge, rep);
    dpred[idx] = __fadd_rn(
        __fadd_rn(__fmul_rn(c_d, inv), __fmul_rn(__fmul_rn(__fmul_rn(c_d2, 2.0f), d), inv)),
        __fmul_rn(c_rep, drep));
  }
}

int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

}  // namespace

extern "C" {

// Rows of four partial sums that cadepth_fused_loss_stats writes for
// B * H * W elements.
int cadepth_fused_loss_blocks(int B, int H, int W) {
  return blocks_for((int64_t)B * H * W);
}

// pred and gt are contiguous (B, H, W) float32 device buffers, k4 a
// contiguous (B, 4) float32 one; partials holds
// cadepth_fused_loss_blocks(B, H, W) * 4 floats. Launches the statistics
// kernel on `stream` and returns cudaGetLastError(); summed over its
// rows, partials gives [sum d, sum d^2, count, sum reprojection].
int cadepth_fused_loss_stats(const void* pred, const void* gt, const void* k4,
                             void* partials, int B, int H, int W,
                             void* stream) {
  const int blocks = blocks_for((int64_t)B * H * W);
  stats_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pred), static_cast<const float*>(gt),
      static_cast<const float*>(k4), static_cast<float*>(partials), B, H, W);
  return (int)cudaGetLastError();
}

// pred, gt and dpred are contiguous (B, H, W) float32 device buffers, k4
// (B, 4) and coefs (3,) [c_d, c_d2, c_rep] float32 ones. Launches the
// gradient kernel on `stream` and returns cudaGetLastError().
int cadepth_fused_loss_grad(const void* pred, const void* gt, const void* k4,
                            const void* coefs, void* dpred, int B, int H,
                            int W, void* stream) {
  if ((int64_t)B * H * W == 0) return 0;
  const int blocks = blocks_for((int64_t)B * H * W);
  grad_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pred), static_cast<const float*>(gt),
      static_cast<const float*>(k4), static_cast<const float*>(coefs),
      static_cast<float*>(dpred), B, H, W);
  return (int)cudaGetLastError();
}

const char* cadepth_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
