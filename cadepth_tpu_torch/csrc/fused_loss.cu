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
// Statistics, one launch (stats_kernel): a block owns tiles of `rows`
// rows of one sample (tile i of the B * ceil(H / rows) tiles goes to
// block i mod blocks, at most kMaxStatsBlocks blocks), so each pixel's
// sample, row and column come from the tile and the thread; a thread
// takes Q = 4 neighbouring columns where W % 4 == 0 (a float4 load of
// pred and of gt where the buffers are 16-byte aligned, four scalar
// loads where not) and one elsewhere, the same columns in each of its
// rows. Its xs come once per column and its ys once per row (a thread
// per element would divide both for each element, after two 64-bit
// integer divisions of the flat index). Each thread sums its pixels'
// four values in f32, the block sums its threads in double in a fixed
// order and writes one row of four partials; after a grid-wide barrier
// (a cooperative launch: every block is resident at once), block 0 sums
// the rows in double in a fixed order and writes the four statistics.
// No float atomics, no counter, no second kernel: the block count and
// each block's pixels depend on the shape alone (ops/fused_loss.py:
// stats_plan), so two runs, and two cards, give the same bits, and the
// partial rows are a scratch buffer of the call's own (nothing carries
// from one launch to the next). The count is exact below 2^24 pixels.
//
// Gradient, one launch (grad_kernel): a block owns a tile of rows of one
// sample (grid z) and a strip of columns (grid y); its threads form a
// (threads_per_row, groups) grid, so each pixel's sample, row and column
// come from the block and the thread with no division. A thread takes Q
// = 4 neighbouring columns where W % 4 == 0 (a float4 load of pred and
// gt and a float4 store of dpred where the three buffers are 16-byte
// aligned, scalar loads and stores where not) and one elsewhere, in
// kGradRows rows of the tile (ops/fused_loss.py: grad_plan): every
// thread's pixels are loaded at once, and no thread takes a second
// pass. Its xs come once per column and its ys once per row; each pixel
// is computed in full and selected (+0 where gt <= eps), so the quad's
// logs and divisions overlap. The cotangents are read from device memory
// through a stride and three offsets (a stride of 0 is a broadcast one),
// so the backward neither waits on the host nor gathers them first.
// Each output is elementwise with the parent's expressions in their
// order: the blocks and their order change no bit.
//
// What bounds them: memory, 8 bytes read per element (12 with dpred
// written) against ~30 f32 operations and two logs; at the flagship's
// (4, 240, 320) that is 2.46 MB (3.69 MB for the gradient), about a
// microsecond at 3.35 TB/s, so the launch's fixed cost and the latency
// of one pass over memory set the time.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// rows of a tile each gradient thread takes (GRAD_ROWS_PER_THREAD of
// ops/fused_loss.py)
constexpr int kGradRows = 1;
// The statistics' most blocks (STATS_MAX_BLOCKS of ops/fused_loss.py):
// 2 an SM of the 132 of an H100 SXM, which a cooperative launch holds
// at once on any H100 (the kernel is built for 4 blocks an SM).
constexpr int kMaxStatsBlocks = 256;
constexpr float kEps = 1e-6f;
constexpr float kClampMax = 1000.0f;

__device__ __forceinline__ float clip(float x) {
  return fminf(fmaxf(x, kEps), kClampMax);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The block's sums of v[0..3] in a fixed order, in thread 0's v; every
// thread of the block calls it.
__device__ __forceinline__ void block_sum4(double (&v)[4],
                                           double (&sh)[4][kThreads / 32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const double t = warp_sum(v[m]);
    if (lane == 0) sh[m][warp] = t;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      double t = 0.0;
      for (int w = 0; w < kThreads / 32; ++w) t += sh[m][w];
      v[m] = t;
    }
  }
}

// One pixel's four terms added to s where gt > eps. Computed for every
// pixel and selected, without a branch, so that the pixels of a thread's
// quad overlap (the clips keep both logs finite); adding +0 for a
// masked pixel leaves each f32 sum as skipping it would, since a sum
// that starts at +0 never becomes -0.
__device__ __forceinline__ void add_pixel(float p, float g, float xs, float ys,
                                          float (&s)[4]) {
  const bool in = g > kEps;
  const float d = __fsub_rn(logf(clip(p)), logf(clip(g)));
  const float e = __fsub_rn(p, g);
  const float ex = __fmul_rn(xs, e), ey = __fmul_rn(ys, e);
  const float rep = __fsqrt_rn(__fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)), __fmul_rn(e, e)),
      kEps));
  s[0] += in ? d : 0.0f;
  s[1] += in ? d * d : 0.0f;
  s[2] += in ? 1.0f : 0.0f;
  s[3] += in ? rep : 0.0f;
}

// Q values of pred and gt from flat index `at`: one float4 each where
// Q = 4 and the buffers are 16-byte aligned.
template <int Q, bool ALIGNED>
__device__ __forceinline__ void load_quad(const float* __restrict__ pred,
                                          const float* __restrict__ gt, int64_t at,
                                          float (&pv)[Q], float (&gv)[Q]) {
  if constexpr (Q == 4 && ALIGNED) {
    const float4 p4 = *reinterpret_cast<const float4*>(pred + at);
    const float4 g4 = *reinterpret_cast<const float4*>(gt + at);
    pv[0] = p4.x; pv[1] = p4.y; pv[2] = p4.z; pv[3] = p4.w;
    gv[0] = g4.x; gv[1] = g4.y; gv[2] = g4.z; gv[3] = g4.w;
  } else {
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      pv[k] = pred[at + k];
      gv[k] = gt[at + k];
    }
  }
}

// Block i owns tiles i, i + blocks, ... of the B * n_tiles tiles; tile t
// is rows [(t mod n_tiles) * rows, +rows) of sample t / n_tiles. A
// thread owns Q columns (q * Q, +Q) for q = q0, q0 + tpr, ... and the
// rows v0 + g, v0 + g + groups, ... of each tile, with tpr = min(W / Q,
// kThreads) and groups = kThreads / tpr (threads past tpr * groups idle).
// Launched cooperatively (grid.sync()); part holds 4 doubles a block.
template <int Q, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, 4)
stats_kernel(const float* __restrict__ pred, const float* __restrict__ gt,
             const float* __restrict__ k4, double* __restrict__ part,
             float* __restrict__ out, int B, int H, int W, int rows,
             int n_tiles) {
  __shared__ double sh[4][kThreads / 32];
  const int nq = W / Q;
  const int tpr = max(1, min(nq, kThreads)), groups = kThreads / tpr;
  const int q0 = threadIdx.x % tpr, g = threadIdx.x / tpr;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int tile = blockIdx.x; g < groups && tile < B * n_tiles;
       tile += gridDim.x) {
    const int b = tile / n_tiles;
    const int v_lo = (tile - b * n_tiles) * rows;
    const int v_hi = min(v_lo + rows, H);
    // K's four values are read here and first used after the first row's
    // loads are issued, and each row's loads are issued before the row
    // before it is summed: the thread waits for memory about once a tile
    const float* kb = k4 + 4 * b;
    const float k_fx = kb[0], k_fy = kb[1], cx = kb[2], cy = kb[3];
    const int64_t plane = (int64_t)b * H;
    for (int q = q0; q < nq; q += tpr) {
      int v = v_lo + g;
      if (v >= v_hi) break;
      float pv[Q], gv[Q];
      load_quad<Q, ALIGNED>(pred, gt, (plane + v) * W + (int64_t)q * Q, pv, gv);
      const float fx = __fadd_rn(k_fx, kEps), fy = __fadd_rn(k_fy, kEps);
      float xs[Q];
#pragma unroll
      for (int k = 0; k < Q; ++k)
        xs[k] = __fdiv_rn(__fsub_rn((float)(q * Q + k), cx), fx);
      for (; v < v_hi; v += groups) {
        float pn[Q], gn[Q];
        const bool more = v + groups < v_hi;
        if (more)
          load_quad<Q, ALIGNED>(pred, gt, (plane + v + groups) * W + (int64_t)q * Q,
                                pn, gn);
        const float ys = __fdiv_rn(__fsub_rn((float)v, cy), fy);
#pragma unroll
        for (int k = 0; k < Q; ++k) add_pixel(pv[k], gv[k], xs[k], ys, s);
        if (more) {
#pragma unroll
          for (int k = 0; k < Q; ++k) {
            pv[k] = pn[k];
            gv[k] = gn[k];
          }
        }
      }
    }
  }
  double v[4] = {s[0], s[1], s[2], s[3]};
  block_sum4(v, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int m = 0; m < 4; ++m) part[(int64_t)blockIdx.x * 4 + m] = v[m];
  }
  // every block's row is in device memory past this barrier
  cooperative_groups::this_grid().sync();
  if (blockIdx.x != 0) return;
  // block 0: the rows in a fixed order (thread t: rows t, t + kThreads,
  // ...; then block_sum4), read past L1
  double a[4] = {0.0, 0.0, 0.0, 0.0};
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) {
    const double2* row = reinterpret_cast<const double2*>(part + (int64_t)i * 4);
    const double2 lo = __ldcg(row), hi = __ldcg(row + 1);
    a[0] += lo.x;
    a[1] += lo.y;
    a[2] += hi.x;
    a[3] += hi.y;
  }
  block_sum4(a, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int m = 0; m < 4; ++m) out[m] = (float)a[m];
  }
}

// d/dpred of one pixel given the cotangents (c_d2x2 = c_d2 * 2), the
// reference's expressions in their order; computed for every pixel and
// selected, +0 where gt <= eps (the clips keep every term finite).
__device__ __forceinline__ float grad_pixel(float p, float g, float xs2, float ys2,
                                            float c_d, float c_d2x2, float c_rep) {
  const float pc = clip(p);
  const float d = __fsub_rn(logf(pc), logf(clip(g)));
  const float inv = (p > kEps && p < kClampMax) ? __fdiv_rn(1.0f, pc) : 0.0f;
  const float e = __fsub_rn(p, g);
  const float geom = __fadd_rn(__fadd_rn(xs2, ys2), 1.0f);
  const float ge = __fmul_rn(geom, e);
  const float rep = __fsqrt_rn(__fadd_rn(__fmul_rn(ge, e), kEps));
  const float drep = __fdiv_rn(ge, rep);
  const float out = __fadd_rn(
      __fadd_rn(__fmul_rn(c_d, inv), __fmul_rn(__fmul_rn(c_d2x2, d), inv)),
      __fmul_rn(c_rep, drep));
  return g > kEps ? out : 0.0f;
}

// Block (tile, strip, b): rows [tile * rows, +rows) of sample b, column
// units (Q columns each) [strip * blockDim.x, +blockDim.x); thread (x, y)
// takes unit strip * blockDim.x + x in rows tile * rows + y + r * groups,
// r < kGradRows, with groups = blockDim.y and rows = groups * kGradRows.
// cot holds c_d, c_d2 and c_rep at elements off_d, off_d2 and off_rep
// times cot_stride.
template <int Q, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, 4)
grad_kernel(const float* __restrict__ pred, const float* __restrict__ gt,
            const float* __restrict__ k4, const float* __restrict__ cot,
            int64_t cot_stride, int off_d, int off_d2, int off_rep,
            float* __restrict__ dpred, int H, int W) {
  const int q = blockIdx.y * blockDim.x + threadIdx.x;
  const int v0 = blockIdx.x * blockDim.y * kGradRows + threadIdx.y;
  if (q >= W / Q || v0 >= H) return;
  const int b = blockIdx.z;
  const int u0 = q * Q;
  const int64_t plane = (int64_t)b * H;
  float pv[kGradRows][Q], gv[kGradRows][Q];
#pragma unroll
  for (int r = 0; r < kGradRows; ++r) {
    const int v = v0 + r * blockDim.y;
    if (v < H) load_quad<Q, ALIGNED>(pred, gt, (plane + v) * W + u0, pv[r], gv[r]);
  }
  const float c_d = cot[off_d * cot_stride];
  const float c_d2x2 = __fmul_rn(cot[off_d2 * cot_stride], 2.0f);
  const float c_rep = cot[off_rep * cot_stride];
  const float* kb = k4 + 4 * b;
  const float fx = __fadd_rn(kb[0], kEps), fy = __fadd_rn(kb[1], kEps);
  const float cx = kb[2], cy = kb[3];
  float xs2[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const float xs = __fdiv_rn(__fsub_rn((float)(u0 + k), cx), fx);
    xs2[k] = __fmul_rn(xs, xs);
  }
#pragma unroll
  for (int r = 0; r < kGradRows; ++r) {
    const int v = v0 + r * blockDim.y;
    if (v >= H) break;
    const float ys = __fdiv_rn(__fsub_rn((float)v, cy), fy);
    const float ys2 = __fmul_rn(ys, ys);
    float out[Q];
#pragma unroll
    for (int k = 0; k < Q; ++k)
      out[k] = grad_pixel(pv[r][k], gv[r][k], xs2[k], ys2, c_d, c_d2x2, c_rep);
    float* at = dpred + (plane + v) * W + u0;
    if constexpr (Q == 4 && ALIGNED) {
      *reinterpret_cast<float4*>(at) = make_float4(out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
      for (int k = 0; k < Q; ++k) at[k] = out[k];
    }
  }
}

}  // namespace

extern "C" {

// pred and gt are contiguous (B, H, W) float32 device buffers, k4 a
// contiguous (B, 4) float32 one, out a float32 (4,) one; `rows` rows a
// tile and `blocks` blocks (ops/fused_loss.py: stats_plan: 1 to
// kMaxStatsBlocks); part holds 32 * blocks bytes, 16-byte aligned (its
// contents are not read). Launches the statistics kernel cooperatively
// on `stream` and returns the launch's error; out receives [sum d,
// sum d^2, count, sum reprojection].
int cadepth_fused_loss_stats(const void* pred, const void* gt, const void* k4,
                             void* part, void* out, int B, int H, int W,
                             int rows, int blocks, void* stream) {
  if (rows <= 0 || B < 0 || H < 0 || W < 0 || blocks <= 0 ||
      blocks > kMaxStatsBlocks)
    return (int)cudaErrorInvalidValue;
  int n_tiles = H > 0 ? (H + rows - 1) / rows : 1;
  if ((int64_t)B * n_tiles >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  const float* p = static_cast<const float*>(pred);
  const float* g = static_cast<const float*>(gt);
  const float* k = static_cast<const float*>(k4);
  double* rows_out = static_cast<double*>(part);
  float* o = static_cast<float*>(out);
  void* args[] = {&p, &g, &k, &rows_out, &o, &B, &H, &W, &rows, &n_tiles};
  const bool aligned = ((reinterpret_cast<uintptr_t>(pred) |
                         reinterpret_cast<uintptr_t>(gt)) & 15u) == 0;
  const void* fn = W % 4 != 0 ? (const void*)stats_kernel<1, false>
                   : aligned  ? (const void*)stats_kernel<4, true>
                              : (const void*)stats_kernel<4, false>;
  return (int)cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads), args,
                                          0, static_cast<cudaStream_t>(stream));
}

// pred, gt and dpred are contiguous (B, H, W) float32 device buffers, k4
// a contiguous (B, 4) float32 one; cot a float32 device buffer holding
// the cotangents c_d, c_d2 and c_rep of sums 0, 1 and 3 at elements
// off_d, off_d2 and off_rep times cot_stride (which may be 0). The plan
// (ops/fused_loss.py: grad_plan): threads_per_row threads of Q columns
// span a strip of a row, groups rows at once, rows = groups * kGradRows
// rows a tile, strips strips a row. Launches the gradient kernel on
// `stream` (nothing where B * H * W == 0) and returns the launch's error.
int cadepth_fused_loss_grad(const void* pred, const void* gt, const void* k4,
                            const void* cot, long long cot_stride, int off_d,
                            int off_d2, int off_rep, void* dpred, int B, int H,
                            int W, int threads_per_row, int groups, int rows,
                            int strips, void* stream) {
  if (B < 0 || H < 0 || W < 0) return (int)cudaErrorInvalidValue;
  if ((int64_t)B * H * W == 0) return 0;
  const int quad = W % 4 == 0 ? 4 : 1;
  const int nq = W / quad;
  if (threads_per_row <= 0 || groups <= 0 || threads_per_row * groups > kThreads ||
      rows != groups * kGradRows || strips <= 0 || strips > 65535 || B > 65535 ||
      (int64_t)strips * threads_per_row < nq ||
      (int64_t)(strips - 1) * threads_per_row >= nq)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((H + rows - 1) / rows, strips, B);
  const dim3 block(threads_per_row, groups);
  const bool aligned = ((reinterpret_cast<uintptr_t>(pred) |
                         reinterpret_cast<uintptr_t>(gt) |
                         reinterpret_cast<uintptr_t>(dpred)) & 15u) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pred);
  const float* g = static_cast<const float*>(gt);
  const float* k = static_cast<const float*>(k4);
  const float* c = static_cast<const float*>(cot);
  float* o = static_cast<float*>(dpred);
  const int64_t cs = cot_stride;
  if (quad == 1)
    grad_kernel<1, false><<<grid, block, 0, s>>>(p, g, k, c, cs, off_d, off_d2,
                                                  off_rep, o, H, W);
  else if (aligned)
    grad_kernel<4, true><<<grid, block, 0, s>>>(p, g, k, c, cs, off_d, off_d2,
                                                 off_rep, o, H, W);
  else
    grad_kernel<4, false><<<grid, block, 0, s>>>(p, g, k, c, cs, off_d, off_d2,
                                                  off_rep, o, H, W);
  return (int)cudaGetLastError();
}

const char* cadepth_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
