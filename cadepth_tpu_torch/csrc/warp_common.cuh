// Device code of the warp kernels. Shared by two_pass_warp.cu and
// fused_warp.cu: the line coefficients, the two-tap blend and the
// transposed passes' candidate search (span). Launched by fused_warp.cu
// alone: pass H (pass_h_kernel) and the transposed pass H of its
// backward (bwd_pass_kernel); the two-pass warp has kernels of its own.
// Both libraries compile it from this header; the build hashes it with
// each source that includes it (ops/_build.py).
//
// Numerics: the coefficients with the same f32 operations and
// f32-rounded constants as affine_pixel_coeffs and warp_coeffs
// (cadepth_tpu_torch/ops/affine_warp.py), each tap weight as
// max(1 - |pos - y|, 0) in f32, rounded to bf16 for bf16 features before
// the multiply, products and sums in f32. The _rn intrinsics forbid
// nvcc's contraction of a*b + c into one FMA, which would move a
// position by an ulp.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowBlocks = 65535;  // gridDim.y limit

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Weight in the dtype the reference multiplies with: bf16 tents for bf16 data.
template <typename T> __device__ __forceinline__ float tap_weight(float w) { return w; }
template <> __device__ __forceinline__ float tap_weight<__nv_bfloat16>(float w) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// f32 constants of affine_pixel_coeffs, rounded from double on the host
// as PyTorch rounds a Python float operand.
struct Consts {
  float w, h;      // W, H                     (align_corners: W-1, H-1)
  float kx, ky;    // 1/W - 1, 1/H - 1          (unused with align_corners)
  float hw, hh;    // W/2, H/2                  (align_corners: (W-1)/2, (H-1)/2)
  int align_corners;
};

// The six line coefficients [A, B, C, p, q, r] of one batch element.
struct Lines {
  float a, b, c, p, q, r;
};

__device__ __forceinline__ Lines lines(const float* __restrict__ th, const Consts& k) {
  const float t00 = th[0], t01 = th[1], t02 = th[2];
  const float t10 = th[3], t11 = th[4], t12 = th[5];
  float b, c, d, f;
  if (k.align_corners) {
    b = __fdiv_rn(__fmul_rn(t01, k.w), k.h);
    c = __fmul_rn(__fadd_rn(__fadd_rn(__fsub_rn(-t00, t01), t02), 1.0f), k.hw);
    d = __fdiv_rn(__fmul_rn(t10, k.h), k.w);
    f = __fmul_rn(__fadd_rn(__fadd_rn(__fsub_rn(-t10, t11), t12), 1.0f), k.hh);
  } else {
    b = __fdiv_rn(__fmul_rn(t01, k.w), k.h);
    c = __fsub_rn(__fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(t00, k.kx),
                                                           __fmul_rn(t01, k.ky)),
                                                 t02), 1.0f), k.hw), 0.5f);
    d = __fdiv_rn(__fmul_rn(t10, k.h), k.w);
    f = __fsub_rn(__fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(t10, k.kx),
                                                           __fmul_rn(t11, k.ky)),
                                                 t12), 1.0f), k.hh), 0.5f);
  }
  Lines l;
  l.a = t00;
  l.b = b;
  l.c = c;
  // A_safe keeps |A| >= 1e-3 with A's sign
  const float a_safe = fabsf(t00) < 1e-3f ? (t00 < 0.0f ? -1e-3f : 1e-3f) : t00;
  l.p = __fdiv_rn(d, a_safe);
  l.q = __fsub_rn(t11, __fmul_rn(l.p, b));
  l.r = __fsub_rn(f, __fmul_rn(l.p, c));
  return l;
}

// The two taps of tent(pos - y) over y in [0, size-1].
struct Taps {
  int i0, i1;  // source indices (valid only where the weight is non-zero)
  float w0, w1;
};

template <typename T>
__device__ __forceinline__ Taps two_taps(float pos, int size, bool border) {
  const float hi = (float)(size - 1);
  if (border) pos = fminf(fmaxf(pos, 0.0f), hi);
  const float y0 = floorf(pos);
  const float y1 = __fadd_rn(y0, 1.0f);
  Taps t;
  t.w0 = 0.0f;
  t.w1 = 0.0f;
  t.i0 = 0;
  t.i1 = 0;
  if (y0 >= 0.0f && y0 <= hi) {
    t.w0 = tap_weight<T>(fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(pos, y0))), 0.0f));
    t.i0 = (int)y0;
  }
  if (y1 >= 0.0f && y1 <= hi) {
    t.w1 = tap_weight<T>(fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(pos, y1))), 0.0f));
    t.i1 = (int)y1;
  }
  return t;
}

// dst[k] = w0 * a[k] + w1 * b[k] over one vector of VEC channels.
template <typename T, int VEC>
__device__ __forceinline__ void blend(T* __restrict__ dst, const T* __restrict__ a,
                                      const T* __restrict__ b, const Taps& t) {
  using P = Pack<T, VEC>;
  P pa, pb, out;
  if (t.w0 != 0.0f) pa = *reinterpret_cast<const P*>(a);
  if (t.w1 != 0.0f) pb = *reinterpret_cast<const P*>(b);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float s0 = t.w0 != 0.0f ? __fmul_rn(t.w0, to_f32(pa.v[k])) : 0.0f;
    const float s1 = t.w1 != 0.0f ? __fmul_rn(t.w1, to_f32(pb.v[k])) : 0.0f;
    out.v[k] = from_f32<T>(__fadd_rn(s0, s1));
  }
  *reinterpret_cast<P*>(dst) = out;
}

// Pass H: block row (b, i); threads over (j, channel vector) of the row.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
pass_h_kernel(const T* __restrict__ v, T* __restrict__ out,
              const float* __restrict__ theta, Consts k, int B, int H, int W,
              int C, int border) {
  const int cv_count = C / VEC;
  const int row_items = W * cv_count;
  for (int row = blockIdx.y; row < B * H; row += gridDim.y) {
    const int b = row / H;
    const int i = row - b * H;
    const Lines l = lines(theta + 6 * b, k);
    const float bi = __fmul_rn(l.b, (float)i);
    const T* src_row = v + (int64_t)row * W * C;
    T* dst_row = out + (int64_t)row * W * C;
    for (int item = blockIdx.x * blockDim.x + threadIdx.x; item < row_items;
         item += gridDim.x * blockDim.x) {
      const int j = item / cv_count;
      const int c0 = (item - j * cv_count) * VEC;
      const float hp = __fadd_rn(__fadd_rn(__fmul_rn(l.a, (float)j), bi), l.c);
      const Taps t = two_taps<T>(hp, W, border != 0);
      blend<T, VEC>(dst_row + (int64_t)j * C + c0, src_row + (int64_t)t.i0 * C + c0,
                    src_row + (int64_t)t.i1 * C + c0, t);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward of the banded warp's passes (fused_warp.cu launches the H
// pass; it replaces `_bwd_h_kernel` of the TPU module). The two-pass
// warp's transposed passes (two_pass_warp.cu) compute the same
// functions with span below. Given the cotangent G of `out`:
//
//   d_v[b,i,x,c]   = sum_j tent(h'(j,i) - x) * G[b,i,j,c]        (bwd H)
//   d_img[b,y,x,c] = sum_i tent(g'(x,i) - y) * d_v[b,i,x,c]      (bwd V)
//
// with h', g' the positions after the border clamp, and the six partials
// of the loss with respect to the line coefficients,
//
//   (s_a, s_b, s_c) = sum_{i,j,x} <G[i,j], V[i,x]>  * dt(h'-x) * dc(h) * (j, i, 1)
//   (s_p, s_q, s_r) = sum_{i,x,y} <d_v[i,x], img[y,x]> * dt(g'-y) * dc(g) * (x, i, 1)
//
// where dt is the tent's derivative with JAX's kink conventions
// (abs'(0) = +1, a max tie of weight 0.5: -1 at 0, -/+0.5 at +/-1) and
// dc the clamp's (1 inside, 0.5 on a bound, 0 outside; 1 for zeros
// padding). The banded warp's host sums them and chains them to d_theta
// through warp_coeffs.
//
// Gather form, no scatter and no atomics: a thread owns one 16-byte
// channel vector of one pixel of the transposed pass's OUTPUT (d_v in bwd
// H, d_img in bwd V) and loops over the outputs j (or i) of the forward
// pass that reach it. Those form one interval, since a position is linear
// in j (in i) and the clamp is monotone; the interval is solved in double,
// widened for the f32 rounding of the positions, and each candidate is
// then tested with the forward's own f32 position arithmetic, so a tap
// counts exactly when the reference's tent (and its derivative, which is
// non-zero on the closed interval |pos - x| <= 1: three taps at an
// integer position) says so. Where the slope is tiny (|A| or |q| near 0)
// the interval covers the whole row. The same visit gives the partials:
// the thread's own vector (V in bwd H, img in bwd V) dotted with the
// visited cotangent vector is its share of the channel dot product.
// Per-thread partials are summed over the block in a fixed order and
// written per (row, block); the host sums those (a deterministic
// reduction), so two runs give the same bits.
//
// What bounds it: memory, as for the forward. The least traffic is G, V
// and img read once and d_img written once; the two launches also write
// and read d_v, 1.5 times that.

// Indices k in [lo, hi] (within [0, n-1]) whose position s*k + u can come
// within 1 of `target` after the padding's clamp to [0, size-1]: a
// superset. The f32 position is off s*k + u by a few ulps of `mag` (the
// sum of the magnitudes of the terms it adds), which 1e-5 (mag + 2) / |s|
// indices cover many times over; half an index more covers the double
// arithmetic here. The slope's reciprocal is taken once (slope_of), so a
// block that shares s takes it once. Every index outside the range has
// |pos - target| > 1, so a pass that tests each candidate with its f32
// position visits the same taps, in the same order, as one that tests
// every index.
struct Range {
  int lo, hi;
};

struct Slope {
  double inv, slack_per_mag;
  bool flat;  // s is 0 (or NaN): test every index
};

__device__ __forceinline__ Slope slope_of(float s) {
  Slope sl;
  const double as = fabs((double)s);
  sl.flat = !(as > 0.0);
  sl.inv = 1.0 / (double)s;
  sl.slack_per_mag = 1e-5 / as;
  return sl;
}

__device__ __forceinline__ Range span(const Slope& sl, double u, double mag,
                                      int target, int size, int n,
                                      bool border) {
  Range r;
  if (sl.flat) {
    r.lo = 0;
    r.hi = n - 1;
    return r;
  }
  double lo = target - 1.0, hi = target + 1.0;
  if (border) {
    if (target <= 1) lo = -INFINITY;         // clamped up to 0
    if (target >= size - 2) hi = INFINITY;   // clamped down to size-1
  }
  const double k1 = (lo - u) * sl.inv, k2 = (hi - u) * sl.inv;
  const double slack = 0.5 + (mag + 2.0) * sl.slack_per_mag;
  const double kmin = fmax(fmin(k1, k2) - slack, 0.0);
  const double kmax = fmin(fmax(k1, k2) + slack, n - 1.0);
  if (!(kmin <= kmax)) {
    r.lo = 0;
    r.hi = -1;
    return r;
  }
  r.lo = (int)floor(kmin);
  r.hi = (int)ceil(kmax);
  return r;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum s[0..2] over the block in a fixed order; thread 0 writes them.
__device__ __forceinline__ void block_sum3(float s0, float s1, float s2,
                                           float* __restrict__ out) {
  __shared__ float sh[3][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s0 = warp_sum(s0);
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    sh[0][warp] = s0;
    sh[1][warp] = s1;
    sh[2][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      float t = 0.0f;
      for (int w = 0; w < kThreads / 32; ++w) t += sh[m][w];
      out[m] = t;
    }
  }
  __syncthreads();
}

// One transposed pass. H_PASS: rows (b, i), thread pixel x, loop over j;
// cot = G, own = V, d_own = d_v, partials (s_a, s_b, s_c). Otherwise:
// rows (b, y), thread pixel x, loop over i; cot = d_v, own = img,
// d_own = d_img, partials (s_p, s_q, s_r). `partials` holds, for each
// row, `stride` triples; block x writes triple x, block 0 zeroes the
// tail.
template <typename T, int VEC, bool H_PASS>
__global__ void __launch_bounds__(kThreads)
bwd_pass_kernel(const T* __restrict__ cot, const T* __restrict__ own,
                T* __restrict__ d_own, float* __restrict__ partials,
                int stride, const float* __restrict__ theta, Consts k, int B,
                int H, int W, int C, int border) {
  using P = Pack<T, VEC>;
  const int cv_count = C / VEC;
  const int row_items = W * cv_count;
  const int size = H_PASS ? W : H;
  const float hi = (float)(size - 1);
  const int item = blockIdx.x * blockDim.x + threadIdx.x;
  for (int row = blockIdx.y; row < B * H; row += gridDim.y) {
    const int b = row / H;
    const int r = row - b * H;  // i in bwd H, y in bwd V
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
    if (item < row_items) {
      const Lines l = lines(theta + 6 * b, k);
      const int x = item / cv_count;
      const int c0 = (item - x * cv_count) * VEC;
      const int64_t at = ((int64_t)row * W + x) * C + c0;
      const P mine = *reinterpret_cast<const P*>(own + at);
      float mine_f[VEC], acc[VEC];
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        mine_f[q] = to_f32(mine.v[q]);
        acc[q] = 0.0f;
      }
      // the forward's position of loop index m is
      //   bwd H: ((A*m) + (B*i)) + C         bwd V: ((p*x) + (q*m)) + r
      float fixed, slope, tail;
      if (H_PASS) {
        fixed = __fmul_rn(l.b, (float)r);
        slope = l.a;
        tail = l.c;
      } else {
        fixed = __fmul_rn(l.p, (float)x);
        slope = l.q;
        tail = l.r;
      }
      const int target = H_PASS ? x : r;
      const int n = H_PASS ? W : H;
      const double mag = fabs((double)slope) * n + fabs((double)fixed) +
                         fabs((double)tail);
      const Range rg = span(slope_of(slope), (double)fixed + (double)tail,
                            mag, target, size, n, border != 0);
      for (int m = rg.lo; m <= rg.hi; ++m) {
        const float sm = __fmul_rn(slope, (float)m);
        const float pos = H_PASS ? __fadd_rn(__fadd_rn(sm, fixed), tail)
                                 : __fadd_rn(__fadd_rn(fixed, sm), tail);
        const float pp = border ? fminf(fmaxf(pos, 0.0f), hi) : pos;
        const float diff = __fsub_rn(pp, (float)target);
        const float ad = fabsf(diff);
        if (!(ad <= 1.0f)) continue;
        const int64_t src = H_PASS ? ((int64_t)row * W + m) * C + c0
                                   : (((int64_t)b * H + m) * W + x) * C + c0;
        const P cv = *reinterpret_cast<const P*>(cot + src);
        const float wgt = fmaxf(__fsub_rn(1.0f, ad), 0.0f);
        float dot = 0.0f;
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          const float gv = to_f32(cv.v[q]);
          acc[q] = __fadd_rn(acc[q], __fmul_rn(wgt, gv));
          dot = __fadd_rn(dot, __fmul_rn(gv, mine_f[q]));
        }
        float dt = ad < 1.0f ? 1.0f : 0.5f;
        if (diff >= 0.0f) dt = -dt;
        if (border) dt *= (pos > 0.0f && pos < hi) ? 1.0f
                          : (pos == 0.0f || pos == hi) ? 0.5f : 0.0f;
        const float t = dot * dt;
        s0 += t * (float)(H_PASS ? m : x);
        s1 += t * (float)(H_PASS ? r : m);
        s2 += t;
      }
      P out;
#pragma unroll
      for (int q = 0; q < VEC; ++q) out.v[q] = from_f32<T>(acc[q]);
      *reinterpret_cast<P*>(d_own + at) = out;
    }
    float* dst = partials + ((int64_t)row * stride) * 3;
    block_sum3(s0, s1, s2, dst + blockIdx.x * 3);
    if (blockIdx.x == 0) {
      for (int t = gridDim.x * 3 + threadIdx.x; t < stride * 3; t += blockDim.x)
        dst[t] = 0.0f;
    }
  }
}

Consts make_consts(int H, int W, int align_corners) {
  Consts k;
  k.align_corners = align_corners;
  if (align_corners) {
    k.w = (float)((double)W - 1.0);
    k.h = (float)((double)H - 1.0);
    k.hw = (float)(((double)W - 1.0) / 2.0);
    k.hh = (float)(((double)H - 1.0) / 2.0);
    k.kx = 0.0f;
    k.ky = 0.0f;
  } else {
    k.w = (float)W;
    k.h = (float)H;
    k.hw = (float)((double)W / 2.0);
    k.hh = (float)((double)H / 2.0);
    k.kx = (float)(1.0 / (double)W - 1.0);
    k.ky = (float)(1.0 / (double)H - 1.0);
  }
  return k;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace
