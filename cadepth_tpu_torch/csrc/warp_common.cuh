// Device code of the warp kernels, shared by two_pass_warp.cu and
// fused_warp.cu (banded_affine_warp.cu takes the small helpers): the line
// coefficients, the two-tap blend, pass H out of a row in shared memory
// (pass_h_row), the per-row channel chunks of a launch (Chunk), the
// transposed passes' candidate search (span), the transposed pass H
// (two_pass_bwd_h_kernel, the same function for both warps) and the sum
// of the theta partials with the chain to d_theta
// (two_pass_theta_kernel). Each library compiles it from this header;
// the build hashes it with each source that includes it (ops/_build.py).
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
constexpr int kMaxRowBlocks = 65535;       // gridDim.y limit
constexpr int kDefaultSmem = 48 * 1024;    // dynamic shared memory without opt-in
constexpr int kMaxSmem = 232448;           // the most a block may use (227 KB)

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

// The channel chunk of one block of a per-row launch: rows (b, i) in
// order, chunks inner, so neighbouring blocks work on the same or
// neighbouring rows. The wrappers plan the chunk (ops/two_pass_warp.py:
// fwd_plan, ops/fused_warp.py: fused_plan).
struct Chunk {
  int64_t row;  // b * H + i
  int b, i, c_lo, cc;  // cc channels from c_lo
};

__device__ __forceinline__ Chunk chunk_of(int H, int C, int c_chunk, int n_chunks) {
  Chunk ch;
  ch.row = blockIdx.x / n_chunks;
  const int k = (int)(blockIdx.x - ch.row * n_chunks);
  ch.b = (int)(ch.row / H);
  ch.i = (int)(ch.row - (int64_t)ch.b * H);
  ch.c_lo = k * c_chunk;
  ch.cc = min(c_chunk, C - ch.c_lo);
  return ch;
}

// Pass H of one output row i from V's row chunk `vrow` in shared memory
// (pixel stride cc): out_row[j, c] for the block's cc channels, out_row
// pointing at the row's first pixel and chunk (pixel stride C). The
// caller synchronises the block after writing vrow.
template <typename T, int VEC>
__device__ __forceinline__ void pass_h_row(T* __restrict__ out_row,
                                           const T* __restrict__ vrow,
                                           const Lines& l, int i, int W, int C,
                                           int cc, bool border) {
  const int cvn = cc / VEC;
  const int items = W * cvn;
  const float bi = __fmul_rn(l.b, (float)i);
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int j = item / cvn;
    const int c = (item - j * cvn) * VEC;
    const float hp = __fadd_rn(__fadd_rn(__fmul_rn(l.a, (float)j), bi), l.c);
    const Taps t = two_taps<T>(hp, W, border);
    blend<T, VEC>(out_row + (int64_t)j * C + c, vrow + t.i0 * cc + c,
                  vrow + t.i1 * cc + c, t);
  }
}

// ---------------------------------------------------------------------------
// Backward. Given the cotangent G of `out`:
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
// padding). Bwd H is the same function for the two-pass and the banded
// warp (their pass H is the same); bwd V differs (the banded one reads a
// band of d_v's rows), so each warp has its own.
//
// Gather form, no scatter and no atomics: a thread owns one 16-byte
// channel vector of one pixel of the transposed pass's OUTPUT and visits
// the forward outputs j (or i) that reach it. Those form one interval,
// since a position is linear in j (in i) and the clamp is monotone
// (span); each candidate is then tested with the forward's own f32
// position, so a tap counts exactly when the plain version's tent (and
// its derivative, non-zero on the closed interval |pos - x| <= 1) says
// so. The visit dots the thread's own vector (V in bwd H, img in bwd V)
// with the visited cotangent vector: its share of the channel dot
// product. Each block sums its threads' partials in a fixed order and
// writes one triple; two_pass_theta_kernel then sums the triples of each
// batch element in a fixed order, so two runs give the same bits.

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

// One visit of a transposed pass: the forward outputs m in `rg` whose
// position reaches `target` add their cotangent vector (cot + (m - m0) *
// step: `cot` holds outputs m0 onwards) to acc with the tent weight; t = <cot, mine> * dtent * dclip of each
// adds to t_sum, and t * m to tm_sum. The position of m is the
// forward's: bwd H ((A*m) + (B*i)) + C, bwd V ((p*x) + (q*m)) + r.
template <typename T, int VEC, bool H_PASS>
__device__ __forceinline__ void visit(const T* __restrict__ cot, int64_t step,
                                      int m0, const float* mine, float* acc,
                                      Range rg,
                                      float slope, float fixed, float tail,
                                      int target, float hi, int border,
                                      float& tm_sum, float& t_sum) {
  using P = Pack<T, VEC>;
  for (int m = rg.lo; m <= rg.hi; ++m) {
    const float sm = __fmul_rn(slope, (float)m);
    const float pos = H_PASS ? __fadd_rn(__fadd_rn(sm, fixed), tail)
                             : __fadd_rn(__fadd_rn(fixed, sm), tail);
    const float pp = border ? fminf(fmaxf(pos, 0.0f), hi) : pos;
    const float diff = __fsub_rn(pp, (float)target);
    const float ad = fabsf(diff);
    if (!(ad <= 1.0f)) continue;
    const P cv = *reinterpret_cast<const P*>(cot + (int64_t)(m - m0) * step);
    const float wgt = fmaxf(__fsub_rn(1.0f, ad), 0.0f);
    float dot = 0.0f;
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      const float gv = to_f32(cv.v[q]);
      acc[q] = fmaf(wgt, gv, acc[q]);
      dot = fmaf(gv, mine[q], dot);
    }
    float dt = ad < 1.0f ? 1.0f : 0.5f;
    if (diff >= 0.0f) dt = -dt;
    if (border) dt *= (pos > 0.0f && pos < hi) ? 1.0f
                      : (pos == 0.0f || pos == hi) ? 0.5f : 0.0f;
    const float t = dot * dt;
    tm_sum += t * (float)m;
    t_sum += t;
  }
}

// Bwd H: block (b, i, chunk); G's row chunk staged in shared memory;
// thread pixel x, loop over j; own = V, writes d_v and the block's triple
// (s_a, s_b, s_c) to part[blockIdx.x]. grad, v and d_v hold `rows` rows
// a batch element: the output rows row0 .. row0 + rows - 1 of the warp
// (the whole map: row0 0, rows H), and the positions take the map's row
// index row0 + i.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 4)
two_pass_bwd_h_kernel(const T* __restrict__ grad, const T* __restrict__ v,
                      T* __restrict__ d_v, float* __restrict__ part,
                      const float* __restrict__ theta, Consts k, int row0,
                      int rows, int W, int C, int c_chunk, int n_chunks,
                      int border) {
  using P = Pack<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* grow = reinterpret_cast<T*>(smem_raw);  // G[b, i, :, chunk], pixel stride cc
  const Chunk ch = chunk_of(rows, C, c_chunk, n_chunks);
  const int cvn = ch.cc / VEC;
  const int items = W * cvn;
  const int64_t row_at = ch.row * W * C + ch.c_lo;
  const int i = row0 + ch.i;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int x = item / cvn;
    const int c = (item - x * cvn) * VEC;
    *reinterpret_cast<P*>(grow + x * ch.cc + c) =
        *reinterpret_cast<const P*>(grad + row_at + (int64_t)x * C + c);
  }
  __syncthreads();

  const Lines l = lines(theta + 6 * ch.b, k);
  const float fixed = __fmul_rn(l.b, (float)i);
  const double mag = fabs((double)l.a) * W + fabs((double)fixed) + fabs((double)l.c);
  const Slope sl = slope_of(l.a);
  const float hi = (float)(W - 1);
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int x = item / cvn;
    const int c = (item - x * cvn) * VEC;
    const int64_t at = row_at + (int64_t)x * C + c;
    const P own = *reinterpret_cast<const P*>(v + at);
    float mine[VEC], acc[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      mine[q] = to_f32(own.v[q]);
      acc[q] = 0.0f;
    }
    const Range rg = span(sl, (double)fixed + (double)l.c, mag, x, W, W,
                          border != 0);
    float tj = 0.0f, t = 0.0f;
    visit<T, VEC, true>(grow + c, ch.cc, 0, mine, acc, rg, l.a, fixed, l.c,
                        x, hi, border, tj, t);
    s0 += tj;
    s1 += t * (float)i;
    s2 += t;
    P res;
#pragma unroll
    for (int q = 0; q < VEC; ++q) res.v[q] = from_f32<T>(acc[q]);
    *reinterpret_cast<P*>(d_v + at) = res;
  }
  block_sum3(s0, s1, s2, part + (int64_t)blockIdx.x * 3);
}

// d_theta of one batch element from the six sums (s_a, s_b, s_c, s_p,
// s_q, s_r): the derivative of warp_coeffs written out, in the f32
// operation order of ops/affine_warp.py: chain_theta_closed. A_safe's
// clamp passes no gradient where |A| < 1e-3, as safe_divisor's where.
__device__ void chain_to_theta(const float* __restrict__ th, const Consts& k,
                            const float* s, float* __restrict__ d) {
  const Lines l = lines(th, k);
  const float t00 = th[0];
  const bool live = !(fabsf(t00) < 1e-3f);
  const float a_safe = live ? t00 : (t00 < 0.0f ? -1e-3f : 1e-3f);
  // p reaches the loss directly and through q = E - p*B and r = F - p*C
  const float gp = __fsub_rn(__fsub_rn(s[3], __fmul_rn(s[4], l.b)),
                             __fmul_rn(s[5], l.c));
  // p = D / A_safe: dp/dA = -p / A_safe where A_safe = A
  const float ga = live ? __fsub_rn(s[0], __fdiv_rn(__fmul_rn(gp, l.p), a_safe))
                        : s[0];
  const float gb = __fsub_rn(s[1], __fmul_rn(s[4], l.p));
  const float gc = __fsub_rn(s[2], __fmul_rn(s[5], l.p));
  const float gd = __fdiv_rn(gp, a_safe);
  // B = (t01 * w) / h, D = (t10 * h) / w, C and F scale their sums by hw, hh
  const float bw = __fmul_rn(__fdiv_rn(gb, k.h), k.w);
  const float dh = __fmul_rn(__fdiv_rn(gd, k.w), k.h);
  const float gcs = __fmul_rn(gc, k.hw);
  const float gfs = __fmul_rn(s[5], k.hh);
  if (k.align_corners) {
    d[0] = __fsub_rn(ga, gcs);
    d[1] = __fsub_rn(bw, gcs);
    d[2] = gcs;
    d[3] = __fsub_rn(dh, gfs);
    d[4] = __fsub_rn(s[4], gfs);
    d[5] = gfs;
  } else {
    d[0] = __fadd_rn(ga, __fmul_rn(gcs, k.kx));
    d[1] = __fadd_rn(bw, __fmul_rn(gcs, k.ky));
    d[2] = gcs;
    d[3] = __fadd_rn(dh, __fmul_rn(gfs, k.kx));
    d[4] = __fadd_rn(s[4], __fmul_rn(gfs, k.ky));
    d[5] = gfs;
  }
}

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// One block per batch element b: the per-block triples of pass H
// (`per_b_h` of them) and of pass V (`per_b_v`) summed in a fixed order,
// then chained to d_theta[b].
__global__ void __launch_bounds__(kThreads)
two_pass_theta_kernel(const float* __restrict__ part_h,
                      const float* __restrict__ part_v, int per_b_h,
                      int per_b_v, const float* __restrict__ theta, Consts k,
                      float* __restrict__ d_theta) {
  __shared__ double sh[6][kThreads / 32];
  const int b = blockIdx.x;
  const float* ph = part_h + (int64_t)b * per_b_h * 3;
  const float* pv = part_v + (int64_t)b * per_b_v * 3;
  double s[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int t = threadIdx.x; t < per_b_h; t += blockDim.x) {
#pragma unroll
    for (int m = 0; m < 3; ++m) s[m] += (double)ph[t * 3 + m];
  }
  for (int t = threadIdx.x; t < per_b_v; t += blockDim.x) {
#pragma unroll
    for (int m = 0; m < 3; ++m) s[3 + m] += (double)pv[t * 3 + m];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < 6; ++m) {
    s[m] = warp_sum_d(s[m]);
    if (lane == 0) sh[m][warp] = s[m];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sums[6];
    for (int m = 0; m < 6; ++m) {
      double t = 0.0;
      for (int w = 0; w < kThreads / 32; ++w) t += sh[m][w];
      sums[m] = (float)t;
    }
    chain_to_theta(theta + 6 * b, k, sums, d_theta + 6 * b);
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

// Lets `kernel` take `smem` bytes of dynamic shared memory.
template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// What a wrapper planned, checked against what the per-row kernels take:
// VEC 1 or one 16-byte vector (with C and every pointer aligned to it),
// the chunk a positive multiple of VEC, its row in `smem` bytes, and
// fewer than 2^31 blocks. Returns the block count, or 0 where the plan
// is bad.
int64_t plan_blocks(int B, int H, int W, int C, int size, int vec,
                    int c_chunk, int smem, bool aligned) {
  if (vec != 1 && (vec * size != 16 || C % vec != 0 || !aligned)) return 0;
  if (c_chunk <= 0 || c_chunk % vec != 0) return 0;
  if ((int64_t)W * c_chunk * size != smem) return 0;
  const int64_t blocks = (int64_t)B * H * ((C + c_chunk - 1) / c_chunk);
  return blocks < ((int64_t)1 << 31) ? blocks : 0;
}

}  // namespace
