// Banded ("fused") two-pass affine warp, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels `_fwd_v_banded_kernel` (launched by
// `_fused_fwd_passes`) and `_bwd_v_banded_kernel` (launched by
// `_fused_trainable_bwd`) of cadepth_tpu/ops/pallas/fused_warp.py, and
// their H passes, the pass-H kernel (:125) and `_bwd_h_kernel` (:194) of
// cadepth_tpu/ops/pallas/two_pass_warp.py, with the sum of the theta
// partials and their chain to d_theta.
//
// The function is the two-pass warp's (two_pass_warp.cu) with a banded
// V pass. Output rows are cut into tiles of `it` rows and columns into
// strips of `wt`; for each (tile, strip) cell the TPU kernel read a
// static band of kb_f source rows,
//
//   V[b,i,x,c] = sum_{k<kb_f} tent(pos) * img[b,y0+k,x,c],
//   pos = (p*x + (r - (y0+k))) + q*i,
//   y0  = clip(floor(min over the cell's 4 corners of (p*x + q*i) + r), 0, H - kb_f),
//
// so a tap outside the band is dropped (exact only inside
// fused_warp_theta_ok). The transposed pass reads, for each cell of
// d_img (y-tile, strip), kb_b rows of d_v from a base i0 that the
// corners of t = y - r - p*x over the cell give through (t -+ 1)/q_safe:
//
//   d_img[b,y,x,c] = sum_{k<kb_b} tent(diff) * d_v[b,i0+k,x,c],
//   diff = (p*x + (q*(i0+k) + r)) - y,
//
// and the (p, q, r) partials sum <d_v, img> * dtent(diff) * (x, i, 1).
// The forward and the backward write the tent position with different
// f32 expressions; each is mirrored here operation for operation with
// the _rn intrinsics (no FMA contraction), as in the plain versions of
// cadepth_tpu_torch/ops/fused_warp.py, because the PCL starts at the
// identity, where every tap sits on a kink of the tent and its
// derivative depends on the last bit. For bf16 features both passes
// round each tent weight to bf16 before the multiply; the theta partials
// use the unrounded derivative.
//
// What bounds it on this card: memory, as for the two-pass warp. Each
// output element costs a few multiply-adds against the bytes it moves.
// The least traffic is img read and out written (forward), and G, V and
// img read and d_img written (backward).
//
// Forward, one launch (fused_fwd_kernel), laid out as
// two_pass_fwd_kernel: a block owns one channel chunk of one output row
// (b, i), computes the row's banded V into dynamic shared memory, rounded
// to the feature dtype, and after one __syncthreads runs pass H from it
// (pass_h_row, zeros padding). V reaches device memory only when the
// caller passes `v` (training), so serving moves the 2-map bound's
// bytes. The banded V row of output row i depends only on img and on the
// band bases of that row's cells, so the shared row holds it exactly.
// Where the V pass of the TPU kernel tested all kb_f = it + 8 rows of the
// band, this one tests only the rows floor(g) - 1 .. floor(g) + 2 of the
// band, g = (p*x + q*i) + r the line's position in f32, each with the
// banded expression above, and sums the taps in ascending y as the full
// loop does: the same non-zero taps in the same order, so the result
// equals fused_warp_plain_fwd bit for bit. The window holds every tap of
// weight > 0: that needs |pos| < 1, and the f32 pos differs from the
// exact p*x + q*i + r - y (three roundings), and the f32 g from the exact
// p*x + q*i + r (two), by at most 2^-24 M a rounding, where M = |p| W +
// |q| H + |r| + H bounds every term and partial sum (p*x and q*i are the
// same f32 products in both). Below M = 2^20 the five roundings stay
// under 5/16, so a tap needs |g - y| < 1 + 5/16 < 2, and the integers y
// with |g - y| < 2 all lie in floor(g) - 1 .. floor(g) + 2. Where M >=
// 2^20 (or is not finite) the block tests the whole band, as the TPU
// kernel did. The taps depend on the column x alone, not on the
// channels, so the block first writes each column's taps to a table
// after its V row (24 bytes a column: the first row of non-zero weight,
// their count and their weights; the rows are consecutive, since pos
// falls as y grows), and every channel vector of the column reads them
// there: testing the four rows for each 16-byte vector cost more issue
// slots than the loads they select. The first two taps are loaded
// together, as blend does.
//
// Backward, three launches, laid out as the two-pass backward: the
// transposed pass H is two_pass_bwd_h_kernel of warp_common.cuh with
// border = 0 (the banded warp's pass H is the two-pass one); the banded
// transposed pass V (fused_bwd_v_kernel) has block (b, y, chunk) and a
// thread per pixel x and channel vector of d_img, whose candidate rows i
// are the band [i0, i0 + kb_b) of its (y-tile, strip) cell intersected
// with the two-pass interval (span); each candidate is tested with the
// banded diff above, with the kink conventions of the reference's _dtent
// (abs'(0) = +1; slope 0.5 at |diff| = 1). The band bounds the work where
// |q| vanishes and span covers the whole column: at most kb_b candidates
// a pixel. Each block of either pass sums its threads' partials in a
// fixed order and writes one triple; two_pass_theta_kernel then sums the
// triples of each batch element in double, in a fixed order, and applies
// the closed-form chain to d_theta. No float atomics and no host
// arithmetic: two runs give the same bits, and the wrapper allocates and
// launches, nothing else. The passes move 6 maps where the bound counts
// 4: d_v goes through device memory between them.
//
// Launch plan (ops/fused_warp.py: fused_plan): the two-pass chunk, split
// further at the small decoder levels until a launch has enough blocks,
// by a rule of the shape alone, so the block partials, and d_theta's
// bits, are the same on every card.

#include "warp_common.cuh"

namespace {

// Static tile and band sizes of one level (fused_tiles in the wrapper).
struct Band {
  int it;  // output rows per tile
  int wt;  // columns per strip
  int kb;  // band rows
};

// Below this bound on the magnitudes that make up a position, the f32
// rounding keeps every tap of the forward's band within
// floor(g) - 1 .. floor(g) + 2 (see the note above).
constexpr float kNarrowMag = 1048576.0f;  // 2^20

__device__ __forceinline__ float min4(float a, float b, float c, float d) {
  return fminf(fminf(a, b), fminf(c, d));
}

__device__ __forceinline__ float max4(float a, float b, float c, float d) {
  return fmaxf(fmaxf(a, b), fmaxf(c, d));
}

// clip(floor(lo), 0, size - kb) as an index.
__device__ __forceinline__ int band_base(float lo, int size, int kb) {
  return (int)fminf(fmaxf(floorf(lo), 0.0f), (float)(size - kb));
}

// First and last index of the tile (or strip) of `n` cells holding idx.
__device__ __forceinline__ void cell_span(int idx, int n, float& lo, float& hi) {
  lo = (float)((idx / n) * n);
  hi = __fsub_rn(__fadd_rn(lo, (float)n), 1.0f);
}

// The base of the forward's band for column x of output row i:
// clip(floor(min over the (tile, strip) cell's corners of (p*x + q*i) +
// r), 0, H - kb), with q*i at the tile's first and last row given.
__device__ __forceinline__ int fwd_band_base(int x, const Lines& l,
                                             const Band& band, float q_lo,
                                             float q_hi, int H) {
  float x_lo, x_hi;
  cell_span(x, band.wt, x_lo, x_hi);
  const float p_lo = __fmul_rn(l.p, x_lo), p_hi = __fmul_rn(l.p, x_hi);
  return band_base(min4(__fadd_rn(__fadd_rn(p_lo, q_lo), l.r),
                        __fadd_rn(__fadd_rn(p_hi, q_lo), l.r),
                        __fadd_rn(__fadd_rn(p_lo, q_hi), l.r),
                        __fadd_rn(__fadd_rn(p_hi, q_hi), l.r)),
                   H, band.kb);
}

// The forward's tent weight of source row y at column x (px = p*x).
template <typename T>
__device__ __forceinline__ float fwd_weight(float px, float qi, float r, int y) {
  const float pos = __fadd_rn(__fadd_rn(px, __fsub_rn(r, (float)y)), qi);
  return tap_weight<T>(fmaxf(__fsub_rn(1.0f, fabsf(pos)), 0.0f));
}

// Bytes of the forward's per-column tap table: the first row with a
// non-zero weight and their count (int2), and the weights (float4).
constexpr int kTapBytes = 24;

// Forward: block (b, i, chunk); the banded pass V into shared memory,
// pass H out of it; V also to `v` when it is not null. Where `table` is
// set and the block's positions are narrow, the block first writes each
// column's taps to a table after its V row (`row_bytes` in): they depend
// on x alone, so every channel vector of the column reads them there.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
fused_fwd_kernel(const T* __restrict__ img, T* __restrict__ v,
                 T* __restrict__ out, const float* __restrict__ theta,
                 Consts k, Band band, int H, int W, int C, int c_chunk,
                 int n_chunks, int row_bytes, int table) {
  using P = Pack<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* vrow = reinterpret_cast<T*>(smem_raw);  // V[b, i, :, chunk], pixel stride cc
  float4* tap_w = reinterpret_cast<float4*>(smem_raw + row_bytes);
  int2* tap_y = reinterpret_cast<int2*>(smem_raw + row_bytes + W * 16);
  const Chunk ch = chunk_of(H, C, c_chunk, n_chunks);
  const int cvn = ch.cc / VEC;
  const int items = W * cvn;
  const Lines l = lines(theta + 6 * ch.b, k);
  const int64_t row_at = ch.row * W * C + ch.c_lo;
  const T* plane = img + (int64_t)ch.b * H * W * C + ch.c_lo;

  float i_lo, i_hi;
  cell_span(ch.i, band.it, i_lo, i_hi);
  const float q_lo = __fmul_rn(l.q, i_lo), q_hi = __fmul_rn(l.q, i_hi);
  const float qi = __fmul_rn(l.q, (float)ch.i);
  const bool narrow =
      fabsf(l.p) * W + fabsf(l.q) * H + fabsf(l.r) + H < kNarrowMag;
  if (narrow && table) {
    // the rows floor(g) - 1 .. floor(g) + 2 of the band; those of
    // non-zero weight are consecutive (pos falls as y grows)
    for (int x = threadIdx.x; x < W; x += blockDim.x) {
      const int y0 = fwd_band_base(x, l, band, q_lo, q_hi, H);
      const float px = __fmul_rn(l.p, (float)x);
      const int g = (int)floorf(__fadd_rn(__fadd_rn(px, qi), l.r));
      const int lo = max(y0, g - 1), hi = min(y0 + band.kb - 1, g + 2);
      float w[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        w[t] = lo + t <= hi ? fwd_weight<T>(px, qi, l.r, lo + t) : 0.0f;
      const int f = w[0] != 0.0f ? 0 : w[1] != 0.0f ? 1 : w[2] != 0.0f ? 2 : 3;
      const int n = (w[0] != 0.0f) + (w[1] != 0.0f) + (w[2] != 0.0f) +
                    (w[3] != 0.0f);
      tap_w[x] = f == 0 ? make_float4(w[0], w[1], w[2], w[3])
               : f == 1 ? make_float4(w[1], w[2], w[3], 0.0f)
               : f == 2 ? make_float4(w[2], w[3], 0.0f, 0.0f)
                        : make_float4(w[3], 0.0f, 0.0f, 0.0f);
      tap_y[x] = make_int2(lo + f, n);
    }
    __syncthreads();
  }
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int x = item / cvn;
    const int c = (item - x * cvn) * VEC;
    const T* col = plane + (int64_t)x * C + c;
    float acc[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = 0.0f;
    if (narrow && table) {
      // the first two taps loaded together (as blend does); a third and
      // a fourth have weight only where rounding puts g on an integer
      const int2 yn = tap_y[x];
      const float4 w4 = tap_w[x];
      P a, b;
      if (w4.x != 0.0f) a = *reinterpret_cast<const P*>(col + (int64_t)yn.x * W * C);
      if (w4.y != 0.0f) b = *reinterpret_cast<const P*>(col + (int64_t)(yn.x + 1) * W * C);
      if (w4.x != 0.0f) {
#pragma unroll
        for (int q = 0; q < VEC; ++q)
          acc[q] = __fadd_rn(acc[q], __fmul_rn(w4.x, to_f32(a.v[q])));
      }
      if (w4.y != 0.0f) {
#pragma unroll
        for (int q = 0; q < VEC; ++q)
          acc[q] = __fadd_rn(acc[q], __fmul_rn(w4.y, to_f32(b.v[q])));
      }
      const float* wx = reinterpret_cast<const float*>(tap_w + x);
      for (int t = 2; t < yn.y; ++t) {
        const P s = *reinterpret_cast<const P*>(col + (int64_t)(yn.x + t) * W * C);
#pragma unroll
        for (int q = 0; q < VEC; ++q)
          acc[q] = __fadd_rn(acc[q], __fmul_rn(wx[t], to_f32(s.v[q])));
      }
    } else {
      // the whole band, as the TPU kernel read it
      const int y0 = fwd_band_base(x, l, band, q_lo, q_hi, H);
      const float px = __fmul_rn(l.p, (float)x);
      for (int y = y0; y < y0 + band.kb; ++y) {
        const float w = fwd_weight<T>(px, qi, l.r, y);
        if (w == 0.0f) continue;
        const P s = *reinterpret_cast<const P*>(col + (int64_t)y * W * C);
#pragma unroll
        for (int q = 0; q < VEC; ++q)
          acc[q] = __fadd_rn(acc[q], __fmul_rn(w, to_f32(s.v[q])));
      }
    }
    P res;
#pragma unroll
    for (int q = 0; q < VEC; ++q) res.v[q] = from_f32<T>(acc[q]);
    *reinterpret_cast<P*>(vrow + x * ch.cc + c) = res;
    if (v != nullptr)
      *reinterpret_cast<P*>(v + row_at + (int64_t)x * C + c) = res;
  }
  __syncthreads();

  pass_h_row<T, VEC>(out + row_at, vrow, l, ch.i, W, C, ch.cc, false);
}

// Banded transposed pass V: block (b, y, chunk); thread pixel x, loop
// over the candidate rows i of its cell's band, reading d_v's column;
// own = img, writes d_img and the block's triple (s_p, s_q, s_r) to
// part[blockIdx.x].
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 4)
fused_bwd_v_kernel(const T* __restrict__ d_v, const T* __restrict__ img,
                   T* __restrict__ d_img, float* __restrict__ part,
                   const float* __restrict__ theta, Consts k, Band band,
                   int H, int W, int C, int c_chunk, int n_chunks) {
  using P = Pack<T, VEC>;
  const Chunk ch = chunk_of(H, C, c_chunk, n_chunks);  // ch.i is y
  const int cvn = ch.cc / VEC;
  const int items = W * cvn;
  const int64_t row_at = ch.row * W * C + ch.c_lo;
  const T* plane = d_v + (int64_t)ch.b * H * W * C + ch.c_lo;
  const Lines l = lines(theta + 6 * ch.b, k);
  const float q_safe = fabsf(l.q) < 1e-3f ? (l.q < 0.0f ? -1e-3f : 1e-3f) : l.q;
  const Slope sl = slope_of(l.q);
  float y_lo, y_hi;
  cell_span(ch.i, band.it, y_lo, y_hi);
  const float lo_r = __fsub_rn(y_lo, l.r), hi_r = __fsub_rn(y_hi, l.r);
  const float yf = (float)ch.i;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int x = item / cvn;
    const int c = (item - x * cvn) * VEC;
    const int64_t at = row_at + (int64_t)x * C + c;
    const P own = *reinterpret_cast<const P*>(img + at);
    float mine[VEC], acc[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      mine[q] = to_f32(own.v[q]);
      acc[q] = 0.0f;
    }
    // the band of the cell (y-tile, strip)
    float x_lo, x_hi;
    cell_span(x, band.wt, x_lo, x_hi);
    const float p_lo = __fmul_rn(l.p, x_lo), p_hi = __fmul_rn(l.p, x_hi);
    const float t00 = __fsub_rn(lo_r, p_lo), t01 = __fsub_rn(lo_r, p_hi);
    const float t10 = __fsub_rn(hi_r, p_lo), t11 = __fsub_rn(hi_r, p_hi);
    const float t_lo = min4(t00, t01, t10, t11);
    const float t_hi = max4(t00, t01, t10, t11);
    const float u_lo = min4(__fdiv_rn(__fsub_rn(t_lo, 1.0f), q_safe),
                            __fdiv_rn(__fadd_rn(t_lo, 1.0f), q_safe),
                            __fdiv_rn(__fsub_rn(t_hi, 1.0f), q_safe),
                            __fdiv_rn(__fadd_rn(t_hi, 1.0f), q_safe));
    const int i0 = band_base(u_lo, H, band.kb);
    // the rows whose line comes within 1 of y, inside the band
    const float px = __fmul_rn(l.p, (float)x);
    const double mag = fabs((double)l.q) * H + fabs((double)px) + fabs((double)l.r);
    Range rg = span(sl, (double)px + (double)l.r, mag, ch.i, H, H, false);
    rg.lo = max(rg.lo, i0);
    rg.hi = min(rg.hi, i0 + band.kb - 1);
    const T* col = plane + (int64_t)x * C + c;
    float ti = 0.0f, t = 0.0f;
    for (int i = rg.lo; i <= rg.hi; ++i) {
      const float fi = (float)i;
      const float diff = __fsub_rn(__fadd_rn(px, __fadd_rn(__fmul_rn(l.q, fi), l.r)), yf);
      const float ad = fabsf(diff);
      if (!(ad <= 1.0f)) continue;  // weight and slope both 0
      const P cv = *reinterpret_cast<const P*>(col + (int64_t)i * W * C);
      const float w = tap_weight<T>(fmaxf(__fsub_rn(1.0f, ad), 0.0f));
      float dot = 0.0f;
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const float gv = to_f32(cv.v[q]);
        acc[q] = fmaf(w, gv, acc[q]);
        dot = fmaf(gv, mine[q], dot);
      }
      // the reference's _dtent: abs'(0) = +1, weight 0.5 at |diff| == 1
      float dt = ad < 1.0f ? 1.0f : 0.5f;
      if (diff >= 0.0f) dt = -dt;
      const float tt = dot * dt;
      ti += tt * fi;
      t += tt;
    }
    s0 += t * (float)x;
    s1 += ti;
    s2 += t;
    P res;
#pragma unroll
    for (int q = 0; q < VEC; ++q) res.v[q] = from_f32<T>(acc[q]);
    *reinterpret_cast<P*>(d_img + at) = res;
  }
  block_sum3(s0, s1, s2, part + (int64_t)blockIdx.x * 3);
}

template <typename T, int VEC>
cudaError_t launch_fwd(const void* img, void* v, void* out, const float* theta,
                       const Consts& k, const Band& band, int blocks, int H,
                       int W, int C, int c_chunk, int n_chunks, int smem,
                       cudaStream_t stream) {
  // the tap table follows the V row, 16-byte aligned, where both fit
  const int row_bytes = (smem + 15) & ~15;
  const int64_t with_table = (int64_t)row_bytes + (int64_t)W * kTapBytes;
  const int table = with_table <= kMaxSmem;
  const int bytes = table ? (int)with_table : smem;
  cudaError_t err = allow_smem(fused_fwd_kernel<T, VEC>, bytes);
  if (err != cudaSuccess) return err;
  fused_fwd_kernel<T, VEC><<<blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(img), static_cast<T*>(v), static_cast<T*>(out),
      theta, k, band, H, W, C, c_chunk, n_chunks, row_bytes, table);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_bwd(const void* grad, const void* v, const void* img,
                       void* d_v, void* d_img, float* part_h, float* part_v,
                       float* d_theta, const float* theta, const Consts& k,
                       const Band& band, int B, int blocks, int H, int W, int C,
                       int c_chunk, int n_chunks, int smem,
                       cudaStream_t stream) {
  cudaError_t err = allow_smem(two_pass_bwd_h_kernel<T, VEC>, smem);
  if (err != cudaSuccess) return err;
  two_pass_bwd_h_kernel<T, VEC><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(grad), static_cast<const T*>(v),
      static_cast<T*>(d_v), part_h, theta, k, 0, H, W, C, c_chunk, n_chunks, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_bwd_v_kernel<T, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(d_v), static_cast<const T*>(img),
      static_cast<T*>(d_img), part_v, theta, k, band, H, W, C, c_chunk,
      n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  two_pass_theta_kernel<<<B, kThreads, 0, stream>>>(
      part_h, part_v, H * n_chunks, H * n_chunks, theta, k, d_theta);
  return cudaGetLastError();
}

bool band_ok(int H, int W, int it, int wt, int kb) {
  return it > 0 && wt > 0 && H % it == 0 && W % wt == 0 && kb >= 1 && kb <= H;
}

}  // namespace

extern "C" {

// img, v and out are contiguous NHWC (B, H, W, C) device buffers of one
// dtype (0 = float32, 1 = bfloat16); v may be null (nothing stored);
// theta is a contiguous (B, 2, 3) float32 device buffer; it divides H,
// wt divides W, 1 <= kb <= H (the forward's band, kb_f). `vec` channels
// per thread, `c_chunk` channels per block and `smem` = W * c_chunk *
// sizeof(dtype) come from ops/fused_warp.py: fused_plan. Launches
// fused_fwd_kernel on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for bands or a plan the kernel does not take).
int cadepth_fused_warp_fwd(const void* img, void* v, void* out,
                           const void* theta, int B, int H, int W, int C,
                           int dtype, int align_corners, int it, int wt,
                           int kb, int vec, int c_chunk, int smem,
                           void* stream) {
  if (B == 0 || H == 0 || W == 0 || C == 0) return (int)cudaSuccess;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (!band_ok(H, W, it, wt, kb)) return (int)cudaErrorInvalidValue;
  const bool aligned = aligned16(img) && aligned16(out) && (v == nullptr || aligned16(v));
  const int64_t blocks = plan_blocks(B, H, W, C, dtype == 0 ? 4 : 2, vec,
                                     c_chunk, smem, aligned);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  const int n_chunks = (C + c_chunk - 1) / c_chunk;
  const Consts k = make_consts(H, W, align_corners);
  const Band band{it, wt, kb};
  const float* th = static_cast<const float*>(theta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (int)blocks;
  if (dtype == 0) {
    if (vec == 4)
      return (int)launch_fwd<float, 4>(img, v, out, th, k, band, nb, H, W, C,
                                       c_chunk, n_chunks, smem, s);
    return (int)launch_fwd<float, 1>(img, v, out, th, k, band, nb, H, W, C,
                                     c_chunk, n_chunks, smem, s);
  }
  if (vec == 8)
    return (int)launch_fwd<__nv_bfloat16, 8>(img, v, out, th, k, band, nb, H,
                                             W, C, c_chunk, n_chunks, smem, s);
  return (int)launch_fwd<__nv_bfloat16, 1>(img, v, out, th, k, band, nb, H, W,
                                           C, c_chunk, n_chunks, smem, s);
}

// The backward of cadepth_fused_warp_fwd, with kb the backward's band
// (kb_b). grad (the cotangent of out), v (the forward's V), img, d_v
// (scratch) and d_img are contiguous NHWC (B, H, W, C) device buffers of
// one dtype; theta is (B, 2, 3) float32; part is a float32 scratch
// buffer of 2 * B * H * n_chunks * 3 values (n_chunks = ceil(C /
// c_chunk)); d_theta a float32 (B, 2, 3) output. vec, c_chunk and smem
// as for the forward. Launches the transposed pass H (grad, v -> d_v,
// part[0]), the banded transposed pass V (d_v, img -> d_img, part[1])
// and the theta kernel (part -> d_theta) on `stream` and returns
// cudaGetLastError().
int cadepth_fused_warp_bwd(const void* grad, const void* v, const void* img,
                           const void* theta, void* d_v, void* d_img,
                           void* part, void* d_theta, int B, int H, int W,
                           int C, int dtype, int align_corners, int it, int wt,
                           int kb, int vec, int c_chunk, int smem,
                           void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (H == 0 || W == 0 || C == 0) {
    // nothing to visit: every partial is 0, and so is d_theta
    return (int)cudaMemsetAsync(d_theta, 0, (size_t)B * 6 * sizeof(float),
                                static_cast<cudaStream_t>(stream));
  }
  if (!band_ok(H, W, it, wt, kb)) return (int)cudaErrorInvalidValue;
  const bool aligned = aligned16(grad) && aligned16(v) && aligned16(img) &&
                       aligned16(d_v) && aligned16(d_img);
  const int64_t blocks = plan_blocks(B, H, W, C, dtype == 0 ? 4 : 2, vec,
                                     c_chunk, smem, aligned);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  const int n_chunks = (C + c_chunk - 1) / c_chunk;
  const Consts k = make_consts(H, W, align_corners);
  const Band band{it, wt, kb};
  const float* th = static_cast<const float*>(theta);
  float* ph = static_cast<float*>(part);
  float* pv = ph + blocks * 3;
  float* dt = static_cast<float*>(d_theta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (int)blocks;
  if (dtype == 0) {
    if (vec == 4)
      return (int)launch_bwd<float, 4>(grad, v, img, d_v, d_img, ph, pv, dt, th,
                                       k, band, B, nb, H, W, C, c_chunk,
                                       n_chunks, smem, s);
    return (int)launch_bwd<float, 1>(grad, v, img, d_v, d_img, ph, pv, dt, th,
                                     k, band, B, nb, H, W, C, c_chunk, n_chunks,
                                     smem, s);
  }
  if (vec == 8)
    return (int)launch_bwd<__nv_bfloat16, 8>(grad, v, img, d_v, d_img, ph, pv,
                                             dt, th, k, band, B, nb, H, W, C,
                                             c_chunk, n_chunks, smem, s);
  return (int)launch_bwd<__nv_bfloat16, 1>(grad, v, img, d_v, d_img, ph, pv, dt,
                                           th, k, band, B, nb, H, W, C, c_chunk,
                                           n_chunks, smem, s);
}

const char* cadepth_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
