// Banded ("fused") two-pass affine warp, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels `_fwd_v_banded_kernel` (launched by
// `_fused_fwd_passes`) and `_bwd_v_banded_kernel` (launched by
// `_fused_trainable_bwd`) of cadepth_tpu/ops/pallas/fused_warp.py, and
// their H passes, `_pass_h_kernel` and `_bwd_h_kernel` of
// cadepth_tpu/ops/pallas/two_pass_warp.py: this file launches
// pass_h_kernel and bwd_pass_kernel<..., true> of warp_common.cuh with
// border = 0.
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
// Design: one thread per (b, output row, x, 16-byte channel vector), as
// in pass_h_kernel and bwd_pass_kernel, looping over the kb rows of ITS cell's band (the
// TPU kernel's loop, one grid cell per thread group); each thread
// computes its cell's band base from the cell's corners. A tap whose
// weight is 0 loads nothing (the product is +-0). The partials are
// summed per block in a fixed order and over blocks by the host: no float
// atomics, two runs give the same bits.
//
// What bounds it: memory. The least traffic is the two-pass warp's (img
// read and out written; for the backward grad_out, V and img read and
// d_img written), plus V (d_v) written and read again between the two
// launches. A thread reads only the band rows whose weight is non-zero
// (two of kb_f), so the band costs arithmetic, not bytes: kb_f (kb_b)
// position tests per output element.

#include "warp_common.cuh"

namespace {

// Static tile and band sizes of one level (fused_tiles in the wrapper).
struct Band {
  int it;  // output rows per tile
  int wt;  // columns per strip
  int kb;  // band rows
};

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

// Banded pass V: block row (b, i); threads over (x, channel vector).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
fused_v_kernel(const T* __restrict__ img, T* __restrict__ v,
               const float* __restrict__ theta, Consts k, Band band, int B,
               int H, int W, int C) {
  using P = Pack<T, VEC>;
  const int cv_count = C / VEC;
  const int row_items = W * cv_count;
  for (int row = blockIdx.y; row < B * H; row += gridDim.y) {
    const int b = row / H;
    const int i = row - b * H;
    const Lines l = lines(theta + 6 * b, k);
    float i_lo, i_hi;
    cell_span(i, band.it, i_lo, i_hi);
    const float q_lo = __fmul_rn(l.q, i_lo), q_hi = __fmul_rn(l.q, i_hi);
    const float qi = __fmul_rn(l.q, (float)i);
    const T* plane = img + (int64_t)b * H * W * C;
    T* dst_row = v + (int64_t)row * W * C;
    for (int item = blockIdx.x * blockDim.x + threadIdx.x; item < row_items;
         item += gridDim.x * blockDim.x) {
      const int x = item / cv_count;
      const int c0 = (item - x * cv_count) * VEC;
      float x_lo, x_hi;
      cell_span(x, band.wt, x_lo, x_hi);
      const float p_lo = __fmul_rn(l.p, x_lo), p_hi = __fmul_rn(l.p, x_hi);
      const float gmin = min4(__fadd_rn(__fadd_rn(p_lo, q_lo), l.r),
                              __fadd_rn(__fadd_rn(p_hi, q_lo), l.r),
                              __fadd_rn(__fadd_rn(p_lo, q_hi), l.r),
                              __fadd_rn(__fadd_rn(p_hi, q_hi), l.r));
      const int y0 = band_base(gmin, H, band.kb);
      const float px = __fmul_rn(l.p, (float)x);
      const T* col = plane + (int64_t)x * C + c0;
      float acc[VEC];
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = 0.0f;
      for (int kk = 0; kk < band.kb; ++kk) {
        const int y = y0 + kk;
        const float pos = __fadd_rn(__fadd_rn(px, __fsub_rn(l.r, (float)y)), qi);
        const float w = tap_weight<T>(fmaxf(__fsub_rn(1.0f, fabsf(pos)), 0.0f));
        if (w == 0.0f) continue;
        const P s = *reinterpret_cast<const P*>(col + (int64_t)y * W * C);
#pragma unroll
        for (int q = 0; q < VEC; ++q)
          acc[q] = __fadd_rn(acc[q], __fmul_rn(w, to_f32(s.v[q])));
      }
      P out;
#pragma unroll
      for (int q = 0; q < VEC; ++q) out.v[q] = from_f32<T>(acc[q]);
      *reinterpret_cast<P*>(dst_row + (int64_t)x * C + c0) = out;
    }
  }
}

// Banded transposed pass V: block row (b, y); the thread's item is one
// channel vector of d_img[b, y, x]. `partials` holds, for each row,
// `stride` triples (s_p, s_q, s_r); block x writes triple x, block 0
// zeroes the tail (the layout of bwd_pass_kernel's).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
fused_bwd_v_kernel(const T* __restrict__ d_v, const T* __restrict__ img,
                   T* __restrict__ d_img, float* __restrict__ partials,
                   int stride, const float* __restrict__ theta, Consts k,
                   Band band, int B, int H, int W, int C) {
  using P = Pack<T, VEC>;
  const int cv_count = C / VEC;
  const int row_items = W * cv_count;
  const int item = blockIdx.x * blockDim.x + threadIdx.x;
  for (int row = blockIdx.y; row < B * H; row += gridDim.y) {
    const int b = row / H;
    const int y = row - b * H;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
    if (item < row_items) {
      const Lines l = lines(theta + 6 * b, k);
      const float q_safe = fabsf(l.q) < 1e-3f ? (l.q < 0.0f ? -1e-3f : 1e-3f) : l.q;
      const int x = item / cv_count;
      const int c0 = (item - x * cv_count) * VEC;
      float x_lo, x_hi, y_lo, y_hi;
      cell_span(x, band.wt, x_lo, x_hi);
      cell_span(y, band.it, y_lo, y_hi);
      const float p_lo = __fmul_rn(l.p, x_lo), p_hi = __fmul_rn(l.p, x_hi);
      const float lo_r = __fsub_rn(y_lo, l.r), hi_r = __fsub_rn(y_hi, l.r);
      const float t00 = __fsub_rn(lo_r, p_lo), t01 = __fsub_rn(lo_r, p_hi);
      const float t10 = __fsub_rn(hi_r, p_lo), t11 = __fsub_rn(hi_r, p_hi);
      const float t_lo = min4(t00, t01, t10, t11);
      const float t_hi = max4(t00, t01, t10, t11);
      const float u_lo = min4(__fdiv_rn(__fsub_rn(t_lo, 1.0f), q_safe),
                              __fdiv_rn(__fadd_rn(t_lo, 1.0f), q_safe),
                              __fdiv_rn(__fsub_rn(t_hi, 1.0f), q_safe),
                              __fdiv_rn(__fadd_rn(t_hi, 1.0f), q_safe));
      const int i0 = band_base(u_lo, H, band.kb);
      const float px = __fmul_rn(l.p, (float)x);
      const float yf = (float)y;
      const int64_t at = ((int64_t)row * W + x) * C + c0;
      const P mine = *reinterpret_cast<const P*>(img + at);
      const T* col = d_v + ((int64_t)b * H * W + x) * C + c0;
      float mine_f[VEC], acc[VEC];
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        mine_f[q] = to_f32(mine.v[q]);
        acc[q] = 0.0f;
      }
      for (int kk = 0; kk < band.kb; ++kk) {
        const int i = i0 + kk;
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
          acc[q] = __fadd_rn(acc[q], __fmul_rn(w, gv));
          dot = __fadd_rn(dot, __fmul_rn(gv, mine_f[q]));
        }
        // the reference's _dtent: abs'(0) = +1, weight 0.5 at |diff| == 1
        float dt = ad < 1.0f ? 1.0f : 0.5f;
        if (diff >= 0.0f) dt = -dt;
        const float t = dot * dt;
        s0 += t * (float)x;
        s1 += t * fi;
        s2 += t;
      }
      P out;
#pragma unroll
      for (int q = 0; q < VEC; ++q) out.v[q] = from_f32<T>(acc[q]);
      *reinterpret_cast<P*>(d_img + at) = out;
    }
    float* dst = partials + ((int64_t)row * stride) * 3;
    block_sum3(s0, s1, s2, dst + blockIdx.x * 3);
    if (blockIdx.x == 0) {
      for (int t = gridDim.x * 3 + threadIdx.x; t < stride * 3; t += blockDim.x)
        dst[t] = 0.0f;
    }
  }
}

dim3 row_grid(int B, int H, int W, int C, int vec) {
  const int64_t row_items = (int64_t)W * (C / vec);
  const int64_t rows = (int64_t)B * H;
  return dim3((unsigned)((row_items + kThreads - 1) / kThreads),
              (unsigned)(rows < kMaxRowBlocks ? rows : kMaxRowBlocks));
}

template <typename T, int VEC>
cudaError_t launch_fwd(const void* img, void* v, void* out, const float* theta,
                       const Consts& k, const Band& band, int B, int H, int W,
                       int C, cudaStream_t stream) {
  if ((int64_t)B * H * W * C == 0) return cudaSuccess;
  const dim3 grid = row_grid(B, H, W, C, VEC);
  fused_v_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(img), static_cast<T*>(v), theta, k, band, B, H, W, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pass_h_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(v), static_cast<T*>(out), theta, k, B, H, W, C, 0);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_bwd(const void* grad, const void* v, const void* img,
                       void* d_v, void* d_img, float* part_h, float* part_v,
                       int stride, const float* theta, const Consts& k,
                       const Band& band, int B, int H, int W, int C,
                       cudaStream_t stream) {
  if ((int64_t)B * H * W * C == 0) return cudaSuccess;
  const dim3 grid = row_grid(B, H, W, C, VEC);
  bwd_pass_kernel<T, VEC, true><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(grad), static_cast<const T*>(v),
      static_cast<T*>(d_v), part_h, stride, theta, k, B, H, W, C, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_bwd_v_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(d_v), static_cast<const T*>(img),
      static_cast<T*>(d_img), part_v, stride, theta, k, band, B, H, W, C);
  return cudaGetLastError();
}

bool band_ok(int H, int W, int it, int wt, int kb) {
  return it > 0 && wt > 0 && H % it == 0 && W % wt == 0 && kb >= 1 && kb <= H;
}

}  // namespace

extern "C" {

// img, v and out are contiguous NHWC (B, H, W, C) device buffers of one
// dtype (0 = float32, 1 = bfloat16); theta is a contiguous (B, 2, 3)
// float32 device buffer; it divides H, wt divides W, 1 <= kb <= H. The
// caller keeps B * H and W * C below 2^31. Launches the banded pass V
// (img -> v) and pass H (v -> out, zeros padding) on `stream` and returns
// cudaGetLastError().
int cadepth_fused_warp_fwd(const void* img, void* v, void* out,
                           const void* theta, int B, int H, int W, int C,
                           int dtype, int align_corners, int it, int wt,
                           int kb, void* stream) {
  if (!band_ok(H, W, it, wt, kb)) return (int)cudaErrorInvalidValue;
  const Consts k = make_consts(H, W, align_corners);
  const Band band{it, wt, kb};
  const float* th = static_cast<const float*>(theta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec_ok = aligned16(img) && aligned16(v) && aligned16(out);
  if (dtype == 0) {
    if (vec_ok && C % 4 == 0)
      return (int)launch_fwd<float, 4>(img, v, out, th, k, band, B, H, W, C, s);
    return (int)launch_fwd<float, 1>(img, v, out, th, k, band, B, H, W, C, s);
  }
  if (dtype == 1) {
    if (vec_ok && C % 8 == 0)
      return (int)launch_fwd<__nv_bfloat16, 8>(img, v, out, th, k, band, B, H, W, C, s);
    return (int)launch_fwd<__nv_bfloat16, 1>(img, v, out, th, k, band, B, H, W, C, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Triples of theta partials per row that cadepth_fused_warp_bwd's
// `part_h` and `part_v` hold: the most blocks a row can take.
int cadepth_fused_warp_bwd_stride(int W, int C) {
  return (int)(((int64_t)W * C + kThreads - 1) / kThreads);
}

// The backward of cadepth_fused_warp_fwd, with kb the backward's band
// (kb_b). grad (the cotangent of out), v (the forward's V), img, d_v
// (scratch) and d_img are contiguous NHWC (B, H, W, C) device buffers of
// one dtype; theta is (B, 2, 3) float32; part_h and part_v are float32
// buffers of B * H * stride * 3 values (stride =
// cadepth_fused_warp_bwd_stride(W, C)). Launches the transposed pass H
// (grad, v -> d_v, part_h) and the banded transposed pass V (d_v, img ->
// d_img, part_v) on `stream` and returns cudaGetLastError(). Summed over
// rows and the stride, part_h of batch b gives (s_a, s_b, s_c) and part_v
// (s_p, s_q, s_r).
int cadepth_fused_warp_bwd(const void* grad, const void* v, const void* img,
                           const void* theta, void* d_v, void* d_img,
                           void* part_h, void* part_v, int B, int H, int W,
                           int C, int dtype, int align_corners, int it, int wt,
                           int kb, void* stream) {
  if (!band_ok(H, W, it, wt, kb)) return (int)cudaErrorInvalidValue;
  const Consts k = make_consts(H, W, align_corners);
  const Band band{it, wt, kb};
  const float* th = static_cast<const float*>(theta);
  float* ph = static_cast<float*>(part_h);
  float* pv = static_cast<float*>(part_v);
  const int stride = cadepth_fused_warp_bwd_stride(W, C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec_ok = aligned16(grad) && aligned16(v) && aligned16(img) &&
                      aligned16(d_v) && aligned16(d_img);
  if (dtype == 0) {
    if (vec_ok && C % 4 == 0)
      return (int)launch_bwd<float, 4>(grad, v, img, d_v, d_img, ph, pv, stride,
                                       th, k, band, B, H, W, C, s);
    return (int)launch_bwd<float, 1>(grad, v, img, d_v, d_img, ph, pv, stride,
                                     th, k, band, B, H, W, C, s);
  }
  if (dtype == 1) {
    if (vec_ok && C % 8 == 0)
      return (int)launch_bwd<__nv_bfloat16, 8>(grad, v, img, d_v, d_img, ph, pv,
                                               stride, th, k, band, B, H, W, C, s);
    return (int)launch_bwd<__nv_bfloat16, 1>(grad, v, img, d_v, d_img, ph, pv,
                                             stride, th, k, band, B, H, W, C, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* cadepth_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
