// Banded affine bilinear warp, forward only, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_warp_kernel` of
// cadepth_tpu/ops/pallas/affine_warp.py (launched by `pallas_affine_warp`):
// grid_sample(img, affine_grid(theta)) with zeros padding and
// align_corners=False, summed over a static band of BAND_S = 16 source
// rows per output row. With the pixel-space coefficients of theta
//
//   u = (ax*o + bx*j) + cx,   v = (ay*o + by*j) + cy     (output row j, column o)
//
// output row j reads the source rows ys .. ys + s_hi - 1, where
//
//   ys   = clip(floor(min(v(0, j), v(W-1, j))), -BAND_S, H)
//   s_hi = min(ceil(max(v(0, j), v(W-1, j))) - ys + 2, BAND_S)
//
// and out[b,j,o,c] = sum over those rows y, in order, and over the two
// columns x0 = floor(u), x0 + 1, of fl(img[b,y,xc,c] * fl(wx_c * wy)) with
// wy = max(0, 1 - |v - y|), wx = (1 - (u - x0), u - x0), in f32; a row
// outside [0, H) or a column outside [0, W-1] adds nothing; the sum is
// cast to img's dtype. Rows past the band are dropped: where
// max_rotation_rows(theta) + 2 > BAND_S the result differs from
// grid_sample, and that truncation is the TPU kernel's function, kept
// here.
//
// The TPU kernel DMA'd each output row's band of a channel-major,
// lane-padded copy of img into VMEM and gathered along x with one-hot
// matrix products on the MXU (each output lane sums one product and 127
// zeros). None of that carries over: there is no transpose, no padding
// and no matrix unit work here. One thread per (b, output row, column,
// 16-byte channel vector) reads NHWC directly and visits only the rows
// floor(v) and floor(v) + 1 that lie in the band and in the image (no
// other row has a non-zero weight), and their two columns: at most four
// 16-byte loads and one 16-byte store. A tap whose weight is exactly 0 is
// skipped; for finite features its product is +-0, and adding +-0 to the
// running sum (which starts at +0) leaves the f32 sum unchanged, so the
// skip does not change the result.
//
// Numerics: the coefficients with the operations and f32-rounded Python
// constants of the reference's _pixel_coeffs, the positions in its
// order, all with the _rn intrinsics (nvcc would otherwise contract a*b
// + c into one FMA, moving a position by an ulp), so the kernel equals
// its plain version (cadepth_tpu_torch/ops/banded_affine_warp.py) bit
// for bit.
//
// What bounds it on this card: memory. Each output element costs four
// multiply-adds against the bytes of img it reads (each source element
// about once, from L2 after the first neighbour) and writes once, so the
// least time is img read once and out written once at 3.35 TB/s. Each
// thread also recomputes its row's coefficients and band (~30 f32
// operations, no memory traffic).

#include "warp_common.cuh"

namespace {

constexpr int kBandS = 16;  // BAND_S of the reference

// f32 constants of _pixel_coeffs, rounded from double on the host as a
// Python constant is rounded against a float32 array.
struct PixelConsts {
  float w, h;    // W, H
  float kx, ky;  // 1/W - 1, 1/H - 1
  float wm1;     // W - 1
};

struct Coeffs {
  float ax, bx, cx, ay, by, cy;
};

__device__ __forceinline__ Coeffs pixel_coeffs(const float* __restrict__ th,
                                               const PixelConsts& k) {
  const float t00 = th[0], t01 = th[1], t02 = th[2];
  const float t10 = th[3], t11 = th[4], t12 = th[5];
  Coeffs c;
  c.ax = __fdiv_rn(__fmul_rn(t00, k.w), k.w);
  c.bx = __fdiv_rn(__fmul_rn(t01, k.w), k.h);
  c.cx = __fdiv_rn(__fsub_rn(__fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(
      __fmul_rn(t00, k.kx), __fmul_rn(t01, k.ky)), t02), 1.0f), k.w), 1.0f), 2.0f);
  c.ay = __fdiv_rn(__fmul_rn(t10, k.h), k.w);
  c.by = __fdiv_rn(__fmul_rn(t11, k.h), k.h);
  c.cy = __fdiv_rn(__fsub_rn(__fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(
      __fmul_rn(t10, k.kx), __fmul_rn(t11, k.ky)), t12), 1.0f), k.h), 1.0f), 2.0f);
  return c;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
banded_affine_kernel(const T* __restrict__ img, T* __restrict__ out,
                     const float* __restrict__ theta, PixelConsts k, int B,
                     int H, int W, int C) {
  using P = Pack<T, VEC>;
  const int cv_count = C / VEC;
  const int row_items = W * cv_count;
  const float hi_row = (float)(H - 1), hi_col = (float)(W - 1);
  for (int row = blockIdx.y; row < B * H; row += gridDim.y) {
    const int b = row / H;
    const int j = row - b * H;
    const Coeffs co = pixel_coeffs(theta + 6 * b, k);
    const float jf = (float)j;
    const float bxj = __fmul_rn(co.bx, jf), byj = __fmul_rn(co.by, jf);
    // the row's band: v at the row's first and last column
    const float v0 = __fadd_rn(__fadd_rn(__fmul_rn(co.ay, 0.0f), byj), co.cy);
    const float v1 = __fadd_rn(__fadd_rn(__fmul_rn(co.ay, k.wm1), byj), co.cy);
    // clipping in float first keeps the int conversions in range; the
    // clip of ceil() changes nothing, since s_hi is BAND_S or below 1
    // beyond it
    const int ys = (int)fminf(fmaxf(floorf(fminf(v0, v1)), (float)-kBandS), (float)H);
    const int top = (int)fminf(fmaxf(ceilf(fmaxf(v0, v1)), -16777216.0f), 16777216.0f);
    const int s_hi = min(top - ys + 2, kBandS);
    const T* plane = img + (int64_t)b * H * W * C;
    T* dst_row = out + (int64_t)row * W * C;
    for (int item = blockIdx.x * blockDim.x + threadIdx.x; item < row_items;
         item += gridDim.x * blockDim.x) {
      const int o = item / cv_count;
      const int c0 = (item - o * cv_count) * VEC;
      const float of = (float)o;
      const float u = __fadd_rn(__fadd_rn(__fmul_rn(co.ax, of), bxj), co.cx);
      const float v = __fadd_rn(__fadd_rn(__fmul_rn(co.ay, of), byj), co.cy);
      const float x0 = floorf(u);
      const float wx1 = __fsub_rn(u, x0);
      const float xs[2] = {x0, __fadd_rn(x0, 1.0f)};
      const float wxs[2] = {__fsub_rn(1.0f, wx1), wx1};
      const float fy = floorf(v);
      float acc[VEC];
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = 0.0f;
      if (fy >= -1.0f && fy <= hi_row) {
        for (int dy = 0; dy < 2; ++dy) {
          const int y = (int)fy + dy;
          const int s = y - ys;
          if (y < 0 || y >= H || s < 0 || s >= s_hi) continue;
          const float wy = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(v, (float)y))));
          if (wy == 0.0f) continue;
#pragma unroll
          for (int cx = 0; cx < 2; ++cx) {
            if (!(xs[cx] >= 0.0f && xs[cx] <= hi_col)) continue;
            const float wgt = __fmul_rn(wxs[cx], wy);
            if (wgt == 0.0f) continue;
            const P src = *reinterpret_cast<const P*>(
                plane + ((int64_t)y * W + (int)xs[cx]) * C + c0);
#pragma unroll
            for (int q = 0; q < VEC; ++q)
              acc[q] = __fadd_rn(acc[q], __fmul_rn(to_f32(src.v[q]), wgt));
          }
        }
      }
      P res;
#pragma unroll
      for (int q = 0; q < VEC; ++q) res.v[q] = from_f32<T>(acc[q]);
      *reinterpret_cast<P*>(dst_row + (int64_t)o * C + c0) = res;
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* img, void* out, const float* theta,
                   const PixelConsts& k, int B, int H, int W, int C,
                   cudaStream_t stream) {
  if ((int64_t)B * H * W * C == 0) return cudaSuccess;
  const int64_t row_items = (int64_t)W * (C / VEC);
  const int64_t rows = (int64_t)B * H;
  const dim3 grid((unsigned)((row_items + kThreads - 1) / kThreads),
                  (unsigned)(rows < kMaxRowBlocks ? rows : kMaxRowBlocks));
  banded_affine_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(img), static_cast<T*>(out), theta, k, B, H, W, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// img and out are contiguous NHWC (B, H, W, C) device buffers of one dtype
// (0 = float32, 1 = bfloat16); theta is a contiguous (B, 2, 3) float32
// device buffer. The caller keeps B * H and W * C below 2^31 and H, W
// below 2^24. Launches the warp (img -> out) on `stream` and returns
// cudaGetLastError().
int cadepth_banded_affine_warp(const void* img, void* out, const void* theta,
                               int B, int H, int W, int C, int dtype,
                               void* stream) {
  PixelConsts k;
  k.w = (float)W;
  k.h = (float)H;
  k.kx = (float)(1.0 / (double)W - 1.0);
  k.ky = (float)(1.0 / (double)H - 1.0);
  k.wm1 = (float)(W - 1);
  const float* th = static_cast<const float*>(theta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec_ok = aligned16(img) && aligned16(out);
  if (dtype == 0) {
    if (vec_ok && C % 4 == 0)
      return (int)launch<float, 4>(img, out, th, k, B, H, W, C, s);
    return (int)launch<float, 1>(img, out, th, k, B, H, W, C, s);
  }
  if (dtype == 1) {
    if (vec_ok && C % 8 == 0)
      return (int)launch<__nv_bfloat16, 8>(img, out, th, k, B, H, W, C, s);
    return (int)launch<__nv_bfloat16, 1>(img, out, th, k, B, H, W, C, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* cadepth_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
