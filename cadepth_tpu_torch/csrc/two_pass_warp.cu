// Two-pass affine warp, forward and backward, for Hopper (sm_90a). Pass H
// and the backward's passes live in warp_common.cuh, which the fused warp
// (fused_warp.cu) shares; the backward's notes stand above
// bwd_pass_kernel there.
//
// Replaces the TPU kernels `_pass_v_kernel` and `_pass_h_kernel` of
// cadepth_tpu/ops/pallas/two_pass_warp.py (launched by
// `_pallas_warp_fwd_passes`), and the XLA einsum form
// `two_pass_affine_warp` of cadepth_tpu/ops/affine_warp.py. Both compute
//
//   V[b,i,x,c]   = sum_y tent(g(x,i) - y) * img[b,y,x,c],  g = p*x + q*i + r
//   out[b,i,j,c] = sum_x tent(h(j,i) - x) * V[b,i,x,c],    h = A*j + B*i + C
//   tent(d) = max(1 - |d|, 0),  p = D/A_safe,  q = E - p*B,  r = F - p*C
//
// with A..F the pixel-space coefficients of the torch-convention theta
// (cadepth_tpu_torch/ops/affine_warp.py: affine_pixel_coeffs, warp_coeffs).
//
// What bounds it on this card: memory. Each output element costs two
// multiply-adds against the 2 to 4 bytes it reads, so the card's
// 3.35 TB/s, not its arithmetic, sets the time. The TPU kernels built
// dense (H x H) and (W x W) tent blocks in VMEM and ran them through the
// matrix unit; here the tent has at most two non-zero taps per output,
// so each pass is a direct 2-tap gather. A block walks one output row
// (b, i): one thread per 16-byte vector of channels of one pixel (8 bf16
// or 4 f32 values), neighbouring threads on neighbouring channels, then
// neighbouring pixels, so every warp reads and writes whole contiguous
// NHWC rows; (b, i) come from the block index, so a thread divides only
// once, by the vector count. No tent matrix exists anywhere. Each thread
// derives the six line coefficients from theta itself, so the host
// launches nothing but the two passes. Two launches per warp: V goes
// through device memory between them, which doubles the bytes moved;
// fusing the passes is later work.
//
// Numerics follow the plain PyTorch version (two_pass_affine_warp_plain)
// operation for operation: the coefficients with the same f32 operations
// and f32-rounded constants as affine_pixel_coeffs and warp_coeffs, each
// tap weight as max(1 - |pos - y|, 0) in f32 (not 1 - frac / frac),
// rounded to bf16 for bf16 features before the multiply, products and
// the two-tap sum in f32, V stored in the feature dtype. nvcc would
// contract a*b + c into one FMA, which moves a position by an ulp; the
// _rn intrinsics forbid that, so the kernel's values equal the
// plain version's (up to the sign of a zero), not only within the
// tolerance that the continuity of the warp in its positions would give.
// Taps outside [0, size-1] contribute nothing (zeros padding); border
// padding clamps the position into [0, size-1] first.

#include "warp_common.cuh"

namespace {

// Pass V: block row (b, i); threads over (x, channel vector) of the row.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
pass_v_kernel(const T* __restrict__ img, T* __restrict__ v,
              const float* __restrict__ theta, Consts k, int B, int H, int W,
              int C, int border) {
  const int cv_count = C / VEC;
  const int row_items = W * cv_count;
  for (int row = blockIdx.y; row < B * H; row += gridDim.y) {
    const int b = row / H;
    const int i = row - b * H;
    const Lines l = lines(theta + 6 * b, k);
    const float qi = __fmul_rn(l.q, (float)i);
    const T* plane = img + (int64_t)b * H * W * C;
    T* dst_row = v + (int64_t)row * W * C;
    for (int item = blockIdx.x * blockDim.x + threadIdx.x; item < row_items;
         item += gridDim.x * blockDim.x) {
      const int x = item / cv_count;
      const int c0 = (item - x * cv_count) * VEC;
      const float g = __fadd_rn(__fadd_rn(__fmul_rn(l.p, (float)x), qi), l.r);
      const Taps t = two_taps<T>(g, H, border != 0);
      const T* col = plane + (int64_t)x * C + c0;
      blend<T, VEC>(dst_row + (int64_t)x * C + c0, col + (int64_t)t.i0 * W * C,
                    col + (int64_t)t.i1 * W * C, t);
    }
  }
}

template <typename T, int VEC>
cudaError_t launch_bwd(const void* grad, const void* v, const void* img,
                       void* d_v, void* d_img, float* part_h, float* part_v,
                       int stride, const float* theta, const Consts& k, int B,
                       int H, int W, int C, int border, cudaStream_t stream) {
  const int64_t row_items = (int64_t)W * (C / VEC);
  const int64_t rows = (int64_t)B * H;
  if (row_items == 0 || rows == 0) return cudaSuccess;
  const dim3 grid((unsigned)((row_items + kThreads - 1) / kThreads),
                  (unsigned)(rows < kMaxRowBlocks ? rows : kMaxRowBlocks));
  bwd_pass_kernel<T, VEC, true><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(grad), static_cast<const T*>(v),
      static_cast<T*>(d_v), part_h, stride, theta, k, B, H, W, C, border);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_pass_kernel<T, VEC, false><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(d_v), static_cast<const T*>(img),
      static_cast<T*>(d_img), part_v, stride, theta, k, B, H, W, C, border);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch(const void* img, void* v, void* out, const float* theta,
                   const Consts& k, int B, int H, int W, int C, int border,
                   cudaStream_t stream) {
  const int64_t row_items = (int64_t)W * (C / VEC);
  const int64_t rows = (int64_t)B * H;
  if (row_items == 0 || rows == 0) return cudaSuccess;
  const dim3 grid((unsigned)((row_items + kThreads - 1) / kThreads),
                  (unsigned)(rows < kMaxRowBlocks ? rows : kMaxRowBlocks));
  pass_v_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(img), static_cast<T*>(v), theta, k, B, H, W, C, border);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pass_h_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(v), static_cast<T*>(out), theta, k, B, H, W, C, border);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// img, v and out are contiguous NHWC (B, H, W, C) device buffers of one
// dtype (0 = float32, 1 = bfloat16); theta is a contiguous (B, 2, 3)
// float32 device buffer. The caller keeps B * H and W * C below 2^31
// (rows and one row's items are counted in int).
// Launches pass V (img -> v) and pass H (v -> out) on `stream` and returns
// cudaGetLastError().
int cadepth_two_pass_warp_fwd(const void* img, void* v, void* out,
                              const void* theta, int B, int H, int W, int C,
                              int dtype, int border, int align_corners,
                              void* stream) {
  const Consts k = make_consts(H, W, align_corners);
  const float* th = static_cast<const float*>(theta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec_ok = aligned16(img) && aligned16(v) && aligned16(out);
  if (dtype == 0) {
    if (vec_ok && C % 4 == 0)
      return (int)launch<float, 4>(img, v, out, th, k, B, H, W, C, border, s);
    return (int)launch<float, 1>(img, v, out, th, k, B, H, W, C, border, s);
  }
  if (dtype == 1) {
    if (vec_ok && C % 8 == 0)
      return (int)launch<__nv_bfloat16, 8>(img, v, out, th, k, B, H, W, C, border, s);
    return (int)launch<__nv_bfloat16, 1>(img, v, out, th, k, B, H, W, C, border, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Triples of theta partials per row that cadepth_two_pass_warp_bwd's
// `part_h` and `part_v` hold: the most blocks a row can take.
int cadepth_two_pass_warp_bwd_stride(int W, int C) {
  return (int)(((int64_t)W * C + kThreads - 1) / kThreads);
}

// The backward of cadepth_two_pass_warp_fwd. grad (the cotangent of
// out), v (the forward's V), img, d_v (scratch) and d_img are contiguous
// NHWC (B, H, W, C) device buffers of one dtype; theta is (B, 2, 3)
// float32; part_h and part_v are float32 buffers of B * H * stride * 3
// values (stride = cadepth_two_pass_warp_bwd_stride(W, C)). Launches bwd
// H (grad, v -> d_v, part_h) and bwd V (d_v, img -> d_img, part_v) on
// `stream` and returns cudaGetLastError(). Summed over rows and the
// stride, part_h of batch b gives (s_a, s_b, s_c) and part_v
// (s_p, s_q, s_r).
int cadepth_two_pass_warp_bwd(const void* grad, const void* v, const void* img,
                              const void* theta, void* d_v, void* d_img,
                              void* part_h, void* part_v, int B, int H, int W,
                              int C, int dtype, int border, int align_corners,
                              void* stream) {
  const Consts k = make_consts(H, W, align_corners);
  const float* th = static_cast<const float*>(theta);
  float* ph = static_cast<float*>(part_h);
  float* pv = static_cast<float*>(part_v);
  const int stride = cadepth_two_pass_warp_bwd_stride(W, C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec_ok = aligned16(grad) && aligned16(v) && aligned16(img) &&
                      aligned16(d_v) && aligned16(d_img);
  if (dtype == 0) {
    if (vec_ok && C % 4 == 0)
      return (int)launch_bwd<float, 4>(grad, v, img, d_v, d_img, ph, pv, stride,
                                       th, k, B, H, W, C, border, s);
    return (int)launch_bwd<float, 1>(grad, v, img, d_v, d_img, ph, pv, stride,
                                     th, k, B, H, W, C, border, s);
  }
  if (dtype == 1) {
    if (vec_ok && C % 8 == 0)
      return (int)launch_bwd<__nv_bfloat16, 8>(grad, v, img, d_v, d_img, ph, pv,
                                               stride, th, k, B, H, W, C, border, s);
    return (int)launch_bwd<__nv_bfloat16, 1>(grad, v, img, d_v, d_img, ph, pv,
                                             stride, th, k, B, H, W, C, border, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* cadepth_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
