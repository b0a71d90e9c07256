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
// and no matrix unit work here. Only the rows floor(v) and floor(v) + 1
// that lie in the band and in the image have a non-zero weight, and
// their columns x0 and x0 + 1: at most four taps a pixel, read from NHWC
// directly. A tap whose weight is exactly 0 is skipped; for finite
// features its product is +-0, and adding +-0 to the running sum (which
// starts at +0) leaves the f32 sum unchanged, so the skip does not
// change the result.
//
// Numerics: the coefficients with the operations and f32-rounded Python
// constants of the reference's _pixel_coeffs, the positions in its
// order, all with the _rn intrinsics (nvcc would otherwise contract a*b
// + c into one FMA, moving a position by an ulp), and the taps summed in
// the order y ascending, then x0, x0 + 1, so the kernel equals its plain
// version (cadepth_tpu_torch/ops/banded_affine_warp.py) bit for bit.
//
// What bounds it on this card: memory. Each output element costs four
// multiply-adds against the bytes of img it reads (each source element
// about once from device memory, again from L1 or L2 for its neighbours)
// and writes once, so the least time is img read once and out written
// once at 3.35 TB/s.
//
// Design: one launch; a block owns `rows` consecutive output rows of one
// sample, a strip of `cols` columns (all W but for very wide maps) and a
// chunk of channels, from a plan of the shape alone
// (ops/banded_affine_warp.py: affine_plan); consecutive blocks take
// neighbouring tiles of rows, so the source rows they share meet in L2.
// The position, band and weights of a pixel depend on its row and column
// alone, not on the channels, so the block does that arithmetic once:
// one thread computes the sample's six coefficients into shared memory,
// then the block writes a tap table with one entry for each (row,
// column) of its tile (kTapBytes: the four tap weights, zero where a tap
// lies outside the band, the image or has weight 0, and the tap rows' and
// columns' first index). Then the threads sweep (row, column, channel
// vector) doing loads and multiply-adds only: each reads its pixel's
// entry, issues the loads of the taps of non-zero weight together, and
// adds them in order. A thread per 16-byte vector that found its own
// taps would repeat the six coefficients (six IEEE divisions), the row's
// band and the pixel's taps for each of the pixel's vectors, to select
// at most four loads issued one by one behind branches. The kernel is
// built for 4 blocks an SM, which holds the bf16 kernel to 64
// registers: the plan's launches at the small levels then fit one wave. At the flagship's decoder levels the plan gives one
// row a block: blocks of 2 to 8 rows were slower in the design runs.

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

// Bytes of the tap table's entry for one (row, column): the weights of
// the taps (y, x0), (y, x0 + 1), (y + 1, x0), (y + 1, x0 + 1) (float4)
// and (y, x0) (int2).
constexpr int kTapBytes = 24;

// A launch's tiling (ops/banded_affine_warp.py: affine_plan).
struct Tiling {
  int rows;     // output rows a block owns
  int cols;     // columns a block owns
  int c_chunk;  // channels a block owns
  int n_strips, n_tiles;
};

// Built for 4 blocks an SM, as warp_common.cuh's kernels: that caps the
// bf16 kernel at 64 registers a thread (80 uncapped, 3 blocks an SM),
// 0.092 -> 0.071 ms at dec1 on an H100 (PERF.md).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 4)
banded_affine_kernel(const T* __restrict__ img, T* __restrict__ out,
                     const float* __restrict__ theta, PixelConsts k, Tiling t,
                     int B, int H, int W, int C) {
  using P = Pack<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* tap_w = reinterpret_cast<float4*>(smem_raw);
  int2* tap_at = reinterpret_cast<int2*>(smem_raw + (size_t)t.rows * t.cols * 16);
  __shared__ Coeffs co_s;
  // block -> (strip, tile of rows, sample, channel chunk), strip fastest
  int blk = blockIdx.x;
  const int strip = blk % t.n_strips;
  blk /= t.n_strips;
  const int tile = blk % t.n_tiles;
  blk /= t.n_tiles;
  const int b = blk % B;
  const int c_lo = (blk / B) * t.c_chunk;
  const int j0 = tile * t.rows, o0 = strip * t.cols;
  const int nr = min(t.rows, H - j0), nc = min(t.cols, W - o0);
  const int n_taps = nr * nc;

  if (threadIdx.x == 0) co_s = pixel_coeffs(theta + 6 * b, k);
  __syncthreads();
  const Coeffs co = co_s;
  const float hi_row = (float)(H - 1), hi_col = (float)(W - 1);
  for (int e = threadIdx.x; e < n_taps; e += blockDim.x) {
    const int r = e / nc;
    const float jf = (float)(j0 + r), of = (float)(o0 + e - r * nc);
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
    const float u = __fadd_rn(__fadd_rn(__fmul_rn(co.ax, of), bxj), co.cx);
    const float v = __fadd_rn(__fadd_rn(__fmul_rn(co.ay, of), byj), co.cy);
    const float x0 = floorf(u), x1 = __fadd_rn(x0, 1.0f);
    const float wx1 = __fsub_rn(u, x0);
    const float wx0 = __fsub_rn(1.0f, wx1);
    const bool in0 = x0 >= 0.0f && x0 <= hi_col, in1 = x1 >= 0.0f && x1 <= hi_col;
    const float fy = floorf(v);
    float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int yi = 0;
    if (fy >= -1.0f && fy <= hi_row) {
      yi = (int)fy;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int y = yi + dy;
        const int s = y - ys;
        if (y < 0 || y >= H || s < 0 || s >= s_hi) continue;
        const float wy = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(v, (float)y))));
        w[2 * dy] = in0 ? __fmul_rn(wx0, wy) : 0.0f;
        w[2 * dy + 1] = in1 ? __fmul_rn(wx1, wy) : 0.0f;
      }
    }
    // x0 lies in [-1, W - 1] where a column is in the image
    tap_w[e] = make_float4(w[0], w[1], w[2], w[3]);
    tap_at[e] = make_int2(yi, in0 || in1 ? (int)x0 : 0);
  }
  __syncthreads();

  // the sweep: item = (r * nc + oc) * cvn + cv, the thread's items
  // blockDim.x apart, its indices carried from one to the next
  const int cvn = min(t.c_chunk, C - c_lo) / VEC;
  const int items = n_taps * cvn;
  const int64_t wc = (int64_t)W * C;
  const T* plane = img + (int64_t)b * H * wc + c_lo;
  T* dst = out + ((int64_t)b * H + j0) * wc + o0 * (int64_t)C + c_lo;
  const int step = blockDim.x;
  const int d_e = step / cvn, d_cv = step - d_e * cvn;
  const int d_r = d_e / nc, d_oc = d_e - d_r * nc;
  int e = threadIdx.x / cvn;
  int cv = threadIdx.x - e * cvn;
  int r = e / nc;
  int oc = e - r * nc;
  for (int item = threadIdx.x; item < items; item += step) {
    const float4 wt = tap_w[e];
    const int2 at = tap_at[e];
    const T* src = plane + ((int64_t)at.x * W + at.y) * C + cv * VEC;
    P p0, p1, p2, p3;
    if (wt.x != 0.0f) p0 = *reinterpret_cast<const P*>(src);
    if (wt.y != 0.0f) p1 = *reinterpret_cast<const P*>(src + C);
    if (wt.z != 0.0f) p2 = *reinterpret_cast<const P*>(src + wc);
    if (wt.w != 0.0f) p3 = *reinterpret_cast<const P*>(src + wc + C);
    float acc[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = 0.0f;
    if (wt.x != 0.0f) {
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = __fadd_rn(acc[q], __fmul_rn(to_f32(p0.v[q]), wt.x));
    }
    if (wt.y != 0.0f) {
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = __fadd_rn(acc[q], __fmul_rn(to_f32(p1.v[q]), wt.y));
    }
    if (wt.z != 0.0f) {
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = __fadd_rn(acc[q], __fmul_rn(to_f32(p2.v[q]), wt.z));
    }
    if (wt.w != 0.0f) {
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = __fadd_rn(acc[q], __fmul_rn(to_f32(p3.v[q]), wt.w));
    }
    P res;
#pragma unroll
    for (int q = 0; q < VEC; ++q) res.v[q] = from_f32<T>(acc[q]);
    *reinterpret_cast<P*>(dst + ((int64_t)r * W + oc) * C + cv * VEC) = res;
    // advance by `step` items
    cv += d_cv;
    const int carry = cv >= cvn ? 1 : 0;
    cv -= carry * cvn;
    e += d_e + carry;
    oc += d_oc + carry;
    r += d_r;
    if (oc >= nc) {
      oc -= nc;
      ++r;
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* img, void* out, const float* theta,
                   const PixelConsts& k, const Tiling& t, int B, int H, int W,
                   int C, int blocks, int smem, cudaStream_t stream) {
  const cudaError_t err = allow_smem(banded_affine_kernel<T, VEC>, smem);
  if (err != cudaSuccess) return err;
  banded_affine_kernel<T, VEC><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(img), static_cast<T*>(out), theta, k, t, B, H, W, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// img and out are contiguous NHWC (B, H, W, C) device buffers of one dtype
// (0 = float32, 1 = bfloat16); theta is a contiguous (B, 2, 3) float32
// device buffer; H and W stay below 2^24. `vec` channels per thread,
// blocks of `rows` output rows, `cols` columns and `c_chunk` channels,
// and smem = rows * cols * 24 bytes come from
// ops/banded_affine_warp.py: affine_plan. Launches the warp (img -> out)
// on `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for
// a plan the kernel does not take).
int cadepth_banded_affine_warp(const void* img, void* out, const void* theta,
                               int B, int H, int W, int C, int dtype, int vec,
                               int rows, int cols, int c_chunk, int smem,
                               void* stream) {
  if (B == 0 || H == 0 || W == 0 || C == 0) return (int)cudaSuccess;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int size = dtype == 0 ? 4 : 2;
  const bool aligned = aligned16(img) && aligned16(out);
  if (vec != 1 && (vec * size != 16 || C % vec != 0 || !aligned))
    return (int)cudaErrorInvalidValue;
  if (rows <= 0 || cols <= 0 || c_chunk <= 0 || c_chunk % vec != 0)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)rows * cols * kTapBytes != smem || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  Tiling t;
  t.rows = rows;
  t.cols = cols;
  t.c_chunk = c_chunk;
  t.n_strips = (W + cols - 1) / cols;
  t.n_tiles = (H + rows - 1) / rows;
  const int64_t blocks = (int64_t)t.n_strips * t.n_tiles * B * ((C + c_chunk - 1) / c_chunk);
  if (blocks >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  PixelConsts k;
  k.w = (float)W;
  k.h = (float)H;
  k.kx = (float)(1.0 / (double)W - 1.0);
  k.ky = (float)(1.0 / (double)H - 1.0);
  k.wm1 = (float)(W - 1);
  const float* th = static_cast<const float*>(theta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (int)blocks;
  if (dtype == 0) {
    if (vec == 4)
      return (int)launch<float, 4>(img, out, th, k, t, B, H, W, C, nb, smem, s);
    return (int)launch<float, 1>(img, out, th, k, t, B, H, W, C, nb, smem, s);
  }
  if (vec == 8)
    return (int)launch<__nv_bfloat16, 8>(img, out, th, k, t, B, H, W, C, nb, smem, s);
  return (int)launch<__nv_bfloat16, 1>(img, out, th, k, t, B, H, W, C, nb, smem, s);
}

const char* cadepth_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
