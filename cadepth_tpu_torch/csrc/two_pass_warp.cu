// Two-pass affine warp, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of passes V and H (`_pass_v_kernel` :80 and
// its pass-H twin :125) of cadepth_tpu/ops/pallas/two_pass_warp.py
// (launched by `_pallas_warp_fwd_passes`), the XLA einsum form
// `two_pass_affine_warp` of cadepth_tpu/ops/affine_warp.py, and the
// backward `_trainable_bwd` of the same TPU module (`_bwd_h_kernel`,
// `_bwd_v_kernel` and the chain of their partials to d_theta). They
// compute
//
//   V[b,i,x,c]   = sum_y tent(g(x,i) - y) * img[b,y,x,c],  g = p*x + q*i + r
//   out[b,i,j,c] = sum_x tent(h(j,i) - x) * V[b,i,x,c],    h = A*j + B*i + C
//   tent(d) = max(1 - |d|, 0),  p = D/A_safe,  q = E - p*B,  r = F - p*C
//
// with A..F the pixel-space coefficients of the torch-convention theta
// (cadepth_tpu_torch/ops/affine_warp.py: affine_pixel_coeffs, warp_coeffs).
// The line coefficients, the two-tap blend, pass H out of shared memory,
// the transposed pass H (two_pass_bwd_h_kernel), the candidate search
// (span) and the theta kernel live in warp_common.cuh, which the banded
// warp (fused_warp.cu) shares.
//
// What bounds it on this card: memory. Each output element costs two
// multiply-adds against the 2 to 4 bytes it reads, so the card's
// 3.35 TB/s sets the time. The TPU kernels ran dense tent blocks through
// the matrix unit; here each output has at most two non-zero taps, so
// each pass is a direct 2-tap gather.
//
// Forward, one launch (two_pass_fwd_kernel). A block owns one chunk of
// channels of one output row (b, i). It computes V's row for its chunk
// into dynamic shared memory with pass V's arithmetic, then, after one
// __syncthreads, pass H from that shared row. V never goes to device
// memory while serving, so the launch reads img about once (the two
// source rows of neighbouring output rows are the same rows, and blocks
// run in (b, i) order, so the second read comes from the 50 MB L2) and
// writes out once: the 2-map bound. While training, the caller passes
// `v` and the block also stores its shared row there for the backward:
// one more map written, none read back. Threads own 16-byte vectors of
// channels (8 bf16 or 4 f32), neighbouring threads on neighbouring
// channels, then pixels, so warps read and write contiguous segments.
// The chunk (ops/two_pass_warp.py: fwd_plan) halves the channels until a
// row's chunk fits 48 KB: at the flagship's five decoder levels a row
// holds W*C = 20,480 values (40 KB bf16, 80 KB f32), so a bf16 block holds
// the whole row (all 64 channels = 128 bytes a pixel at dec1) and an f32
// block half of it. The chunk at dec1 is the whole bf16 row because
// registers, not shared memory, set the occupancy: the kernel takes 57
// registers a thread, so four 256-thread blocks fit an SM whatever the
// chunk (four 40 KB rows take 160 of the SM's 228 KB); a smaller chunk
// only cuts each pixel's contiguous segment and reads the two source
// rows' pixels in more, shorter pieces, while a whole f32 row (80 KB)
// would leave room for two blocks only. A width whose single vector per
// pixel exceeds the 227 KB a block may use is refused by the wrapper;
// chunks above 48 KB raise the kernel's dynamic shared memory limit
// first.
//
// Numerics follow the plain PyTorch version (two_pass_affine_warp_plain)
// operation for operation: the coefficients with the same f32 operations
// and f32-rounded constants, each tap weight as max(1 - |pos - y|, 0) in
// f32, rounded to bf16 for bf16 features before the multiply, products
// and the two-tap sum in f32, V rounded to the feature dtype in shared
// memory as it was in device memory. nvcc would contract a*b + c into
// one FMA, which moves a position by an ulp; the _rn intrinsics forbid
// that, so the kernel's values equal the plain version's (up to the sign
// of a zero). Taps outside [0, size-1] contribute nothing (zeros
// padding); border padding clamps the position into [0, size-1] first.
//
// Backward, three launches. Given the cotangent G of `out`:
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
// (abs'(0) = +1, a max tie of weight 0.5) and dc the clamp's (1 inside,
// 0.5 on a bound, 0 outside; 1 for zeros padding). Both transposed passes
// are gathers: a thread owns one channel vector of one pixel of the
// transposed pass's output and visits the forward outputs that reach it
// (span of warp_common.cuh, then each candidate tested with the
// forward's own f32 position, so a tap counts exactly when the plain
// version's does). The visited vectors are summed with FMAs: their
// order differs from the plain version's index_add_ anyway, so the sums
// agree within the tolerance the plain version is held to, not bit for
// bit.
// two_pass_bwd_h_kernel stages the block's row chunk of G in shared
// memory, so every visit of a column j reads it there;
// two_pass_bwd_v_kernel reads the column of d_v from device memory
// (its rows i depend on x, and at |q| near 0 span the whole column, so
// no bounded tile holds them; neighbouring blocks read neighbouring rows,
// which L2 serves). Each block loops over all of its chunk's items, sums
// its threads' partials in a fixed order and writes one triple. Then
// two_pass_theta_kernel, one block per batch element, sums the triples
// of its batch element in a fixed order (in double) and applies the
// closed-form derivative of the line coefficients (chain_to_theta of
// warp_common.cuh, ops/affine_warp.py: chain_theta_closed) on the card:
// no float atomics, so two runs give the same bits, and the host
// launches the three kernels and nothing else. The passes move 6 maps
// (G, V, img and d_v read, d_v and d_img written) where the bound counts
// 4: d_v goes through device memory (a single launch would need d_v's
// rows for every output row, and at |q| near 0 those are the whole
// column). Each pass
// reaches about 60 % of the card's bandwidth on its own traffic: a
// thread has one item's loads in flight, and the passes are held to 64
// registers so that four 256-thread blocks share an SM. More loads in
// flight a thread (several candidates grouped, the next item prefetched,
// G and V both staged) take more registers or shared memory, so fewer
// blocks an SM.
//
// A window of output rows. Under spatial parallelism a rank holds a band
// of the map's rows and warps only those: the forward and the backward
// take `row0` and `rows`, the output rows row0 .. row0 + rows - 1 of the
// warp of the whole (H-row) input. The coefficients come from the whole
// map's H and W and every position from the map's row index row0 + i,
// so a window's rows are those rows of the whole warp, bit for bit. The
// forward's blocks and out and V cover the window's rows only; bwd H
// reads the window's cotangent and V; bwd V visits, for each input row,
// only the output rows inside the window and writes the whole input's
// d_img; the theta kernel chains the window's partials, so summing the
// windows' d_img and d_theta over a partition of H gives the whole
// warp's (chain_to_theta is linear in the partials). row0 0 and rows H
// are the whole map, and launch exactly what they did before.

#include "warp_common.cuh"

namespace {

// Forward: pass V into shared memory, pass H out of it; V also to `v`
// when it is not null. img has H rows a batch element, out and v the
// window's `rows`; block (b, i, chunk) computes the map's row row0 + i.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
two_pass_fwd_kernel(const T* __restrict__ img, T* __restrict__ v,
                    T* __restrict__ out, const float* __restrict__ theta,
                    Consts k, int H, int row0, int rows, int W, int C,
                    int c_chunk, int n_chunks, int border) {
  using P = Pack<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* vrow = reinterpret_cast<T*>(smem_raw);  // V[b, i, :, chunk], pixel stride cc
  const Chunk ch = chunk_of(rows, C, c_chunk, n_chunks);
  const int cvn = ch.cc / VEC;
  const int items = W * cvn;
  const Lines l = lines(theta + 6 * ch.b, k);
  const int64_t row_at = ch.row * W * C + ch.c_lo;
  const T* plane = img + (int64_t)ch.b * H * W * C + ch.c_lo;
  const int i = row0 + ch.i;

  const float qi = __fmul_rn(l.q, (float)i);
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int x = item / cvn;
    const int c = (item - x * cvn) * VEC;
    const float g = __fadd_rn(__fadd_rn(__fmul_rn(l.p, (float)x), qi), l.r);
    const Taps t = two_taps<T>(g, H, border != 0);
    const T* col = plane + (int64_t)x * C + c;
    T* dst = vrow + x * ch.cc + c;
    blend<T, VEC>(dst, col + (int64_t)t.i0 * W * C, col + (int64_t)t.i1 * W * C, t);
    if (v != nullptr)
      *reinterpret_cast<P*>(v + row_at + (int64_t)x * C + c) =
          *reinterpret_cast<const P*>(dst);
  }
  __syncthreads();

  pass_h_row<T, VEC>(out + row_at, vrow, l, i, W, C, ch.cc, border != 0);
}

// Bwd V: block (b, y, chunk) over the H input rows; thread pixel x, loop
// over the window's output rows i reading d_v's column (d_v holds the
// window's `rows` rows, i = row0 ..); own = img, writes d_img and the
// triple (s_p, s_q, s_r).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 4)
two_pass_bwd_v_kernel(const T* __restrict__ d_v, const T* __restrict__ img,
                      T* __restrict__ d_img, float* __restrict__ part,
                      const float* __restrict__ theta, Consts k, int H,
                      int row0, int rows, int W, int C, int c_chunk,
                      int n_chunks, int border) {
  using P = Pack<T, VEC>;
  const Chunk ch = chunk_of(H, C, c_chunk, n_chunks);
  const int cvn = ch.cc / VEC;
  const int items = W * cvn;
  const int64_t row_at = ch.row * W * C + ch.c_lo;
  const T* plane = d_v + (int64_t)ch.b * rows * W * C + ch.c_lo;
  const Lines l = lines(theta + 6 * ch.b, k);
  const Slope sl = slope_of(l.q);
  const float hi = (float)(H - 1);
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
    const float fixed = __fmul_rn(l.p, (float)x);
    const double mag = fabs((double)l.q) * H + fabs((double)fixed) + fabs((double)l.r);
    Range rg = span(sl, (double)fixed + (double)l.r, mag, ch.i, H,
                    row0 + rows, border != 0);
    rg.lo = max(rg.lo, row0);
    float ti = 0.0f, t = 0.0f;
    visit<T, VEC, false>(plane + (int64_t)x * C + c, (int64_t)W * C, row0,
                         mine, acc, rg, l.q, fixed, l.r, ch.i, hi, border, ti,
                         t);
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
                       const Consts& k, int blocks, int H, int row0, int rows,
                       int W, int C, int c_chunk, int n_chunks, int smem,
                       int border, cudaStream_t stream) {
  cudaError_t err = allow_smem(two_pass_fwd_kernel<T, VEC>, smem);
  if (err != cudaSuccess) return err;
  two_pass_fwd_kernel<T, VEC><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(img), static_cast<T*>(v), static_cast<T*>(out),
      theta, k, H, row0, rows, W, C, c_chunk, n_chunks, border);
  return cudaGetLastError();
}

// blocks_h cover the window's rows (bwd H), blocks_v the input's H rows
// (bwd V).
template <typename T, int VEC>
cudaError_t launch_bwd(const void* grad, const void* v, const void* img,
                       void* d_v, void* d_img, float* part_h, float* part_v,
                       float* d_theta, const float* theta, const Consts& k,
                       int B, int blocks_h, int blocks_v, int H, int row0,
                       int rows, int W, int C, int c_chunk, int n_chunks,
                       int smem, int border, cudaStream_t stream) {
  cudaError_t err = allow_smem(two_pass_bwd_h_kernel<T, VEC>, smem);
  if (err != cudaSuccess) return err;
  two_pass_bwd_h_kernel<T, VEC><<<blocks_h, kThreads, smem, stream>>>(
      static_cast<const T*>(grad), static_cast<const T*>(v),
      static_cast<T*>(d_v), part_h, theta, k, row0, rows, W, C, c_chunk,
      n_chunks, border);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  two_pass_bwd_v_kernel<T, VEC><<<blocks_v, kThreads, 0, stream>>>(
      static_cast<const T*>(d_v), static_cast<const T*>(img),
      static_cast<T*>(d_img), part_v, theta, k, H, row0, rows, W, C, c_chunk,
      n_chunks, border);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  two_pass_theta_kernel<<<B, kThreads, 0, stream>>>(
      part_h, part_v, rows * n_chunks, H * n_chunks, theta, k, d_theta);
  return cudaGetLastError();
}

bool window_ok(int H, int row0, int rows) {
  return row0 >= 0 && rows >= 0 && (int64_t)row0 + rows <= H;
}

}  // namespace

extern "C" {

// img is a contiguous NHWC (B, H, W, C) device buffer; out and v are
// contiguous (B, rows, W, C) buffers of the same dtype (0 = float32, 1 =
// bfloat16) for the output rows row0 .. row0 + rows - 1 (the whole map:
// row0 0, rows H); v may be null (nothing stored); theta is a contiguous
// (B, 2, 3) float32 device buffer. `vec` channels per thread (1, or 4
// f32 / 8 bf16 with C a multiple and the buffers 16-byte aligned),
// `c_chunk` channels per block and `smem` = W * c_chunk * sizeof(dtype)
// come from ops/two_pass_warp.py: fwd_plan. Launches
// two_pass_fwd_kernel on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a plan or a window the kernel does not
// take).
int cadepth_two_pass_warp_fwd(const void* img, void* v, void* out,
                              const void* theta, int B, int H, int row0,
                              int rows, int W, int C, int dtype, int border,
                              int align_corners, int vec, int c_chunk,
                              int smem, void* stream) {
  if (!window_ok(H, row0, rows)) return (int)cudaErrorInvalidValue;
  if (B == 0 || rows == 0 || W == 0 || C == 0) return (int)cudaSuccess;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const bool aligned = aligned16(img) && aligned16(out) && (v == nullptr || aligned16(v));
  const int64_t blocks = plan_blocks(B, rows, W, C, dtype == 0 ? 4 : 2, vec,
                                     c_chunk, smem, aligned);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  const int n_chunks = (C + c_chunk - 1) / c_chunk;
  const Consts k = make_consts(H, W, align_corners);
  const float* th = static_cast<const float*>(theta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (int)blocks;
  if (dtype == 0) {
    if (vec == 4)
      return (int)launch_fwd<float, 4>(img, v, out, th, k, nb, H, row0, rows,
                                       W, C, c_chunk, n_chunks, smem, border, s);
    return (int)launch_fwd<float, 1>(img, v, out, th, k, nb, H, row0, rows, W,
                                     C, c_chunk, n_chunks, smem, border, s);
  }
  if (vec == 8)
    return (int)launch_fwd<__nv_bfloat16, 8>(img, v, out, th, k, nb, H, row0,
                                             rows, W, C, c_chunk, n_chunks,
                                             smem, border, s);
  return (int)launch_fwd<__nv_bfloat16, 1>(img, v, out, th, k, nb, H, row0,
                                           rows, W, C, c_chunk, n_chunks, smem,
                                           border, s);
}

// The backward of cadepth_two_pass_warp_fwd over the same window. grad
// (the cotangent of out), v (the forward's V) and d_v (scratch) are
// contiguous (B, rows, W, C) device buffers, img and d_img contiguous
// (B, H, W, C) ones, all of one dtype; theta is (B, 2, 3) float32; part
// is a float32 scratch buffer of B * (rows + H) * n_chunks * 3 values
// (n_chunks = ceil(C / c_chunk)); d_theta a float32 (B, 2, 3) output.
// vec, c_chunk and smem as for the forward. Launches bwd H (grad, v ->
// d_v, the first B * rows * n_chunks triples of part), bwd V (d_v, img
// -> d_img, the rest) and the theta kernel (part -> d_theta) on
// `stream` and returns cudaGetLastError().
int cadepth_two_pass_warp_bwd(const void* grad, const void* v, const void* img,
                              const void* theta, void* d_v, void* d_img,
                              void* part, void* d_theta, int B, int H,
                              int row0, int rows, int W, int C, int dtype,
                              int border, int align_corners, int vec,
                              int c_chunk, int smem, void* stream) {
  if (!window_ok(H, row0, rows)) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int n_chunks = C > 0 && c_chunk > 0 ? (C + c_chunk - 1) / c_chunk : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 0 || W == 0 || C == 0) {
    // nothing to visit: every partial is 0, and so is d_theta
    return (int)cudaMemsetAsync(d_theta, 0, (size_t)B * 6 * sizeof(float), s);
  }
  if (rows == 0) {
    // an empty window reads no input row
    cudaError_t err = cudaMemsetAsync(
        d_img, 0, (size_t)B * H * W * C * (dtype == 0 ? 4 : 2), s);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaMemsetAsync(d_theta, 0, (size_t)B * 6 * sizeof(float), s);
  }
  const bool aligned = aligned16(grad) && aligned16(v) && aligned16(img) &&
                       aligned16(d_v) && aligned16(d_img);
  const int size = dtype == 0 ? 4 : 2;
  const int64_t blocks_h = plan_blocks(B, rows, W, C, size, vec, c_chunk, smem,
                                       aligned);
  const int64_t blocks_v = plan_blocks(B, H, W, C, size, vec, c_chunk, smem,
                                       aligned);
  if (blocks_h == 0 || blocks_v == 0) return (int)cudaErrorInvalidValue;
  const Consts k = make_consts(H, W, align_corners);
  const float* th = static_cast<const float*>(theta);
  float* ph = static_cast<float*>(part);
  float* pv = ph + blocks_h * 3;
  float* dt = static_cast<float*>(d_theta);
  const int bh = (int)blocks_h, bv = (int)blocks_v;
  if (dtype == 0) {
    if (vec == 4)
      return (int)launch_bwd<float, 4>(grad, v, img, d_v, d_img, ph, pv, dt, th,
                                       k, B, bh, bv, H, row0, rows, W, C,
                                       c_chunk, n_chunks, smem, border, s);
    return (int)launch_bwd<float, 1>(grad, v, img, d_v, d_img, ph, pv, dt, th,
                                     k, B, bh, bv, H, row0, rows, W, C, c_chunk,
                                     n_chunks, smem, border, s);
  }
  if (vec == 8)
    return (int)launch_bwd<__nv_bfloat16, 8>(grad, v, img, d_v, d_img, ph, pv,
                                             dt, th, k, B, bh, bv, H, row0,
                                             rows, W, C, c_chunk, n_chunks,
                                             smem, border, s);
  return (int)launch_bwd<__nv_bfloat16, 1>(grad, v, img, d_v, d_img, ph, pv, dt,
                                           th, k, B, bh, bv, H, row0, rows, W,
                                           C, c_chunk, n_chunks, smem, border,
                                           s);
}

const char* cadepth_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
