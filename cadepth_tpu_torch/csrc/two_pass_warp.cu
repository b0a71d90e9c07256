// Two-pass affine warp, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels `_pass_v_kernel` and `_pass_h_kernel` of
// cadepth_tpu/ops/pallas/two_pass_warp.py (launched by
// `_pallas_warp_fwd_passes`), the XLA einsum form `two_pass_affine_warp`
// of cadepth_tpu/ops/affine_warp.py, and the backward `_trainable_bwd`
// of the same TPU module (`_bwd_h_kernel`, `_bwd_v_kernel` and the chain
// of their partials to d_theta). They compute
//
//   V[b,i,x,c]   = sum_y tent(g(x,i) - y) * img[b,y,x,c],  g = p*x + q*i + r
//   out[b,i,j,c] = sum_x tent(h(j,i) - x) * V[b,i,x,c],    h = A*j + B*i + C
//   tent(d) = max(1 - |d|, 0),  p = D/A_safe,  q = E - p*B,  r = F - p*C
//
// with A..F the pixel-space coefficients of the torch-convention theta
// (cadepth_tpu_torch/ops/affine_warp.py: affine_pixel_coeffs, warp_coeffs).
// The line coefficients, the two-tap blend and the transposed passes'
// candidate search (span) live in warp_common.cuh, which the banded warp
// (fused_warp.cu) shares; pass_h_kernel and bwd_pass_kernel there are
// the banded warp's, not launched from this file.
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
// closed-form derivative of the line coefficients (chain_theta below,
// ops/affine_warp.py: chain_theta_closed) on the card: no float atomics,
// so two runs give the same bits, and the host launches the three
// kernels and nothing else. The passes move 6 maps (G, V, img and d_v
// read, d_v and d_img written) where the bound counts 4: d_v goes
// through device memory (a single launch would need d_v's rows for every
// output row, and at |q| near 0 those are the whole column). Each pass
// reaches about 60 % of the card's bandwidth on its own traffic: a
// thread has one item's loads in flight, and the passes are held to 64
// registers so that four 256-thread blocks share an SM. More loads in
// flight a thread (several candidates grouped, the next item prefetched,
// G and V both staged) take more registers or shared memory, so fewer
// blocks an SM.

#include "warp_common.cuh"

namespace {

constexpr int kDefaultSmem = 48 * 1024;  // dynamic shared memory without opt-in

// The channel chunk of one block: rows (b, i) in order, chunks inner, so
// neighbouring blocks work on the same or neighbouring rows.
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

// Forward: pass V into shared memory, pass H out of it; V also to `v`
// when it is not null.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
two_pass_fwd_kernel(const T* __restrict__ img, T* __restrict__ v,
                    T* __restrict__ out, const float* __restrict__ theta,
                    Consts k, int H, int W, int C, int c_chunk, int n_chunks,
                    int border) {
  using P = Pack<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* vrow = reinterpret_cast<T*>(smem_raw);  // V[b, i, :, chunk], pixel stride cc
  const Chunk ch = chunk_of(H, C, c_chunk, n_chunks);
  const int cvn = ch.cc / VEC;
  const int items = W * cvn;
  const Lines l = lines(theta + 6 * ch.b, k);
  const int64_t row_at = ch.row * W * C + ch.c_lo;
  const T* plane = img + (int64_t)ch.b * H * W * C + ch.c_lo;

  const float qi = __fmul_rn(l.q, (float)ch.i);
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

  const float bi = __fmul_rn(l.b, (float)ch.i);
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int j = item / cvn;
    const int c = (item - j * cvn) * VEC;
    const float hp = __fadd_rn(__fadd_rn(__fmul_rn(l.a, (float)j), bi), l.c);
    const Taps t = two_taps<T>(hp, W, border != 0);
    blend<T, VEC>(out + row_at + (int64_t)j * C + c, vrow + t.i0 * ch.cc + c,
                  vrow + t.i1 * ch.cc + c, t);
  }
}

// One visit of a transposed pass: the forward outputs m in `rg` whose
// position reaches `target` add their cotangent vector (cot + m * step)
// to acc with the tent weight; t = <cot, mine> * dtent * dclip of each
// adds to t_sum, and t * m to tm_sum. The position of m is the
// forward's: bwd H ((A*m) + (B*i)) + C, bwd V ((p*x) + (q*m)) + r.
template <typename T, int VEC, bool H_PASS>
__device__ __forceinline__ void visit(const T* __restrict__ cot, int64_t step,
                                      const float* mine, float* acc, Range rg,
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
    const P cv = *reinterpret_cast<const P*>(cot + (int64_t)m * step);
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
// (s_a, s_b, s_c) to part[blockIdx.x].
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 4)
two_pass_bwd_h_kernel(const T* __restrict__ grad, const T* __restrict__ v,
                      T* __restrict__ d_v, float* __restrict__ part,
                      const float* __restrict__ theta, Consts k, int H, int W,
                      int C, int c_chunk, int n_chunks, int border) {
  using P = Pack<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* grow = reinterpret_cast<T*>(smem_raw);  // G[b, i, :, chunk], pixel stride cc
  const Chunk ch = chunk_of(H, C, c_chunk, n_chunks);
  const int cvn = ch.cc / VEC;
  const int items = W * cvn;
  const int64_t row_at = ch.row * W * C + ch.c_lo;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int x = item / cvn;
    const int c = (item - x * cvn) * VEC;
    *reinterpret_cast<P*>(grow + x * ch.cc + c) =
        *reinterpret_cast<const P*>(grad + row_at + (int64_t)x * C + c);
  }
  __syncthreads();

  const Lines l = lines(theta + 6 * ch.b, k);
  const float fixed = __fmul_rn(l.b, (float)ch.i);
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
    visit<T, VEC, true>(grow + c, ch.cc, mine, acc, rg, l.a, fixed, l.c, x,
                        hi, border, tj, t);
    s0 += tj;
    s1 += t * (float)ch.i;
    s2 += t;
    P res;
#pragma unroll
    for (int q = 0; q < VEC; ++q) res.v[q] = from_f32<T>(acc[q]);
    *reinterpret_cast<P*>(d_v + at) = res;
  }
  block_sum3(s0, s1, s2, part + (int64_t)blockIdx.x * 3);
}

// Bwd V: block (b, y, chunk); thread pixel x, loop over i reading d_v's
// column; own = img, writes d_img and the triple (s_p, s_q, s_r).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 4)
two_pass_bwd_v_kernel(const T* __restrict__ d_v, const T* __restrict__ img,
                      T* __restrict__ d_img, float* __restrict__ part,
                      const float* __restrict__ theta, Consts k, int H, int W,
                      int C, int c_chunk, int n_chunks, int border) {
  using P = Pack<T, VEC>;
  const Chunk ch = chunk_of(H, C, c_chunk, n_chunks);
  const int cvn = ch.cc / VEC;
  const int items = W * cvn;
  const int64_t row_at = ch.row * W * C + ch.c_lo;
  const T* plane = d_v + (int64_t)ch.b * H * W * C + ch.c_lo;
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
    const Range rg = span(sl, (double)fixed + (double)l.r, mag, ch.i, H, H,
                          border != 0);
    float ti = 0.0f, t = 0.0f;
    visit<T, VEC, false>(plane + (int64_t)x * C + c, (int64_t)W * C, mine, acc,
                         rg, l.q, fixed, l.r, ch.i, hi, border, ti, t);
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

// d_theta of one batch element from the six sums (s_a, s_b, s_c, s_p,
// s_q, s_r): the derivative of warp_coeffs written out, in the f32
// operation order of ops/affine_warp.py: chain_theta_closed. A_safe's
// clamp passes no gradient where |A| < 1e-3, as safe_divisor's where.
__device__ void chain_theta(const float* __restrict__ th, const Consts& k,
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

// One block per batch element b: the per-block triples of both passes
// (`per_b` each) summed in a fixed order, then chained to d_theta[b].
__global__ void __launch_bounds__(kThreads)
two_pass_theta_kernel(const float* __restrict__ part_h,
                      const float* __restrict__ part_v, int per_b,
                      const float* __restrict__ theta, Consts k,
                      float* __restrict__ d_theta) {
  __shared__ double sh[6][kThreads / 32];
  const int b = blockIdx.x;
  const float* ph = part_h + (int64_t)b * per_b * 3;
  const float* pv = part_v + (int64_t)b * per_b * 3;
  double s[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int t = threadIdx.x; t < per_b; t += blockDim.x) {
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      s[m] += (double)ph[t * 3 + m];
      s[3 + m] += (double)pv[t * 3 + m];
    }
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
    chain_theta(theta + 6 * b, k, sums, d_theta + 6 * b);
  }
}

// Lets `kernel` take `smem` bytes of dynamic shared memory.
template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <typename T, int VEC>
cudaError_t launch_fwd(const void* img, void* v, void* out, const float* theta,
                       const Consts& k, int blocks, int H, int W, int C,
                       int c_chunk, int n_chunks, int smem, int border,
                       cudaStream_t stream) {
  cudaError_t err = allow_smem(two_pass_fwd_kernel<T, VEC>, smem);
  if (err != cudaSuccess) return err;
  two_pass_fwd_kernel<T, VEC><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(img), static_cast<T*>(v), static_cast<T*>(out),
      theta, k, H, W, C, c_chunk, n_chunks, border);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_bwd(const void* grad, const void* v, const void* img,
                       void* d_v, void* d_img, float* part_h, float* part_v,
                       float* d_theta, const float* theta, const Consts& k,
                       int B, int blocks, int H, int W, int C, int c_chunk,
                       int n_chunks, int smem, int border, cudaStream_t stream) {
  cudaError_t err = allow_smem(two_pass_bwd_h_kernel<T, VEC>, smem);
  if (err != cudaSuccess) return err;
  two_pass_bwd_h_kernel<T, VEC><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(grad), static_cast<const T*>(v),
      static_cast<T*>(d_v), part_h, theta, k, H, W, C, c_chunk, n_chunks,
      border);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  two_pass_bwd_v_kernel<T, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(d_v), static_cast<const T*>(img),
      static_cast<T*>(d_img), part_v, theta, k, H, W, C, c_chunk, n_chunks,
      border);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  two_pass_theta_kernel<<<B, kThreads, 0, stream>>>(
      part_h, part_v, H * n_chunks, theta, k, d_theta);
  return cudaGetLastError();
}

// What the wrapper planned, checked against what the kernels take: VEC
// 1 or one 16-byte vector (with C and every pointer aligned to it), the
// chunk a positive multiple of VEC, its row in `smem` bytes, and fewer
// than 2^31 blocks. Returns the block count, or 0 where the plan is bad.
int64_t plan_blocks(int B, int H, int W, int C, int size, int vec,
                    int c_chunk, int smem, bool aligned) {
  if (vec != 1 && (vec * size != 16 || C % vec != 0 || !aligned)) return 0;
  if (c_chunk <= 0 || c_chunk % vec != 0) return 0;
  if ((int64_t)W * c_chunk * size != smem) return 0;
  const int64_t blocks = (int64_t)B * H * ((C + c_chunk - 1) / c_chunk);
  return blocks < ((int64_t)1 << 31) ? blocks : 0;
}

}  // namespace

extern "C" {

// img, v and out are contiguous NHWC (B, H, W, C) device buffers of one
// dtype (0 = float32, 1 = bfloat16); v may be null (nothing stored);
// theta is a contiguous (B, 2, 3) float32 device buffer. `vec` channels
// per thread (1, or 4 f32 / 8 bf16 with C a multiple and the buffers
// 16-byte aligned), `c_chunk` channels per block and `smem` = W *
// c_chunk * sizeof(dtype) come from ops/two_pass_warp.py: fwd_plan.
// Launches two_pass_fwd_kernel on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a plan the kernel does not take).
int cadepth_two_pass_warp_fwd(const void* img, void* v, void* out,
                              const void* theta, int B, int H, int W, int C,
                              int dtype, int border, int align_corners,
                              int vec, int c_chunk, int smem, void* stream) {
  if (B == 0 || H == 0 || W == 0 || C == 0) return (int)cudaSuccess;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const bool aligned = aligned16(img) && aligned16(out) && (v == nullptr || aligned16(v));
  const int64_t blocks = plan_blocks(B, H, W, C, dtype == 0 ? 4 : 2, vec,
                                     c_chunk, smem, aligned);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  const int n_chunks = (C + c_chunk - 1) / c_chunk;
  const Consts k = make_consts(H, W, align_corners);
  const float* th = static_cast<const float*>(theta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (int)blocks;
  if (dtype == 0) {
    if (vec == 4)
      return (int)launch_fwd<float, 4>(img, v, out, th, k, nb, H, W, C, c_chunk,
                                       n_chunks, smem, border, s);
    return (int)launch_fwd<float, 1>(img, v, out, th, k, nb, H, W, C, c_chunk,
                                     n_chunks, smem, border, s);
  }
  if (vec == 8)
    return (int)launch_fwd<__nv_bfloat16, 8>(img, v, out, th, k, nb, H, W, C,
                                             c_chunk, n_chunks, smem, border, s);
  return (int)launch_fwd<__nv_bfloat16, 1>(img, v, out, th, k, nb, H, W, C,
                                           c_chunk, n_chunks, smem, border, s);
}

// The backward of cadepth_two_pass_warp_fwd. grad (the cotangent of
// out), v (the forward's V), img, d_v (scratch) and d_img are contiguous
// NHWC (B, H, W, C) device buffers of one dtype; theta is (B, 2, 3)
// float32; part is a float32 scratch buffer of 2 * B * H * n_chunks * 3
// values (n_chunks = ceil(C / c_chunk)); d_theta a float32 (B, 2, 3)
// output. vec, c_chunk and smem as for the forward. Launches bwd H (grad,
// v -> d_v, part[0]), bwd V (d_v, img -> d_img, part[1]) and the theta
// kernel (part -> d_theta) on `stream` and returns cudaGetLastError().
int cadepth_two_pass_warp_bwd(const void* grad, const void* v, const void* img,
                              const void* theta, void* d_v, void* d_img,
                              void* part, void* d_theta, int B, int H, int W,
                              int C, int dtype, int border, int align_corners,
                              int vec, int c_chunk, int smem, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int n_chunks = C > 0 && c_chunk > 0 ? (C + c_chunk - 1) / c_chunk : 0;
  if (H == 0 || W == 0 || C == 0) {
    // nothing to visit: every partial is 0, and so is d_theta
    return (int)cudaMemsetAsync(d_theta, 0, (size_t)B * 6 * sizeof(float),
                                static_cast<cudaStream_t>(stream));
  }
  const bool aligned = aligned16(grad) && aligned16(v) && aligned16(img) &&
                       aligned16(d_v) && aligned16(d_img);
  const int64_t blocks = plan_blocks(B, H, W, C, dtype == 0 ? 4 : 2, vec,
                                     c_chunk, smem, aligned);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  const Consts k = make_consts(H, W, align_corners);
  const float* th = static_cast<const float*>(theta);
  float* ph = static_cast<float*>(part);
  float* pv = ph + blocks * 3;
  float* dt = static_cast<float*>(d_theta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (int)blocks;
  if (dtype == 0) {
    if (vec == 4)
      return (int)launch_bwd<float, 4>(grad, v, img, d_v, d_img, ph, pv, dt, th,
                                       k, B, nb, H, W, C, c_chunk, n_chunks,
                                       smem, border, s);
    return (int)launch_bwd<float, 1>(grad, v, img, d_v, d_img, ph, pv, dt, th,
                                     k, B, nb, H, W, C, c_chunk, n_chunks, smem,
                                     border, s);
  }
  if (vec == 8)
    return (int)launch_bwd<__nv_bfloat16, 8>(grad, v, img, d_v, d_img, ph, pv,
                                             dt, th, k, B, nb, H, W, C, c_chunk,
                                             n_chunks, smem, border, s);
  return (int)launch_bwd<__nv_bfloat16, 1>(grad, v, img, d_v, d_img, ph, pv, dt,
                                           th, k, B, nb, H, W, C, c_chunk,
                                           n_chunks, smem, border, s);
}

const char* cadepth_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
