// Backward of the bilinear grid sample (torch F.grid_sample semantics:
// bilinear, zero padding, align_corners=False), channel-last, float32.
//
// Replaces the VJPs the JAX package attaches to grid_sample_pallas
// (waldo_tpu/ops/pallas/grid_sample.py) in both of its modes:
//   shared      img (F, H, W, C), grid (F*tp, Ho, Wo, 2), grad_out
//               (F*tp, Ho, Wo, C) -> grad_grid (F*tp, Ho, Wo, 2) and, if
//               asked, grad_img (F, H, W, C) (the training path's gathered
//               context fusion, _pallas_bwd in waldo_tpu/ops/grid_sample.py,
//               at (112, 128, 256, 23) with tp = 1; there x is data and only
//               grad_grid is asked for);
//   per-channel planes (F, C, H, W) and their nonzero boxes (F, C, 4) from
//               the forward's pre-pass (planes.cu), grids (F, C, Ho, Wo, 2),
//               grad_out (F, Ho, Wo, C) -> grad_grids (F, C, Ho, Wo, 2) and,
//               if asked, grad_planes (F, C, H, W) (the training path's
//               unfused alpha_ctx warp, _pallas_mg_bwd, at (112, 128, 256,
//               17); the alphas come from LVD's parameters, so grad_img is
//               asked for), C <= 32.
//
// The derivative follows torch's grid_sampler_2d_backward: floor taps, so
// a sample exactly on a texel centre takes the one-sided difference towards
// the next texel (the JAX MXU VJP takes another one there).
//
// Bound on an H100: memory. Per output sample the kernels read the grid
// point, the output gradient and four texels and write the grid gradient,
// a few flop each; grad_img adds four float atomics per sample.
// Design (shared mode), as the forward's: a block takes 128 output pixels of
// one row, computes each pixel's taps once into shared memory, then walks
// the (pixel, channel) values channel-fastest, so its grad_out reads are one
// contiguous span and a warp's texel reads (and grad_img's atomics) hit
// neighbouring channels of neighbouring texels; each value's two grid-
// gradient terms meet their pixel's in shared memory (no atomics), summed by
// two threads a pixel (one thread a pixel left half the block idle).
// Design (per-channel mode): as the forward, a block takes 128 output pixels
// of one row and all C layers, a warp being 32 pixels of one layer; the
// block stages its (128 x C) slice of grad_out, one contiguous span, in
// shared memory. The grid gradient skips the texel reads of a sample whose
// 2x2 footprint misses its plane's nonzero box (its four texels are zero,
// so is its derivative); grad_img may not skip by that box (a zero texel
// still receives gradient), only where the output gradient is zero.
// grad_planes take float atomics, summed in an order that changes from run
// to run.

#include "bilinear.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBwPix = 128;  // shared mode: output pixels per block
constexpr int kPcPix = 128;  // per-channel mode: output pixels per block
constexpr int kMaxC = 32;    // channels a block stages at a time

struct Valid {
  bool x0, x1, y0, y1;
};

__device__ __forceinline__ Valid valid_taps(const Taps& t, int H, int W) {
  return {t.x0 >= 0 && t.x0 < W, t.x0 + 1 >= 0 && t.x0 + 1 < W, t.y0 >= 0 && t.y0 < H,
          t.y0 + 1 >= 0 && t.y0 + 1 < H};
}

// d(bilinear sum)/d(ix, iy) for the tap values v in tap order (y0,x0)
// (y0,x1) (y1,x0) (y1,x1), in unnormalized (pixel) units.
__device__ __forceinline__ float2 tap_derivative(const Taps& t, const float v[4]) {
  return make_float2((1.f - t.ty) * (v[1] - v[0]) + t.ty * (v[3] - v[2]),
                     (1.f - t.tx) * (v[2] - v[0]) + t.tx * (v[3] - v[1]));
}

// g times each tap's bilinear weight, added into the texels of a texture
// whose texel (y, x) sits at base[(y * W + x) * stride]; taps outside the
// texture are dropped (zero padding).
__device__ __forceinline__ void scatter_taps(float* base, int W, int stride, const Taps& t,
                                             const Valid& ok, float g) {
  const int x1 = t.x0 + 1, y1 = t.y0 + 1;
  const float wx0 = 1.f - t.tx, wy0 = 1.f - t.ty;
  if (ok.y0 && ok.x0) atomicAdd(base + (size_t)(t.y0 * W + t.x0) * stride, wx0 * wy0 * g);
  if (ok.y0 && ok.x1) atomicAdd(base + (size_t)(t.y0 * W + x1) * stride, t.tx * wy0 * g);
  if (ok.y1 && ok.x0) atomicAdd(base + (size_t)(y1 * W + t.x0) * stride, wx0 * t.ty * g);
  if (ok.y1 && ok.x1) atomicAdd(base + (size_t)(y1 * W + x1) * stride, t.tx * t.ty * g);
}

// Shared grid: row n = blockIdx.y, pixels [p0, p0 + 128) of it. The taps
// of each pixel go to shared memory first; then, 32 channels at a time, the
// block walks its (pixel, channel) values channel-fastest, each thread
// leaving a value's two grid-gradient terms in shared memory, and threads
// 2q and 2q + 1 sum pixel q's even and odd channels' terms, met by one
// shuffle at the end. In-row indices are 32-bit (the wrapper bounds
// Ho*Wo*C and H*W*C). kImg: grad_img is asked for (its atomics compiled
// out of the grid-only instantiation the training path runs).
template <bool kImg>
__global__ void __launch_bounds__(kThreads) grid_sample_shared_bwd_kernel(
    const float* __restrict__ img, const float* __restrict__ grid,
    const float* __restrict__ gout, float* __restrict__ ggrid, float* __restrict__ gimg,
    int H, int W, int C, int P, int tp) {
  __shared__ Taps s_t[kBwPix];
  __shared__ float s_dx[kBwPix * (kMaxC + 1)], s_dy[kBwPix * (kMaxC + 1)];
  const int n = blockIdx.y, p0 = blockIdx.x * kBwPix;
  const int np = min(kBwPix, P - p0);
  const size_t tex_off = (size_t)(n / tp) * H * W * C;
  const float* tex = img + tex_off;
  const float* go = gout + ((size_t)n * P + p0) * C;
  if (threadIdx.x < np) {
    const float2 gp = reinterpret_cast<const float2*>(grid)[(size_t)n * P + p0 + threadIdx.x];
    s_t[threadIdx.x] = top_left_tap(gp.x, gp.y, H, W);
  }
  // this thread's half of pixel `mine`'s sums, over the channel chunks
  const int mine = threadIdx.x >> 1, half = threadIdx.x & 1;
  float ax = 0.f, ay = 0.f;
  for (int c0 = 0; c0 < C; c0 += kMaxC) {
    const int cc = min(kMaxC, C - c0);
    const int S = cc | 1;  // odd row stride: thread q's reads hit 32 banks
    __syncthreads();
    const int count = np * cc;
    const int dq = kThreads / cc, dc = kThreads - dq * cc;
    int q = threadIdx.x / cc, c = threadIdx.x - q * cc;
    for (int k = threadIdx.x; k < count; k += kThreads) {
      const Taps t = s_t[q];
      const Valid ok = valid_taps(t, H, W);
      const int o00 = (t.y0 * W + t.x0) * C + c0 + c, o01 = o00 + C, o10 = o00 + W * C,
                o11 = o10 + C;
      const float g = go[q * C + c0 + c];
      float v[4];
      v[0] = (ok.y0 && ok.x0) ? tex[o00] : 0.f;
      v[1] = (ok.y0 && ok.x1) ? tex[o01] : 0.f;
      v[2] = (ok.y1 && ok.x0) ? tex[o10] : 0.f;
      v[3] = (ok.y1 && ok.x1) ? tex[o11] : 0.f;
      const float2 d = tap_derivative(t, v);
      s_dx[q * S + c] = g * d.x;
      s_dy[q * S + c] = g * d.y;
      if (kImg && g != 0.f) scatter_taps(gimg + tex_off + c0 + c, W, C, t, ok, g);
      q += dq;
      c += dc;
      if (c >= cc) {
        c -= cc;
        ++q;
      }
    }
    __syncthreads();
    if (mine < np) {
      for (int j = half; j < cc; j += 2) {
        ax += s_dx[mine * S + j];
        ay += s_dy[mine * S + j];
      }
    }
  }
  ax += __shfl_xor_sync(0xffffffffu, ax, 1);
  ay += __shfl_xor_sync(0xffffffffu, ay, 1);
  if (half == 0 && mine < np)
    reinterpret_cast<float2*>(ggrid)[(size_t)n * P + p0 + mine] =
        make_float2(ax * (W * 0.5f), ay * (H * 0.5f));
}

// Per-channel grids: row n = blockIdx.y, pixels [p0, p0 + 128) of it, all C
// layers. Thread t takes pixel t % 128 of layers t / 128, t / 128 + 2, ...
__global__ void __launch_bounds__(kThreads) grid_sample_per_channel_bwd_kernel(
    const float* __restrict__ planes, const int4* __restrict__ boxes,
    const float* __restrict__ grid, const float* __restrict__ gout,
    float* __restrict__ ggrid, float* __restrict__ gplanes, int H, int W, int C, int P) {
  __shared__ float s_g[kPcPix * (kMaxC + 1)];
  const int n = blockIdx.y, p0 = blockIdx.x * kPcPix;
  const int np = min(kPcPix, P - p0);
  const int S = C | 1;  // odd row stride: a warp's reads hit 32 banks

  // the block's slice of grad_out is one contiguous span, read channel-fastest
  const float* src = gout + ((size_t)n * P + p0) * C;
  const int count = np * C;
  const int dq = kThreads / C, dc = kThreads - dq * C;
  int r = threadIdx.x / C, c = threadIdx.x - r * C;
  for (int k = threadIdx.x; k < count; k += kThreads) {
    s_g[r * S + c] = src[k];
    r += dq;
    c += dc;
    if (c >= C) {
      c -= C;
      ++r;
    }
  }
  __syncthreads();

  const int q = threadIdx.x % kPcPix;
  if (q >= np) return;
  const float2* g = reinterpret_cast<const float2*>(grid) + (size_t)n * C * P + p0 + q;
  float2* gg = reinterpret_cast<float2*>(ggrid) + (size_t)n * C * P + p0 + q;
  for (int l = threadIdx.x / kPcPix; l < C; l += kThreads / kPcPix) {
    const float2 gp = g[(size_t)l * P];
    const Taps t = top_left_tap(gp.x, gp.y, H, W);
    const float go = s_g[q * S + l];
    const size_t plane = ((size_t)n * C + l) * H * W;
    float2 d = make_float2(0.f, 0.f);
    if (go != 0.f && !misses_box(t, boxes[n * C + l])) {
      float v[4];
      load_taps(planes + plane, H, W, t, true, v);
      d = tap_derivative(t, v);
      d.x *= go * (W * 0.5f);
      d.y *= go * (H * 0.5f);
    }
    gg[(size_t)l * P] = d;
    if (gplanes != nullptr && go != 0.f)
      scatter_taps(gplanes + plane, W, 1, t, valid_taps(t, H, W), go);
  }
}

}  // namespace

// per_channel: img holds the planes (F, C, H, W) and boxes their nonzero
// boxes (planes.cu), gimg receives grad_planes (F, C, H, W); otherwise img
// and gimg are (F, H, W, C) and boxes is unused. gimg may be null (no
// texture gradient); when given it must hold zeros.
extern "C" int waldo_grid_sample_bwd(const void* img, const void* boxes, const void* grid,
                                     const void* gout, void* ggrid, void* gimg, int H, int W,
                                     int C, int N, int Ho, int Wo, int tp, int per_channel,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int P = Ho * Wo;
  if (per_channel) {
    if (C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
    const dim3 blocks((unsigned)((P + kPcPix - 1) / kPcPix), (unsigned)N);
    grid_sample_per_channel_bwd_kernel<<<blocks, kThreads, 0, s>>>(
        (const float*)img, (const int4*)boxes, (const float*)grid, (const float*)gout,
        (float*)ggrid, (float*)gimg, H, W, C, P);
  } else {
    const dim3 blocks((unsigned)((P + kBwPix - 1) / kBwPix), (unsigned)N);
    if (gimg != nullptr)
      grid_sample_shared_bwd_kernel<true><<<blocks, kThreads, 0, s>>>(
          (const float*)img, (const float*)grid, (const float*)gout, (float*)ggrid,
          (float*)gimg, H, W, C, P, tp);
    else
      grid_sample_shared_bwd_kernel<false><<<blocks, kThreads, 0, s>>>(
          (const float*)img, (const float*)grid, (const float*)gout, (float*)ggrid, nullptr,
          H, W, C, P, tp);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* waldo_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
