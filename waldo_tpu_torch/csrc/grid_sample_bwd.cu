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
//               grad_out as planes (F, C, Ho, Wo) -> grad_grids (F, C, Ho,
//               Wo, 2) and, if asked, grad_img as planes (F, C, H, W) (the
//               training path's unfused alpha_ctx warp, _pallas_mg_bwd, at
//               (112, 128, 256, 17); the alphas come from LVD's parameters,
//               so grad_img is asked for; the caller holds both gradients as
//               planes), C <= 32.
//
// The derivative follows torch's grid_sampler_2d_backward: floor taps, so
// a sample exactly on a texel centre takes the one-sided difference towards
// the next texel (the JAX MXU VJP takes another one there).
//
// Bound on an H100: memory. Per output sample the kernels read the grid
// point, the output gradient and four texels and write the grid gradient,
// a few flop each; grad_img adds four tap terms per sample, summed where
// they meet.
// Design (shared mode), as the forward's: a block takes 128 output pixels of
// one row, computes each pixel's taps once into shared memory, then walks
// the (pixel, channel) values channel-fastest, so its grad_out reads are one
// contiguous span and a warp's texel reads (and grad_img's atomics) hit
// neighbouring channels of neighbouring texels; each value's two grid-
// gradient terms meet their pixel's in shared memory (no atomics), summed by
// two threads a pixel (one thread a pixel left half the block idle).
// Design (per-channel mode): a block takes one plane (see the kernel), so
// that a plane's grad_img can be summed in shared memory and stored once:
// 250 MB written at the training shape, where device atomics into a
// zero-filled output (the earlier design) also paid the memset and each
// line's round trip from HBM for the read-modify-write. Smaller blocks,
// output tiles with windows of their taps, measured slower on the H100
// (PERF.md): float atomics on shared memory compile to compare-and-swap
// loops on sm_90, and each tile's window still went out by device atomics. The grid gradient skips the texel reads of a sample whose 2x2
// footprint misses its plane's nonzero box (its four texels are zero, so is
// its derivative); grad_img may not skip by that box (a zero texel still
// receives gradient), only where the output gradient is zero. Sums in
// shared memory and by atomics come in an order that changes from run to
// run.

#include "bilinear.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBwPix = 128;  // shared mode: output pixels per block
constexpr int kMaxC = 32;    // channels a block stages at a time
// per-channel mode: a block of kPlaneThreads takes one plane; a plane of at
// most kPlaneCap texels (224 KB) accumulates its grad_img in shared memory
constexpr int kPlaneThreads = 1024, kBatch = 4;
constexpr int kPlaneCap = 56 * 1024;

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

// Per-channel grids: block b takes plane b = n * C + l, its grid (Ho, Wo, 2)
// and its output gradient (Ho, Wo), both contiguous (the training path
// hands the output gradient over as planes); thread t takes samples t,
// t + kPlaneThreads, ..., kBatch at a time with their loads issued together
// (one block an SM leaves few warps to hide latency with). A sample whose
// output gradient is 0 reads nothing
// more and writes a zero grid gradient; the grid gradient reads texels only
// where the footprint meets the plane's nonzero box. kWindow (the plane has
// at most kPlaneCap texels): the block owns its plane's grad_img in shared
// memory, the four tap terms of each sample go in by shared-memory atomics
// (a compare-and-swap loop on sm_90: a warp's 32 samples hit 32 different
// texels, so they seldom retry), and the plane is stored once, coalesced:
// no device atomic, no zero-filled output. Otherwise the block zeroes its
// plane in device memory and the terms go there by device atomics.
template <bool kWindow>
__global__ void __launch_bounds__(kPlaneThreads) grid_sample_per_channel_bwd_kernel(
    const float* __restrict__ planes, const int4* __restrict__ boxes,
    const float* __restrict__ grid, const float* __restrict__ gout,
    float* __restrict__ ggrid, float* __restrict__ gimg, int H, int W, int P) {
  extern __shared__ float4 s_plane4[];  // kWindow: the plane's grad_img
  float* s_plane = reinterpret_cast<float*>(s_plane4);
  const size_t b = blockIdx.x;
  const int HW = H * W;
  const int4 box = boxes[b];
  const float* plane = planes + b * HW;
  float* out = gimg == nullptr ? nullptr : gimg + b * HW;
  float* acc = kWindow ? s_plane : out;
  if (out != nullptr) {
    for (int k = threadIdx.x; k < HW; k += kPlaneThreads) acc[k] = 0.f;
    __syncthreads();
  }
  const float2* g = reinterpret_cast<const float2*>(grid) + b * P;
  float2* gg = reinterpret_cast<float2*>(ggrid) + b * P;
  const float* go_p = gout + b * P;
  // kBatch samples a step, their loads issued together
  for (int p0 = threadIdx.x; p0 < P; p0 += kPlaneThreads * kBatch) {
    float go[kBatch];
    Taps t[kBatch];
    float v[kBatch][4];
    bool hit[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int p = p0 + k * kPlaneThreads;
      go[k] = p < P ? go_p[p] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const float2 gp = go[k] != 0.f ? g[p0 + k * kPlaneThreads] : make_float2(0.f, 0.f);
      t[k] = top_left_tap(gp.x, gp.y, H, W);
      hit[k] = go[k] != 0.f && !misses_box(t[k], box);
      load_taps(plane, H, W, t[k], hit[k], v[k]);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int p = p0 + k * kPlaneThreads;
      float2 d = make_float2(0.f, 0.f);
      if (hit[k]) {
        d = tap_derivative(t[k], v[k]);
        d.x *= go[k] * (W * 0.5f);
        d.y *= go[k] * (H * 0.5f);
      }
      if (p < P) gg[p] = d;
      if (out != nullptr && go[k] != 0.f) scatter_taps(acc, W, 1, t[k], valid_taps(t[k], H, W), go[k]);
    }
  }
  if (kWindow && out != nullptr) {
    __syncthreads();
    if ((HW & 3) == 0)
      for (int k = threadIdx.x; k < HW / 4; k += kPlaneThreads)
        reinterpret_cast<float4*>(out)[k] = s_plane4[k];
    else
      for (int k = threadIdx.x; k < HW; k += kPlaneThreads) out[k] = s_plane[k];
  }
}

}  // namespace

// per_channel: img holds the planes (F, C, H, W) and boxes their nonzero
// boxes (planes.cu), gout the output gradient as planes (F, C, Ho, Wo), and
// gimg receives grad_planes (F, C, H, W), any contents before (every texel
// is written); otherwise img, gout and gimg are channel-last, boxes is
// unused and gimg must hold zeros. gimg may be null (no texture gradient).
extern "C" int waldo_grid_sample_bwd(const void* img, const void* boxes, const void* grid,
                                     const void* gout, void* ggrid, void* gimg, int H, int W,
                                     int C, int N, int Ho, int Wo, int tp, int per_channel,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int P = Ho * Wo;
  if (per_channel) {
    if (C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)N * (unsigned)C;
    if (gimg != nullptr && H * W <= kPlaneCap) {
      const int smem = H * W * 4;
      const cudaError_t err = cudaFuncSetAttribute(
          grid_sample_per_channel_bwd_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (err != cudaSuccess) return (int)err;
      grid_sample_per_channel_bwd_kernel<true><<<blocks, kPlaneThreads, smem, s>>>(
          (const float*)img, (const int4*)boxes, (const float*)grid, (const float*)gout,
          (float*)ggrid, (float*)gimg, H, W, P);
    } else {
      grid_sample_per_channel_bwd_kernel<false><<<blocks, kPlaneThreads, 0, s>>>(
          (const float*)img, (const int4*)boxes, (const float*)grid, (const float*)gout,
          (float*)ggrid, (float*)gimg, H, W, P);
    }
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
