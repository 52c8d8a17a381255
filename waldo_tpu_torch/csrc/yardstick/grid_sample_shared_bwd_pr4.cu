// The shared-grid backward's first design (block-wide value walk), kept as
// the yardstick of the tile kernel in ../grid_sample_bwd.cu:
// chip_smoke.py alone builds it and times it beside that one, in turns, in
// one call. No code path of the package launches it.
//
// Shared grid: img (F, H, W, C), grid (F*tp, Ho, Wo, 2), grad_out (F*tp,
// Ho, Wo, C), all contiguous float32 -> grad_grid (F*tp, Ho, Wo, 2) and, if
// asked, grad_img (F, H, W, C) (zero-filled by the caller), torch's
// floor-tap derivative. A block takes 128 output pixels of one row and
// computes each pixel's taps once into shared memory; then, 32 channels at
// a time, it walks its (pixel, channel) values channel-fastest, each thread
// leaving a value's two grid-gradient terms in shared memory, and after a
// block barrier threads 2q and 2q + 1 sum pixel q's even and odd channels'
// terms, met by one shuffle at the end.

#include "../bilinear.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBwPix = 128;  // output pixels per block
constexpr int kMaxC = 32;    // channels a block stages at a time

struct Valid {
  bool x0, x1, y0, y1;
};

__device__ __forceinline__ Valid valid_taps(const Taps& t, int H, int W) {
  return {t.x0 >= 0 && t.x0 < W, t.x0 + 1 >= 0 && t.x0 + 1 < W, t.y0 >= 0 && t.y0 < H,
          t.y0 + 1 >= 0 && t.y0 + 1 < H};
}

__device__ __forceinline__ float2 tap_derivative(const Taps& t, const float v[4]) {
  return make_float2((1.f - t.ty) * (v[1] - v[0]) + t.ty * (v[3] - v[2]),
                     (1.f - t.tx) * (v[2] - v[0]) + t.tx * (v[3] - v[1]));
}

__device__ __forceinline__ void scatter_taps(float* base, int W, int stride, const Taps& t,
                                             const Valid& ok, float g) {
  const int x1 = t.x0 + 1, y1 = t.y0 + 1;
  const float wx0 = 1.f - t.tx, wy0 = 1.f - t.ty;
  if (ok.y0 && ok.x0) atomicAdd(base + (size_t)(t.y0 * W + t.x0) * stride, wx0 * wy0 * g);
  if (ok.y0 && ok.x1) atomicAdd(base + (size_t)(t.y0 * W + x1) * stride, t.tx * wy0 * g);
  if (ok.y1 && ok.x0) atomicAdd(base + (size_t)(y1 * W + t.x0) * stride, wx0 * t.ty * g);
  if (ok.y1 && ok.x1) atomicAdd(base + (size_t)(y1 * W + x1) * stride, t.tx * t.ty * g);
}

template <bool kImg>
__global__ void __launch_bounds__(kThreads) shared_bwd_first_kernel(
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

}  // namespace

// gimg may be null (no texture gradient); when given it must hold zeros.
extern "C" int waldo_grid_sample_shared_bwd_first(const void* img, const void* grid,
                                                const void* gout, void* ggrid, void* gimg,
                                                int H, int W, int C, int N, int Ho, int Wo,
                                                int tp, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int P = Ho * Wo;
  const dim3 blocks((unsigned)((P + kBwPix - 1) / kBwPix), (unsigned)N);
  if (gimg != nullptr)
    shared_bwd_first_kernel<true><<<blocks, kThreads, 0, s>>>(
        (const float*)img, (const float*)grid, (const float*)gout, (float*)ggrid, (float*)gimg,
        H, W, C, P, tp);
  else
    shared_bwd_first_kernel<false><<<blocks, kThreads, 0, s>>>(
        (const float*)img, (const float*)grid, (const float*)gout, (float*)ggrid, nullptr, H, W,
        C, P, tp);
  return (int)cudaGetLastError();
}

extern "C" const char* waldo_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
