// The per-channel backward's row-strip design, kept as the yardstick of the
// plane kernel in ../grid_sample_bwd.cu: chip_smoke.py alone builds it and
// times it beside that one, in turns, in one call. No code path of the
// package launches it.
//
// Per-channel grids: planes (F, C, H, W) and their nonzero boxes (F, C, 4)
// from the forward's pre-pass, grids (F, C, Ho, Wo, 2), grad_out (F, Ho,
// Wo, C) -> grad_grids (F, C, Ho, Wo, 2) and, if asked, grad_planes (F, C,
// H, W), torch's floor-tap derivative. A block takes 128 output pixels of
// one row and all C layers, a warp being 32 pixels of one layer; it stages
// its (128 x C) slice of grad_out in shared memory. The grid gradient skips
// the texel reads of a sample whose footprint misses its plane's box;
// grad_planes takes four float atomics per sample into device memory (the
// caller zero-fills it and permutes it to (F, H, W, C) afterwards).

#include "../bilinear.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPcPix = 128;  // output pixels per block
constexpr int kMaxC = 32;

__device__ __forceinline__ float2 tap_derivative(const Taps& t, const float v[4]) {
  return make_float2((1.f - t.ty) * (v[1] - v[0]) + t.ty * (v[3] - v[2]),
                     (1.f - t.tx) * (v[2] - v[0]) + t.tx * (v[3] - v[1]));
}

__device__ __forceinline__ void scatter_taps(float* base, int H, int W, const Taps& t, float g) {
  const int x1 = t.x0 + 1, y1 = t.y0 + 1;
  const bool vx0 = t.x0 >= 0 && t.x0 < W, vx1 = x1 >= 0 && x1 < W;
  const bool vy0 = t.y0 >= 0 && t.y0 < H, vy1 = y1 >= 0 && y1 < H;
  const float wx0 = 1.f - t.tx, wy0 = 1.f - t.ty;
  if (vy0 && vx0) atomicAdd(base + t.y0 * W + t.x0, wx0 * wy0 * g);
  if (vy0 && vx1) atomicAdd(base + t.y0 * W + x1, t.tx * wy0 * g);
  if (vy1 && vx0) atomicAdd(base + y1 * W + t.x0, wx0 * t.ty * g);
  if (vy1 && vx1) atomicAdd(base + y1 * W + x1, t.tx * t.ty * g);
}

__global__ void __launch_bounds__(kThreads) per_channel_bwd_rows_kernel(
    const float* __restrict__ planes, const int4* __restrict__ boxes,
    const float* __restrict__ grid, const float* __restrict__ gout,
    float* __restrict__ ggrid, float* __restrict__ gplanes, int H, int W, int C, int P) {
  __shared__ float s_g[kPcPix * (kMaxC + 1)];
  const int n = blockIdx.y, p0 = blockIdx.x * kPcPix;
  const int np = min(kPcPix, P - p0);
  const int S = C | 1;
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
    if (gplanes != nullptr && go != 0.f) scatter_taps(gplanes + plane, H, W, t, go);
  }
}

}  // namespace

// gplanes may be null (no texture gradient); when given it must hold zeros.
extern "C" int waldo_grid_sample_per_channel_bwd_rows(const void* planes, const void* boxes,
                                                      const void* grid, const void* gout,
                                                      void* ggrid, void* gplanes, int H, int W,
                                                      int C, int N, int Ho, int Wo,
                                                      void* stream) {
  if (C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
  const int P = Ho * Wo;
  const dim3 blocks((unsigned)((P + kPcPix - 1) / kPcPix), (unsigned)N);
  per_channel_bwd_rows_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)planes, (const int4*)boxes, (const float*)grid, (const float*)gout,
      (float*)ggrid, (float*)gplanes, H, W, C, P);
  return (int)cudaGetLastError();
}

extern "C" const char* waldo_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
