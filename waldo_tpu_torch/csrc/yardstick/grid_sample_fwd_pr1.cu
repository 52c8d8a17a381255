// K2's shared-grid forward in its first design (a block 256 output pixels of
// one grid row, blockIdx.y the row, the block's values walked
// channel-fastest with scalar loads and stores), kept verbatim as the
// yardstick of the tile kernel in ../grid_sample.cu: chip_smoke.py alone
// builds it and times it beside that one, in turns, in one call. No code
// path of the package launches it.
//
// img (F, H, W, C) float32 or bf16, grid (F*tp, Ho, Wo, 2) float32 -> out
// (F*tp, Ho, Wo, C) in img's type; grid row n reads texture n / tp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Four bilinear taps of normalized point (gx, gy) on an H x W plane: texel
// offsets y*W+x (clamped into the plane) and weights (0 for a tap outside
// it, which is torch's zero padding). Tap order (y0,x0) (y0,x1) (y1,x0)
// (y1,x1).
__device__ __forceinline__ void bilinear_taps(float gx, float gy, int H, int W,
                                              int4& off, float4& wt) {
  float ix = (gx + 1.f) * (W * 0.5f) - 0.5f;
  float iy = (gy + 1.f) * (H * 0.5f) - 0.5f;
  // far-out points (inverse-warp holes sit at 4.0) keep every tap outside
  // the plane; clamping keeps the int conversion defined
  ix = fminf(fmaxf(ix, -2.f), (float)W + 1.f);
  iy = fminf(fmaxf(iy, -2.f), (float)H + 1.f);
  const float fx0 = floorf(ix), fy0 = floorf(iy);
  const float tx = ix - fx0, ty = iy - fy0;
  const int x0 = (int)fx0, y0 = (int)fy0, x1 = x0 + 1, y1 = y0 + 1;
  const bool vx0 = x0 >= 0 && x0 < W, vx1 = x1 >= 0 && x1 < W;
  const bool vy0 = y0 >= 0 && y0 < H, vy1 = y1 >= 0 && y1 < H;
  const int cx0 = min(max(x0, 0), W - 1), cx1 = min(max(x1, 0), W - 1);
  const int cy0 = min(max(y0, 0), H - 1) * W, cy1 = min(max(y1, 0), H - 1) * W;
  off = make_int4(cy0 + cx0, cy0 + cx1, cy1 + cx0, cy1 + cx1);
  wt = make_float4((vy0 && vx0) ? (1.f - tx) * (1.f - ty) : 0.f,
                   (vy0 && vx1) ? tx * (1.f - ty) : 0.f,
                   (vy1 && vx0) ? (1.f - tx) * ty : 0.f,
                   (vy1 && vx1) ? tx * ty : 0.f);
}

// Shared grid: row n = blockIdx.y, pixels [p0, p0 + 256) of it. In-row
// indices are 32-bit (the wrapper bounds Ho*Wo*C and H*W*C).
template <typename T>
__global__ void __launch_bounds__(kThreads) grid_sample_shared_kernel(
    const T* __restrict__ img, const float* __restrict__ grid,
    T* __restrict__ out, int H, int W, int C, int P, int tp) {
  __shared__ int4 s_off[kThreads];
  __shared__ float4 s_wt[kThreads];
  const int n = blockIdx.y;
  const int p0 = blockIdx.x * kThreads;
  const int p = p0 + threadIdx.x;
  if (p < P) {
    const float2 g = reinterpret_cast<const float2*>(grid)[(size_t)n * P + p];
    bilinear_taps(g.x, g.y, H, W, s_off[threadIdx.x], s_wt[threadIdx.x]);
  }
  __syncthreads();

  const T* tex = img + (size_t)(n / tp) * H * W * C;
  T* dst = out + ((size_t)n * P + p0) * C;
  const int count = min(kThreads, P - p0) * C;
  // value k = (pixel q, channel c), k = q*C + c, stepping by kThreads
  const int dq = kThreads / C, dc = kThreads - dq * C;
  int q = threadIdx.x / C, c = threadIdx.x - q * C;
  for (int k = threadIdx.x; k < count; k += kThreads) {
    const int4 o = s_off[q];
    const float4 w = s_wt[q];
    float acc = w.x * to_float(tex[o.x * C + c]);
    acc += w.y * to_float(tex[o.y * C + c]);
    acc += w.z * to_float(tex[o.z * C + c]);
    acc += w.w * to_float(tex[o.w * C + c]);
    dst[k] = from_float<T>(acc);
    q += dq;
    c += dc;
    if (c >= C) {
      c -= C;
      ++q;
    }
  }
}


template <typename T>
int launch(const void* img, const void* grid, void* out, int H, int W, int C, int N, int P,
           int tp, cudaStream_t s) {
  const dim3 blocks((unsigned)((P + kThreads - 1) / kThreads), (unsigned)N);
  grid_sample_shared_kernel<T><<<blocks, kThreads, 0, s>>>((const T*)img, (const float*)grid,
                                                           (T*)out, H, W, C, P, tp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int waldo_grid_sample_fwd_first(const void* img, const void* grid, void* out, int H,
                                           int W, int C, int N, int Ho, int Wo, int tp,
                                           int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) return launch<__nv_bfloat16>(img, grid, out, H, W, C, N, Ho * Wo, tp, s);
  return launch<float>(img, grid, out, H, W, C, N, Ho * Wo, tp, s);
}

extern "C" const char* waldo_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
