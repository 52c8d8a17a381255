// Fused alpha_ctx warp of the predict path: per-layer bilinear sample, ghost
// mask, disocclusion max, prediction-time occlusion product and
// alpha-weighted flow reduction in one pass.
//
// Replaces warp_alpha_ctx_pallas (_war_kernel,
// waldo_tpu/ops/pallas/grid_sample.py). Inputs, all float32, contiguous:
//   planes (F, C, H, W)       unique context-frame alphas, one plane per layer
//                             (the wrapper transposes the channel-last input)
//   grid   (N, C, gh, gw, 2)  per-layer sample grids; row n samples frame
//                             n / tp (N = F * tp)
//   occ    (N, C, C)          occ[n, i, j]: how much layer i occludes j
//   is_obj (B*Tp, C, gh, gw)  ghost masks or null; row n reads mask row
//                             (n / tcp) * tp + n % tp
// Outputs, float32: alpha_occ (N, gh, gw, C) = a_j * prod_i (1 - a_i
// occ[n,i,j]), disocc (N, gh, gw, 1) = max_j a_j, flow (N, gh, gw, 2) =
// sum_j alpha_occ_j * (g_j - base), base the output's pixel-center grid.
//
// Bound on an H100: memory. Per output pixel it reads 8*C bytes of grid and
// writes 4*(C+3) bytes, against ~3C^2+32C flop; at the flagship shape (N=56,
// C=17, 256x512) that is ~1.62 GB, ~0.48 ms at 3.35 TB/s, against ~0.16 ms
// of float32 arithmetic.
// Design: a block takes 64 output pixels of one row n and all C layers, as
// 64 x 4 threads: thread (x, y) works on pixel x and layers y, y+4, ... So
// a warp is 32 neighbouring pixels of one layer: its grid and mask reads
// are one contiguous run, and its four taps read neighbouring texels of one
// layer plane. A thread issues all its grid loads before its first tap, so
// many loads are in flight. The per-pixel layer values meet in shared
// memory, never in device memory:
//   1. sample, mask, and keep a_j and g_j - base for every (pixel, layer);
//   2. thread (x, j) runs the occlusion product over the occluders i, four
//      at a time (float4 reads of the pixel's alphas and of occ[n]'s column
//      j, zero-padded to a multiple of 4: a padded term is exactly 1);
//   3. one thread per pixel takes the disocc max and the flow sum, and the
//      block writes its channel-last alpha_occ rows as one contiguous span.
// Products and sums run in the plain version's order (i, j ascending). The
// TPU kernel's all-zero-footprint skip is not carried over.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kPix = 64;         // output pixels of one row per block
constexpr int kLayerThreads = 4;  // threads along the layer axis
constexpr int kThreads = kPix * kLayerThreads;
constexpr int kMaxLayers = 32;
constexpr int kLayersPerThread = kMaxLayers / kLayerThreads;
constexpr int kStrideA = kMaxLayers + 4;  // float4-aligned, 8 threads conflict-free
constexpr int kStride = kMaxLayers + 1;   // odd: scalar rows conflict-free

__device__ __forceinline__ float sample_plane(const float* __restrict__ plane,
                                              int H, int W, float gx, float gy) {
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
  float acc = 0.f;
  if (vy0 && vx0) acc += (1.f - tx) * (1.f - ty) * plane[y0 * W + x0];
  if (vy0 && vx1) acc += tx * (1.f - ty) * plane[y0 * W + x1];
  if (vy1 && vx0) acc += (1.f - tx) * ty * plane[y1 * W + x0];
  if (vy1 && vx1) acc += tx * ty * plane[y1 * W + x1];
  return acc;
}

// In-row indices are 32-bit (the wrapper bounds gh*gw*C and H*W*C).
__global__ void __launch_bounds__(kThreads) warp_alpha_ctx_kernel(
    const float* __restrict__ planes, const float* __restrict__ grid,
    const float* __restrict__ occ, const float* __restrict__ is_obj,
    float* __restrict__ alpha_out, float* __restrict__ disocc_out,
    float* __restrict__ flow_out, int H, int W, int C, int gh, int gw, int tp,
    int tcp) {
  __shared__ __align__(16) float s_occ_t[kMaxLayers * kMaxLayers];  // [j][i]
  __shared__ __align__(16) float s_a[kPix * kStrideA];  // sampled alphas
  __shared__ float s_ao[kPix * kStride];                // alpha_occ
  __shared__ float s_fx[kPix * kStride], s_fy[kPix * kStride];  // g - base, then * alpha_occ
  const int n = blockIdx.y;
  const int x = threadIdx.x, tid = threadIdx.y * kPix + x;
  const int C4 = (C + 3) & ~3;
  const float* occ_n = occ + (size_t)n * C * C;
  for (int k = tid; k < C * C4; k += kThreads) {
    const int j = k / C4, i = k - j * C4;
    s_occ_t[j * kMaxLayers + i] = i < C ? occ_n[i * C + j] : 0.f;
  }

  const int P = gh * gw;
  const int p0 = blockIdx.x * kPix;
  const int p = p0 + x;
  const bool live = p < P;
  float* a_row = s_a + x * kStrideA;
  if (live) {
    const float* tex = planes + (size_t)(n / tp) * C * H * W;
    const float2* g = reinterpret_cast<const float2*>(grid) + (size_t)n * C * P + p;
    const float* io = is_obj ? is_obj + (size_t)((n / tcp) * tp + n % tp) * C * P + p : nullptr;
    const float bx = ((float)(p % gw) + 0.5f) * (2.f / gw) - 1.f;
    const float by = ((float)(p / gw) + 0.5f) * (2.f / gh) - 1.f;
    float2 gr[kLayersPerThread];
#pragma unroll
    for (int r = 0; r < kLayersPerThread; ++r) {
      const int j = threadIdx.y + r * kLayerThreads;
      if (j < C) gr[r] = g[(size_t)j * P];
    }
#pragma unroll
    for (int r = 0; r < kLayersPerThread; ++r) {
      const int j = threadIdx.y + r * kLayerThreads;
      if (j < C4) {
        float a = 0.f;
        if (j < C) {
          a = sample_plane(tex + (size_t)j * H * W, H, W, gr[r].x, gr[r].y);
          if (io) a *= io[(size_t)j * P];
          s_fx[x * kStride + j] = gr[r].x - bx;
          s_fy[x * kStride + j] = gr[r].y - by;
        }
        a_row[j] = a;
      }
    }
  }
  __syncthreads();

  if (live) {
    const float4* a4 = reinterpret_cast<const float4*>(a_row);
    for (int j = threadIdx.y; j < C; j += kLayerThreads) {
      const float4* o4 = reinterpret_cast<const float4*>(s_occ_t + j * kMaxLayers);
      float pj = 1.f;
      for (int i = 0; i < C4 / 4; ++i) {
        const float4 a = a4[i], o = o4[i];
        pj *= 1.f - a.x * o.x;
        pj *= 1.f - a.y * o.y;
        pj *= 1.f - a.z * o.z;
        pj *= 1.f - a.w * o.w;
      }
      const float aj = pj * a_row[j];
      s_ao[x * kStride + j] = aj;
      s_fx[x * kStride + j] *= aj;
      s_fy[x * kStride + j] *= aj;
    }
  }
  __syncthreads();

  if (live && threadIdx.y == 0) {
    float dis = -INFINITY, fx = 0.f, fy = 0.f;
    for (int j = 0; j < C; ++j) {
      dis = fmaxf(dis, a_row[j]);
      fx += s_fx[x * kStride + j];
      fy += s_fy[x * kStride + j];
    }
    disocc_out[(size_t)n * P + p] = dis;
    reinterpret_cast<float2*>(flow_out)[(size_t)n * P + p] = make_float2(fx, fy);
  }
  // the block's alpha_occ rows are one contiguous span of the output
  const int count = min(kPix, P - p0) * C;
  float* dst = alpha_out + ((size_t)n * P + p0) * C;
  for (int k = tid; k < count; k += kThreads) {
    const int q = k / C;
    dst[k] = s_ao[q * kStride + (k - q * C)];
  }
}

}  // namespace

extern "C" int waldo_warp_alpha_ctx(const void* planes, const void* grid,
                                    const void* occ, const void* is_obj,
                                    void* alpha_out, void* disocc, void* flow,
                                    int H, int W, int C, int N, int gh, int gw,
                                    int tp, int tcp, void* stream) {
  if (C < 1 || C > kMaxLayers) return (int)cudaErrorInvalidValue;
  const int P = gh * gw;
  const dim3 blocks((unsigned)((P + kPix - 1) / kPix), (unsigned)N);
  const dim3 threads(kPix, kLayerThreads);
  warp_alpha_ctx_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)planes, (const float*)grid, (const float*)occ,
      (const float*)is_obj, (float*)alpha_out, (float*)disocc, (float*)flow,
      H, W, C, gh, gw, tp, tcp);
  return (int)cudaGetLastError();
}

extern "C" const char* waldo_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
