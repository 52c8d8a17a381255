// Pre-pass of the per-layer samplers: a channel-last texture (F, H, W, C)
// to planes (F, C, H, W), with the inclusive box of each plane's nonzero
// texels.
//
// Feeds the fused alpha_ctx warp (warp_alpha_ctx.cu) and the per-channel
// grid sample (grid_sample.cu). It carries over, on the card, what
// _skip_flags (waldo_tpu/ops/pallas/grid_sample.py) computes on the TPU with
// an integral image of 8x128 nonzero cells. A per-plane box is enough here:
// one object's alpha is one compact warped quad, so its box is tight, and a
// box costs the samplers one broadcast int4 and four compares per sample.
//
// Input tex (F, H, W, C), float or bf16, contiguous, C <= 32. Outputs, in
// the same type: planes (F, C, H, W); boxes (F, C, 4) int32, (y0, y1, x0,
// x1) inclusive, (H, -1, W, -1) for a plane with no nonzero texel (a NaN
// counts as nonzero, -0.0 as zero).
//
// Bound on an H100: memory. It reads the texture once and writes it once;
// at the flagship shape (4 x 256 x 512 x 17 float) that is 35.7 MB each
// way, ~0.021 ms at 3.35 TB/s. The same bytes as the permute copy it
// replaces.
// Design: a block takes 128 pixels of kRows rows of one frame; a thread
// keeps one pixel and every other channel, so a warp is 32 pixels of one
// channel. It reads its texels straight from the channel-last rows: a
// warp's load is C-strided, but the block's warps together use every byte
// of the lines they touch, which L1 keeps, and a thread's loads of all its
// channels are in flight together. Each channel's texels are written as
// one coalesced run. A thread notes, per channel, a bit mask of the rows
// where its texel is nonzero; after the last row, three warp reductions per
// channel give the warp's box, shared atomics the block's, and four global
// atomics per channel add it to the plane's. A first small kernel sets
// every box empty.

#include <climits>

#include "bilinear.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPixX = 128;  // pixels of a row per block; kThreads / kPixX channels at a time
constexpr int kRows = 16;  // at most 32: a thread keeps a row bit mask per channel
constexpr int kMaxC = 32;

__global__ void empty_boxes_kernel(int4* __restrict__ boxes, int count, int H, int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < count) boxes[i] = make_int4(H, -1, W, -1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) plane_boxes_kernel(
    const T* __restrict__ tex, T* __restrict__ planes, int* __restrict__ boxes, int H, int W,
    int C) {
  constexpr int kGroups = kThreads / kPixX;  // channels worked on at once
  constexpr int kPerThread = kMaxC / kGroups;
  __shared__ int s_box[kMaxC][4];
  const int f = blockIdx.z, xb = blockIdx.x * kPixX, yb = blockIdx.y * kRows;
  const int rows = min(kRows, H - yb);
  const int tid = threadIdx.x, lane = tid & 31;
  const int x = tid % kPixX, c0 = tid / kPixX;
  const bool live = xb + x < W;
  if (tid < C) {
    s_box[tid][0] = INT_MAX;
    s_box[tid][1] = -1;
    s_box[tid][2] = INT_MAX;
    s_box[tid][3] = -1;
  }
  // the rows (bit r for row yb + r) where this thread's texel of channel
  // c0 + kGroups*k is nonzero
  unsigned rows_nz[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) rows_nz[k] = 0u;
  if (live) {
    for (int r = 0; r < rows; ++r) {
      const int y = yb + r;
      const T* src = tex + (((size_t)f * H + y) * W + xb + x) * C + c0;
      T* dst = planes + (((size_t)f * C + c0) * H + y) * W + xb + x;
      T v[kPerThread];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k)
        if (c0 + k * kGroups < C) v[k] = src[k * kGroups];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        if (c0 + k * kGroups < C) {
          dst[(size_t)k * kGroups * H * W] = v[k];
          rows_nz[k] |= (to_float(v[k]) != 0.f) ? 1u << r : 0u;
        }
      }
    }
  }
  __syncthreads();  // s_box is set
  // every thread of a warp takes the same channels
#pragma unroll
  for (int k = 0; k < kMaxC / kGroups; ++k) {
    const int c = c0 + k * kGroups;
    if (c < C) {
      const bool nz = rows_nz[k] != 0u;
      const unsigned any = __reduce_or_sync(0xffffffffu, rows_nz[k]);
      const int y0 = yb + __ffs(any) - 1, y1 = yb + 31 - __clz(any);
      const int x0 = __reduce_min_sync(0xffffffffu, nz ? xb + x : INT_MAX);
      const int x1 = __reduce_max_sync(0xffffffffu, nz ? xb + x : -1);
      if (lane == 0 && any != 0u) {
        atomicMin(&s_box[c][0], y0);
        atomicMax(&s_box[c][1], y1);
        atomicMin(&s_box[c][2], x0);
        atomicMax(&s_box[c][3], x1);
      }
    }
  }
  __syncthreads();
  if (tid < C && s_box[tid][1] >= 0) {
    int* b = boxes + ((size_t)f * C + tid) * 4;
    atomicMin(b, s_box[tid][0]);
    atomicMax(b + 1, s_box[tid][1]);
    atomicMin(b + 2, s_box[tid][2]);
    atomicMax(b + 3, s_box[tid][3]);
  }
}

}  // namespace

extern "C" int waldo_plane_boxes(const void* tex, void* planes, void* boxes, int F, int H,
                                 int W, int C, int is_bf16, void* stream) {
  if (C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int count = F * C;
  empty_boxes_kernel<<<(count + 255) / 256, 256, 0, s>>>((int4*)boxes, count, H, W);
  if (H > 0 && W > 0) {
    const dim3 blocks((unsigned)((W + kPixX - 1) / kPixX), (unsigned)((H + kRows - 1) / kRows),
                      (unsigned)F);
    if (is_bf16)
      plane_boxes_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
          (const __nv_bfloat16*)tex, (__nv_bfloat16*)planes, (int*)boxes, H, W, C);
    else
      plane_boxes_kernel<float><<<blocks, kThreads, 0, s>>>((const float*)tex, (float*)planes,
                                                           (int*)boxes, H, W, C);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* waldo_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
