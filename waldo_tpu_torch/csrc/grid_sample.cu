// Bilinear grid sample, torch F.grid_sample semantics (bilinear, zero
// padding, align_corners=False), channel-last.
//
// Replaces grid_sample_pallas (waldo_tpu/ops/pallas/grid_sample.py) in both
// of its modes:
//   shared      img (F, H, W, C), grid (F*tp, Ho, Wo, 2): every channel rides
//               the grid; grid row n reads texture row n / tp (the predict
//               path's context fusion, C = 3 + 20 at 256x512 on the flagship);
//   per-channel planes (F, C, H, W) and their nonzero boxes (F, C, 4) from
//               the pre-pass (planes.cu), grid (F, C, Ho, Wo, 2): channel k
//               rides grid[:, k] (the training-path alpha_ctx warp), C <= 32.
// Output (rows, Ho, Wo, C) in the texture's type (float or bf16), computed
// in float.
//
// Bound on an H100: memory. Per output pixel the kernel does ~8 flop per
// channel against 4*C bytes written plus 8 bytes of grid read (8*C per
// channel mode); at the flagship fusion shape (56 rows, 256x512, C=23) that
// is ~0.78 GB, ~0.23 ms at 3.35 TB/s, against ~0.02 ms of float32
// arithmetic.
// Design (shared mode): a block takes 256 output pixels of one row. First
// each thread reads one grid point and puts that pixel's four tap offsets
// and weights in shared memory, so the tap arithmetic runs once per pixel
// and not once per channel. Then the block walks its 256*C output values
// with the channel fastest: the output, which is most of the bytes, is
// written in fully coalesced spans, and a warp's loads of one tap read
// neighbouring channels of neighbouring texels. Neighbouring pixels sample
// neighbouring points of a smooth warp, so the taps hit texture lines that
// L2 keeps (one texture is 12 MB at the flagship shape).
// Design (per-channel mode): a block takes 128 output pixels of one row and
// all C channels; a warp is 32 pixels of one channel, so its grid read is
// one contiguous run and its taps read neighbouring texels of one plane.
// A sample whose 2x2 footprint misses its plane's nonzero box is 0 with no
// texel read (the TPU kernel skips per (tile, channel) the same way: the
// training-path alpha planes are mostly zeros). The block stages its
// (pixels x C) values in shared memory and writes them channel-fastest as
// one contiguous span. The TPU kernel's bounding-box DMA blocks and
// pipelining are not carried over.

#include "bilinear.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPcPix = 128;  // per-channel mode: output pixels per block
constexpr int kMaxC = 32;    // per-channel mode: channels a block stages

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

// Per-channel grids: row n = blockIdx.y, pixels [p0, p0 + 128) of it, all C
// channels. Thread t takes pixel t % 128 of channels t / 128, t / 128 + 2,
// ...: a warp is 32 pixels of one channel.
template <typename T>
__global__ void __launch_bounds__(kThreads) grid_sample_per_channel_kernel(
    const T* __restrict__ planes, const int4* __restrict__ boxes,
    const float* __restrict__ grid, T* __restrict__ out, int H, int W, int C, int P) {
  __shared__ float s_out[kPcPix * (kMaxC + 1)];
  const int n = blockIdx.y, p0 = blockIdx.x * kPcPix;
  const int np = min(kPcPix, P - p0);
  const int S = C | 1;  // odd row stride: a warp's writes hit 32 banks
  const int q = threadIdx.x % kPcPix;
  if (q < np) {
    const float2* g = reinterpret_cast<const float2*>(grid) + (size_t)n * C * P + p0 + q;
    for (int c = threadIdx.x / kPcPix; c < C; c += kThreads / kPcPix) {
      const float2 gp = g[(size_t)c * P];
      const Taps t = top_left_tap(gp.x, gp.y, H, W);
      s_out[q * S + c] = sample_boxed(planes + ((size_t)n * C + c) * H * W, H, W, t,
                                      boxes[n * C + c]);
    }
  }
  __syncthreads();

  // the block's values are one contiguous span of the channel-last output
  T* dst = out + ((size_t)n * P + p0) * C;
  const int count = np * C;
  const int dq = kThreads / C, dc = kThreads - dq * C;
  int r = threadIdx.x / C, c = threadIdx.x - r * C;
  for (int k = threadIdx.x; k < count; k += kThreads) {
    dst[k] = from_float<T>(s_out[r * S + c]);
    r += dq;
    c += dc;
    if (c >= C) {
      c -= C;
      ++r;
    }
  }
}

template <typename T>
int launch(const void* img, const void* boxes, const void* grid, void* out, int H, int W,
           int C, int N, int P, int tp, int per_channel, cudaStream_t s) {
  const T* im = (const T*)img;
  const float* g = (const float*)grid;
  T* o = (T*)out;
  if (per_channel) {
    if (C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
    const dim3 blocks((unsigned)((P + kPcPix - 1) / kPcPix), (unsigned)N);
    grid_sample_per_channel_kernel<T><<<blocks, kThreads, 0, s>>>(
        im, (const int4*)boxes, g, o, H, W, C, P);
  } else {
    const dim3 blocks((unsigned)((P + kThreads - 1) / kThreads), (unsigned)N);
    grid_sample_shared_kernel<T><<<blocks, kThreads, 0, s>>>(im, g, o, H, W, C, P, tp);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// per_channel: img holds the planes (F, C, H, W) and boxes their nonzero
// boxes (planes.cu); otherwise img is (F, H, W, C) and boxes is unused.
extern "C" int waldo_grid_sample(const void* img, const void* boxes, const void* grid,
                                 void* out, int H, int W, int C, int N, int Ho, int Wo,
                                 int tp, int per_channel, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(img, boxes, grid, out, H, W, C, N, Ho * Wo, tp, per_channel,
                                 s);
  return launch<float>(img, boxes, grid, out, H, W, C, N, Ho * Wo, tp, per_channel, s);
}

extern "C" const char* waldo_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
