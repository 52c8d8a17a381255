// Bilinear grid sample, torch F.grid_sample semantics (bilinear, zero
// padding, align_corners=False), channel-last.
//
// Replaces grid_sample_pallas (waldo_tpu/ops/pallas/grid_sample.py) in both
// of its modes:
//   shared      img (F, H, W, C), grid (F*tp, Ho, Wo, 2): every channel rides
//               the grid; grid row n reads texture row n / tp (the predict
//               path's context fusion, C = 3 + 20, at 256x512 on the flagship
//               and 512x1024 on test.sh; tp = 1 is the batch mode of the
//               training path, the WIF decode and the MAT post-processing's
//               whole-frame warps, C = 1 or 3 there);
//   per-channel planes (F, C, H, W) and their nonzero boxes (F, C, 4) from
//               the pre-pass (planes.cu), grid (F, C, Ho, Wo, 2): channel k
//               rides grid[:, k] (the training-path alpha_ctx warp), C <= 32.
// Output (rows, Ho, Wo, C) in the texture's type (float or bf16), computed
// in float.
//
// Bound on an H100: memory. Per output pixel the kernel does ~8 flop per
// channel against 4*C bytes written plus 8 bytes of grid read (8*C per
// channel mode); at test.sh's fusion shape (56 rows, 512x1024, C=23) that
// is 3.13 GB, 0.93 ms at 3.35 TB/s, the output 87 % of it.
// Design (shared mode, C > 4): a block takes a 16 x 8 tile of output pixels
// of one grid row, a thread a pixel. The blocks run tile-major with the tp
// grid rows of one texture's tile side by side, so that those rows read the
// texels their taps share while L2 holds them: one texture is 48 MB at
// 512x1024, and a row-major walk (the first design, kept as
// yardstick/grid_sample_fwd_pr1.cu) wrote a whole row's output, as much
// again, between two rows' reads of it, so that every row read its texture
// from device memory. Each thread computes its pixel's taps once; the block
// stages the texture window its taps reach (the bounding box of the valid
// taps, one span of texels a texture row, by 16-byte async copies where the
// rows allow) in shared memory, and each thread sums its pixel's C channels
// from there into a staged output tile (a warp's reads of one tap and
// channel fall C apart, on distinct banks for odd C, and the window's rows
// are padded to 16 mod 32 so the warp's two tile rows do too). The tile's
// output rows, contiguous spans of 16*C values, then leave as bulk copies
// (TMA) with an L2 evict-first hint, so that they do not push the texture
// out of L2. A block is a
// chain of latencies (grid, window, sums, stores) with little in flight, so
// the tile is small enough (7 blocks an SM at C = 23) that the SM always
// holds blocks in each link: 16 x 16 tiles (4 blocks an SM) wrote 1.6 TB/s.
// Where the whole window exceeds the cap (a strong shrink), the tile is
// staged in bands of warps, each band's window within the cap; a band of
// one warp whose window still exceeds it (a strong shrink, or taps that
// scatter where the flow tears) reads its texels from device memory, each
// thread its own pixel's (a warp walking its pixels one at a time, its
// lanes on the channels, ran 6 % slower on test.sh's inputs: 32 chains of
// dependent loads).
// Design (shared mode, C <= 4: the MAT post-processing's masks and frames,
// one row of 512x1024): a thread a pixel, its channels in registers, its
// taps read straight from the texture, which stays in L2; the tile kernel's
// barriers and staging cost more than such a row's work.
// Design (per-channel mode): a block takes 128 output pixels of one row and
// all C channels; a warp is 32 pixels of one channel, so its grid read is
// one contiguous run and its taps read neighbouring texels of one plane.
// A sample whose 2x2 footprint misses its plane's nonzero box is 0 with no
// texel read (the TPU kernel skips per (tile, channel) the same way: the
// training-path alpha planes are mostly zeros). The block stages its
// (pixels x C) values in shared memory and writes them channel-fastest as
// one contiguous span. The TPU kernel's bounding-box DMA blocks and
// pipelining are not carried over.

#include <cuda_pipeline_primitives.h>

#include <climits>

#include "bilinear.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPcPix = 128;  // per-channel mode: output pixels per block
constexpr int kMaxC = 32;    // per-channel mode: channels a block stages
// shared mode, C > kFewC: a block of kTileW x kTileH threads takes as many
// output pixels (a warp two tile rows); its texture windows hold at most
// kWinBytes (ops/grid_sample.py's shared_fwd_windows models the windows and
// bands); 7 blocks fit an SM at C = 23
constexpr int kTileW = 16, kTileH = 8, kTileThreads = kTileW * kTileH;
constexpr int kWarps = kTileThreads / 32;
constexpr int kWinBytes = 19 * 1024;
// shared mode, C <= kFewC: a thread a pixel, kThreads pixels a block
constexpr int kFewC = 4;

// a window row's length in elements padded to 16 mod 32 (a multiple of the
// 16-byte vector too): the two tile rows a warp holds then read distinct
// banks; vec reserves room for the copy's 16-byte-aligned start
__device__ __forceinline__ int win_stride(int texels, int C, int vec_elems) {
  const int len = texels * C + vec_elems - 1;
  return len + ((16 - len) & 31);
}

// elements of a window box (x_lo, x_hi, y_lo, y_hi), 0 for an empty box
__device__ __forceinline__ int win_elems(int4 b, int C, int vec_elems) {
  return b.x > b.y ? 0 : (b.w - b.z + 1) * win_stride(b.y - b.x + 1, C, vec_elems);
}

__device__ __forceinline__ int4 box_union(int4 a, int4 b) {
  return make_int4(min(a.x, b.x), max(a.y, b.y), min(a.z, b.z), max(a.w, b.w));
}

__device__ __forceinline__ void store_cs(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void store_cs(__nv_bfloat16* p, __nv_bfloat16 v) {
  __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(v));
}

// One pixel's C channels, each the bilinear sum of its four taps read at
// src[o[k] + c], into dst[0, C).
template <typename T>
__device__ __forceinline__ void sample_pixel(const T* __restrict__ src, const int o[4],
                                             const float w[4], int C, T* __restrict__ dst) {
  for (int c = 0; c < C; ++c) {
    float acc = w[0] * to_float(src[o[0] + c]);
    acc += w[1] * to_float(src[o[1] + c]);
    acc += w[2] * to_float(src[o[2] + c]);
    acc += w[3] * to_float(src[o[3] + c]);
    dst[c] = from_float<T>(acc);
  }
}

// Shared grid, C > kFewC: block b takes, in tile-major order, texture f's
// tile (ty, tx) for grid row n = f * tp + j, j = b % tp; thread (r, col) of
// the tile its pixel. vec: every texture row starts 16-byte aligned (W*C*sizeof(T)
// a multiple of 16), so window rows are copied 16 bytes at a time. In-row
// indices are 32-bit (the wrapper bounds H*W*C and Ho*Wo*C).
template <typename T>
__global__ void __launch_bounds__(kTileThreads, 7) grid_sample_shared_kernel(
    const T* __restrict__ img, const float* __restrict__ grid, T* __restrict__ out, int H,
    int W, int C, int Ho, int Wo, int tp, int tiles_x, int tiles_y, int cap, int vec) {
  extern __shared__ float4 s_dyn[];
  __shared__ int4 s_box[kWarps];
  constexpr int V = 16 / sizeof(T);  // elements of a 16-byte vector
  const int Cs = C | 1;              // odd stride: a warp's stores hit distinct banks
  T* s_out = reinterpret_cast<T*>(s_dyn);  // kTileThreads x Cs, then the window
  T* s_win = s_out + kTileThreads * Cs;    // 16-byte aligned: 128 * Cs * sizeof(T)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned b = blockIdx.x;
  const int j = b % tp;
  b /= tp;
  const int tx = b % tiles_x;
  b /= tiles_x;
  const int ty = b % tiles_y, f = b / tiles_y, n = f * tp + j;
  const int ox0 = tx * kTileW, oy0 = ty * kTileH;
  const int oy = oy0 + threadIdx.x / kTileW, ox = ox0 + threadIdx.x % kTileW;
  const bool live = oy < Ho && ox < Wo;
  const T* tex = img + (size_t)f * H * W * C;

  Taps t = {0, 0, 0.f, 0.f};
  bool vx0 = false, vx1 = false, vy0 = false, vy1 = false;
  if (live) {
    const float2 gp = reinterpret_cast<const float2*>(grid)[((size_t)n * Ho + oy) * Wo + ox];
    t = top_left_tap(gp.x, gp.y, H, W);
    vx0 = t.x0 >= 0 && t.x0 < W;
    vx1 = t.x0 + 1 >= 0 && t.x0 + 1 < W;
    vy0 = t.y0 >= 0 && t.y0 < H;
    vy1 = t.y0 + 1 >= 0 && t.y0 + 1 < H;
  }
  const bool ok = (vx0 || vx1) && (vy0 || vy1);  // some tap lies on the texture
  // each warp's window: the bounding box of its valid taps
  int4 box = make_int4(ok ? max(t.x0, 0) : INT_MAX, ok ? min(t.x0 + 1, W - 1) : INT_MIN,
                       ok ? max(t.y0, 0) : INT_MAX, ok ? min(t.y0 + 1, H - 1) : INT_MIN);
  box.x = __reduce_min_sync(0xffffffffu, box.x);
  box.y = __reduce_max_sync(0xffffffffu, box.y);
  box.z = __reduce_min_sync(0xffffffffu, box.z);
  box.w = __reduce_max_sync(0xffffffffu, box.w);
  if (lane == 0) s_box[warp] = box;
  const float w[4] = {(vy0 && vx0) ? (1.f - t.tx) * (1.f - t.ty) : 0.f,
                      (vy0 && vx1) ? t.tx * (1.f - t.ty) : 0.f,
                      (vy1 && vx0) ? (1.f - t.tx) * t.ty : 0.f, (vy1 && vx1) ? t.tx * t.ty : 0.f};
  T* so = s_out + threadIdx.x * Cs;
  const int ve = vec ? V : 1;
  __syncthreads();

  // bands of consecutive warps, each as many as fit one window in the cap
  const int nw = (min(kTileH, Ho - oy0) + 1) / 2;  // warps holding live pixels
  for (int wb = 0; wb < nw;) {
    int4 u = s_box[wb];
    int we = wb + 1;
    for (; we < nw; ++we) {
      const int4 v = box_union(u, s_box[we]);
      if (win_elems(v, C, ve) > cap) break;
      u = v;
    }
    const bool staged = win_elems(u, C, ve) <= cap, any = u.x <= u.y;
    const int rs = any ? win_stride(u.y - u.x + 1, C, ve) : 0;
    int sh = 0;  // where the window's first texel sits in its staged row
    if (staged && any) {
      const int row_len = (u.y - u.x + 1) * C;
      const int e0 = (u.z * W + u.x) * C;
      if (vec) {
        sh = e0 & (V - 1);
        const int nv = (sh + row_len + V - 1) / V;
        for (int r = warp; r <= u.w - u.z; r += kWarps) {
          const T* src = tex + (e0 - sh) + r * W * C;
          for (int k = lane; k < nv; k += 32)
            __pipeline_memcpy_async(s_win + r * rs + k * V, src + k * V, 16);
        }
        __pipeline_commit();
        __pipeline_wait_prior(0);
      } else {
        for (int r = warp; r <= u.w - u.z; r += kWarps) {
          const T* src = tex + e0 + r * W * C;
          for (int k = lane; k < row_len; k += 32) s_win[r * rs + k] = src[k];
        }
      }
    }
    __syncthreads();
    if (warp >= wb && warp < we && live) {
      if (!ok) {
        for (int c = 0; c < C; ++c) so[c] = from_float<T>(0.f);
      } else if (staged) {
        // taps off the texture carry weight 0: any texel of the window will do
        const int x0 = min(max(t.x0, u.x), u.y) - u.x, x1 = min(max(t.x0 + 1, u.x), u.y) - u.x;
        const int y0 = min(max(t.y0, u.z), u.w) - u.z, y1 = min(max(t.y0 + 1, u.z), u.w) - u.z;
        const int o[4] = {y0 * rs + x0 * C + sh, y0 * rs + x1 * C + sh, y1 * rs + x0 * C + sh,
                          y1 * rs + x1 * C + sh};
        sample_pixel(s_win, o, w, C, so);
      } else {
        const int x0 = min(max(t.x0, 0), W - 1), x1 = min(max(t.x0 + 1, 0), W - 1);
        const int y0 = min(max(t.y0, 0), H - 1) * W, y1 = min(max(t.y0 + 1, 0), H - 1) * W;
        const int o[4] = {(y0 + x0) * C, (y0 + x1) * C, (y1 + x0) * C, (y1 + x1) * C};
        sample_pixel(tex, o, w, C, so);
      }
    }
    wb = we;
    if (wb < nw) __syncthreads();  // the band's reads of the window are done
  }
  // the staged tile is read next by the bulk copies (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  // the tile's output rows: contiguous spans of tw*C values, each one bulk
  // copy (TMA) with an L2 evict-first hint where rows and spans are whole
  // 16-byte vectors (odd C: the staged rows are the spans), else streaming
  // stores of single values
  const int tw = min(kTileW, Wo - ox0), th = min(kTileH, Ho - oy0), span = tw * C;
  T* dst0 = out + (((size_t)n * Ho + oy0) * Wo + ox0) * C;
  const size_t row = (size_t)Wo * C;
  if (Cs == C && span % V == 0 && row % V == 0 && (reinterpret_cast<size_t>(dst0) & 15) == 0) {
    if (threadIdx.x < th) {
      unsigned long long policy;
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
      const unsigned src = (unsigned)__cvta_generic_to_shared(s_out + threadIdx.x * kTileW * Cs);
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;" ::"l"(
              dst0 + threadIdx.x * row),
          "r"(src), "r"(span * (int)sizeof(T)), "l"(policy)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");  // before the block ends
    }
  } else {
    for (int r = warp; r < th; r += kWarps) {
      T* dst = dst0 + r * row;
      const T* src = s_out + r * kTileW * Cs;
      for (int k = lane; k < span; k += 32) {
        const int q = k / C;
        store_cs(dst + k, src[q * Cs + k - q * C]);
      }
    }
  }
}

// Shared grid, C = kC <= kFewC (the MAT post-processing's masks and RGB
// frames, one row of 512x1024): row n = blockIdx.y, a thread pixel
// blockIdx.x * kThreads + threadIdx.x, its kC channels in registers, the
// taps read straight from the texture (a warp's pixels read neighbouring
// texels of kC elements; the textures are a few MB and stay in L2) and
// only where they lie on it; no window, no barrier.
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads) grid_sample_few_kernel(
    const T* __restrict__ img, const float* __restrict__ grid, T* __restrict__ out, int H,
    int W, int P, int tp) {
  const int n = blockIdx.y, p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const float2 gp = reinterpret_cast<const float2*>(grid)[(size_t)n * P + p];
  const Taps t = top_left_tap(gp.x, gp.y, H, W);
  const T* tex = img + (size_t)(n / tp) * H * W * kC;
  const int x1 = t.x0 + 1, y1 = t.y0 + 1;
  const bool vx0 = t.x0 >= 0 && t.x0 < W, vx1 = x1 >= 0 && x1 < W;
  const bool vy0 = t.y0 >= 0 && t.y0 < H, vy1 = y1 >= 0 && y1 < H;
  const bool ok[4] = {vy0 && vx0, vy0 && vx1, vy1 && vx0, vy1 && vx1};
  const float w[4] = {(1.f - t.tx) * (1.f - t.ty), t.tx * (1.f - t.ty), (1.f - t.tx) * t.ty,
                      t.tx * t.ty};
  const int o[4] = {(t.y0 * W + t.x0) * kC, (t.y0 * W + x1) * kC, (y1 * W + t.x0) * kC,
                    (y1 * W + x1) * kC};
  float acc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) acc[c] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (ok[k]) {
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[c] += w[k] * to_float(tex[o[k] + c]);
    }
  }
  T* dst = out + ((size_t)n * P + p) * kC;
#pragma unroll
  for (int c = 0; c < kC; ++c) store_cs(dst + c, from_float<T>(acc[c]));
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
           int C, int N, int Ho, int Wo, int tp, int per_channel, cudaStream_t s) {
  const T* im = (const T*)img;
  const float* g = (const float*)grid;
  T* o = (T*)out;
  const int P = Ho * Wo;
  if (per_channel) {
    if (C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
    const dim3 blocks((unsigned)((P + kPcPix - 1) / kPcPix), (unsigned)N);
    grid_sample_per_channel_kernel<T><<<blocks, kThreads, 0, s>>>(
        im, (const int4*)boxes, g, o, H, W, C, P);
  } else if (C <= kFewC) {
    const dim3 blocks((unsigned)((P + kThreads - 1) / kThreads), (unsigned)N);
    if (C == 1)
      grid_sample_few_kernel<T, 1><<<blocks, kThreads, 0, s>>>(im, g, o, H, W, P, tp);
    else if (C == 2)
      grid_sample_few_kernel<T, 2><<<blocks, kThreads, 0, s>>>(im, g, o, H, W, P, tp);
    else if (C == 3)
      grid_sample_few_kernel<T, 3><<<blocks, kThreads, 0, s>>>(im, g, o, H, W, P, tp);
    else if (C == 4)
      grid_sample_few_kernel<T, 4><<<blocks, kThreads, 0, s>>>(im, g, o, H, W, P, tp);
    else
      return (int)cudaErrorInvalidValue;
  } else {
    const int tiles_x = (Wo + kTileW - 1) / kTileW, tiles_y = (Ho + kTileH - 1) / kTileH;
    const long long blocks = (long long)N * tiles_x * tiles_y;
    const int es = (int)sizeof(T), cap = kWinBytes / es;
    const int smem = (kTileThreads * (C | 1) + cap) * es;
    if (blocks > INT_MAX || N % tp != 0) return (int)cudaErrorInvalidValue;
    const int vec = (W * C * es) % 16 == 0 && ((size_t)img & 15) == 0;
    if (smem > 48 * 1024) {  // many channels: above the default 48 KB
      const cudaError_t err = cudaFuncSetAttribute(
          grid_sample_shared_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
    }
    grid_sample_shared_kernel<T><<<(unsigned)blocks, kTileThreads, smem, s>>>(
        im, g, o, H, W, C, Ho, Wo, tp, tiles_x, tiles_y, cap, vec);
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
    return launch<__nv_bfloat16>(img, boxes, grid, out, H, W, C, N, Ho, Wo, tp, per_channel, s);
  return launch<float>(img, boxes, grid, out, H, W, C, N, Ho, Wo, tp, per_channel, s);
}

extern "C" const char* waldo_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
