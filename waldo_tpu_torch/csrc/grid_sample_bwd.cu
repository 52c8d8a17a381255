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
// Design (shared mode): a block takes a 16 x 16 tile of output pixels, a
// thread a pixel. Each thread computes its pixel's taps once; the block
// stages the tile's grad_out (16 rows of 16 x C contiguous floats, by
// 16-byte async copies where aligned) and the texture window its taps
// reach (the bounding box of the valid taps, one contiguous span of texels
// a texture row, by 4-byte async copies) in shared memory, and after one
// block barrier each thread walks its pixel's C channels from there, the
// grid-gradient sums in registers: a warp's reads of one tap and channel
// fall 1 texel (C floats, odd) apart, on distinct banks, and no term leaves
// the thread. A tile whose window exceeds kWinCap floats (a strong shrink,
// scattered taps) reads its texels straight from device memory instead.
// Designs that kept channel-last texels coalesced across lanes and summed
// a pixel's channel terms across lanes (the block-wide walk of the first
// design, kept as yardstick/grid_sample_shared_bwd_pr4.cu; a warp a run of
// 32 pixels; 8 lanes a pixel) were slower than ATen's NCHW backward on the
// H100 (PERF.md): their per-value index work, term stores and reductions
// cost more issue slots than the texel loads they coalesced.
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

#include <cuda_pipeline_primitives.h>

#include <climits>

#include "bilinear.cuh"

namespace {

// shared mode: a block of kTile x kTile threads takes as many output
// pixels, stages at most kMaxC channels at a time and a texture window of
// at most kWinCap floats (48 KB)
constexpr int kTile = 16, kTileThreads = kTile * kTile;
constexpr int kMaxC = 32;
constexpr int kWinCap = 12 * 1024;
// blocks an SM holds at C = 23 (72 KB of shared memory each): registers
// need not be held under what that leaves
constexpr int kTileBlocks = 3;
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

// grad_out of channels [c0, c0 + cc) of npx output pixels from go (the
// first pixel, C channels a pixel) into s[q * cw + c] (cw = cc but for the
// last of several chunks). Where that is the pixels' whole span (cc == C)
// and go is 16-byte aligned, by 16-byte async copies and a scalar tail;
// else by scalar loads. The caller commits and waits for the copies.
__device__ __forceinline__ void stage_grad_out(float* s, const float* __restrict__ go, int npx,
                                               int C, int c0, int cc, int cw, int lane) {
  const int count = npx * cc;
  if (cc == C && (reinterpret_cast<size_t>(go) & 15) == 0) {
    const int nv = count >> 2;
    for (int i = lane; i < nv; i += 32) __pipeline_memcpy_async(s + 4 * i, go + 4 * i, 16);
    for (int i = 4 * nv + lane; i < count; i += 32) s[i] = go[i];
  } else {
    for (int k = lane; k < count; k += 32) {
      const int q = k / cc;
      s[q * cw + k - q * cc] = go[q * C + c0 + k - q * cc];
    }
  }
}

// One pixel's grid-gradient sums over channels [0, cc): its taps' texel c
// at src[base + c] (y0,x0), src[base + xs + c] (y0,x1), src[base + rs + c]
// (y1,x0), src[base + rs + xs + c] (y1,x1), each read only where its bit of
// ok is set, the output gradient at g[c]. With u = g (v1 - v0) and so on,
// sx0 + ty (sx1 - sx0) and sy0 + tx (sy1 - sy0) are the two derivatives.
// kImg: g times each tap's weight also goes into grad_img at gi[c], gi[gxs
// + c], gi[grs + c], gi[grs + gxs + c] by device atomics.
template <bool kImg>
__device__ __forceinline__ void pixel_sums(const float* src, int base, int xs, int rs, int ok,
                                           const float* __restrict__ g, int cc, float* gi,
                                           int gxs, int grs, const Taps& t, float& sx0,
                                           float& sx1, float& sy0, float& sy1) {
  const bool b0 = ok & 1, b1 = ok & 2, b2 = ok & 4, b3 = ok & 8;
  // an unread tap's pointer stays at src, so that no address leaves the data
  const float* p00 = src + (b0 ? base : 0);
  const float* p01 = src + (b1 ? base + xs : 0);
  const float* p10 = src + (b2 ? base + rs : 0);
  const float* p11 = src + (b3 ? base + rs + xs : 0);
#pragma unroll 4
  for (int c = 0; c < cc; ++c) {
    const float gc = g[c];
    const float v0 = b0 ? p00[c] : 0.f, v1 = b1 ? p01[c] : 0.f;
    const float v2 = b2 ? p10[c] : 0.f, v3 = b3 ? p11[c] : 0.f;
    sx0 += gc * (v1 - v0);
    sx1 += gc * (v3 - v2);
    sy0 += gc * (v2 - v0);
    sy1 += gc * (v3 - v1);
    if (kImg && gc != 0.f) {
      const float wx0 = 1.f - t.tx, wy0 = 1.f - t.ty;
      if (b0) atomicAdd(gi + c, wx0 * wy0 * gc);
      if (b1) atomicAdd(gi + gxs + c, t.tx * wy0 * gc);
      if (b2) atomicAdd(gi + grs + c, wx0 * t.ty * gc);
      if (b3) atomicAdd(gi + grs + gxs + c, t.tx * t.ty * gc);
    }
  }
}

// Shared grid: block (x, n) takes tile x (row-major over the output's
// kTile x kTile tiles) of grid row n, thread (r, col) its pixel. In-row
// indices are 32-bit (the wrapper bounds H*W*C and Ho*Wo*C; a texel index
// is formed only for a pixel with a tap on the texture). kImg:
// grad_img is asked for (zero-filled by the caller; its atomics are
// compiled out of the grid-only instantiation the training path runs).
template <bool kImg>
__global__ void __launch_bounds__(kTileThreads, kTileBlocks) grid_sample_shared_bwd_kernel(
    const float* __restrict__ img, const float* __restrict__ grid,
    const float* __restrict__ gout, float* __restrict__ ggrid, float* __restrict__ gimg, int H,
    int W, int C, int Ho, int Wo, int tp) {
  extern __shared__ float4 s_dyn[];
  __shared__ int4 s_box[kTileThreads / 32];
  const int cw = min(C, kMaxC);
  float* s_g = reinterpret_cast<float*>(s_dyn);  // kTileThreads x cw
  float* s_w = s_g + kTileThreads * cw;          // the window, kWinCap floats
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles_x = (Wo + kTile - 1) / kTile;
  const int oy0 = (blockIdx.x / tiles_x) * kTile, ox0 = (blockIdx.x % tiles_x) * kTile;
  const int n = blockIdx.y, P = Ho * Wo;
  const int oy = oy0 + threadIdx.x / kTile, ox = ox0 + threadIdx.x % kTile;
  const bool live = oy < Ho && ox < Wo;
  const size_t tex_off = (size_t)(n / tp) * H * W * C;
  const float* tex = img + tex_off;
  const int npx = min(kTile, Wo - ox0);
  // warp w stages the grad_out of tile rows 2w and 2w + 1
  auto stage_tile_grad_out = [&](int c0, int cc) {
    for (int r = 2 * warp; r < 2 * warp + 2 && oy0 + r < Ho; ++r)
      stage_grad_out(s_g + r * kTile * cw,
                     gout + ((size_t)n * P + (size_t)(oy0 + r) * Wo + ox0) * C, npx, C, c0, cc,
                     cw, lane);
    __pipeline_commit();
  };
  stage_tile_grad_out(0, cw);  // on its way while the taps and window are found
  Taps t = {0, 0, 0.f, 0.f};
  int ok = 0;  // one bit a tap in tap order, set where the tap lies on the texture
  if (live) {
    const float2 gp = reinterpret_cast<const float2*>(grid)[(size_t)n * P + (size_t)oy * Wo + ox];
    t = top_left_tap(gp.x, gp.y, H, W);
    const bool vx0 = t.x0 >= 0 && t.x0 < W, vx1 = t.x0 + 1 >= 0 && t.x0 + 1 < W;
    const bool vy0 = t.y0 >= 0 && t.y0 < H, vy1 = t.y0 + 1 >= 0 && t.y0 + 1 < H;
    ok = (vy0 && vx0) | (vy0 && vx1) << 1 | (vy1 && vx0) << 2 | (vy1 && vx1) << 3;
  }
  // the window: the bounding box of the tile's valid taps
  int xlo = ok ? max(t.x0, 0) : INT_MAX, xhi = ok ? min(t.x0 + 1, W - 1) : INT_MIN;
  int ylo = ok ? max(t.y0, 0) : INT_MAX, yhi = ok ? min(t.y0 + 1, H - 1) : INT_MIN;
  xlo = __reduce_min_sync(0xffffffffu, xlo);
  xhi = __reduce_max_sync(0xffffffffu, xhi);
  ylo = __reduce_min_sync(0xffffffffu, ylo);
  yhi = __reduce_max_sync(0xffffffffu, yhi);
  if (lane == 0) s_box[warp] = make_int4(xlo, xhi, ylo, yhi);
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kTileThreads / 32; ++w) {
    const int4 b = s_box[w];
    xlo = min(xlo, b.x);
    xhi = max(xhi, b.y);
    ylo = min(ylo, b.z);
    yhi = max(yhi, b.w);
  }
  const int wx = xlo <= xhi ? xhi - xlo + 1 : 0, wy = xlo <= xhi ? yhi - ylo + 1 : 0;
  float sx0 = 0.f, sx1 = 0.f, sy0 = 0.f, sy1 = 0.f;
  for (int c0 = 0; c0 < C; c0 += cw) {
    const int cc = min(cw, C - c0);
    if (c0 > 0) {
      __syncthreads();  // every thread is done with the previous channels
      stage_tile_grad_out(c0, cc);
    }
    // window rows padded to 16 mod 32 floats: the two rows of output pixels
    // a warp holds then read distinct banks where the warp is 1:1
    const int rowlen = wx * cc, rs = rowlen + ((16 - rowlen) & 31);
    const bool staged = wy * rs <= kWinCap;
    if (staged) {
      for (int r = warp; r < wy; r += kTileThreads / 32) {
        const float* src = tex + ((size_t)(ylo + r) * W + xlo) * C + c0;
        float* dst = s_w + r * rs;
        if (cc == C) {
          for (int j = lane; j < rowlen; j += 32) __pipeline_memcpy_async(dst + j, src + j, 4);
        } else {
          for (int j = lane; j < rowlen; j += 32) {
            const int q = j / cc;
            dst[j] = src[q * C + j - q * cc];
          }
        }
      }
      __pipeline_commit();
    }
    __pipeline_wait_prior(0);
    __syncthreads();
    if (ok) {
      float* gi = kImg ? gimg + tex_off + (ptrdiff_t)(t.y0 * W + t.x0) * C + c0 : nullptr;
      if (staged)
        pixel_sums<kImg>(s_w, (t.y0 - ylo) * rs + (t.x0 - xlo) * cc, cc, rs, ok,
                         s_g + threadIdx.x * cw, cc, gi, C, W * C, t, sx0, sx1, sy0, sy1);
      else
        pixel_sums<kImg>(tex + c0, (t.y0 * W + t.x0) * C, C, W * C, ok, s_g + threadIdx.x * cw,
                         cc, gi, C, W * C, t, sx0, sx1, sy0, sy1);
    }
  }
  if (live)
    reinterpret_cast<float2*>(ggrid)[(size_t)n * P + (size_t)oy * Wo + ox] =
        make_float2((sx0 + t.ty * (sx1 - sx0)) * (W * 0.5f),
                    (sy0 + t.tx * (sy1 - sy0)) * (H * 0.5f));
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
    const unsigned tiles = (unsigned)((Ho + kTile - 1) / kTile) * ((Wo + kTile - 1) / kTile);
    const dim3 blocks(tiles, (unsigned)N);
    const int smem = (kTileThreads * min(C, kMaxC) + kWinCap) * (int)sizeof(float);
    const void* kernel = gimg != nullptr ? (const void*)grid_sample_shared_bwd_kernel<true>
                                         : (const void*)grid_sample_shared_bwd_kernel<false>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (gimg != nullptr)
      grid_sample_shared_bwd_kernel<true><<<blocks, kTileThreads, smem, s>>>(
          (const float*)img, (const float*)grid, (const float*)gout, (float*)ggrid,
          (float*)gimg, H, W, C, Ho, Wo, tp);
    else
      grid_sample_shared_bwd_kernel<false><<<blocks, kTileThreads, smem, s>>>(
          (const float*)img, (const float*)grid, (const float*)gout, (float*)ggrid, nullptr, H,
          W, C, Ho, Wo, tp);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* waldo_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
