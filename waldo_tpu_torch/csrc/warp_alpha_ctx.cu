// Fused alpha_ctx warp of the predict path: per-layer bilinear sample, ghost
// mask, disocclusion max, prediction-time occlusion product and
// alpha-weighted flow reduction in one pass.
//
// Replaces warp_alpha_ctx_pallas (_war_kernel,
// waldo_tpu/ops/pallas/grid_sample.py). Inputs, contiguous:
//   planes (F, C, H, W) f32   unique context-frame alphas, one plane per
//                             layer, and boxes (F, C, 4) int32 their
//                             inclusive nonzero boxes (y0, y1, x0, x1), both
//                             from the pre-pass (planes.cu)
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
// Design: one thread per output pixel, 128 pixels of one row a tile.
//   * The grid (63 % of the bytes), the mask, occ[n] and the row's boxes
//     reach shared memory by cp.async, double-buffered: a persistent block
//     walks tiles k, k + gridDim.x, ... and asks for tile t+1's data before
//     it computes tile t.
//   * Sampling skips exactly: a (pixel, layer) whose 2x2 footprint misses
//     the plane's nonzero box is 0 with no texel read (the TPU kernel's
//     per-(tile, layer) skip, _skip_flags). Object alphas are zero outside
//     each object's warped quad, so most object samples skip. A thread
//     takes its layers eight at a time: all eight footprints, then the taps
//     of every layer that some pixel of the warp does not skip, so that up
//     to 32 tap loads are in flight together, then the sums.
//   * The occlusion product keeps a pixel's C running products in
//     registers and walks the occluders i in ascending order, reading row i
//     of occ[n] as warp-uniform float4 broadcasts. It walks only the
//     occluders that are nonzero at some pixel of the warp (a warp-wide OR
//     of the pixels' nonzero masks): a skipped factor is exactly 1 - 0 * o
//     = 1, so the result is the dense order's, bit for bit. The layer count
//     is rounded up to a compile-time CMAX (8, 16, 17, 20 or 32) so both
//     arrays stay registers.
//   * The block stages its alpha_occ rows in shared memory (over the tile's
//     grid buffer, once read) and writes them as one contiguous span.
// At C=17 the two stages (38 KB, 55 KB with the mask) and ~100 registers
// leave room for 5 blocks of 128 threads on an SM (4 with the mask). On the
// H100 a version that kept the grid in registers, without cp.async, ran
// slower even at 8 blocks an SM, and grouping the taps eight layers at a
// time was the largest single gain (PERF.md).

#include <cuda_pipeline_primitives.h>
#include <math.h>

#include "bilinear.cuh"

namespace {

constexpr int kPix = 128;  // output pixels per tile = threads per block
constexpr int kMaxLayers = 32;
constexpr int kGroup = 8;  // layers whose taps are in flight together

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) & ~15; }

// Row stride of occ[n] in shared memory: CMAX rounded up to float4s.
template <int CMAX>
__host__ __device__ constexpr int occ_stride() { return (CMAX + 3) & ~3; }

// One tile's inputs in shared memory: grid [C][kPix] float2, mask [C][kPix]
// (with HAS_IO), occ[n] rows [C][occ_stride], boxes [C].
template <int CMAX, bool HAS_IO>
struct Stage {
  int g, io, occ, box, bytes;
  __host__ __device__ explicit Stage(int C) {
    g = 0;
    io = align16(C * kPix * 8);
    occ = io + (HAS_IO ? align16(C * kPix * 4) : 0);
    box = occ + align16(C * occ_stride<CMAX>() * 4);
    bytes = box + C * 16;
  }
};

struct Params {
  const float* planes;
  const int4* boxes;
  const float2* grid;
  const float* occ;
  const float* is_obj;
  float* alpha_out;
  float* disocc_out;
  float2* flow_out;
  int H, W, C, N, P, gw, gh, tp, tcp, tiles_per_row;
};

template <int CMAX, bool HAS_IO>
__device__ __forceinline__ void fetch_tile(const Params& a, int k, unsigned char* st) {
  const Stage<CMAX, HAS_IO> L(a.C);
  const int n = k / a.tiles_per_row, p0 = (k - n * a.tiles_per_row) * kPix;
  const int x = threadIdx.x, p = p0 + x, C = a.C;
  if (p < a.P) {
    float2* sg = reinterpret_cast<float2*>(st + L.g);
    const float2* g = a.grid + (size_t)n * C * a.P + p;
    for (int j = 0; j < C; ++j) __pipeline_memcpy_async(sg + j * kPix + x, g + (size_t)j * a.P, 8);
    if (HAS_IO) {
      float* sio = reinterpret_cast<float*>(st + L.io);
      const float* io = a.is_obj + (size_t)((n / a.tcp) * a.tp + n % a.tp) * C * a.P + p;
      for (int j = 0; j < C; ++j)
        __pipeline_memcpy_async(sio + j * kPix + x, io + (size_t)j * a.P, 4);
    }
  }
  float* so = reinterpret_cast<float*>(st + L.occ);
  const float* occ = a.occ + (size_t)n * C * C;
  for (int e = x; e < C * C; e += kPix) {
    const int i = e / C;
    __pipeline_memcpy_async(so + i * occ_stride<CMAX>() + (e - i * C), occ + e, 4);
  }
  int4* sb = reinterpret_cast<int4*>(st + L.box);
  for (int j = x; j < C; j += kPix)
    __pipeline_memcpy_async(sb + j, a.boxes + (size_t)(n / a.tp) * C + j, 16);
}

template <int CMAX, bool HAS_IO>
__device__ __forceinline__ void compute_tile(const Params& a, int k, unsigned char* st) {
  const Stage<CMAX, HAS_IO> L(a.C);
  const int C = a.C, P = a.P;
  const int n = k / a.tiles_per_row, p0 = (k - n * a.tiles_per_row) * kPix;
  const int x = threadIdx.x, p = p0 + x;
  const bool live = p < P;
  const float2* sg = reinterpret_cast<const float2*>(st + L.g);
  const float* sio = reinterpret_cast<const float*>(st + L.io);
  const float* so = reinterpret_cast<const float*>(st + L.occ);
  const int4* sb = reinterpret_cast<const int4*>(st + L.box);
  const float* tex = a.planes + (size_t)(n / a.tp) * C * a.H * a.W;

  // 1. sample and mask, kGroup layers at a time: their footprints first,
  // then the taps of every layer that some pixel of the warp does not skip
  // (a footprint that misses the box reads nothing), all in flight
  // together, then the sums
  float al[CMAX];
  unsigned nz = 0;
  float dis = -INFINITY;
#pragma unroll
  for (int j0 = 0; j0 < CMAX; j0 += kGroup) {
    Taps t[kGroup];
    bool hit[kGroup];
    float v[kGroup][4];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int j = j0 + u;
      t[u] = {0, 0, 0.f, 0.f};
      hit[u] = false;
      if (j < CMAX && j < C && live) {
        const float2 g = sg[j * kPix + x];
        t[u] = top_left_tap(g.x, g.y, a.H, a.W);
        hit[u] = !misses_box(t[u], sb[j]);
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      v[u][0] = v[u][1] = v[u][2] = v[u][3] = 0.f;
      if (j0 + u < CMAX && __any_sync(0xffffffffu, hit[u]))
        load_taps(tex + (size_t)(j0 + u) * a.H * a.W, a.H, a.W, t[u], hit[u], v[u]);
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int j = j0 + u;
      if (j < CMAX) {
        float s = bilinear_sum(t[u], v[u]);
        if (HAS_IO && j < C && live) s *= sio[j * kPix + x];
        al[j] = s;
        if (j < C) dis = fmaxf(dis, s);
        nz |= (s != 0.f) ? 1u << j : 0u;
      }
    }
  }

  // 2. occlusion product over the occluders nonzero somewhere in the warp
  const unsigned wnz = __reduce_or_sync(0xffffffffu, nz);
  float pr[CMAX];
#pragma unroll
  for (int j = 0; j < CMAX; ++j) pr[j] = 1.f;
#pragma unroll
  for (int i = 0; i < CMAX; ++i) {
    if (wnz & (1u << i)) {
      const float ai = al[i];
      const float* oi = so + i * occ_stride<CMAX>();
#pragma unroll
      for (int q = 0; q < CMAX / 4; ++q) {
        const float4 o = reinterpret_cast<const float4*>(oi)[q];
        pr[4 * q] *= 1.f - ai * o.x;
        pr[4 * q + 1] *= 1.f - ai * o.y;
        pr[4 * q + 2] *= 1.f - ai * o.z;
        pr[4 * q + 3] *= 1.f - ai * o.w;
      }
#pragma unroll
      for (int j = CMAX / 4 * 4; j < CMAX; ++j) pr[j] *= 1.f - ai * oi[j];
    }
  }

  // 3. alpha_occ, disocc max and flow sum (a layer zero in the whole warp
  // adds exactly 0)
  const float bx = ((float)(p % a.gw) + 0.5f) * (2.f / a.gw) - 1.f;
  const float by = ((float)(p / a.gw) + 0.5f) * (2.f / a.gh) - 1.f;
  float fx = 0.f, fy = 0.f;
#pragma unroll
  for (int j = 0; j < CMAX; ++j) {
    pr[j] *= al[j];
    if ((wnz & (1u << j)) && live) {
      const float2 g = sg[j * kPix + x];
      fx += pr[j] * (g.x - bx);
      fy += pr[j] * (g.y - by);
    }
  }
  if (live) {
    a.disocc_out[(size_t)n * P + p] = dis;
    a.flow_out[(size_t)n * P + p] = make_float2(fx, fy);
  }
  __syncthreads();  // every thread is done with the tile's grid
  float* s_ao = reinterpret_cast<float*>(st + L.g);
  const int S = C | 1;  // odd row stride: a warp's writes hit 32 banks
  if (live) {
#pragma unroll
    for (int j = 0; j < CMAX; ++j)
      if (j < C) s_ao[x * S + j] = pr[j];
  }
  __syncthreads();
  // the tile's alpha_occ rows are one contiguous span of the output
  const int count = min(kPix, P - p0) * C;
  float* dst = a.alpha_out + ((size_t)n * P + p0) * C;
  const int dq = kPix / C, dc = kPix - dq * C;
  int q = x / C, c = x - q * C;
  for (int e = x; e < count; e += kPix) {
    dst[e] = s_ao[q * S + c];
    q += dq;
    c += dc;
    if (c >= C) {
      c -= C;
      ++q;
    }
  }
  __syncthreads();  // the stage may be refilled
}

template <int CMAX, bool HAS_IO>
__global__ void __launch_bounds__(kPix) warp_alpha_ctx_kernel(Params a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Stage<CMAX, HAS_IO> L(a.C);
  // occ rows are padded to float4s; the padding is never copied into, so
  // zero it once (its products are never read, but stay finite)
  constexpr int kOcc = occ_stride<CMAX>();
  for (int e = threadIdx.x; e < 2 * a.C * kOcc; e += kPix) {
    const int s = e / (a.C * kOcc), r = e - s * a.C * kOcc;
    if (r % kOcc >= a.C) reinterpret_cast<float*>(smem + s * L.bytes + L.occ)[r] = 0.f;
  }
  const int total = a.N * a.tiles_per_row;
  int k = blockIdx.x;
  if (k < total) fetch_tile<CMAX, HAS_IO>(a, k, smem);
  __pipeline_commit();
  for (int it = 0; k < total; ++it, k += gridDim.x) {
    const int next = k + gridDim.x;
    if (next < total) fetch_tile<CMAX, HAS_IO>(a, next, smem + ((it + 1) & 1) * L.bytes);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this thread's copies of tile k have landed
    __syncthreads();           // and every other thread's
    compute_tile<CMAX, HAS_IO>(a, k, smem + (it & 1) * L.bytes);
  }
  __pipeline_wait_prior(0);
}

// Resident blocks per SM of one instantiation at C layers (its shared
// memory set as its limit first), or a negative CUDA error.
template <int CMAX, bool HAS_IO>
int blocks_per_sm(int C) {
  const auto kernel = warp_alpha_ctx_kernel<CMAX, HAS_IO>;
  const int smem = 2 * Stage<CMAX, HAS_IO>(C).bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kPix, smem);
  return err == cudaSuccess ? per_sm : -(int)err;
}

template <int CMAX, bool HAS_IO>
int launch(const Params& a, cudaStream_t s) {
  const auto kernel = warp_alpha_ctx_kernel<CMAX, HAS_IO>;
  const int smem = 2 * Stage<CMAX, HAS_IO>(a.C).bytes;
  const int per_sm = blocks_per_sm<CMAX, HAS_IO>(a.C);
  if (per_sm < 0) return -per_sm;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)a.N * a.tiles_per_row;
  const int blocks = (int)(total < (long long)sms * per_sm ? total : (long long)sms * per_sm);
  kernel<<<blocks, kPix, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool HAS_IO>
int dispatch(const Params& a, cudaStream_t s) {
  if (a.C <= 8) return launch<8, HAS_IO>(a, s);
  if (a.C <= 16) return launch<16, HAS_IO>(a, s);
  if (a.C == 17) return launch<17, HAS_IO>(a, s);  // the flagship: 16 objects + background
  if (a.C <= 20) return launch<20, HAS_IO>(a, s);
  return launch<32, HAS_IO>(a, s);
}

}  // namespace

extern "C" int waldo_warp_alpha_ctx(const void* planes, const void* boxes, const void* grid,
                                    const void* occ, const void* is_obj, void* alpha_out,
                                    void* disocc, void* flow, int H, int W, int C, int N,
                                    int gh, int gw, int tp, int tcp, void* stream) {
  if (C < 1 || C > kMaxLayers) return (int)cudaErrorInvalidValue;
  const int P = gh * gw;
  const Params a{(const float*)planes, (const int4*)boxes, (const float2*)grid,
                 (const float*)occ,    (const float*)is_obj, (float*)alpha_out,
                 (float*)disocc,       (float2*)flow,        H, W, C, N, P, gw, gh, tp, tcp,
                 (P + kPix - 1) / kPix};
  cudaStream_t s = (cudaStream_t)stream;
  return is_obj ? dispatch<true>(a, s) : dispatch<false>(a, s);
}

extern "C" const char* waldo_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
