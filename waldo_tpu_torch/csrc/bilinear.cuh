// Bilinear tap arithmetic shared by the sampling kernels (torch
// F.grid_sample semantics: bilinear, zero padding, align_corners=False),
// and the exact footprint test of the sparsity skip.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// Top-left tap (x0, y0) and fractions of normalized point (gx, gy) on an
// H x W plane: x = (gx + 1) * W/2 - 0.5, rounded step by step as the plain
// version and the JAX reference round it (no fused multiply-add), so that
// the skip test below sees the same footprint as ops/grid_sample.py's
// tap_footprint_skips.
struct Taps {
  int x0, y0;
  float tx, ty;
};

__device__ __forceinline__ Taps top_left_tap(float gx, float gy, int H, int W) {
  float ix = __fsub_rn(__fmul_rn(__fadd_rn(gx, 1.f), W * 0.5f), 0.5f);
  float iy = __fsub_rn(__fmul_rn(__fadd_rn(gy, 1.f), H * 0.5f), 0.5f);
  // far-out points (inverse-warp holes sit at 4.0) keep every tap outside
  // the plane; clamping keeps the int conversion defined
  ix = fminf(fmaxf(ix, -2.f), (float)W + 1.f);
  iy = fminf(fmaxf(iy, -2.f), (float)H + 1.f);
  const float fx0 = floorf(ix), fy0 = floorf(iy);
  return {(int)fx0, (int)fy0, ix - fx0, iy - fy0};
}

// True when the 2x2 footprint [x0, x0+1] x [y0, y0+1] misses the plane's
// inclusive nonzero box (y0, y1, x0, x1): every tap then reads a zero texel
// or lies outside the plane, so the sample is exactly 0. An empty plane's
// box (H, -1, W, -1) is missed by every footprint.
__device__ __forceinline__ bool misses_box(const Taps& t, int4 box) {
  return t.x0 + 1 < box.z || t.x0 > box.w || t.y0 + 1 < box.x || t.y0 > box.y;
}

// The four texels of taps t on one plane, each 0 where it lies outside
// the plane or where hit is false (no texel is read then). Tap order
// (y0,x0) (y0,x1) (y1,x0) (y1,x1).
template <typename T>
__device__ __forceinline__ void load_taps(const T* __restrict__ plane, int H, int W,
                                          const Taps& t, bool hit, float v[4]) {
  const int x1 = t.x0 + 1, y1 = t.y0 + 1;
  const bool vx0 = hit && t.x0 >= 0 && t.x0 < W, vx1 = hit && x1 >= 0 && x1 < W;
  const bool vy0 = t.y0 >= 0 && t.y0 < H, vy1 = y1 >= 0 && y1 < H;
  v[0] = (vy0 && vx0) ? to_float(plane[t.y0 * W + t.x0]) : 0.f;
  v[1] = (vy0 && vx1) ? to_float(plane[t.y0 * W + x1]) : 0.f;
  v[2] = (vy1 && vx0) ? to_float(plane[y1 * W + t.x0]) : 0.f;
  v[3] = (vy1 && vx1) ? to_float(plane[y1 * W + x1]) : 0.f;
}

// The bilinear sum of four tap values, in tap order.
__device__ __forceinline__ float bilinear_sum(const Taps& t, const float v[4]) {
  float acc = (1.f - t.tx) * (1.f - t.ty) * v[0];
  acc += t.tx * (1.f - t.ty) * v[1];
  acc += (1.f - t.tx) * t.ty * v[2];
  acc += t.tx * t.ty * v[3];
  return acc;
}

// Bilinear sample of one plane at taps t, 0 where the footprint misses
// the box: a branch, so that a warp whose samples all miss runs none of
// the tap arithmetic and reads no texel.
template <typename T>
__device__ __forceinline__ float sample_boxed(const T* __restrict__ plane, int H, int W,
                                              const Taps& t, int4 box) {
  if (misses_box(t, box)) return 0.f;
  float v[4];
  load_taps(plane, H, W, t, true, v);
  return bilinear_sum(t, v);
}
