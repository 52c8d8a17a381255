// Fused bias + activation + gain + clamp, channel-last:
//   y = clamp(act(x + b[c]) * gain, -clamp, clamp),  c = i % C.
//
// Replaces bias_act_pallas (_kernel, waldo_tpu/ops/pallas/bias_act.py), the
// TPU kernel behind every layer of the MAT inpainter. Input x (..., C) and
// output y, float32, contiguous; b (C,) float32 or null (zero bias). The
// nine activations of the JAX table, lrelu with slope 0.2; clamp < 0 means
// no clamp.
//
// Bound on an H100: memory. Each element is read once and written once (8
// bytes) against a handful of flop; at MAT's largest call, (1, 512, 512,
// 180), that is 189 MB read and 189 MB written, ~0.113 ms at 3.35 TB/s.
// Design: one pass, no shared memory. Where C is a multiple of 4 and the
// pointers are 16-byte aligned (every MAT width but the 3-channel ToRGB),
// each thread loads and stores one float4 of four neighbouring channels, so
// a warp moves 512 contiguous bytes per access; the bias float4 is read
// through the read-only cache. Otherwise each thread takes one element.
// The activation is a template argument, so the loop body has no branch on
// it. The TPU kernel's 256-row blocking and padding are not carried over.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Act { kLinear = 0, kRelu, kLrelu, kTanh, kSigmoid, kElu, kSelu, kSoftplus, kSwish };

template <int A>
__device__ __forceinline__ float act(float x) {
  if (A == kLinear) return x;
  if (A == kRelu) return fmaxf(x, 0.f);
  if (A == kLrelu) return x >= 0.f ? x : x * 0.2f;
  if (A == kTanh) return tanhf(x);
  if (A == kSigmoid) return 1.f / (1.f + expf(-x));
  if (A == kElu) return x >= 0.f ? x : expm1f(x);
  if (A == kSelu) return 1.0507009873554805f * (x >= 0.f ? x : 1.6732632423543772f * expm1f(x));
  if (A == kSoftplus) return log1pf(expf(-fabsf(x))) + fmaxf(x, 0.f);
  // kSwish
  return x / (1.f + expf(-x));
}

template <int A>
__device__ __forceinline__ float apply(float x, float b, float gain, float clamp) {
  float y = act<A>(x + b) * gain;
  if (clamp >= 0.f) y = fminf(fmaxf(y, -clamp), clamp);
  return y;
}

// C % 4 == 0: thread v takes elements [4v, 4v + 4), channels c .. c + 3
template <int A>
__global__ void __launch_bounds__(kThreads) bias_act_vec4_kernel(
    const float4* __restrict__ x, const float4* __restrict__ b, float4* __restrict__ y,
    int64_t nvec, int cvec, float gain, float clamp) {
  const int64_t v = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (v >= nvec) return;
  const float4 xv = x[v];
  const float4 bv = b ? __ldg(&b[v % cvec]) : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 out;
  out.x = apply<A>(xv.x, bv.x, gain, clamp);
  out.y = apply<A>(xv.y, bv.y, gain, clamp);
  out.z = apply<A>(xv.z, bv.z, gain, clamp);
  out.w = apply<A>(xv.w, bv.w, gain, clamp);
  y[v] = out;
}

template <int A>
__global__ void __launch_bounds__(kThreads) bias_act_scalar_kernel(
    const float* __restrict__ x, const float* __restrict__ b, float* __restrict__ y,
    int64_t n, int C, float gain, float clamp) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  y[i] = apply<A>(x[i], b ? __ldg(&b[i % C]) : 0.f, gain, clamp);
}

template <int A>
void launch(const float* x, const float* b, float* y, int64_t n, int C, float gain,
            float clamp, cudaStream_t s) {
  const bool vec = C % 4 == 0 && ((uintptr_t)x | (uintptr_t)y | (uintptr_t)b) % 16 == 0;
  if (vec) {
    const int64_t nvec = n / 4;
    const unsigned blocks = (unsigned)((nvec + kThreads - 1) / kThreads);
    bias_act_vec4_kernel<A><<<blocks, kThreads, 0, s>>>(
        (const float4*)x, (const float4*)b, (float4*)y, nvec, C / 4, gain, clamp);
  } else {
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    bias_act_scalar_kernel<A><<<blocks, kThreads, 0, s>>>(x, b, y, n, C, gain, clamp);
  }
}

}  // namespace

extern "C" int waldo_bias_act(const void* x, const void* b, void* y, int64_t n, int C,
                              int act_id, float gain, float clamp, void* stream) {
  const float* xf = (const float*)x;
  const float* bf = (const float*)b;
  float* yf = (float*)y;
  cudaStream_t s = (cudaStream_t)stream;
  switch (act_id) {
    case kLinear: launch<kLinear>(xf, bf, yf, n, C, gain, clamp, s); break;
    case kRelu: launch<kRelu>(xf, bf, yf, n, C, gain, clamp, s); break;
    case kLrelu: launch<kLrelu>(xf, bf, yf, n, C, gain, clamp, s); break;
    case kTanh: launch<kTanh>(xf, bf, yf, n, C, gain, clamp, s); break;
    case kSigmoid: launch<kSigmoid>(xf, bf, yf, n, C, gain, clamp, s); break;
    case kElu: launch<kElu>(xf, bf, yf, n, C, gain, clamp, s); break;
    case kSelu: launch<kSelu>(xf, bf, yf, n, C, gain, clamp, s); break;
    case kSoftplus: launch<kSoftplus>(xf, bf, yf, n, C, gain, clamp, s); break;
    case kSwish: launch<kSwish>(xf, bf, yf, n, C, gain, clamp, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* waldo_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
