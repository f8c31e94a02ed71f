// The tile helpers that the three synthesis kernels share: the q-shift
// synthesis (dtcwt_synthesis.cu qshift_kernel), the LeGall synthesis
// (dtcwt_synthesis.cu legall_kernel) and the embed delta's three-level chain
// (dtcwt_delta.cu).  One 1-D synthesis stage, with y2 the zero-upsampled
// input (y2[2a + phase] = y[a]) and its roll folded into the index n,
//
//   up2[n] = sum_k f[k] * y2[n - k]           (k from 0 upward),
//
// sums only the taps that hit a sample, k = k0, k0 + 2, ... with k0 the
// parity of n - phase, in that order: the plain versions fold over every
// tap, and adding their exact zeros leaves a float sum unchanged (the build
// has --fmad=false and no fast-math).  A tile reads its input from a window
// in shared memory whose origin is chosen so that output t of a run reads
// window sample (t + kOff - k) / 2: every tap and every index is a
// compile-time operand.
#pragma once

#include <cuda_runtime.h>

#include "staging.cuh"  // cp.async

namespace vfp {
namespace tiles {

// a tap times a sample, and a sum, lane by lane for the vector types
__device__ __forceinline__ float vmul(float f, float y) { return f * y; }
__device__ __forceinline__ float2 vmul(float f, float2 y) { return make_float2(f * y.x, f * y.y); }
__device__ __forceinline__ float4 vmul(float f, float4 y) {
  return make_float4(f * y.x, f * y.y, f * y.z, f * y.w);
}
__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float2 vadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// One up2 stage at an output whose taps hit the input at parity kK0: sum_k
// f[k] * y[((kOff - k) / 2) * kStride], k = kK0, kK0 + 2, ... < kTaps, in
// that order (kOff - kK0 is even).  Taps and indices are compile-time.
template <int kTaps, int kK0, int kOff, int kStride>
__device__ __forceinline__ float up2_tile(const float* f, const float* y) {
  float acc = f[kK0] * y[(kOff - kK0) / 2 * kStride];
#pragma unroll
  for (int k = kK0 + 2; k < kTaps; k += 2) acc = acc + f[k] * y[(kOff - k) / 2 * kStride];
  return acc;
}

// the same on 4 neighbouring outputs at once, each lane its own column
template <int kTaps, int kK0, int kOff, int kStride>
__device__ __forceinline__ float4 up2_tile4(const float* f, const float* y) {
  float4 acc = vmul(f[kK0], *reinterpret_cast<const float4*>(y + (kOff - kK0) / 2 * kStride));
#pragma unroll
  for (int k = kK0 + 2; k < kTaps; k += 2)
    acc = vadd(acc, vmul(f[k], *reinterpret_cast<const float4*>(y + (kOff - k) / 2 * kStride)));
  return acc;
}

// samples a run of kN outputs reads: output t of the run reads v[(t + kOff -
// k) / 2], at most v[(kN - 1 + kOff) / 2]
__host__ __device__ constexpr int run_len(int kN, int kOff) { return (kN - 1 + kOff) / 2 + 1; }

// kN neighbouring outputs of one stage from samples held in registers (one
// shared read feeds every tap and output that uses the sample): out[t] =
// sum_k f[k] * v[(t + kOff - k) / 2] over the taps k < kTaps with k = t +
// kOff (mod 2), from the lowest upward.  T is float, float2 or float4 (the
// lanes: neighbouring columns of a row stage).
template <int kTaps, int kOff, int kN, typename T, int kM>
__device__ __forceinline__ void up2_run(const float* f, const T (&v)[kM], T (&out)[kN]) {
  static_assert(run_len(kN, kOff) <= kM, "the run reads past its samples");
#pragma unroll
  for (int t = 0; t < kN; ++t) {
    T acc{};
    bool started = false;  // both loops have constant trips: every branch folds
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      if (((t + kOff - k) & 1) == 0) {
        const T term = vmul(f[k], v[(t + kOff - k) >> 1]);
        acc = started ? vadd(acc, term) : term;
        started = true;
      }
    }
    out[t] = acc;
  }
}

// kM consecutive floats from shared memory at an 8-byte aligned address
template <int kM>
__device__ __forceinline__ void load_run2(const float* src, float (&v)[kM]) {
#pragma unroll
  for (int m = 0; m + 1 < kM; m += 2) {
    const float2 a = *reinterpret_cast<const float2*>(src + m);
    v[m] = a.x;
    v[m + 1] = a.y;
  }
  if constexpr (kM % 2) v[kM - 1] = src[kM - 1];
}

// kM consecutive floats at any address
template <int kM>
__device__ __forceinline__ void load_run1(const float* src, float (&v)[kM]) {
#pragma unroll
  for (int m = 0; m < kM; ++m) v[m] = src[m];
}

// kM vectors a stride apart (a column of float2 or float4 lanes)
template <typename T, int kM>
__device__ __forceinline__ void load_rows(const float* src, int stride, T (&v)[kM]) {
#pragma unroll
  for (int m = 0; m < kM; ++m) v[m] = *reinterpret_cast<const T*>(src + m * stride);
}

}  // namespace tiles
}  // namespace vfp
