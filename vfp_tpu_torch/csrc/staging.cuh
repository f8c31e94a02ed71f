// Staging helpers the tiled kernels share: cp.async copies from device
// memory into shared memory (no register round trip; a commit group per
// batch of copies, a wait for all but the newest kPending groups), exact
// conversions between u8 pixel bytes and float32 by integer permutes and
// float adds, which run at four times the rate of the conversion unit, or by
// the conversion unit where float issue is the scarcer resource, a byte of a
// word by one permute, and the strides of u8 planes with the test for the
// interleaved view.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace vfp {

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// both addresses 8-byte aligned
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

// both addresses 16-byte aligned; bypasses L1
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The low byte of v as a float, exactly: 2^23 + byte, minus 2^23.
__device__ __forceinline__ float byte_to_float(uint32_t v) {
  return __uint_as_float(0x4B000000u | (v & 0xffu)) - 8388608.0f;
}

// Byte k of w as a float, exactly: one byte permute that puts it under the
// exponent of 2^23 (bytes k, 0, 0, 0x4B) and the add of byte_to_float, where
// byte_to_float(w >> 8 k) compiles to a shift and two logic operations more.
__device__ __forceinline__ float word_byte_to_float(uint32_t w, int k) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | k)) - 8388608.0f;
}

// Byte k of w, zero-extended, by one byte permute (an integer instruction).
__device__ __forceinline__ uint32_t word_byte(uint32_t w, int k) {
  return __byte_perm(w, 0u, 0x4440 | k);
}

// The low byte of v as a float, exactly, by the conversion unit: one
// instruction at a quarter of the float rate, for kernels whose float issue
// is the scarcer resource.
__device__ __forceinline__ float byte_to_float_cvt(uint32_t v) {
  float f;
  asm("cvt.rn.f32.u8 %0, %1;" : "=f"(f) : "r"(v));
  return f;
}

// rint(f) for f in [0, 255]: adding 1.5 * 2^23 rounds to a whole number,
// half to even as jnp.round does, and leaves it in the low mantissa bits.
__device__ __forceinline__ uint32_t float_to_byte(float f) {
  return __float_as_uint(f + 12582912.0f) & 0xffu;
}

// rint(clip(f, 0, 255)) as a byte, half to even, in one conversion that
// rounds and saturates (below 0 and NaN give 0, as fminf(fmaxf(f, 0), 255)
// then rint do; above 255 gives 255).
__device__ __forceinline__ uint32_t float_to_byte_sat(float f) {
  uint32_t u;
  asm("cvt.rni.sat.u8.f32 %0, %1;" : "=r"(u) : "f"(f));
  return u;
}

// Element strides of u8 planes [B, 3, H, W] (bytes), from the 4 int64 the
// wrappers pass in host memory.
struct Strides {
  long long b, c, h, w;
};

inline Strides strides(const void* host_strides) {
  const long long* p = static_cast<const long long*>(host_strides);
  return Strides{p[0], p[1], p[2], p[3]};
}

// Whether planes at p are the [B, 3, H, W] view of an interleaved [B, H, W,
// 3] batch (channel stride 1, pixel stride 3) whose rows and batch items are
// n-byte aligned.
inline bool interleaved(const void* p, const Strides& s, int n) {
  return s.c == 1 && s.w == 3 && reinterpret_cast<uintptr_t>(p) % n == 0 && s.h % n == 0 &&
         s.b % n == 0;
}

}  // namespace vfp
