// Staging helpers the tiled kernels share: cp.async copies from device
// memory into shared memory (no register round trip; a commit group per
// batch of copies, a wait for all but the newest kPending groups), and exact
// conversions between u8 pixel bytes and float32 by integer permutes and
// float adds, which run at four times the rate of the conversion unit.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace vfp {

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
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

// rint(f) for f in [0, 255]: adding 1.5 * 2^23 rounds to a whole number,
// half to even as jnp.round does, and leaves it in the low mantissa bits.
__device__ __forceinline__ uint32_t float_to_byte(float f) {
  return __float_as_uint(f + 12582912.0f) & 0xffu;
}

}  // namespace vfp
