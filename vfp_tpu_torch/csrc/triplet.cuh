// Dominant singular triplet of one 4x4 block, and the QIM rules on its s0.
//
// The body shared by every kernel of the flagship codec: the CUDA counterpart
// of vfp_tpu/kernels/qim.py:_triplet_core, op for op and in the same order, so
// that with IEEE division and square root and no FMA contraction (the build
// passes --fmad=false and no fast-math flag) it rounds as the plain PyTorch
// versions in kernels/qim.py do.  QIM bins are float32-fragile: a reordered
// sum moves s0 by an ulp, and an s0 on a bin edge then lands in the other bin.
//
//   G = BᵀB; one Frobenius normalisation (1/sqrt); four squarings, each
//   renormalised by the exact reciprocal of its trace; v = normalize(G v0);
//   bv = B v; s0 = |bv|; u = bv / s0, with the eps guards of the reference.
#pragma once

#include <cuda_runtime.h>

namespace vfp {

constexpr float kEps = 1e-20f;

// Start vector of the power step, passed from Python (ops/soa.py:_V0) so it
// holds the reference's float32 bits.
struct StartVector {
  float x[4];
};

__device__ __forceinline__ float inv_sqrt(float x) { return 1.0f / sqrtf(x); }

// m[r*4+c] is entry (r, c) of the block.  Writes u[4], v[4]; returns s0.
__device__ __forceinline__ float dominant_triplet(const float m[16], const StartVector& v0,
                                                  float u[4], float v[4]) {
  float g[16];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      float acc = m[0 * 4 + a] * m[0 * 4 + b];
#pragma unroll
      for (int r = 1; r < 4; ++r) acc = acc + m[r * 4 + a] * m[r * 4 + b];
      g[a * 4 + b] = acc;
    }
  }

  float fro = g[0] * g[0];
#pragma unroll
  for (int i = 1; i < 16; ++i) fro = fro + g[i] * g[i];
  float inv = inv_sqrt(fmaxf(fro, kEps));
#pragma unroll
  for (int i = 0; i < 16; ++i) g[i] = g[i] * inv;

#pragma unroll
  for (int it = 0; it < 4; ++it) {
    float g2[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float acc = g[i * 4 + 0] * g[0 * 4 + j];
#pragma unroll
        for (int k = 1; k < 4; ++k) acc = acc + g[i * 4 + k] * g[k * 4 + j];
        g2[i * 4 + j] = acc;
      }
    }
    const float tr = g2[0] + g2[5] + g2[10] + g2[15];
    const float rinv = 1.0f / fmaxf(tr, kEps);
#pragma unroll
    for (int i = 0; i < 16; ++i) g[i] = g2[i] * rinv;
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float acc = g[i * 4 + 0] * v0.x[0];
#pragma unroll
    for (int j = 1; j < 4; ++j) acc = acc + g[i * 4 + j] * v0.x[j];
    v[i] = acc;
  }
  const float vn = v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + v[3] * v[3];
  const bool bad = vn <= kEps;
  inv = inv_sqrt(fmaxf(vn, kEps));
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = bad ? v0.x[i] : v[i] * inv;

  float bv[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float acc = m[r * 4 + 0] * v[0];
#pragma unroll
    for (int c = 1; c < 4; ++c) acc = acc + m[r * 4 + c] * v[c];
    bv[r] = acc;
  }
  const float s0sq = bv[0] * bv[0] + bv[1] * bv[1] + bv[2] * bv[2] + bv[3] * bv[3];
  const float s0 = sqrtf(s0sq);
  const bool zero = s0 <= kEps;
  inv = inv_sqrt(fmaxf(s0sq, kEps));
#pragma unroll
  for (int r = 0; r < 4; ++r) u[r] = zero ? (r == 0 ? 1.0f : 0.0f) : bv[r] * inv;
  return s0;
}

// QIM embed target: s0' = (floor(s0 / scale) + 0.25 + 0.5 * bit) * scale.
__device__ __forceinline__ float qim_target(float s0, float bit, float scale) {
  return (floorf(s0 / scale) + 0.25f + 0.5f * bit) * scale;
}

// QIM decode: bit = (s0 mod scale) > scale / 2 (s0 >= 0, so fmod is the mod).
__device__ __forceinline__ float qim_bit(float s0, float scale) {
  return fmodf(s0, scale) > scale * 0.5f ? 1.0f : 0.0f;
}

}  // namespace vfp
