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
//
// The symmetric matrices are kept as their upper triangles (see
// dominant_triplet): the same bits with 246 fewer operations a block (524
// instead of 770, counted as chip_smoke.py's FLOPS_PER_UNIT counts them).
// nvcc's common-subexpression elimination finds the same merge in the
// 16-entry form, which compiles to the same instructions; this form states
// it in the source instead of leaving it to the optimiser.
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

// Entry (i, j) of a symmetric 4x4 matrix among its 10 upper-triangle values
// (row-major: (0,0) (0,1) (0,2) (0,3) (1,1) (1,2) (1,3) (2,2) (2,3) (3,3)).
// Not recursive, so that it inlines and every index folds to a constant in
// the unrolled loops: an index left to run time puts the arrays in local
// memory.
__host__ __device__ constexpr int sym(int i, int j) {
  return i <= j ? i * 4 - i * (i - 1) / 2 + (j - i) : j * 4 - j * (j - 1) / 2 + (i - j);
}

// m[r*4+c] is entry (r, c) of the block.  Writes u[4], v[4]; returns s0.
//
// G and every matrix the squarings make are symmetric bit for bit: IEEE
// multiplication commutes exactly, and entry (j, i) sums the same products
// in the same k order as entry (i, j) (for a squaring, because its input is
// symmetric).  So only the 10 entries with i <= j are computed, and (j, i)
// is read from (i, j): 70 operations a product instead of 112.  The
// Frobenius sum keeps its 16 terms in their row-major order, each mirrored
// square added in its own place; the trace and G v0 read the mirrored
// values.  The rounding is the 16-entry form's, op for op.
__device__ __forceinline__ float dominant_triplet(const float m[16], const StartVector& v0,
                                                  float u[4], float v[4]) {
  float g[10];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = a; b < 4; ++b) {
      float acc = m[0 * 4 + a] * m[0 * 4 + b];
#pragma unroll
      for (int r = 1; r < 4; ++r) acc = acc + m[r * 4 + a] * m[r * 4 + b];
      g[sym(a, b)] = acc;
    }
  }

  float sq[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) sq[i] = g[i] * g[i];
  float fro = sq[0];
#pragma unroll
  for (int i = 1; i < 16; ++i) fro = fro + sq[sym(i / 4, i % 4)];
  float inv = inv_sqrt(fmaxf(fro, kEps));
#pragma unroll
  for (int i = 0; i < 10; ++i) g[i] = g[i] * inv;

#pragma unroll
  for (int it = 0; it < 4; ++it) {
    float g2[10];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = i; j < 4; ++j) {
        float acc = g[sym(i, 0)] * g[sym(0, j)];
#pragma unroll
        for (int k = 1; k < 4; ++k) acc = acc + g[sym(i, k)] * g[sym(k, j)];
        g2[sym(i, j)] = acc;
      }
    }
    const float tr = g2[sym(0, 0)] + g2[sym(1, 1)] + g2[sym(2, 2)] + g2[sym(3, 3)];
    const float rinv = 1.0f / fmaxf(tr, kEps);
#pragma unroll
    for (int i = 0; i < 10; ++i) g[i] = g2[i] * rinv;
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float acc = g[sym(i, 0)] * v0.x[0];
#pragma unroll
    for (int j = 1; j < 4; ++j) acc = acc + g[sym(i, j)] * v0.x[j];
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
