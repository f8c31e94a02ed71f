// The q-shift analysis passes that dtcwt_qshift.cu (one level of the
// transform) and dtcwt_masks.cu (the level-2 highpasses under the masks)
// share: the 14-tap filters of trees a and b at phase 0, a row pass whose
// inputs sit in registers, and a column pass over row-pass values kept in
// shared memory with even and odd columns apart.
//
//   row pass     lo[i][x] = sum_k h0r[k] * X[(2i - k) mod h][x]   (hi: h1r)
//   column pass  out[i][j] = sum_k f[k] * r[i][(2j - k) mod w]
//
// Each sum is folded from k = 0 upward and rounded to float32 between the
// passes, as the plain version (ops/dtcwt.py:Transform2d.analysis_qshift)
// does; the build has --fmad=false and no fast-math.  Callers index the
// filters with compile-time tree and band, so every tap is an operand of
// the kernel's parameter block (a broadcast constant), not a shared or
// local array.
#pragma once

#include <cuda_runtime.h>

namespace vfp {
namespace qshift {

constexpr int kTaps = 14;

// q-shift analysis filters from Python (kernels/dtcwt_masks.py:_params_host).
struct QParams {
  float h[2][2][kTaps];  // [tree a/b][h0/h1][k]
};

inline QParams qparams(const void* host_params) {
  QParams k;
  const float* p = static_cast<const float*>(host_params);
  for (int t = 0; t < 2; ++t)
    for (int f = 0; f < 2; ++f)
      for (int i = 0; i < kTaps; ++i) k.h[t][f][i] = p[(t * 2 + f) * kTaps + i];
  return k;
}

__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// i mod n: a compare and an add where i lies within one period of [0, n),
// a modulo only for planes smaller than the window that reads them.
__device__ __forceinline__ int wrap_near(int i, int n) {
  if (i < 0) return i >= -n ? i + n : wrap(i, n);
  return i < n ? i : (i < 2 * n ? i - n : wrap(i, n));
}

// Rows row0 .. row0 + kRows - 1 of one input column (``col`` points at its
// row 0, rows ``w`` floats apart) into registers.  A warp's lanes take
// neighbouring columns, so each load is coalesced.  On an edge tile
// (kEdge) the row index wraps at h by a compare, once per row.
template <int kRows, bool kEdge>
__device__ __forceinline__ void load_column(const float* __restrict__ col, int row0, int h, int w,
                                            float (&v)[kRows]) {
  if constexpr (kEdge) {
    int row = wrap_near(row0, h);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      v[r] = col[(long long)row * w];
      row = row + 1 == h ? 0 : row + 1;
    }
  } else {
    const float* p = col + (long long)row0 * w;
#pragma unroll
    for (int r = 0; r < kRows; ++r) v[r] = p[(long long)r * w];
  }
}

// One row-pass value, sum_k f[k] * v[last - k], k from 0 upward: v[last]
// is input row 2i of output row i.
template <int kRows>
__device__ __forceinline__ float row_tap(const float* f, const float (&v)[kRows], int last) {
  float acc = f[0] * v[last];
#pragma unroll
  for (int k = 1; k < kTaps; ++k) acc = acc + f[k] * v[last - k];
  return acc;
}

// sum_k f[k] * r(d0 - k), k from 0 upward, where r(d) is the row-pass
// column 8 q + d of a thread's window: even d at e[d / 2], odd d at o[d / 2].
__device__ __forceinline__ float col_taps(const float* f, const float* e, const float* o,
                                          int d0) {
  float acc = f[0] * ((d0 & 1) ? o[d0 >> 1] : e[d0 >> 1]);
#pragma unroll
  for (int k = 1; k < kTaps; ++k) {
    const int d = d0 - k;
    acc = acc + f[k] * ((d & 1) ? o[d >> 1] : e[d >> 1]);
  }
  return acc;
}

// The 10 even and 10 odd row-pass columns 8 q .. 8 q + 19 that 4
// neighbouring column-pass outputs read, from a row whose even columns
// start at ``src`` and odd ones kPar floats later (16-byte aligned).
template <int kPar>
__device__ __forceinline__ void load_parities(const float* src, float (&e)[10], float (&o)[10]) {
#pragma unroll
  for (int par = 0; par < 2; ++par) {
    float* dst = par ? o : e;
    const float4 a = *reinterpret_cast<const float4*>(src + par * kPar);
    const float4 c4 = *reinterpret_cast<const float4*>(src + par * kPar + 4);
    const float2 d2 = *reinterpret_cast<const float2*>(src + par * kPar + 8);
    dst[0] = a.x, dst[1] = a.y, dst[2] = a.z, dst[3] = a.w;
    dst[4] = c4.x, dst[5] = c4.y, dst[6] = c4.z, dst[7] = c4.w;
    dst[8] = d2.x, dst[9] = d2.y;
  }
}

}  // namespace qshift
}  // namespace vfp
