// The DT-CWT codecs' perceptual masks in one launch: level-2 q-shift highpass
// analysis -> 6 subband magnitudes -> cv2 2x2 mean filter (reflect-101) ->
// 2x2 mean rebin -> ceil(m / step).
//
// Replaces the Pallas kernels of vfp_tpu/kernels/dtcwt_masks.py:
// dtcwt_qshift_masks (:190) and its chained twin dtcwt_qshift_masks_chain
// (:227).  Input: the Y tree lowpasses [B, 4, h1, w1], f32, h1 and w1 % 4 == 0,
// each batch item's 4 planes contiguous and the items ``bstride`` floats apart
// (so the detect path reads the Y half of [B, 2, 4, h1, w1] in place);
// output: [B, 6, h3, w3] with h3 = h1 / 4, w3 = w1 / 4, bands [LH+, LH-, HL+,
// HL-, HH+, HH-].
//
// One block of 256 threads makes a kTh3 x kTw3 (8 x 24) tile of mask outputs
// of one frame, with nothing in between touching device memory.  Its window
// is 17 x 49 level-2 positions (rows 2 r0 - 1 .. 2 r0 + 15, columns 2 c0 - 1
// ..; the extra row and column feed the mean filter) and 46 x 110 level-1
// inputs per tree, 1.65 times the tile's own 32 x 96.
//   1. Row pass (qshift_passes.cuh, as dtcwt_qshift.cu's): thread (rt, x)
//      loads window column x of tree (rt, 0), then of tree (rt, 1), straight
//      into registers, 46 rows (a warp's lanes take neighbouring columns:
//      coalesced), and makes the tree's 17 lo and 17 hi values from those
//      registers: each input is loaded once per tile, never once for lo and
//      again for hi.  The row tree rt is uniform per warp, so the taps are
//      compile-time operands.  Even and odd columns go to separate shared
//      arrays.  Only tiles whose window crosses the top or bottom edge wrap
//      the row index, by a compare; the column index wraps once per thread.
//   2. Column pass: thread (s, q) makes level-2 positions 4q .. 4q + 3 of
//      window row s (221 threads, one round): lh = sum_k h1c[k] lo[2j - k]
//      of the 4 trees, then hl = sum_k h0c[k] hi[..] and hh = sum_k h1c[k]
//      hi[..], each tree's 10 even and 10 odd lo (hi) values read as 16-byte
//      loads at unit stride and its column taps constants; then the 6
//      magnitudes |zp| = 0.5 sqrt((aa - bb)^2 + (ab + ba)^2), |zm| = 0.5
//      sqrt((aa + bb)^2 + (ab - ba)^2) in registers.  After a barrier they go
//      to shared memory over the row-pass values, which are no longer read.
//   3. Epilogue: per mask output and band, the mean filter at the 4 level-2
//      positions it rebins, 0.25 (((x[i-1,j-1] + x[i-1,j]) + x[i,j-1]) +
//      x[i,j]), the rebin 0.25 (((m00 + m01) + m10) + m11), and ceilf(v /
//      step); stores are coalesced along w3.
// The reflect-101 edge of cv2's filter is at the top row and left column of
// the level-2 grid (row -1 == row 1), never the circular wrap: the window's
// row (column) 0 of the first tile row (column) is computed circularly and
// then not read; the epilogue reads window row (column) 2, level-2 row
// (column) 1, in its place.  Every other index is circular.  ceil turns a
// last-bit difference into a whole step, so the plain version in
// kernels/dtcwt_masks.py folds in this order; the build has --fmad=false and
// no fast-math, so division and sqrt are IEEE.
//
// Bound on the card: memory (16 B read per level-1 position, 24 B written
// per mask output, a 16:1 reduction) against about 3.3 kFLOP per mask
// output; built without multiply-add contraction its float32 instructions
// take about as long as the bytes.  The row pass computes 1.28x and the column
// pass 1.15x the values the tile's own outputs need; the window's input
// overlap is served by L2.

#include <cstdint>

#include "qshift_passes.cuh"

namespace vfp {
namespace {

using qshift::col_taps;
using qshift::kTaps;
using qshift::QParams;

constexpr int kTh3 = 8;                      // mask rows per tile
constexpr int kTw3 = 24;                     // mask columns per tile
constexpr int kWin = 2 * kTh3 + 1;           // level-2 rows of the window (17)
constexpr int kWc2 = 2 * kTw3 + 1;           // level-2 columns of the window (49)
constexpr int kQuads = (kWc2 + 3) / 4;       // column pass: 4 positions a thread (13)
constexpr int kXWin = 8 * kQuads + 12;       // level-1 columns it reads (116 >= 4 kTw3 + 14)
constexpr int kYWin = 2 * kWin + kTaps - 2;  // level-1 rows a row-pass thread loads (46)
constexpr int kPar = 60;                     // floats per column parity: >= kXWin / 2, % 4 == 0
constexpr int kRowStride = 2 * kPar;
constexpr int kThreads = 256;
constexpr int kPerRt = kThreads / 2;         // row-pass threads per row tree (whole warps)
constexpr int kCol = kWin * kQuads;          // column-pass threads (221)
constexpr int kMagStride = 4 * kQuads;       // magnitudes: [6][kWin][kMagStride]
constexpr int kLohiFloats = 4 * 2 * kWin * kRowStride;
constexpr int kSmemBytes = kLohiFloats * 4;  // 65,280: above 48 KB, so dynamic
static_assert(kXWin <= kPerRt && kCol <= kThreads && 6 * kWin * kMagStride <= kLohiFloats,
              "tile geometry");

// lohi[ci][fi][s][column]: the row pass of tree ci (fi 0 lo, 1 hi) at window
// row s, even window columns at [0, kPar), odd ones at [kPar, 2 kPar)
__device__ __forceinline__ float* lohi_row(float* lohi, int ci, int fi, int s) {
  return lohi + ((ci * 2 + fi) * kWin + s) * kRowStride;
}

template <int kRt, bool kEdge>
__device__ __forceinline__ void row_pass(const float* __restrict__ xb, int h1, int w1, int r0,
                                         int c0, int x, const QParams& k, float* lohi) {
  const long long plane = (long long)h1 * w1;
  const int col = qshift::wrap_near(4 * c0 - 15 + x, w1);
  const int slot = (x & 1) * kPar + (x >> 1);
  // one tree after the other: with their loads interleaved, the kernel
  // spilled at its 80-register cap and ran slower
#pragma unroll 1
  for (int ct = 0; ct < 2; ++ct) {
    const int ci = 2 * kRt + ct;
    float v[kYWin];  // level-1 rows 4 r0 - 15 ...: window row s reads v[2s + 13 - k]
    qshift::load_column<kYWin, kEdge>(xb + ci * plane + col, 4 * r0 - 15, h1, w1, v);
#pragma unroll
    for (int fi = 0; fi < 2; ++fi)
#pragma unroll
      for (int s = 0; s < kWin; ++s)
        lohi_row(lohi, ci, fi, s)[slot] = qshift::row_tap(k.h[kRt][fi], v, 2 * s + kTaps - 1);
  }
}

// the highpasses of tree (., kCt) at 4 neighbouring level-2 positions of one
// window row: lh from its lo values, or hl and hh from its hi values
template <int kCt>
__device__ __forceinline__ void lo_highpass(const float* lo, const QParams& k, float (&lh)[4]) {
  float e[10], o[10];
  qshift::load_parities<kPar>(lo, e, o);
#pragma unroll
  for (int t = 0; t < 4; ++t) lh[t] = col_taps(k.h[kCt][1], e, o, 2 * t + kTaps - 1);
}

template <int kCt>
__device__ __forceinline__ void hi_highpasses(const float* hi, const QParams& k, float (&hl)[4],
                                              float (&hh)[4]) {
  float e[10], o[10];
  qshift::load_parities<kPar>(hi, e, o);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    hl[t] = col_taps(k.h[kCt][0], e, o, 2 * t + kTaps - 1);
    hh[t] = col_taps(k.h[kCt][1], e, o, 2 * t + kTaps - 1);
  }
}

__device__ __forceinline__ float magnitude(float d, float e) { return 0.5f * sqrtf(d * d + e * e); }

__global__ void __launch_bounds__(kThreads, 3)
    masks_kernel(const float* __restrict__ ll4, float* __restrict__ out, int h1, int w1,
                 int bstride, float step, QParams k) {
  extern __shared__ __align__(16) float smem[];
  float* lohi = smem;
  float* mags = smem;  // after the column pass, over lohi
  const int h3 = h1 / 4, w3 = w1 / 4;
  const int c0 = blockIdx.x * kTw3, r0 = blockIdx.y * kTh3;
  const float* xb = ll4 + (long long)blockIdx.z * bstride;

  // 1. row pass
  const int x = threadIdx.x % kPerRt;
  if (x < kXWin) {
    const bool edge = 4 * r0 - 15 < 0 || 4 * r0 - 15 + kYWin > h1;
    const bool rt = threadIdx.x >= kPerRt;
    if (rt) {
      if (edge) row_pass<1, true>(xb, h1, w1, r0, c0, x, k, lohi);
      else row_pass<1, false>(xb, h1, w1, r0, c0, x, k, lohi);
    } else {
      if (edge) row_pass<0, true>(xb, h1, w1, r0, c0, x, k, lohi);
      else row_pass<0, false>(xb, h1, w1, r0, c0, x, k, lohi);
    }
  }
  __syncthreads();

  // 2. column pass and magnitudes: thread (s, q), positions 4q .. 4q + 3 of
  // window row s, from row-pass columns 8q .. 8q + 19
  const int s = threadIdx.x / kQuads, q = threadIdx.x % kQuads;
  float m[6][4];
  if (threadIdx.x < kCol) {
    // band by band, so that at most the 32 hl and hh values of the 4 trees
    // and one tree's 20 row-pass values are live beside the magnitudes
    const float* row = lohi_row(lohi, 0, 0, s) + 4 * q;  // tree ci, fi at + (2 ci + fi) kWin rows
    constexpr int kTree = 2 * kWin * kRowStride, kHi = kWin * kRowStride;
    float lh[4][4], hl[4][4], hh[4][4];  // [tree][position]
    lo_highpass<0>(row, k, lh[0]);
    lo_highpass<1>(row + kTree, k, lh[1]);
    lo_highpass<0>(row + 2 * kTree, k, lh[2]);
    lo_highpass<1>(row + 3 * kTree, k, lh[3]);
#pragma unroll
    for (int t = 0; t < 4; ++t) {  // trees aa, ab, ba, bb
      m[0][t] = magnitude(lh[0][t] - lh[3][t], lh[1][t] + lh[2][t]);
      m[1][t] = magnitude(lh[0][t] + lh[3][t], lh[1][t] - lh[2][t]);
    }
    hi_highpasses<0>(row + kHi, k, hl[0], hh[0]);
    hi_highpasses<1>(row + kTree + kHi, k, hl[1], hh[1]);
    hi_highpasses<0>(row + 2 * kTree + kHi, k, hl[2], hh[2]);
    hi_highpasses<1>(row + 3 * kTree + kHi, k, hl[3], hh[3]);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      m[2][t] = magnitude(hl[0][t] - hl[3][t], hl[1][t] + hl[2][t]);
      m[3][t] = magnitude(hl[0][t] + hl[3][t], hl[1][t] - hl[2][t]);
      m[4][t] = magnitude(hh[0][t] - hh[3][t], hh[1][t] + hh[2][t]);
      m[5][t] = magnitude(hh[0][t] + hh[3][t], hh[1][t] - hh[2][t]);
    }
  }
  __syncthreads();  // every row-pass value read: the magnitudes may overwrite them
  if (threadIdx.x < kCol) {
#pragma unroll
    for (int band = 0; band < 6; ++band)
      *reinterpret_cast<float4*>(mags + (band * kWin + s) * kMagStride + 4 * q) =
          make_float4(m[band][0], m[band][1], m[band][2], m[band][3]);
  }
  __syncthreads();

  // 3. mean filter, rebin, quantize: mask output (r, c) rebins level-2
  // positions (2r + di, 2c + dj), whose mean filter reads window rows 2 tr +
  // di, 2 tr + di + 1 and columns 2 tc + dj, 2 tc + dj + 1; level-2 row
  // (column) -1 reads row (column) 1, window slot 2
  for (int it = threadIdx.x; it < 6 * kTh3 * kTw3; it += kThreads) {
    const int tc = it % kTw3, tr = (it / kTw3) % kTh3, band = it / (kTw3 * kTh3);
    const int r = r0 + tr, c = c0 + tc;
    if (r >= h3 || c >= w3) continue;
    const float* mb = mags + band * kWin * kMagStride;
    const int rows[3] = {r == 0 ? 2 : 2 * tr, 2 * tr + 1, 2 * tr + 2};
    const int cols[3] = {c == 0 ? 2 : 2 * tc, 2 * tc + 1, 2 * tc + 2};
    float mm[2][2];
#pragma unroll
    for (int di = 0; di < 2; ++di)
#pragma unroll
      for (int dj = 0; dj < 2; ++dj) {
        const float* up = mb + rows[di] * kMagStride;
        const float* dn = mb + rows[di + 1] * kMagStride;
        mm[di][dj] = 0.25f * (((up[cols[dj]] + up[cols[dj + 1]]) + dn[cols[dj]]) + dn[cols[dj + 1]]);
      }
    const float v = (((mm[0][0] + mm[0][1]) + mm[1][0]) + mm[1][1]) * 0.25f;
    out[(((long long)blockIdx.z * 6 + band) * h3 + r) * w3 + c] = ceilf(v / step);
  }
}

}  // namespace
}  // namespace vfp

// Plain C interface, bound with ctypes (kernels/_build.py).  ll4/out are
// device pointers to f32 [B, 4, h1, w1] (batch stride ``bstride`` floats,
// the rest contiguous) and a contiguous [B, 6, h1/4, w1/4]; params is host
// memory (56 floats: h0a, h1a, h0b, h1b).  Returns the launch's cudaError_t.
extern "C" int vfp_dtcwt_qshift_masks(const void* ll4, void* out, int batch, int h1, int w1,
                                      int bstride, float step, const void* params,
                                      void* stream) {
  const int h3 = h1 / 4, w3 = w1 / 4;
  if (batch == 0 || h3 == 0 || w3 == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(vfp::masks_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         vfp::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w3 + vfp::kTw3 - 1) / vfp::kTw3, (h3 + vfp::kTh3 - 1) / vfp::kTh3, batch);
  vfp::masks_kernel<<<grid, vfp::kThreads, vfp::kSmemBytes, (cudaStream_t)stream>>>(
      (const float*)ll4, (float*)out, h1, w1, bstride, step, vfp::qshift::qparams(params));
  return (int)cudaGetLastError();
}
