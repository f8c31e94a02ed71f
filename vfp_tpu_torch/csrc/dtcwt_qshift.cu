// One q-shift DT-CWT analysis level (levels >= 2) with circular indexing.
//
// Replaces the Pallas kernels of vfp_tpu/kernels/dtcwt_level1.py:
//   qshift_kernel<kLl>  <- dtcwt_qshift_analysis_ll (:685) and its chained
//                          twin dtcwt_qshift_ll_chain (:947): the tree
//                          lowpasses [B, 4, h, w] -> the next level's
//                          lowpasses [B, 4, h/2, w/2];
//   qshift_kernel<kHp>  <- dtcwt_qshift_analysis_hp (:797) and its chained
//                          twin dtcwt_qshift_hp_chain (:972): -> the 12
//                          highpass planes [B, 12, h/2, w/2], [lh*4, hl*4,
//                          hh*4], tree combos (rt, ct) row-major;
//   qshift_kernel<kAll> <- dtcwt_qshift_analysis (:715): -> all 16 planes
//                          [B, 16, h/2, w/2], [ll*4, lh*4, hl*4, hh*4] (the
//                          transform at any depth).
//
// Per tree (rt, ct) with the 14-tap q-shift filters (tree a, tree b its time
// reverse), phase 0 on both axes: a row pass
//   lo[i][x] = sum_k h0r[k] * X[(2i - k) mod h][x],  hi likewise with h1r,
// then a column pass out[i][j] = sum_k g[k] * r[i][(2j - k) mod w] with
// (lo, h0c) for ll and (lo, h1c), (hi, h0c), (hi, h1c) for lh, hl, hh.  Each
// sum is folded from k = 0 upward and rounded to float32 between the passes,
// as the plain version (ops/dtcwt.py:Transform2d.analysis_qshift) does; the
// build has --fmad=false and no fast-math.  Modular indexing covers the
// chained and unchained Pallas twins: no pad copy, no selection matmul, no
// strip or chunk width.
//
// One block of 160 threads makes a 16 x 32 output tile of one tree of one
// frame; its input window is (2 * 16 + 12) x (2 * 32 + 12).
// - Row pass: two threads per window column (152 items), each loading 28
//   inputs of its column straight into registers (a warp reads 32
//   neighbouring columns: coalesced) and computing 8 output rows' lo (and
//   hi) from them, with no shared-memory round trip.  Two items per column
//   rather than one halve each thread's serial chain of taps, which measured
//   faster on an H100 (PERF.md).  Only tiles whose window crosses the top or
//   bottom edge wrap the row index, by a compare (a modulo only on a level
//   smaller than the window); the column index wraps once per thread.  The
//   column load, the row and column taps and the parity loads are
//   qshift_passes.cuh's, which the masks kernel (dtcwt_masks.cu) shares.
// - The row pass writes even and odd window columns to separate shared
//   arrays (kPar apart, 16 mod 32: a warp's even and odd lanes hit disjoint
//   banks), so the column pass reads at unit stride with 16-byte loads.
// - Column pass: 128 threads each make 4 neighbouring outputs of one row for
//   every plane from 20 row-pass values per array held in registers, and
//   store each plane's 4 as one 16-byte store where w/2 % 4 == 0.
// - The tree (rt, ct) is uniform per block: the tile body is a template on
//   it, so every tap is a compile-time operand of the kernel's parameter
//   block (a broadcast constant), not a shared or local array.
// Loads of one block overlap the arithmetic of the other blocks on the SM;
// there is no persistent loop and no asynchronous copy: the loads go
// straight to registers, which a copy to shared memory would only delay.
//
// Bound on the card: memory (16 B read per input position; 4 B (ll), 12 B
// (highpasses) or 16 B (all) written per output position, 1/4 as many)
// against 14 FLOP x 2 per row-pass value and per column-pass value; built
// without multiply-add contraction, the all-planes mode issues about 59
// float32 instructions per input pixel, close to the bytes bound.  The
// window overlaps its neighbours by 13 rows and columns (1.37 x 1.19 of the
// input), served by L2.

#include <cstdint>

#include "qshift_passes.cuh"

namespace vfp {
namespace {

using qshift::col_taps;
using qshift::kTaps;
using qshift::QParams;
using qshift::wrap_near;

constexpr int kTh = 16;                      // output rows per tile
constexpr int kTw = 32;                      // output columns per tile
constexpr int kWc = 2 * kTw + kTaps - 2;     // window columns (76)
constexpr int kSplit = 2;                    // row-pass items per window column
constexpr int kPer = kTh / kSplit;           // output rows per row-pass item (8)
constexpr int kWin = 2 * kPer + kTaps - 2;   // input rows an item loads (28)
constexpr int kItems = kSplit * kWc;         // row-pass items (152)
constexpr int kCol = kTh * kTw / 4;          // column pass: 4 outputs a thread (128)
constexpr int kThreads = 160;                // >= kItems and kCol, whole warps
constexpr int kPar = 48;                     // floats per column parity: >= kWc / 2
constexpr int kRowStride = 2 * kPar;
constexpr int kLl = 0, kHp = 1, kAll = 2;    // the planes a level writes
static_assert(kItems <= kThreads && kCol <= kThreads && kThreads % 32 == 0, "block size");

__device__ __forceinline__ void store4(float* p, const float (&v)[4], int room, bool vec) {
  if (vec && room >= 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (t < room) p[t] = v[t];
  }
}

template <int kMode, int kRt, int kCt, bool kEdge>
__device__ __forceinline__ void tile(const float* __restrict__ xp, float* __restrict__ out,
                                     int h, int w, int i0, int j0, long long b, int ci,
                                     const QParams& k, float (*rows)[kTh][kRowStride]) {
  constexpr int kRows = kMode == kLl ? 1 : 2;  // row-pass outputs: lo (and hi)
  // row pass: item (c, s) takes window column c, input column (2 j0 - 13 +
  // c) mod w, and output rows r0 = s kPer ... r0 + kPer - 1, from input rows
  // 2 (i0 + r0) - 13 ... (mod h on an edge tile)
  if (threadIdx.x < kItems) {
    const int c = threadIdx.x % kWc, r0 = threadIdx.x / kWc * kPer;
    const float* col = xp + wrap_near(2 * j0 - (kTaps - 1) + c, w);
    float v[kWin];
    qshift::load_column<kWin, kEdge>(col, 2 * (i0 + r0) - (kTaps - 1), h, w, v);
#pragma unroll
    for (int fi = 0; fi < kRows; ++fi)
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        rows[fi][r0 + i][(c & 1) * kPar + (c >> 1)] =
            qshift::row_tap(k.h[kRt][fi], v, 2 * i + kTaps - 1);
  }
  __syncthreads();

  // column pass: thread (ii, q) makes outputs (i0 + ii, j0 + 4 q + t), t < 4,
  // from row-pass columns 8 q .. 8 q + 19
  const int ii = threadIdx.x >> 3, q = threadIdx.x & 7;
  const int ho = h / 2, wo = w / 2;
  const int i = i0 + ii, j = j0 + 4 * q;
  if (threadIdx.x >= kCol || i >= ho || j >= wo) return;
  float e[kRows][10], o[kRows][10];
#pragma unroll
  for (int fi = 0; fi < kRows; ++fi) qshift::load_parities<kPar>(&rows[fi][ii][4 * q], e[fi], o[fi]);
  const float* h0c = k.h[kCt][0];
  const float* h1c = k.h[kCt][1];
  const long long plane = (long long)ho * wo;
  const long long o_ij = (long long)i * wo + j;
  const int room = wo - j;
  const bool vec = (wo & 3) == 0;
  float v4[4];
  if constexpr (kMode == kLl) {
#pragma unroll
    for (int t = 0; t < 4; ++t) v4[t] = col_taps(h0c, e[0], o[0], 2 * t + kTaps - 1);
    store4(out + (b * 4 + ci) * plane + o_ij, v4, room, vec);  // ll
  } else {
    constexpr int kPlanes = kMode == kAll ? 16 : 12, kOff = kMode == kAll ? 4 : 0;
    float* ob = out + b * kPlanes * plane + o_ij;
    if constexpr (kMode == kAll) {
#pragma unroll
      for (int t = 0; t < 4; ++t) v4[t] = col_taps(h0c, e[0], o[0], 2 * t + kTaps - 1);
      store4(ob + ci * plane, v4, room, vec);  // ll
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) v4[t] = col_taps(h1c, e[0], o[0], 2 * t + kTaps - 1);
    store4(ob + (kOff + 0 * 4 + ci) * plane, v4, room, vec);  // lh
#pragma unroll
    for (int t = 0; t < 4; ++t) v4[t] = col_taps(h0c, e[1], o[1], 2 * t + kTaps - 1);
    store4(ob + (kOff + 1 * 4 + ci) * plane, v4, room, vec);  // hl
#pragma unroll
    for (int t = 0; t < 4; ++t) v4[t] = col_taps(h1c, e[1], o[1], 2 * t + kTaps - 1);
    store4(ob + (kOff + 2 * 4 + ci) * plane, v4, room, vec);  // hh
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    qshift_kernel(const float* __restrict__ x, float* __restrict__ out, int h, int w,
                  int bstride, QParams k) {
  __shared__ __align__(16) float rows[kMode == kLl ? 1 : 2][kTh][kRowStride];
  const int j0 = blockIdx.x * kTw, i0 = blockIdx.y * kTh;
  const int ci = blockIdx.z % 4;
  const long long b = blockIdx.z / 4;
  const float* xp = x + b * bstride + (long long)ci * h * w;
  const bool edge = 2 * i0 - (kTaps - 1) < 0 || 2 * (i0 + kTh) - 1 > h;
#define VFP_TILE(RT, CT, EDGE) tile<kMode, RT, CT, EDGE>(xp, out, h, w, i0, j0, b, ci, k, rows)
  switch (ci * 2 + (edge ? 1 : 0)) {
    case 0: VFP_TILE(0, 0, false); break;
    case 1: VFP_TILE(0, 0, true); break;
    case 2: VFP_TILE(0, 1, false); break;
    case 3: VFP_TILE(0, 1, true); break;
    case 4: VFP_TILE(1, 0, false); break;
    case 5: VFP_TILE(1, 0, true); break;
    case 6: VFP_TILE(1, 1, false); break;
    default: VFP_TILE(1, 1, true); break;
  }
#undef VFP_TILE
}

template <int kMode>
int launch(const void* x, void* out, int batch, int h, int w, int bstride, const void* params,
           void* stream) {
  const int ho = h / 2, wo = w / 2;
  if (batch == 0 || ho == 0 || wo == 0) return 0;
  const dim3 grid((wo + kTw - 1) / kTw, (ho + kTh - 1) / kTh, 4 * batch);
  qshift_kernel<kMode><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, h, w, bstride, qshift::qparams(params));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace vfp

// Plain C interface, bound with ctypes (kernels/_build.py).  x is a device
// pointer to f32 [B, 4, h, w] (batch stride ``bstride`` floats, the rest
// contiguous; h and w even), out to a contiguous f32 [B, 4, h/2, w/2]
// (qshift_ll), [B, 12, h/2, w/2] (qshift_hp) or [B, 16, h/2, w/2]
// (qshift_analysis) at a 16-byte-aligned address; params is host memory (56
// floats: h0a, h1a, h0b, h1b).  Returns the launch's cudaError_t.

extern "C" int vfp_dtcwt_qshift_ll(const void* x, void* out, int batch, int h, int w,
                                   int bstride, const void* params, void* stream) {
  return vfp::launch<vfp::kLl>(x, out, batch, h, w, bstride, params, stream);
}

extern "C" int vfp_dtcwt_qshift_hp(const void* x, void* out, int batch, int h, int w,
                                   int bstride, const void* params, void* stream) {
  return vfp::launch<vfp::kHp>(x, out, batch, h, w, bstride, params, stream);
}

extern "C" int vfp_dtcwt_qshift_analysis(const void* x, void* out, int batch, int h, int w,
                                         int bstride, const void* params, void* stream) {
  return vfp::launch<vfp::kAll>(x, out, batch, h, w, bstride, params, stream);
}
