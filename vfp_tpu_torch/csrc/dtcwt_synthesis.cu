// DT-CWT synthesis levels with circular indexing: the q-shift levels (>= 2)
// and the LeGall level 1, each one launch over all 4 trees.
//
// Replaces the Pallas kernels of vfp_tpu/kernels/dtcwt_synthesis.py:
//   qshift_kernel<true>  <- dtcwt_qshift_synthesis (:273): [B, 16, h, w] planes
//                           [ll*4, lh*4, hl*4, hh*4] (tree combos (rt, ct)
//                           row-major) -> the level below's tree lowpasses
//                           [B, 4, 2h, 2w], before any crop;
//   qshift_kernel<false> <- dtcwt_qshift_synthesis_ll (:497): [B, 4, h, w] tree
//                           lowpasses with zero highpasses -> [B, 4, 2h, 2w];
//   legall_kernel<kAll>  <- dtcwt_legall_synthesis (:299): [B, 16, h, w] level-1
//                           planes -> the reconstruction [B, 2h, 2w];
//   legall_kernel<kLl>   <- dtcwt_legall_synthesis_ll (:523): [B, 4, h, w] tree
//                           lowpasses with zero highpasses -> [B, 2h, 2w];
//   legall_kernel<kHp>   <- dtcwt_legall_synthesis_hp (:467): [B, 12, h, w]
//                           planes [lh*4, hl*4, hh*4] with a zero lowpass ->
//                           [B, 2h, 2w].
//
// Per tree (rt, ct), as ops/dtcwt.py:Transform2d's synthesis blocks compute
// it, with the filters g0/g1 of the column tree (c) and of the row tree (r):
//   lo = up2(ll, g0c) + up2(lh, g1c),  hi = up2(hl, g0c) + up2(hh, g1c)   (along W)
//   x  = up2(lo, g0r) + up2(hi, g1r)                                      (along H)
// rolled on both axes, out[i][j] = x[(i - roll_r) mod 2h][(j - roll_c) mod 2w].
// The q-shift levels keep the 4 trees apart (phase 0, tree b's filters the
// time reverse of tree a's, its own roll); the LeGall level samples tree rt
// (ct) at row (column) phase rt (ct), rolls by LEGALL_ROLL and averages,
// (((x_00 + x_01) + x_10) + x_11) * 0.25.  Where a band is zero (the _ll and
// _hp twins) its terms are left out.  One 1-D stage, with y2 the
// zero-upsampled input (y2[2a + phase] = y[a]), is
//   up2(y, f, phase)[n] = sum_k f[k] * y2[(n - k) mod 2N]      (k from 0 upward)
// and only the taps that hit a sample are summed: k = k0, k0 + 2, ... with k0
// the parity of n - phase.  Each up2 is its own sum, and the bands add in
// the order above: interleaving two filters' taps in one accumulator would
// change bits.  The plain versions add the zero terms too, and adding an
// exact zero leaves a float sum unchanged; the build has --fmad=false, so
// both round alike.  Odd h and w are fine: every index is taken modulo the
// level's own size, and the caller crops the inter-level sizes.
//
// The q-shift kernels (both modes share one template): one block of 256
// threads makes a 32 x 64 output tile of one (frame, tree combo).
// - The block's tree is uniform, so it dispatches once to a body templated
//   on (rt, ct) and the rolls' parity (both -13): every tap is a
//   compile-time operand of the parameter block, every window offset a
//   constant, and no parity is decided at run time.
// - Load: the tile's input window, 23 x 39 per band (16 + 7 rows and 32 + 7
//   columns: the 7 hitting taps and the roll), goes to shared memory once
//   by cp.async, coalesced along the row; each thread wraps its one column
//   and its 4 rows once, by a compare.
// - Column stage: lo and hi at every (window row, output column), 4
//   columns a thread from the 8 or 9 samples they share, held in registers
//   (about 2 shared reads per output and band instead of 7).
// - Row stage: each thread makes 2 rows x 4 columns from 16-byte reads of
//   lo and hi, 7 or 8 rows of each; float4 stores where 2w % 4 == 0.
// - The bound is bytes (4 or 16 planes read, 4 written, all of h x w), but
//   built without multiply-add contraction the column and row stages issue
//   about 2 x 34 (full) or 2 x 13 (lowpass-only) float instructions per
//   output: of the order of the bytes' time at these shapes.
//
// The LeGall kernels (the three modes share one template): one block of 256
// threads makes a 32 x 64 output tile of one frame.
// - Load: the tile's input window, 19 x 35 per band (16 + 3 rows and 32 + 3
//   columns: the 3- and 5-tap filters and the roll), goes to shared memory
//   once, by cp.async, coalesced along the row, tree by tree in four commit
//   groups, so that tree 0's stages run while trees 1-3 still arrive.  Each
//   thread wraps its one window column and its 3 window rows once, by a
//   compare (a modulo only for planes smaller than the window).
// - Column stage, per tree: lo and hi at every (window row, output column),
//   2 columns a thread, read at unit stride, into shared memory: computed
//   once, not once per output row that needs them.
// - Row stage, per tree: each thread makes 2 rows x 4 columns of outputs
//   from 16-byte reads of lo and hi, and adds the tree into registers,
//   (((t0 + t1) + t2) + t3) * 0.25 at the end.
// - An output's tap parities follow from its place in the tile and the
//   parity of the roll (kE, a template argument), so every tap is a
//   compile-time operand of the kernel's parameter block and every window
//   index a constant offset.
// - Stores: one float4 per thread and row where 2w % 4 == 0.
// Bound on the card: memory (16, 4 or 12 planes of h x w read, 16 B written
// per input position) against about 80 float32 operations per output; the
// windows overlap by 3 rows and columns (1.30 x the input), served by L2.

#include <cstdint>

#include "qshift_passes.cuh"    // wrap_near
#include "synthesis_tiles.cuh"  // the stages' helpers, cp.async

namespace vfp {
namespace {

using qshift::wrap_near;
using namespace tiles;

constexpr int kG0 = 3, kG1 = 5;  // LeGall synthesis taps
constexpr int kQTaps = 14;       // q-shift synthesis taps
constexpr int kAll = 0, kLl = 1, kHp = 2;  // the bands a LeGall synthesis reads

// From Python (kernels/dtcwt_synthesis.py:_params_host).
struct SynParams {
  float g0[kG0], g1[kG1];  // LeGall synthesis lowpass and highpass
  int roll;                // LEGALL_ROLL
};

// From Python (kernels/dtcwt_synthesis.py:_qparams_host).
struct QSynParams {
  float g[2][2][kQTaps];  // [tree a/b][g0/g1][k]
  int roll[2];            // QSHIFT_ROLL_A, QSHIFT_ROLL_B
};

// -- the q-shift levels: one block per kQTh x kQTw output tile of one (frame, tree) --

constexpr int kQTh = 32, kQTw = 64;           // output rows and columns per tile
constexpr int kQHalo = (kQTaps - 1) / 2;      // samples a run reads before its first (6)
constexpr int kQWr = kQTh / 2 + kQHalo + 1;   // input rows of its window (23)
constexpr int kQWc = kQTw / 2 + kQHalo + 1;   // input columns of its window (39)
constexpr int kQWcp = 40;                     // a window row in shared memory (8-byte runs)
constexpr int kQThreads = 256;
constexpr int kQLoadGroups = kQThreads / kQWc;                          // 6 row groups
constexpr int kQLoadRows = (kQWr + kQLoadGroups - 1) / kQLoadGroups;    // rows a thread loads (4)
static_assert((kQTh / 2) * (kQTw / 4) == kQThreads, "row stage: 2 x 4 outputs a thread");
static_assert(kQWcp >= kQWc && kQWcp % 2 == 0, "column runs start at even window columns");

template <bool kFull>
constexpr int qshift_smem_bytes() {
  return 4 * ((kFull ? 4 : 1) * kQWr * kQWcp + (kFull ? 2 : 1) * kQWr * kQTw);
}

// Tree (kRt, kCt) of frame b: the output tile at rows i0.., columns j0...
// Output row i is n = i - roll_r of the unrolled synthesis; n0 = i0 - roll_r
// has the parity kEr of the roll (i0 is even), and the window starts kQHalo
// samples before (n0 - kEr) / 2, so output t of the tile reads window row (t +
// kEr + 2 kQHalo - k) / 2 at tap k: a constant for each (t mod 2, k).  The
// same on columns with kEc.
template <bool kFull, int kRt, int kCt, int kEr, int kEc>
__device__ __forceinline__ void qshift_tile(const float* __restrict__ d, float* __restrict__ out,
                                            int b, int h, int w, const QSynParams& p,
                                            float* smem) {
  constexpr int kCi = kRt * 2 + kCt;
  constexpr int kBands = kFull ? 4 : 1;
  constexpr int kBand = kQWr * kQWcp;
  constexpr int kOffR = kEr + 2 * kQHalo, kOffC = kEc + 2 * kQHalo;
  float* win = smem;                   // [band][kQWr][kQWcp]: ll (lh, hl, hh)
  float* lo = win + kBands * kBand;    // [kQWr][kQTw]
  float* hi = lo + kQWr * kQTw;        // [kQWr][kQTw], full mode only
  const int oh = 2 * h, ow = 2 * w;
  const int i0 = blockIdx.y * kQTh, j0 = blockIdx.x * kQTw;
  const long long plane = (long long)h * w;
  const float* db = d + (long long)b * (kFull ? 16 : 4) * plane;

  // the window, input rows br .. br + kQWr - 1 and columns bc .. bc + kQWc - 1
  // (mod h, w) of the tree's bands: thread (g, c) takes window column c and
  // rows g, g + 6, ..., each index wrapped once
  {
    const int br = (i0 - p.roll[kRt] - kEr) / 2 - kQHalo;
    const int bc = (j0 - p.roll[kCt] - kEc) / 2 - kQHalo;
    const int g = threadIdx.x / kQWc, c = threadIdx.x % kQWc;
    if (g < kQLoadGroups) {
      const int col = wrap_near(bc + c, w);
      int off[kQLoadRows];
#pragma unroll
      for (int j = 0; j < kQLoadRows; ++j) off[j] = wrap_near(br + g + kQLoadGroups * j, h) * w + col;
#pragma unroll
      for (int bi = 0; bi < kBands; ++bi) {
        const float* src = db + (bi * 4 + kCi) * plane;
        float* dst = win + bi * kBand + g * kQWcp + c;
#pragma unroll
        for (int j = 0; j < kQLoadRows; ++j)
          if (g + kQLoadGroups * j < kQWr) cp_async4(dst + kQLoadGroups * j * kQWcp, src + off[j]);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }

  // column stage, once per (window row, output column), 4 columns a thread
  // from the run of samples they share: lo = up2(ll, g0c) + up2(lh, g1c), hi =
  // up2(hl, g0c) + up2(hh, g1c)
  constexpr int kMc = run_len(4, kOffC);
  const float* g0c = p.g[kCt][0];
  const float* g1c = p.g[kCt][1];
  for (int it = threadIdx.x; it < kQWr * (kQTw / 4); it += kQThreads) {
    const int a = it / (kQTw / 4), q = it % (kQTw / 4);
    const float* src = win + a * kQWcp + 2 * q;
    float v[kMc], x[4], y[4];
    load_run2(src, v);
    up2_run<kQTaps, kOffC, 4>(g0c, v, x);
    if constexpr (kFull) {
      load_run2(src + kBand, v);
      up2_run<kQTaps, kOffC, 4>(g1c, v, y);
#pragma unroll
      for (int t = 0; t < 4; ++t) x[t] = x[t] + y[t];
    }
    *reinterpret_cast<float4*>(lo + a * kQTw + 4 * q) = make_float4(x[0], x[1], x[2], x[3]);
    if constexpr (kFull) {
      load_run2(src + 2 * kBand, v);
      up2_run<kQTaps, kOffC, 4>(g0c, v, x);
      load_run2(src + 3 * kBand, v);
      up2_run<kQTaps, kOffC, 4>(g1c, v, y);
      *reinterpret_cast<float4*>(hi + a * kQTw + 4 * q) =
          make_float4(x[0] + y[0], x[1] + y[1], x[2] + y[2], x[3] + y[3]);
    }
  }
  __syncthreads();

  // row stage: rows i0 + 2 rp + di, columns j0 + 4q .. + 3 from 16-byte reads,
  // up2(lo, g0r) + up2(hi, g1r)
  constexpr int kMr = run_len(2, kOffR);
  const int rp = threadIdx.x / (kQTw / 4), q = threadIdx.x % (kQTw / 4);
  float4 v4[kMr], acc[2];
  load_rows(lo + rp * kQTw + 4 * q, kQTw, v4);
  up2_run<kQTaps, kOffR, 2>(p.g[kRt][0], v4, acc);
  if constexpr (kFull) {
    float4 e[2];
    load_rows(hi + rp * kQTw + 4 * q, kQTw, v4);
    up2_run<kQTaps, kOffR, 2>(p.g[kRt][1], v4, e);
    acc[0] = vadd(acc[0], e[0]);
    acc[1] = vadd(acc[1], e[1]);
  }
  const int j = j0 + 4 * q;
  const bool vec = (ow & 3) == 0 && j + 4 <= ow;
#pragma unroll
  for (int di = 0; di < 2; ++di) {
    const int i = i0 + 2 * rp + di;
    if (i >= oh) continue;
    float* o = out + (((long long)b * 4 + kCi) * oh + i) * ow + j;
    if (vec) {
      *reinterpret_cast<float4*>(o) = acc[di];
    } else {
      const float vs[4] = {acc[di].x, acc[di].y, acc[di].z, acc[di].w};
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (j + t < ow) o[t] = vs[t];
    }
  }
}

// kE: the parity of the rolls (trees a and b share it).  The block's tree
// combo is uniform, so it dispatches once to a body whose taps and window
// offsets are all compile-time.
template <bool kFull, int kE>
__global__ void __launch_bounds__(kQThreads, 4)
    qshift_kernel(const float* __restrict__ d, float* __restrict__ out, int h, int w,
                  QSynParams p) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.z >> 2;
  switch (blockIdx.z & 3) {
    case 0: qshift_tile<kFull, 0, 0, kE, kE>(d, out, b, h, w, p, smem); break;
    case 1: qshift_tile<kFull, 0, 1, kE, kE>(d, out, b, h, w, p, smem); break;
    case 2: qshift_tile<kFull, 1, 0, kE, kE>(d, out, b, h, w, p, smem); break;
    default: qshift_tile<kFull, 1, 1, kE, kE>(d, out, b, h, w, p, smem); break;
  }
}

// -- the LeGall level 1: one block per kLTh x kLTw output tile --------------------

constexpr int kLTh = 32, kLTw = 64;    // output rows and columns per tile
constexpr int kLWr = kLTh / 2 + 3;     // input rows of its window (19)
constexpr int kLWc = kLTw / 2 + 3;     // input columns of its window (35)
constexpr int kLThreads = 256;
constexpr int kLoadGroups = kLThreads / kLWc;           // 7 row groups of kLWc threads
constexpr int kLoadRows = (kLWr + kLoadGroups - 1) / kLoadGroups;  // rows a thread loads (3)
static_assert(kLTh % 2 == 0 && kLTw % 4 == 0 && (kLTh / 2) * (kLTw / 4) == kLThreads,
              "row stage: 2 x 4 outputs a thread");

// bands per tree and where each sits among them (-1: a zero band)
template <int kMode>
struct Bands {
  static constexpr int n = kMode == kAll ? 4 : kMode == kLl ? 1 : 3;
  static constexpr int ll = kMode == kHp ? -1 : 0;
  static constexpr int lh = kMode == kAll ? 1 : kMode == kHp ? 0 : -1;
  static constexpr int hl = kMode == kAll ? 2 : kMode == kHp ? 1 : -1;
  static constexpr int hh = kMode == kAll ? 3 : kMode == kHp ? 2 : -1;
};

template <int kMode>
constexpr int legall_smem_bytes() {
  return 4 * (4 * Bands<kMode>::n * kLWr * kLWc + (kMode == kLl ? 1 : 2) * kLWr * kLTw);
}

// Column stage of tree (., kCt) at window input row a, output column 2p +
// kT: lo = up2(ll, g0) + up2(lh, g1), hi = up2(hl, g0) + up2(hh, g1) (zero
// bands left out), from the tree's bands in shared memory (``in`` points at
// row a, column p of its first band).
template <int kMode, int kE, int kCt, int kT>
__device__ __forceinline__ void column_stage(const float* in, const SynParams& p, float& lo,
                                             float& hi) {
  using B = Bands<kMode>;
  constexpr int kK0 = (kE + 1 + kT - kCt) & 1, kOff = 5 + kE + kT - kCt;
  constexpr int kBand = kLWr * kLWc;
  if constexpr (B::ll >= 0) {
    lo = up2_tile<kG0, kK0, kOff, 1>(p.g0, in + B::ll * kBand);
    if constexpr (B::lh >= 0) lo = lo + up2_tile<kG1, kK0, kOff, 1>(p.g1, in + B::lh * kBand);
  } else {
    lo = up2_tile<kG1, kK0, kOff, 1>(p.g1, in + B::lh * kBand);
  }
  if constexpr (B::hl >= 0)
    hi = up2_tile<kG0, kK0, kOff, 1>(p.g0, in + B::hl * kBand) +
         up2_tile<kG1, kK0, kOff, 1>(p.g1, in + B::hh * kBand);
}

// Row stage of tree (kRt, .) at output row 2 rp + kDi, columns 4q .. 4q + 3:
// up2(lo, g0) + up2(hi, g1) along H (taps below 3 of g0, all of g1)
template <int kMode, int kE, int kRt, int kDi>
__device__ __forceinline__ float4 row_stage(const float* lo, const float* hi, const SynParams& p) {
  constexpr int kK0 = (kE + 1 + kDi - kRt) & 1, kOff = 5 + kE + kDi - kRt;
  const float4 a = up2_tile4<kG0, kK0, kOff, kLTw>(p.g0, lo);
  if constexpr (kMode == kLl) return a;
  else return vadd(a, up2_tile4<kG1, kK0, kOff, kLTw>(p.g1, hi));
}

template <int kMode, int kE, int kCi>
__device__ __forceinline__ void legall_tree(const float* in, float* lo, float* hi,
                                            const SynParams& p, float4 (&acc)[2]) {
  constexpr int kRt = kCi >> 1, kCt = kCi & 1;
  cp_async_wait<3 - kCi>();  // this tree's bands are in
  __syncthreads();           // for every thread; the last tree's row stage is done
  const float* tin = in + kCi * Bands<kMode>::n * kLWr * kLWc;
  for (int it = threadIdx.x; it < kLWr * (kLTw / 2); it += kLThreads) {
    const int a = it / (kLTw / 2), pp = it % (kLTw / 2);
    const float* src = tin + a * kLWc + pp;
    float lo0, lo1, hi0 = 0.0f, hi1 = 0.0f;
    column_stage<kMode, kE, kCt, 0>(src, p, lo0, hi0);
    column_stage<kMode, kE, kCt, 1>(src, p, lo1, hi1);
    *reinterpret_cast<float2*>(lo + a * kLTw + 2 * pp) = make_float2(lo0, lo1);
    if constexpr (kMode != kLl)
      *reinterpret_cast<float2*>(hi + a * kLTw + 2 * pp) = make_float2(hi0, hi1);
  }
  __syncthreads();
  const int rp = threadIdx.x / (kLTw / 4), q = threadIdx.x % (kLTw / 4);
  const float* l = lo + rp * kLTw + 4 * q;
  const float* h = hi + rp * kLTw + 4 * q;
  const float4 t0 = row_stage<kMode, kE, kRt, 0>(l, h, p);
  const float4 t1 = row_stage<kMode, kE, kRt, 1>(l, h, p);
  if constexpr (kCi == 0) {  // (((t0 + t1) + t2) + t3)
    acc[0] = t0;
    acc[1] = t1;
  } else {
    acc[0] = vadd(acc[0], t0);
    acc[1] = vadd(acc[1], t1);
  }
}

template <int kMode, int kE>
__global__ void __launch_bounds__(kLThreads, 4)
    legall_kernel(const float* __restrict__ d, float* __restrict__ out, int h, int w,
                  SynParams p) {
  using B = Bands<kMode>;
  extern __shared__ __align__(16) float smem[];
  float* in = smem;                          // [tree][band][kLWr][kLWc]
  float* lo = in + 4 * B::n * kLWr * kLWc;   // [kLWr][kLTw]
  float* hi = lo + kLWr * kLTw;              // [kLWr][kLTw], not for kLl
  const int oh = 2 * h, ow = 2 * w;
  const int i0 = blockIdx.y * kLTh, j0 = blockIdx.x * kLTw;
  const long long plane = (long long)h * w;
  const float* db = d + (long long)blockIdx.z * 4 * B::n * plane;

  // load the window, input rows br .. br + kLWr - 1 and columns bc .. bc +
  // kLWc - 1 (mod h, w) of every band, tree by tree, one commit group each:
  // thread (g, c) takes window column c and rows g, g + 7, g + 14
  {
    const int br = (i0 - p.roll - 5) >> 1, bc = (j0 - p.roll - 5) >> 1;
    const int g = threadIdx.x / kLWc, c = threadIdx.x % kLWc;
    int off[kLoadRows];
    if (g < kLoadGroups) {
      const int col = wrap_near(bc + c, w);
#pragma unroll
      for (int j = 0; j < kLoadRows; ++j)
        off[j] = wrap_near(br + g + kLoadGroups * j, h) * w + col;
    }
#pragma unroll
    for (int ci = 0; ci < 4; ++ci) {
      if (g < kLoadGroups) {
#pragma unroll
        for (int bi = 0; bi < B::n; ++bi) {
          const float* src = db + (bi * 4 + ci) * plane;
          float* dst = in + ((ci * B::n + bi) * kLWr + g) * kLWc + c;
#pragma unroll
          for (int j = 0; j < kLoadRows; ++j)
            if (g + kLoadGroups * j < kLWr) cp_async4(dst + kLoadGroups * j * kLWc, src + off[j]);
        }
      }
      cp_async_commit();
    }
  }

  float4 acc[2];
  legall_tree<kMode, kE, 0>(in, lo, hi, p, acc);
  legall_tree<kMode, kE, 1>(in, lo, hi, p, acc);
  legall_tree<kMode, kE, 2>(in, lo, hi, p, acc);
  legall_tree<kMode, kE, 3>(in, lo, hi, p, acc);

  // out[i][j], rows i0 + 2 rp + di, columns j0 + 4q .. j0 + 4q + 3
  const int rp = threadIdx.x / (kLTw / 4), q = threadIdx.x % (kLTw / 4);
  const int j = j0 + 4 * q;
  const bool vec = (ow & 3) == 0 && j + 4 <= ow;
#pragma unroll
  for (int di = 0; di < 2; ++di) {
    const int i = i0 + 2 * rp + di;
    if (i >= oh) continue;
    const float4 v = make_float4(acc[di].x * 0.25f, acc[di].y * 0.25f, acc[di].z * 0.25f,
                                 acc[di].w * 0.25f);
    float* o = out + ((long long)blockIdx.z * oh + i) * ow + j;
    if (vec) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (j + t < ow) o[t] = vs[t];
    }
  }
}

SynParams syn_params(const void* host_params) {
  SynParams k;
  const float* q = static_cast<const float*>(host_params);
  for (int i = 0; i < kG0; ++i) k.g0[i] = q[i];
  for (int i = 0; i < kG1; ++i) k.g1[i] = q[kG0 + i];
  k.roll = (int)q[kG0 + kG1];
  return k;
}

QSynParams qsyn_params(const void* host_params) {
  QSynParams k;
  const float* q = static_cast<const float*>(host_params);
  for (int t = 0; t < 2; ++t)
    for (int f = 0; f < 2; ++f)
      for (int i = 0; i < kQTaps; ++i) k.g[t][f][i] = q[(t * 2 + f) * kQTaps + i];
  k.roll[0] = (int)q[4 * kQTaps];
  k.roll[1] = (int)q[4 * kQTaps + 1];
  return k;
}

template <int kMode, int kE>
int launch_legall_tiles(const float* d, float* out, int batch, int h, int w, const SynParams& p,
                        cudaStream_t stream) {
  constexpr int bytes = legall_smem_bytes<kMode>();
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        legall_kernel<kMode, kE>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((2 * w + kLTw - 1) / kLTw, (2 * h + kLTh - 1) / kLTh, batch);
  legall_kernel<kMode, kE><<<grid, kLThreads, bytes, stream>>>(d, out, h, w, p);
  return (int)cudaGetLastError();
}

template <int kMode>
int launch_legall(const void* d, void* out, int batch, int h, int w, const void* params,
                  void* stream) {
  if (batch == 0 || h == 0 || w == 0) return 0;
  const SynParams p = syn_params(params);
  // kE: the parity of the window origin 2 i0 - roll - 5 (i0 even), which
  // fixes each output's tap parities at compile time
  return (p.roll + 1) & 1
             ? launch_legall_tiles<kMode, 1>((const float*)d, (float*)out, batch, h, w, p,
                                            (cudaStream_t)stream)
             : launch_legall_tiles<kMode, 0>((const float*)d, (float*)out, batch, h, w, p,
                                            (cudaStream_t)stream);
}

template <bool kFull, int kE>
int launch_qshift_tiles(const float* d, float* out, int batch, int h, int w,
                        const QSynParams& p, cudaStream_t stream) {
  constexpr int bytes = qshift_smem_bytes<kFull>();
  static_assert(bytes <= 48 * 1024, "over the default dynamic shared memory");
  const dim3 grid((2 * w + kQTw - 1) / kQTw, (2 * h + kQTh - 1) / kQTh, 4 * batch);
  qshift_kernel<kFull, kE><<<grid, kQThreads, bytes, stream>>>(d, out, h, w, p);
  return (int)cudaGetLastError();
}

template <bool kFull>
int launch_qshift(const void* d, void* out, int batch, int h, int w, const void* params,
                  void* stream) {
  if (batch == 0 || h == 0 || w == 0) return 0;
  const QSynParams p = qsyn_params(params);
  // QSHIFT_ROLL_A and _B are both -13: the tiles take one parity for both
  if ((p.roll[0] & 1) != (p.roll[1] & 1)) return (int)cudaErrorInvalidValue;
  return p.roll[0] & 1 ? launch_qshift_tiles<kFull, 1>((const float*)d, (float*)out, batch, h, w,
                                                       p, (cudaStream_t)stream)
                       : launch_qshift_tiles<kFull, 0>((const float*)d, (float*)out, batch, h, w,
                                                       p, (cudaStream_t)stream);
}

}  // namespace
}  // namespace vfp

// Plain C interface, bound with ctypes (kernels/_build.py).  d/out are device
// pointers to contiguous f32 tensors: d [B, 16, h, w], [B, 4, h, w] or
// [B, 12, h, w]; out [B, 2h, 2w] (LeGall) or [B, 4, 2h, 2w] (q-shift).  params
// is host memory: 9 floats (LeGall g0, g1, then the roll) or 58 (g0a, g1a,
// g0b, g1b, then the rolls of trees a and b).  Returns the launch's
// cudaError_t.

extern "C" int vfp_dtcwt_legall_synthesis(const void* d, void* out, int batch, int h, int w,
                                          const void* params, void* stream) {
  return vfp::launch_legall<vfp::kAll>(d, out, batch, h, w, params, stream);
}

extern "C" int vfp_dtcwt_legall_synthesis_ll(const void* d, void* out, int batch, int h, int w,
                                             const void* params, void* stream) {
  return vfp::launch_legall<vfp::kLl>(d, out, batch, h, w, params, stream);
}

extern "C" int vfp_dtcwt_legall_synthesis_hp(const void* d, void* out, int batch, int h, int w,
                                             const void* params, void* stream) {
  return vfp::launch_legall<vfp::kHp>(d, out, batch, h, w, params, stream);
}

extern "C" int vfp_dtcwt_qshift_synthesis(const void* d, void* out, int batch, int h, int w,
                                          const void* params, void* stream) {
  return vfp::launch_qshift<true>(d, out, batch, h, w, params, stream);
}

extern "C" int vfp_dtcwt_qshift_synthesis_ll(const void* d, void* out, int batch, int h, int w,
                                             const void* params, void* stream) {
  return vfp::launch_qshift<false>(d, out, batch, h, w, params, stream);
}
