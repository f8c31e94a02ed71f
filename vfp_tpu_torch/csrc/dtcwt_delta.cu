// The DT-CWT embed delta's whole synthesis in one launch: level-3 highpass
// delta planes -> pixel delta.
//
// Replaces the Pallas kernel dtcwt_delta_synthesis of
// vfp_tpu/kernels/dtcwt_delta.py (:258).  Input [B, 12, h3, w3] f32, planes
// [lh*4, hl*4, hh*4] with tree combos (rt, ct) row-major and a zero lowpass at
// every level; output [B, 8 h3, 8 w3].  Per tree:
//   level 3 (q-shift, full):    lo = S_c(lh; g1c), hi = S_c(hl; g0c) + S_c(hh; g1c),
//                               ll2 = S_r(lo; g0r) + S_r(hi; g1r)
//   level 2 (q-shift, ll only): ll1 = S_r(S_c(ll2; g0c); g0r)
//   level 1 (LeGall, ll only):  x   = S_r(S_c(ll1; G0, phase ct); G0, phase rt)
// and du = (((x_00 + x_01) + x_10) + x_11) * 0.25.  S is one 1-D synthesis
// stage with its roll folded in (synthesis_tiles.cuh):
//   out[i] = sum_k f[k] * y2[i - roll - k],  y2[2j + phase] = y[j], else 0,
// summed from k = 0 upward over the taps that hit a sample, in the order of
// the plain version (kernels/dtcwt_delta.py, the chain of the plain
// Transform2d); the build has --fmad=false.
//
// One block of 256 threads makes a 64 x 128 tile of du, tree by tree, in
// unwrapped level coordinates: an index past the plane is the circular one,
// and only the level-3 loads wrap, which is exact because each level is
// exactly twice the one below.  Per tree, in shared memory:
// - its level-3 window, 19 x 28 of its 3 planes, loaded at the start by
//   cp.async with the other trees', one commit group a tree, so that later
//   trees arrive while the first computes;
// - S1, the level-3 column stage, lo and hi at 19 rows x 44 level-2 columns;
//   S2, its row stage, ll2 at 26 x 44; S3, the level-2 column stage, at 24 x
//   68; S4, its row stage, ll1 at 36 x 68; each a run of 4 (columns) or 2
//   (rows) neighbouring outputs a thread from samples held in registers, so
//   one shared read feeds several taps;
// - the last stage, the LeGall columns and rows of 2 x 4 pixels a thread from
//   the ll1 samples they read (at most 3 x 4), added into registers, tree by
//   tree.
// The level-1 window's origin fixes the tap parities there (the tile origin
// is a multiple of 8 pixels; a template on the LeGall roll's parity).  At
// levels 2 and 3 each stage starts its outputs one earlier where needed to
// make the first output's unrolled index even, so every q-shift stage runs
// at one parity, with taps and window offsets compile-time and the buffers'
// start offsets (0 or 1) at run time.  Halos: the level-3 window is 2.6 x
// the 8 x 16 positions the tile owns, level 2 2.0 x 32 x 64.  Barriers: one
// after each of S1-S4, so 17 a tile.
//
// Bound on the card: memory (12 planes of h3 x w3 read, 4 B/pixel written:
// 25 MB + 133 MB per 16-frame 1080p batch).  Built without multiply-add
// contraction the stages issue about 2 x 40 float instructions per pixel
// (about 26 if every intermediate were computed once): of the order of the
// bytes' time.

#include <cstdint>

#include "qshift_passes.cuh"    // wrap_near
#include "synthesis_tiles.cuh"  // the stages' helpers, cp.async

namespace vfp {
namespace {

using qshift::wrap_near;
using namespace tiles;

constexpr int kThreads = 256;
constexpr int kQTaps = 14;
constexpr int kLTaps = 3;
constexpr int kTh = 64, kTw = 128;             // pixel tile
constexpr int kQOff = 12;                      // kOff of a q-shift stage at parity 0
constexpr int kW1r = kTh / 2 + 2, kW1c = kTw / 2 + 2;  // level-1 window (34 x 66)
constexpr int kR1 = 36, kC1 = 68;              // ll1 computed (from one earlier)
constexpr int kW2r = kR1 / 2 + 6, kW2c = kC1 / 2 + 6;  // level-2 window (24 x 40)
constexpr int kR2 = 26, kC2 = 44;              // ll2 computed
constexpr int kW3r = kR2 / 2 + 6, kW3c = kC2 / 2 + 6;  // level-3 window (19 x 28)
constexpr int kPlane3 = kW3r * kW3c;
constexpr int kLoadGroups = kThreads / kW3c;   // 9 row groups of kW3c threads
constexpr int kLoadRows = (kW3r + kLoadGroups - 1) / kLoadGroups;  // 3
// shared memory: the 4 trees' level-3 windows, then A (S1's lo and hi, then
// S3's output) and B (S2's ll2, then S4's ll1)
constexpr int kSizeA = 2 * kW3r * kC2 > kW2r * kC1 ? 2 * kW3r * kC2 : kW2r * kC1;
constexpr int kSizeB = kR2 * kC2 > kR1 * kC1 ? kR2 * kC2 : kR1 * kC1;
constexpr int kSmem = 12 * kPlane3 + kSizeA + kSizeB;
static_assert(kR1 >= kW1r + 1 && kC1 >= kW1c + 1 && kR2 >= kW2r + 1 && kC2 >= kW2c + 1,
              "a stage may start one output early");
static_assert(kR1 % 2 == 0 && kR2 % 2 == 0 && kC1 % 4 == 0 && kC2 % 4 == 0 && kW3c % 4 == 0,
              "runs of 2 rows and 4 columns, 16-byte rows");
static_assert(2 * (kC2 / 4 - 1) + run_len(4, kQOff) <= kW3c, "S1 reads inside its window");
static_assert((kTh / 2) * (kTw / 4) == 4 * kThreads, "last stage: 4 runs of 2 x 4 pixels a thread");

// From Python (kernels/dtcwt_delta.py:_params_host).
struct DeltaParams {
  float g[2][2][kQTaps];  // [tree a/b][g0/g1][k]
  float lg0[kLTaps];      // LeGall synthesis lowpass
  int qroll[2];           // q-shift roll of tree a/b
  int lroll;              // LeGall roll
};

// Where one axis of a tree's chain starts, for the tile's first pixel p0: the
// level-1 window (the LeGall stage's samples) sits at ll1 buffer index e2
// (S4 starts one earlier if the window's first row has an odd unrolled
// index), the level-2 window at ll2 buffer index e3, and w3 is the level-3
// window's first sample (before the wrap).
struct Axis {
  int e2, e3, w3;
};

__device__ __forceinline__ Axis axis_origins(int p0, int phase, int lroll, int qroll) {
  const int n1 = p0 - lroll - phase;         // unrolled index of the first pixel
  const int w1 = (n1 - (n1 & 1)) / 2 - 1;    // its LeGall window (kHalo 1)
  const int e2 = (w1 - qroll) & 1;
  const int w2 = (w1 - e2 - qroll) / 2 - 6;  // the level-2 window (kHalo 6)
  const int e3 = (w2 - qroll) & 1;
  return {e2, e3, (w2 - e3 - qroll) / 2 - 6};
}

// S1 to S4 of tree kCi: its level-3 window (visible to every thread) -> ll1
// in B.  A is free on entry.
template <int kCi>
__device__ __forceinline__ void tree_ll1(const float* win, float* sa, float* sb, const Axis& ar,
                                         const Axis& ac, const DeltaParams& p) {
  constexpr int kRt = kCi >> 1, kCt = kCi & 1;
  const float* g0c = p.g[kCt][0];
  const float* g1c = p.g[kCt][1];
  const float* g0r = p.g[kRt][0];
  const float* g1r = p.g[kRt][1];
  // S1: lo = S_c(lh; g1c), hi = S_c(hl; g0c) + S_c(hh; g1c) at 19 rows x 44
  {
    constexpr int kM = run_len(4, kQOff);
    for (int it = threadIdx.x; it < kW3r * (kC2 / 4); it += kThreads) {
      const int a = it / (kC2 / 4), q = it % (kC2 / 4);
      const float* src = win + a * kW3c + 2 * q;
      float v[kM], x[4], y[4];
      load_run2(src, v);
      up2_run<kQTaps, kQOff, 4>(g1c, v, x);
      *reinterpret_cast<float4*>(sa + a * kC2 + 4 * q) = make_float4(x[0], x[1], x[2], x[3]);
      load_run2(src + kPlane3, v);
      up2_run<kQTaps, kQOff, 4>(g0c, v, x);
      load_run2(src + 2 * kPlane3, v);
      up2_run<kQTaps, kQOff, 4>(g1c, v, y);
      *reinterpret_cast<float4*>(sa + (kW3r + a) * kC2 + 4 * q) =
          make_float4(x[0] + y[0], x[1] + y[1], x[2] + y[2], x[3] + y[3]);
    }
  }
  __syncthreads();
  // S2: ll2 = S_r(lo; g0r) + S_r(hi; g1r) at 26 x 44, 2 rows x 2 columns a thread
  {
    constexpr int kM = run_len(2, kQOff);
    for (int it = threadIdx.x; it < (kR2 / 2) * (kC2 / 2); it += kThreads) {
      const int rp = it / (kC2 / 2), c2 = it % (kC2 / 2);
      float2 v[kM], x[2], y[2];
      load_rows(sa + rp * kC2 + 2 * c2, kC2, v);
      up2_run<kQTaps, kQOff, 2>(g0r, v, x);
      load_rows(sa + (kW3r + rp) * kC2 + 2 * c2, kC2, v);
      up2_run<kQTaps, kQOff, 2>(g1r, v, y);
#pragma unroll
      for (int di = 0; di < 2; ++di)
        *reinterpret_cast<float2*>(sb + (2 * rp + di) * kC2 + 2 * c2) = vadd(x[di], y[di]);
    }
  }
  __syncthreads();
  // S3: S_c(ll2; g0c) at the level-2 window's 24 rows x 68 level-1 columns
  {
    constexpr int kM = run_len(4, kQOff);
    const float* ll2 = sb + ar.e3 * kC2 + ac.e3;
    for (int it = threadIdx.x; it < kW2r * (kC1 / 4); it += kThreads) {
      const int a = it / (kC1 / 4), q = it % (kC1 / 4);
      float v[kM], x[4];
      load_run1(ll2 + a * kC2 + 2 * q, v);
      up2_run<kQTaps, kQOff, 4>(g0c, v, x);
      *reinterpret_cast<float4*>(sa + a * kC1 + 4 * q) = make_float4(x[0], x[1], x[2], x[3]);
    }
  }
  __syncthreads();
  // S4: ll1 = S_r(.; g0r) at 36 x 68, 2 rows x 4 columns a thread
  {
    constexpr int kM = run_len(2, kQOff);
    for (int it = threadIdx.x; it < (kR1 / 2) * (kC1 / 4); it += kThreads) {
      const int rp = it / (kC1 / 4), q = it % (kC1 / 4);
      float4 v[kM], x[2];
      load_rows(sa + rp * kC1 + 4 * q, kC1, v);
      up2_run<kQTaps, kQOff, 2>(g0r, v, x);
      *reinterpret_cast<float4*>(sb + 2 * rp * kC1 + 4 * q) = x[0];
      *reinterpret_cast<float4*>(sb + (2 * rp + 1) * kC1 + 4 * q) = x[1];
    }
  }
}

// The LeGall stage of tree kCi (its ll1 in B, visible to every thread):
// x = S_r(S_c(ll1; G0, phase ct); G0, phase rt) at the thread's 4 runs of 2
// rows x 4 pixels, added into acc.  kLE: the LeGall roll's parity.
template <int kCi, int kLE>
__device__ __forceinline__ void tree_pixels(const float* sb, const Axis& ar, const Axis& ac,
                                            const DeltaParams& p, float4 (&acc)[4][2]) {
  constexpr int kRt = kCi >> 1, kCt = kCi & 1;
  // the first pixel's unrolled index y0 - roll - phase has the parity of
  // roll + phase (y0 is even)
  constexpr int kOffR = ((kLE + kRt) & 1) + 2, kOffC = ((kLE + kCt) & 1) + 2;
  constexpr int kMr = run_len(2, kOffR), kMc = run_len(4, kOffC);
  const float* ll1 = sb + ar.e2 * kC1 + ac.e2;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int it = threadIdx.x + s * kThreads;
    const int rp = it / (kTw / 4), q = it % (kTw / 4);
    float4 c[kMr], x[2];
#pragma unroll
    for (int m = 0; m < kMr; ++m) {
      float v[kMc], t[4];
      load_run1(ll1 + (rp + m) * kC1 + 2 * q, v);
      up2_run<kLTaps, kOffC, 4>(p.lg0, v, t);
      c[m] = make_float4(t[0], t[1], t[2], t[3]);
    }
    up2_run<kLTaps, kOffR, 2>(p.lg0, c, x);
    if constexpr (kCi == 0) {  // (((x_00 + x_01) + x_10) + x_11)
      acc[s][0] = x[0];
      acc[s][1] = x[1];
    } else {
      acc[s][0] = vadd(acc[s][0], x[0]);
      acc[s][1] = vadd(acc[s][1], x[1]);
    }
  }
}

template <int kLE>
__global__ void __launch_bounds__(kThreads, 3)
    delta_kernel(const float* __restrict__ d, float* __restrict__ out, int h3, int w3,
                 DeltaParams p) {
  __shared__ __align__(16) float smem[kSmem];
  float* win = smem;                    // [tree][band][kW3r][kW3c]
  float* sa = win + 12 * kPlane3;
  float* sb = sa + kSizeA;
  const int h = 8 * h3, w = 8 * w3;
  const int y0 = blockIdx.y * kTh, x0 = blockIdx.x * kTw;
  const long long b = blockIdx.z;
  const long long plane = (long long)h3 * w3;
  const float* db = d + b * 12 * plane;
  // each tree's chain origins, recomputed where used rather than held
  const auto row_axis = [&](int ci) {
    return axis_origins(y0, ci >> 1, p.lroll, (ci >> 1) ? p.qroll[1] : p.qroll[0]);
  };
  const auto col_axis = [&](int ci) {
    return axis_origins(x0, ci & 1, p.lroll, (ci & 1) ? p.qroll[1] : p.qroll[0]);
  };

  // every tree's level-3 window, one commit group a tree: thread (g, c)
  // takes window column c and rows g, g + 9, g + 18, each index wrapped once
  {
    const int g = threadIdx.x / kW3c, c = threadIdx.x % kW3c;
#pragma unroll
    for (int ci = 0; ci < 4; ++ci) {
      if (g < kLoadGroups) {
        const int col = wrap_near(col_axis(ci).w3 + c, w3);
        const int row0 = row_axis(ci).w3;
#pragma unroll
        for (int j = 0; j < kLoadRows; ++j) {
          const int r = g + kLoadGroups * j;
          if (r >= kW3r) break;
          const long long off = (long long)wrap_near(row0 + r, h3) * w3 + col;
#pragma unroll
          for (int band = 0; band < 3; ++band)
            cp_async4(win + (ci * 3 + band) * kPlane3 + r * kW3c + c,
                      db + (band * 4 + ci) * plane + off);
        }
      }
      cp_async_commit();
    }
  }

  float4 acc[4][2];
  cp_async_wait<3>();
  __syncthreads();
  tree_ll1<0>(win, sa, sb, row_axis(0), col_axis(0), p);
  cp_async_wait<2>();
  __syncthreads();  // ll1 of tree 0 and the window of tree 1 are in
  tree_pixels<0, kLE>(sb, row_axis(0), col_axis(0), p, acc);
  tree_ll1<1>(win + 3 * kPlane3, sa, sb, row_axis(1), col_axis(1), p);
  cp_async_wait<1>();
  __syncthreads();
  tree_pixels<1, kLE>(sb, row_axis(1), col_axis(1), p, acc);
  tree_ll1<2>(win + 6 * kPlane3, sa, sb, row_axis(2), col_axis(2), p);
  cp_async_wait<0>();
  __syncthreads();
  tree_pixels<2, kLE>(sb, row_axis(2), col_axis(2), p, acc);
  tree_ll1<3>(win + 9 * kPlane3, sa, sb, row_axis(3), col_axis(3), p);
  __syncthreads();
  tree_pixels<3, kLE>(sb, row_axis(3), col_axis(3), p, acc);

  // du rows y0 + 2 rp + di, columns x0 + 4q .. + 3: one float4 each (w is a
  // multiple of 8)
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int it = threadIdx.x + s * kThreads;
    const int rp = it / (kTw / 4), q = it % (kTw / 4);
    const int x = x0 + 4 * q;
    if (x >= w) continue;
#pragma unroll
    for (int di = 0; di < 2; ++di) {
      const int y = y0 + 2 * rp + di;
      if (y >= h) continue;
      *reinterpret_cast<float4*>(out + (b * h + y) * w + x) =
          make_float4(acc[s][di].x * 0.25f, acc[s][di].y * 0.25f, acc[s][di].z * 0.25f,
                      acc[s][di].w * 0.25f);
    }
  }
}

DeltaParams params(const void* host_params) {
  DeltaParams k;
  const float* q = static_cast<const float*>(host_params);
  for (int t = 0; t < 2; ++t)
    for (int f = 0; f < 2; ++f)
      for (int i = 0; i < kQTaps; ++i) k.g[t][f][i] = q[(t * 2 + f) * kQTaps + i];
  for (int i = 0; i < kLTaps; ++i) k.lg0[i] = q[4 * kQTaps + i];
  k.qroll[0] = (int)q[4 * kQTaps + kLTaps];
  k.qroll[1] = (int)q[4 * kQTaps + kLTaps + 1];
  k.lroll = (int)q[4 * kQTaps + kLTaps + 2];
  return k;
}

}  // namespace
}  // namespace vfp

// Plain C interface, bound with ctypes (kernels/_build.py).  d/out are device
// pointers to contiguous f32 [B, 12, h3, w3] and [B, 8 h3, 8 w3]; params is
// host memory (62 floats: g0a, g1a, g0b, g1b, LeGall g0, then the rolls
// q-shift a, q-shift b, LeGall).  Returns the launch's cudaError_t.
extern "C" int vfp_dtcwt_delta_synthesis(const void* d, void* out, int batch, int h3, int w3,
                                         const void* params, void* stream) {
  if (batch == 0 || h3 == 0 || w3 == 0) return 0;
  const vfp::DeltaParams p = vfp::params(params);
  const dim3 grid((8 * w3 + vfp::kTw - 1) / vfp::kTw, (8 * h3 + vfp::kTh - 1) / vfp::kTh, batch);
  const cudaStream_t s = (cudaStream_t)stream;
  if (p.lroll & 1)
    vfp::delta_kernel<1><<<grid, vfp::kThreads, 0, s>>>((const float*)d, (float*)out, h3, w3, p);
  else
    vfp::delta_kernel<0><<<grid, vfp::kThreads, 0, s>>>((const float*)d, (float*)out, h3, w3, p);
  return (int)cudaGetLastError();
}
