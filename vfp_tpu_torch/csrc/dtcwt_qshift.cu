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
// One block makes a 16x16 output tile of one tree of one frame.  It loads the
// (2 * 16 + 13)^2 input window once into shared memory (circular reads), runs
// the row pass over the window's columns into shared memory, then the column
// pass.  The filters sit in shared memory: a kernel parameter indexed by a
// runtime tree would go to local memory.  The batch stride is an argument, so
// the U half of the level-1 output [B, 2, 4, h, w] is read in place.
//
// Bound on the card: memory (16 B read per input position; 4 B (ll), 12 B
// (highpasses) or 16 B (all) written per output position, 1/4 as many)
// against 14 FLOP x 2 per row-pass value and per column-pass value.  The
// window overlaps its neighbours by 13 rows and columns, about 2x of the
// input, served by L2.

#include <cstdint>

namespace vfp {
namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;                    // output positions per tile side
constexpr int kTaps = 14;
constexpr int kWin = 2 * kTile + kTaps - 1;  // input rows/cols of the window (45)
constexpr int kLl = 0, kHp = 1, kAll = 2;    // the planes a level writes

// q-shift analysis filters from Python (kernels/dtcwt_masks.py:_params_host).
struct QParams {
  float h[2][2][kTaps];  // [tree a/b][h0/h1][k]
};

__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// sum_k f[k] * v[(x0 - k) * stride], k from 0 upward
__device__ __forceinline__ float taps(const float* f, const float* v, int x0, int stride) {
  float acc = f[0] * v[x0 * stride];
#pragma unroll
  for (int k = 1; k < kTaps; ++k) acc = acc + f[k] * v[(x0 - k) * stride];
  return acc;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    qshift_kernel(const float* __restrict__ x, float* __restrict__ out, int h, int w,
                  int bstride, QParams k) {
  constexpr int kRows = kMode == kLl ? 1 : 2;  // row-pass outputs: lo (and hi)
  __shared__ float win[kWin][kWin];
  __shared__ float rows[kRows][kTile][kWin];
  __shared__ float filt[2][2][kTaps];
  const int ho = h / 2, wo = w / 2;
  const int j0 = blockIdx.x * kTile, i0 = blockIdx.y * kTile;
  const int ci = blockIdx.z % 4, rt = ci >> 1, ct = ci & 1;
  const long long b = blockIdx.z / 4;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int i = 0; i < kTaps; ++i) filt[t][f][i] = k.h[t][f][i];
  }
  // window slot (r, c) holds input (2 i0 - 13 + r, 2 j0 - 13 + c), circularly
  const float* xb = x + b * bstride + (long long)ci * h * w;
  for (int it = threadIdx.x; it < kWin * kWin; it += kThreads) {
    const int c = it % kWin, r = it / kWin;
    win[r][c] = xb[(long long)wrap(2 * i0 - (kTaps - 1) + r, h) * w +
                   wrap(2 * j0 - (kTaps - 1) + c, w)];
  }
  __syncthreads();

  // row pass: rows[fi][i][c] = sum_k f[k] * win[2 i + 13 - k][c]
  for (int it = threadIdx.x; it < kRows * kTile * kWin; it += kThreads) {
    const int c = it % kWin, i = (it / kWin) % kTile, fi = it / (kWin * kTile);
    rows[fi][i][c] = taps(filt[rt][fi], &win[0][c], 2 * i + kTaps - 1, kWin);
  }
  __syncthreads();

  // column pass
  for (int it = threadIdx.x; it < kTile * kTile; it += kThreads) {
    const int jj = it % kTile, ii = it / kTile;
    const int i = i0 + ii, j = j0 + jj;
    if (i >= ho || j >= wo) continue;
    const int c0 = 2 * jj + kTaps - 1;
    const long long plane = (long long)ho * wo;
    const long long o = (long long)i * wo + j;
    if constexpr (kMode == kLl) {
      out[(b * 4 + ci) * plane + o] = taps(filt[ct][0], rows[0][ii], c0, 1);  // ll
    } else {
      constexpr int kPlanes = kMode == kAll ? 16 : 12, kOff = kMode == kAll ? 4 : 0;
      float* ob = out + b * kPlanes * plane + o;
      if constexpr (kMode == kAll) ob[ci * plane] = taps(filt[ct][0], rows[0][ii], c0, 1);  // ll
      ob[(kOff + 0 * 4 + ci) * plane] = taps(filt[ct][1], rows[0][ii], c0, 1);  // lh
      ob[(kOff + 1 * 4 + ci) * plane] = taps(filt[ct][0], rows[kRows - 1][ii], c0, 1);  // hl
      ob[(kOff + 2 * 4 + ci) * plane] = taps(filt[ct][1], rows[kRows - 1][ii], c0, 1);  // hh
    }
  }
}

QParams qparams(const void* host_params) {
  QParams k;
  const float* p = static_cast<const float*>(host_params);
  for (int t = 0; t < 2; ++t)
    for (int f = 0; f < 2; ++f)
      for (int i = 0; i < kTaps; ++i) k.h[t][f][i] = p[(t * 2 + f) * kTaps + i];
  return k;
}

template <int kMode>
int launch(const void* x, void* out, int batch, int h, int w, int bstride, const void* params,
           void* stream) {
  const int ho = h / 2, wo = w / 2;
  if (batch == 0 || ho == 0 || wo == 0) return 0;
  const dim3 grid((wo + kTile - 1) / kTile, (ho + kTile - 1) / kTile, 4 * batch);
  qshift_kernel<kMode><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, h, w, bstride, qparams(params));
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace vfp

// Plain C interface, bound with ctypes (kernels/_build.py).  x is a device
// pointer to f32 [B, 4, h, w] (batch stride ``bstride`` floats, the rest
// contiguous; h and w even), out to a contiguous f32 [B, 4, h/2, w/2]
// (qshift_ll), [B, 12, h/2, w/2] (qshift_hp) or [B, 16, h/2, w/2]
// (qshift_analysis); params is host memory (56 floats: h0a, h1a, h0b, h1b).
// Returns the launch's cudaError_t.

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
