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
// stage with its roll folded in:
//   out[i] = sum_k f[k] * y2[i - roll - k],  y2[2j + phase] = y[j], else 0,
// summed from k = 0 upward over the taps that hit a sample.  The rolls are
// negative (-13, -3), so every read goes right/down of i.
//
// One block makes a 32x32 tile of du.  It computes, in shared memory, the
// windows of each level that the tile reads, in unwrapped level coordinates
// (an index past the plane is the circular one; only the level-3 loads wrap,
// which is exact because each level is exactly twice the one below): level 1
// 18x18 per tree, level 2 16x16, level 3 15x15 for the 12 planes.  The halos
// recompute 2x (level 1) to 4x (level 3) of those levels' positions, which
// are 1/4 and 1/16 of the pixels.  No intermediate touches device memory; the
// three Pallas stages' wrap-pads, selection matmuls and strips are not
// carried over.  The plain version in kernels/dtcwt_delta.py folds in this
// order; the build has --fmad=false.
//
// Bound on the card: memory (12 planes of h3 x w3 read, 4 B/pixel written:
// 25 MB + 133 MB per 16-frame 1080p batch) against about 50 FLOPs per pixel.

#include <cstdint>

namespace vfp {
namespace {

constexpr int kThreads = 256;
constexpr int kOut = 32;  // output tile side
constexpr int kW1 = 18;   // level-1 window side
constexpr int kW2 = 16;   // level-2 window side
constexpr int kW3 = 15;   // level-3 window side
constexpr int kQTaps = 14;
constexpr int kLTaps = 3;

// From Python (kernels/dtcwt_delta.py:_params_host).
struct DeltaParams {
  float g[2][2][kQTaps];  // [tree a/b][g0/g1][k]
  float lg0[kLTaps];      // LeGall synthesis lowpass
  int qroll[2];           // q-shift roll of tree a/b
  int lroll;              // LeGall roll
};

__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// sum_k f[k] * y[(i - roll - k - phase) / 2 - base] over the taps whose index
// is even, from k = 0 upward; y is a window starting at input index base,
// read with stride ``stride``.  The taps that hit a sample are k0, k0 + 2, ...
// with k0 the parity of i - roll - phase, so neighbouring outputs (of the
// other parity) run the same number of steps instead of skipping half.
template <int kTaps>
__device__ __forceinline__ float synth(const float* f, const float* y, int stride, int i,
                                       int roll, int phase, int base) {
  const int u0 = i - roll - phase;
  const int k0 = u0 & 1;
  const float* yj = y + (((u0 - k0) >> 1) - base) * stride;  // the sample of tap k0
  float acc = f[k0] * yj[0];
#pragma unroll
  for (int t = 1; t < (kTaps + 1) / 2; ++t) {
    if (k0 + 2 * t < kTaps) acc = acc + f[k0 + 2 * t] * yj[-t * stride];
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    delta_kernel(const float* __restrict__ d, float* __restrict__ out, int h3, int w3,
                 DeltaParams p) {
  __shared__ float l3[12][kW3][kW3];
  __shared__ float a_lohi[4][2][kW3][kW2];  // level-3 rows x level-2 cols
  __shared__ float ll2[4][kW2][kW2];
  __shared__ float b_col[4][kW2][kW1];      // level-2 rows x level-1 cols
  __shared__ float ll1[4][kW1][kW1];
  __shared__ float c_col[4][kW1][kOut];     // level-1 rows x output cols
  const int h = 8 * h3, w = 8 * w3;
  const int y0 = blockIdx.y * kOut, x0 = blockIdx.x * kOut;
  const long long b = blockIdx.z;
  // window origins per level (rows r*, cols c*)
  const int r1 = y0 / 2, c1 = x0 / 2, r2 = y0 / 4, c2 = x0 / 4, r3 = y0 / 8, c3 = x0 / 8;

  // the filters in shared memory, copied with constant indices: indexing the
  // kernel parameter block by a runtime tree would copy it to local memory
  __shared__ float g[2][2][kQTaps];
  __shared__ float lg0[kLTaps];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int k = 0; k < kQTaps; ++k) g[t][f][k] = p.g[t][f][k];
#pragma unroll
    for (int k = 0; k < kLTaps; ++k) lg0[k] = p.lg0[k];
  }
  const int qroll_a = p.qroll[0], qroll_b = p.qroll[1];
  const auto qroll = [=](int tree) { return tree ? qroll_b : qroll_a; };
  __syncthreads();
  const float* db = d + b * 12 * h3 * w3;
  for (int it = threadIdx.x; it < 12 * kW3 * kW3; it += kThreads) {
    const int c = it % kW3, r = (it / kW3) % kW3, pl = it / (kW3 * kW3);
    l3[pl][r][c] = db[((long long)pl * h3 + wrap(r3 + r, h3)) * w3 + wrap(c3 + c, w3)];
  }
  __syncthreads();

  // level 3, columns: lo = S(lh; g1c), hi = S(hl; g0c) + S(hh; g1c)
  for (int it = threadIdx.x; it < 4 * kW3 * kW2; it += kThreads) {
    const int c = it % kW2, r = (it / kW2) % kW3, ci = it / (kW2 * kW3);
    const int ct = ci & 1, i = c2 + c;
    const float* g0c = g[ct][0];
    const float* g1c = g[ct][1];
    const int rc = qroll(ct);
    a_lohi[ci][0][r][c] = synth<kQTaps>(g1c, &l3[0 * 4 + ci][r][0], 1, i, rc, 0, c3);
    a_lohi[ci][1][r][c] = synth<kQTaps>(g0c, &l3[1 * 4 + ci][r][0], 1, i, rc, 0, c3) +
                          synth<kQTaps>(g1c, &l3[2 * 4 + ci][r][0], 1, i, rc, 0, c3);
  }
  __syncthreads();

  // level 3, rows: ll2 = S(lo; g0r) + S(hi; g1r)
  for (int it = threadIdx.x; it < 4 * kW2 * kW2; it += kThreads) {
    const int c = it % kW2, r = (it / kW2) % kW2, ci = it / (kW2 * kW2);
    const int rt = ci >> 1, i = r2 + r;
    const int rr = qroll(rt);
    ll2[ci][r][c] = synth<kQTaps>(g[rt][0], &a_lohi[ci][0][0][c], kW2, i, rr, 0, r3) +
                    synth<kQTaps>(g[rt][1], &a_lohi[ci][1][0][c], kW2, i, rr, 0, r3);
  }
  __syncthreads();

  // level 2, columns then rows (lowpass only)
  for (int it = threadIdx.x; it < 4 * kW2 * kW1; it += kThreads) {
    const int c = it % kW1, r = (it / kW1) % kW2, ci = it / (kW1 * kW2);
    const int ct = ci & 1;
    b_col[ci][r][c] = synth<kQTaps>(g[ct][0], &ll2[ci][r][0], 1, c1 + c, qroll(ct), 0, c2);
  }
  __syncthreads();
  for (int it = threadIdx.x; it < 4 * kW1 * kW1; it += kThreads) {
    const int c = it % kW1, r = (it / kW1) % kW1, ci = it / (kW1 * kW1);
    const int rt = ci >> 1;
    ll1[ci][r][c] = synth<kQTaps>(g[rt][0], &b_col[ci][0][c], kW1, r1 + r, qroll(rt), 0, r2);
  }
  __syncthreads();

  // level 1 (LeGall, tree = sampling phase), columns
  for (int it = threadIdx.x; it < 4 * kW1 * kOut; it += kThreads) {
    const int c = it % kOut, r = (it / kOut) % kW1, ci = it / (kOut * kW1);
    c_col[ci][r][c] = synth<kLTaps>(lg0, &ll1[ci][r][0], 1, x0 + c, p.lroll, ci & 1, c1);
  }
  __syncthreads();

  // level 1 rows and the 4-tree average
  for (int it = threadIdx.x; it < kOut * kOut; it += kThreads) {
    const int c = it % kOut, r = it / kOut;
    const int y = y0 + r, x = x0 + c;
    if (y >= h || x >= w) continue;
    float acc = 0.0f;
#pragma unroll
    for (int ci = 0; ci < 4; ++ci) {
      const float v = synth<kLTaps>(lg0, &c_col[ci][0][c], kOut, y, p.lroll, ci >> 1, r1);
      acc = ci == 0 ? v : acc + v;
    }
    out[(b * h + y) * w + x] = acc * 0.25f;
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
  const dim3 grid((8 * w3 + vfp::kOut - 1) / vfp::kOut, (8 * h3 + vfp::kOut - 1) / vfp::kOut,
                  batch);
  vfp::delta_kernel<<<grid, vfp::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)d, (float*)out, h3, w3, vfp::params(params));
  return (int)cudaGetLastError();
}
