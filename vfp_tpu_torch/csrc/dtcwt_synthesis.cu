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
// One thread per output sample computes every intermediate it needs in
// registers (1-2 rows of lo and hi per tree for LeGall, 7 for the 14-tap
// q-shift filters, each 1-7 column taps), reading the input circularly; the
// filters sit in shared memory (a parameter block indexed by a runtime tap
// parity or tree would go to local memory).  The q-shift kernel takes its 7
// row and 7 column indices once per output.  The rereads of neighbouring
// inputs are served by L1/L2.  Bound on the card: memory for the LeGall
// kernels (16, 4 or 12 planes of h x w read, 16 B written per input
// position); the full q-shift kernel reads each input 49 times from L1 and
// does about 400 FLOPs per output, so L1 traffic and the FLOPs, not HBM,
// set its time.  No tiling yet.

#include <cstdint>

namespace vfp {
namespace {

constexpr int kThreads = 256;
constexpr int kG0 = 3, kG1 = 5;  // LeGall synthesis taps
constexpr int kQTaps = 14;       // q-shift synthesis taps
constexpr int kQHit = kQTaps / 2;  // taps that hit a sample per output
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

__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// sum over the taps k = k0, k0 + 2, ... (k0 = u & 1) of f[k] * y[((u - k) / 2)
// mod n], k from k0 upward: one up2 stage at position u - phase, reading the
// input with stride ``stride``.
template <int kTaps>
__device__ __forceinline__ float up2_at(const float* f, const float* y, long long stride, int u,
                                        int n) {
  const int k0 = u & 1;
  float acc = f[k0] * y[wrap((u - k0) >> 1, n) * stride];
#pragma unroll
  for (int s = 1; s < (kTaps + 1) / 2; ++s) {
    const int k = k0 + 2 * s;
    if (k < kTaps) acc = acc + f[k] * y[wrap((u - k) >> 1, n) * stride];
  }
  return acc;
}

// the 14-tap stage with its sample indices taken beforehand: sum_s f[k0 + 2s]
// * y[idx[s]], s from 0 upward
__device__ __forceinline__ float up2_q(const float* f, int k0, const float* y,
                                       const int idx[kQHit]) {
  float acc = f[k0] * y[idx[0]];
#pragma unroll
  for (int s = 1; s < kQHit; ++s) acc = acc + f[k0 + 2 * s] * y[idx[s]];
  return acc;
}

template <bool kFull>
__global__ void __launch_bounds__(kThreads)
    qshift_kernel(const float* __restrict__ d, float* __restrict__ out, int batch, int h, int w,
                  QSynParams p) {
  __shared__ float g[2][2][kQTaps];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int tr = 0; tr < 2; ++tr)
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int k = 0; k < kQTaps; ++k) g[tr][f][k] = p.g[tr][f][k];
  }
  __syncthreads();
  const int oh = 2 * h, ow = 2 * w;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)batch * 4 * oh * ow) return;
  const int x = (int)(t % ow);
  const int y = (int)((t / ow) % oh);
  const int ci = (int)((t / ((long long)ow * oh)) % 4);
  const long long b = t / (4LL * ow * oh);
  const int rt = ci >> 1, ct = ci & 1;
  const int r = wrap(y - (rt ? p.roll[1] : p.roll[0]), oh);  // the rolls
  const int c = wrap(x - (ct ? p.roll[1] : p.roll[0]), ow);
  const int kr = r & 1, kc = c & 1;
  int rows[kQHit], cols[kQHit];
#pragma unroll
  for (int s = 0; s < kQHit; ++s) {
    rows[s] = wrap((r - kr - 2 * s) >> 1, h) * w;
    cols[s] = wrap((c - kc - 2 * s) >> 1, w);
  }
  const long long plane = (long long)h * w;
  const float* db = d + b * (kFull ? 16 : 4) * plane;
  const float* ll = db + ci * plane;
  const float *g0r = g[rt][0], *g1r = g[rt][1], *g0c = g[ct][0], *g1c = g[ct][1];
  float a = 0.0f, e = 0.0f;
#pragma unroll
  for (int s = 0; s < kQHit; ++s) {
    const int k = kr + 2 * s;
    float lo = up2_q(g0c, kc, ll + rows[s], cols);
    if constexpr (kFull) lo = lo + up2_q(g1c, kc, db + (4 + ci) * plane + rows[s], cols);
    a = s == 0 ? g0r[k] * lo : a + g0r[k] * lo;
    if constexpr (kFull) {
      const float hi = up2_q(g0c, kc, db + (8 + ci) * plane + rows[s], cols) +
                       up2_q(g1c, kc, db + (12 + ci) * plane + rows[s], cols);
      e = s == 0 ? g1r[k] * hi : e + g1r[k] * hi;
    }
  }
  out[t] = kFull ? a + e : a;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    legall_kernel(const float* __restrict__ d, float* __restrict__ out, int batch, int h, int w,
                  SynParams p) {
  constexpr int kPlanes = kMode == kAll ? 16 : kMode == kLl ? 4 : 12;
  // the planes of ll, lh, hl, hh for tree 0 (-1: a zero band)
  constexpr int kLlAt = kMode == kHp ? -1 : 0;
  constexpr int kLhAt = kMode == kAll ? 4 : kMode == kHp ? 0 : -1;
  constexpr int kHlAt = kMode == kAll ? 8 : kMode == kHp ? 4 : -1;
  constexpr int kHhAt = kMode == kAll ? 12 : kMode == kHp ? 8 : -1;
  __shared__ float g0[kG0], g1[kG1];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kG0; ++k) g0[k] = p.g0[k];
#pragma unroll
    for (int k = 0; k < kG1; ++k) g1[k] = p.g1[k];
  }
  __syncthreads();
  const int oh = 2 * h, ow = 2 * w;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)batch * oh * ow) return;
  const int x = (int)(t % ow);
  const int y = (int)((t / ow) % oh);
  const long long b = t / ((long long)ow * oh);
  const int r = wrap(y - p.roll, oh), c = wrap(x - p.roll, ow);  // the roll
  const long long plane = (long long)h * w;
  const float* db = d + b * kPlanes * plane;
  float acc = 0.0f;
#pragma unroll
  for (int ci = 0; ci < 4; ++ci) {
    const int rt = ci >> 1, ct = ci & 1;
    const int u = r - rt, v = c - ct;
    const int k0 = u & 1;
    // rows: up2(lo, g0, rt) + up2(hi, g1, rt), each row of lo and hi its
    // column stage at v: lo = up2(ll, g0, ct) + up2(lh, g1, ct),
    // hi = up2(hl, g0, ct) + up2(hh, g1, ct)
    float a = 0.0f, e = 0.0f;
#pragma unroll
    for (int s = 0; s < (kG1 + 1) / 2; ++s) {
      const int k = k0 + 2 * s;
      if (k >= kG1) continue;
      const long long row = (long long)wrap((u - k) >> 1, h) * w;
      if (k < kG0) {
        float lo;
        if constexpr (kMode == kHp) {
          lo = up2_at<kG1>(g1, db + (kLhAt + ci) * plane + row, 1, v, w);
        } else {
          lo = up2_at<kG0>(g0, db + (kLlAt + ci) * plane + row, 1, v, w);
          if constexpr (kMode == kAll)
            lo = lo + up2_at<kG1>(g1, db + (kLhAt + ci) * plane + row, 1, v, w);
        }
        a = s == 0 ? g0[k] * lo : a + g0[k] * lo;
      }
      if constexpr (kHlAt >= 0) {
        const float hi = up2_at<kG0>(g0, db + (kHlAt + ci) * plane + row, 1, v, w) +
                         up2_at<kG1>(g1, db + (kHhAt + ci) * plane + row, 1, v, w);
        e = s == 0 ? g1[k] * hi : e + g1[k] * hi;
      }
    }
    const float tree = kHlAt >= 0 ? a + e : a;
    acc = ci == 0 ? tree : acc + tree;
  }
  out[t] = acc * 0.25f;
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

unsigned grid_for(long long total) { return (unsigned)((total + kThreads - 1) / kThreads); }

template <int kMode>
int launch_legall(const void* d, void* out, int batch, int h, int w, const void* params,
                  void* stream) {
  const long long total = (long long)batch * (2 * h) * (2 * w);
  if (total == 0) return 0;
  legall_kernel<kMode><<<grid_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)d, (float*)out, batch, h, w, syn_params(params));
  return (int)cudaGetLastError();
}

template <bool kFull>
int launch_qshift(const void* d, void* out, int batch, int h, int w, const void* params,
                  void* stream) {
  const long long total = (long long)batch * 4 * (2 * h) * (2 * w);
  if (total == 0) return 0;
  qshift_kernel<kFull><<<grid_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)d, (float*)out, batch, h, w, qsyn_params(params));
  return (int)cudaGetLastError();
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
