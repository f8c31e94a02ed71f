// The DT-CWT decode's level-1 LeGall synthesis of the 12 highpass planes with
// a zero lowpass: [B, 12, h, w] planes [lh*4, hl*4, hh*4] (tree combos (rt,
// ct) row-major) -> the recovered plane [B, 2h, 2w].
//
// Replaces the Pallas kernel dtcwt_legall_synthesis_hp of
// vfp_tpu/kernels/dtcwt_synthesis.py (:467).  Per tree (rt, ct), as
// ops/dtcwt.py:Transform2d.synthesis_legall_hp computes it:
//   lo = up2(lh, g1, ct),  hi = up2(hl, g0, ct) + up2(hh, g1, ct)    (along W)
//   x  = up2(lo, g0, rt) + up2(hi, g1, rt)                            (along H)
// rolled by LEGALL_ROLL on both axes, out[i][j] = x[(i - roll) mod 2h][(j -
// roll) mod 2w]; then out = (((x_00 + x_01) + x_10) + x_11) * 0.25.  One 1-D
// stage, with y2 the zero-upsampled input (y2[2a + phase] = y[a]), is
//   up2(y, f, phase)[n] = sum_k f[k] * y2[(n - k) mod 2N]      (k from 0 upward)
// and only the taps that hit a sample are summed: k = k0, k0 + 2, ... with k0
// the parity of n - phase.  The plain version adds the zero terms too, and
// adding an exact zero leaves a float sum unchanged; the build has
// --fmad=false, so both round alike.
//
// One thread per output pixel computes every intermediate it needs in
// registers (1-2 rows of lo and 2-3 rows of hi per tree, each 1-3 column
// taps), with circular reads of the input.  At 1080p the output is 136x240
// per frame, so the kernel is bound by its launch, not by its 6.3 MB of input
// and 2.1 MB of output per 16-frame batch; no tiling is worth its code.

#include <cstdint>

namespace vfp {
namespace {

constexpr int kThreads = 256;
constexpr int kG0 = 3, kG1 = 5;

// From Python (kernels/dtcwt_synthesis.py:_params_host).
struct SynParams {
  float g0[kG0], g1[kG1];  // LeGall synthesis lowpass and highpass
  int roll;                // LEGALL_ROLL
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

__global__ void __launch_bounds__(kThreads)
    legall_hp_kernel(const float* __restrict__ d, float* __restrict__ out, int batch, int h,
                     int w, SynParams p) {
  // the filters in shared memory: indexing the kernel parameter block by the
  // runtime tap parity would copy it to local memory
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
  const float* db = d + b * 12 * plane;
  float acc = 0.0f;
#pragma unroll
  for (int ci = 0; ci < 4; ++ci) {
    const int rt = ci >> 1, ct = ci & 1;
    const float* lh = db + (0 * 4 + ci) * plane;
    const float* hl = db + (1 * 4 + ci) * plane;
    const float* hh = db + (2 * 4 + ci) * plane;
    const int u = r - rt, v = c - ct;
    const int k0 = u & 1;
    // rows: up2(lo, g0, rt) + up2(hi, g1, rt), each row of lo and hi its
    // column stage at v: lo = up2(lh, g1, ct), hi = up2(hl, g0, ct) + up2(hh, g1, ct)
    float a = 0.0f, e = 0.0f;
#pragma unroll
    for (int s = 0; s < (kG1 + 1) / 2; ++s) {
      const int k = k0 + 2 * s;
      if (k >= kG1) continue;
      const long long row = (long long)wrap((u - k) >> 1, h) * w;
      if (k < kG0) {
        const float lo = up2_at<kG1>(g1, lh + row, 1, v, w);
        a = s == 0 ? g0[k] * lo : a + g0[k] * lo;
      }
      const float hi = up2_at<kG0>(g0, hl + row, 1, v, w) + up2_at<kG1>(g1, hh + row, 1, v, w);
      e = s == 0 ? g1[k] * hi : e + g1[k] * hi;
    }
    const float tree = a + e;
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

}  // namespace
}  // namespace vfp

// Plain C interface, bound with ctypes (kernels/_build.py).  d/out are device
// pointers to contiguous f32 [B, 12, h, w] and [B, 2h, 2w]; params is host
// memory (9 floats: LeGall g0, g1, then the roll).  Returns the launch's
// cudaError_t.
extern "C" int vfp_dtcwt_legall_synthesis_hp(const void* d, void* out, int batch, int h, int w,
                                             const void* params, void* stream) {
  const long long total = (long long)batch * (2 * h) * (2 * w);
  if (total == 0) return 0;
  const unsigned grid = (unsigned)((total + vfp::kThreads - 1) / vfp::kThreads);
  vfp::legall_hp_kernel<<<grid, vfp::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)d, (float*)out, batch, h, w, vfp::syn_params(params));
  return (int)cudaGetLastError();
}
