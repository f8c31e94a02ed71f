// DT-CWT level-1 analysis with the LeGall 5/3 pair and circular indexing.
//
// Replaces the Pallas kernels of vfp_tpu/kernels/dtcwt_level1.py:
//   ll_color_kernel<1> <- dtcwt_level1_analysis_ll_y (:508) and its chained
//                         twin dtcwt_level1_ll_y_chain (:918): u8 [B, H, W, 3]
//                         -> the Y channel's 4 tree lowpasses [B, 4, H/2, W/2];
//   ll_color_kernel<2> <- dtcwt_level1_analysis_ll_color (:428) and its chained
//                         twin dtcwt_level1_ll_color_chain (:888): u8 frames
//                         -> the Y and U tree lowpasses [B, 2, 4, H/2, W/2];
//   analysis_kernel<true>  <- dtcwt_level1_analysis (:276): f32 [B, H, W] -> the
//                         16 planes [ll*4, lh*4, hl*4, hh*4], combos (rt, ct)
//                         row-major;
//   analysis_kernel<false> <- dtcwt_level1_analysis_ll (:347): f32 [B, H, W] ->
//                         the 4 tree lowpasses [B, 4, H/2, W/2] (the codecs'
//                         float-frame and odd-shape path), ll_y's row pass.
//
// Per tree (rt, ct) and output (m, n): a row pass
//   lo_rt[x] = sum_k f[k] * X[(2m + rt - k) mod H][x]       (k from 0 upward)
// then a column pass
//   out[m][n] = sum_k g[k] * lo_rt[(2n + ct - k) mod W].
// With the 5-tap h0 and both phases, every output position reads rows
// 2m-4 .. 2m+1 and columns 2n-4 .. 2n+1: one thread loads that 6x6 patch
// (for u8 input it reads each pixel's 3 bytes once and forms each channel as
// ((M_FWD[ch,0] b + M_FWD[ch,1] g) + M_FWD[ch,2] r) + OFF_FWD[ch]) and writes
// all 4 (8, or 16) planes of its position.  Modular
// indexing covers the chained and unchained Pallas twins alike: there is no
// pad copy, no selection matmul, no strip or chunk width, and no
// u8->i32->f32 hop.  The plain versions in kernels/dtcwt_level1.py fold in
// the same order; the build has --fmad=false and no fast-math.
//
// Bound on the card: memory (3 B/pixel read for the u8 kernels and 4 B
// (Y) or 8 B (Y and U) per pixel written; 4 B/pixel read and 16 B/pixel
// written for the full analysis, 4 B/pixel for its lowpass-only twin)
// against about 100 (190, 170, 72) FLOPs per output position.  A patch
// overlaps its neighbours' 9-fold; the overlap is served by L1/L2, not HBM.
// Neighbouring threads take neighbouring n, so the plane stores coalesce.

#include <cstdint>

namespace vfp {
namespace {

constexpr int kThreads = 128;

// Constants from Python (kernels/dtcwt_level1.py:_params_host).
struct L1Params {
  float h0[5], h1[3];
  float fwd[2][3];  // M_FWD rows of Y and U
  float off[2];     // OFF_FWD of Y and U
};

__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// lo[c] = sum_k f[k] * p[rt - k + 4][c] over the taps, k from 0 upward.
template <int kTaps>
__device__ __forceinline__ void row_pass(const float p[6][6], const float* f, int rt,
                                         float lo[6]) {
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    float acc = f[0] * p[rt + 4][c];
#pragma unroll
    for (int k = 1; k < kTaps; ++k) acc = acc + f[k] * p[rt - k + 4][c];
    lo[c] = acc;
  }
}

template <int kTaps>
__device__ __forceinline__ float col_pass(const float lo[6], const float* f, int ct) {
  float acc = f[0] * lo[ct + 4];
#pragma unroll
  for (int k = 1; k < kTaps; ++k) acc = acc + f[k] * lo[ct - k + 4];
  return acc;
}

// kCh = 1: Y only; kCh = 2: Y and U, out [B, 2, 4, H/2, W/2].
template <int kCh>
__global__ void __launch_bounds__(kThreads)
    ll_color_kernel(const uint8_t* __restrict__ x, float* __restrict__ out, int batch, int h,
                    int w, L1Params k) {
  const int h1 = h / 2, w1 = w / 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)batch * h1 * w1) return;
  const int n = (int)(t % w1);
  const int m = (int)((t / w1) % h1);
  const long long b = t / ((long long)w1 * h1);
  const uint8_t* xb = x + b * h * w * 3;
  float p[kCh][6][6];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    const uint8_t* row = xb + (long long)wrap(2 * m - 4 + r, h) * w * 3;
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const uint8_t* px = row + wrap(2 * n - 4 + c, w) * 3;
      const float v0 = (float)px[0], v1 = (float)px[1], v2 = (float)px[2];
#pragma unroll
      for (int ch = 0; ch < kCh; ++ch)
        p[ch][r][c] = ((k.fwd[ch][0] * v0 + k.fwd[ch][1] * v1) + k.fwd[ch][2] * v2) + k.off[ch];
    }
  }
  const long long plane = (long long)h1 * w1;
  float* ob = out + b * kCh * 4 * plane + (long long)m * w1 + n;
#pragma unroll
  for (int ch = 0; ch < kCh; ++ch)
#pragma unroll
    for (int rt = 0; rt < 2; ++rt) {
      float lo[6];
      row_pass<5>(p[ch], k.h0, rt, lo);
#pragma unroll
      for (int ct = 0; ct < 2; ++ct) ob[(ch * 4 + rt * 2 + ct) * plane] = col_pass<5>(lo, k.h0, ct);
    }
}

// kFull: all 16 planes; else the 4 lowpasses [B, 4, H/2, W/2].
template <bool kFull>
__global__ void __launch_bounds__(kThreads)
    analysis_kernel(const float* __restrict__ x, float* __restrict__ out, int batch, int h, int w,
                    L1Params k) {
  constexpr int kPlanes = kFull ? 16 : 4;
  const int h1 = h / 2, w1 = w / 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)batch * h1 * w1) return;
  const int n = (int)(t % w1);
  const int m = (int)((t / w1) % h1);
  const long long b = t / ((long long)w1 * h1);
  const float* xb = x + b * h * w;
  float p[6][6];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    const float* row = xb + (long long)wrap(2 * m - 4 + r, h) * w;
#pragma unroll
    for (int c = 0; c < 6; ++c) p[r][c] = row[wrap(2 * n - 4 + c, w)];
  }
  const long long plane = (long long)h1 * w1;
  float* ob = out + b * kPlanes * plane + (long long)m * w1 + n;
#pragma unroll
  for (int rt = 0; rt < 2; ++rt) {
    float lo[6];
    row_pass<5>(p, k.h0, rt, lo);
#pragma unroll
    for (int ct = 0; ct < 2; ++ct) ob[(rt * 2 + ct) * plane] = col_pass<5>(lo, k.h0, ct);  // ll
    if constexpr (kFull) {
      float hi[6];
      row_pass<3>(p, k.h1, rt, hi);
#pragma unroll
      for (int ct = 0; ct < 2; ++ct) {
        const int combo = rt * 2 + ct;
        ob[(1 * 4 + combo) * plane] = col_pass<3>(lo, k.h1, ct);  // lh
        ob[(2 * 4 + combo) * plane] = col_pass<5>(hi, k.h0, ct);  // hl
        ob[(3 * 4 + combo) * plane] = col_pass<3>(hi, k.h1, ct);  // hh
      }
    }
  }
}

L1Params params(const void* host_params) {
  L1Params k;
  const float* p = static_cast<const float*>(host_params);
  for (int i = 0; i < 5; ++i) k.h0[i] = p[i];
  for (int i = 0; i < 3; ++i) k.h1[i] = p[5 + i];
  for (int ch = 0; ch < 2; ++ch) {
    for (int i = 0; i < 3; ++i) k.fwd[ch][i] = p[8 + 4 * ch + i];
    k.off[ch] = p[11 + 4 * ch];
  }
  return k;
}

unsigned grid_for(long long total) { return (unsigned)((total + kThreads - 1) / kThreads); }

}  // namespace
}  // namespace vfp

// Plain C interface, bound with ctypes (kernels/_build.py).  x/out are
// device pointers to contiguous tensors (x: u8 [B, H, W, 3] or f32 [B, H, W];
// out: f32 [B, 4, H/2, W/2], [B, 2, 4, H/2, W/2] or [B, 16, H/2, W/2]); H
// and W are even; params is host memory (16 floats in the order of
// vfp::L1Params).  Returns the launch's cudaError_t.

template <int kCh>
static int launch_ll(const void* x, void* out, int batch, int h, int w, const void* params,
                     void* stream) {
  const long long total = (long long)batch * (h / 2) * (w / 2);
  if (total == 0) return 0;
  vfp::ll_color_kernel<kCh><<<vfp::grid_for(total), vfp::kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (float*)out, batch, h, w, vfp::params(params));
  return (int)cudaGetLastError();
}

extern "C" int vfp_dtcwt_level1_ll_y(const void* x, void* out, int batch, int h, int w,
                                     const void* params, void* stream) {
  return launch_ll<1>(x, out, batch, h, w, params, stream);
}

extern "C" int vfp_dtcwt_level1_ll_color(const void* x, void* out, int batch, int h, int w,
                                         const void* params, void* stream) {
  return launch_ll<2>(x, out, batch, h, w, params, stream);
}

template <bool kFull>
static int launch_analysis(const void* x, void* out, int batch, int h, int w, const void* params,
                           void* stream) {
  const long long total = (long long)batch * (h / 2) * (w / 2);
  if (total == 0) return 0;
  vfp::analysis_kernel<kFull><<<vfp::grid_for(total), vfp::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, batch, h, w, vfp::params(params));
  return (int)cudaGetLastError();
}

extern "C" int vfp_dtcwt_level1_analysis(const void* x, void* out, int batch, int h, int w,
                                         const void* params, void* stream) {
  return launch_analysis<true>(x, out, batch, h, w, params, stream);
}

extern "C" int vfp_dtcwt_level1_analysis_ll(const void* x, void* out, int batch, int h, int w,
                                            const void* params, void* stream) {
  return launch_analysis<false>(x, out, batch, h, w, params, stream);
}
