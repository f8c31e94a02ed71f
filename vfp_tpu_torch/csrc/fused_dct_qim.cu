// The perceptual DCT-QIM codec's embed and extract in one launch each, u8
// planes in, and the per-frame Y mean that their luminance mask needs.
//
// Replaces the Pallas kernels of vfp_tpu/kernels/fused_dct_qim.py:
// fused_dct_qim_mark and fused_dct_qim_extract, and the XLA pre-pass
// _y_dc_mean of the same file.  Per 8x8 pixel tile (one QIM block):
//
//   Y, U = ((M_FWD[k,0] * x0 + M_FWD[k,1] * x1) + M_FWD[k,2] * x2) + OFF_FWD[k]
//   C    = D Y Dᵀ, separable: a row pass then a column pass, each sum a
//          left fold over the 8 terms (1,024 multiplies and adds per tile,
//          a quarter of the 64x64 Kronecker form's)
//   v    = (D U Dᵀ)[2][1] = sum_r D[2][r] * (sum_c U[r][c] * D[1][c]); no
//          other U coefficient is read
//   step = alpha * (texture_mask(|C|) * luminance_mask(C[0][0] / 8, mean))
//   mark:    amp = qim(v, bit, step) - v; out_k = rint(clip(x_k + M_BWD[k,1]
//            * (amp * basis[r][c]), 0, 255)) with basis = outer(D[2], D[1]),
//            and x_k itself where M_BWD[k,1] == 0 (channel 2)
//   extract: bit = floor-mod(rint(v / step), 2) == 1
//
// The plain versions in kernels/fused_dct_qim.py repeat these operations in
// this order.  The build has no fast-math and --fmad=false, so every product
// and sum rounds as PyTorch's do and division is IEEE.  Reference quirks,
// each handled where it is marked below:
//   - jnp.round rounds half to even: rintf, never roundf;
//   - jnp.sign(0) == 0: (v > 0) - (v < 0), never copysignf;
//   - jnp.mod is a floor-mod: rint(-3) must give parity 1, which fmodf does
//     not, so the parity is q - 2 floor(q / 2);
//   - the texture mask divides by e and h unguarded: flat tiles give inf or
//     NaN there and IEEE comparisons decide the branches, as in the reference.
//
// None of the Mosaic workarounds is carried over: no selection matmuls, no
// strips or chunk widths, no padded columns, no u8->i32->f32 hop, no aliased
// output; any W % 8 == 0 width runs as it is.  One thread per tile keeps the
// 64 row-pass values in registers and overwrites them with the coefficients.
// Bound on the card: memory (3 B/pixel read, and 3 B/pixel written by mark)
// against about 3.5 kFLOP per 64 pixels.  Neighbouring threads take
// neighbouring tiles of a tile row.  Planes are read through the strides they
// come with; where they are the permuted view of an interleaved [B, H, W, 3]
// batch (channel stride 1, pixel stride 3, 8-byte aligned rows), each thread
// moves a tile row as three 8-byte words instead of 24 single bytes.
//
// The Y mean is a reduction across all tiles of a frame, so it is its own
// pass: a fixed-order two-stage sum in double (per-block partial sums, then
// one ordered sum per frame), with no atomics, so repeated runs decode the
// same bits.

#include <cstdint>

namespace vfp {
namespace {

constexpr int kThreads = 128;
constexpr int kMeanThreads = 256;

struct Strides {
  long long b, c, h, w;  // in elements (bytes: the planes are u8)
};

// Constants from Python (kernels/fused_dct_qim.py:_params_host), so they hold
// the reference's float32 bits.
struct Params {
  float d[64];      // D[p][i] at p * 8 + i: the orthonormal 8-point DCT-II
  float basis[64];  // outer(D[2], D[1]) at r * 8 + c: the spatial pattern of coefficient [2][1]
  float fwd_y[3], fwd_u[3];
  float off_y, off_u;
  float bwd[3];  // M_BWD[:, 1]
};

// One tile row: byte 3 * c + ch holds channel ch of pixel c, as in an
// interleaved frame.
template <bool kPacked>
__device__ __forceinline__ void load_row(const uint8_t* __restrict__ p, const Strides& s,
                                         unsigned v[24]) {
  if (kPacked) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    const uint2 b = *reinterpret_cast<const uint2*>(p + 8);
    const uint2 c = *reinterpret_cast<const uint2*>(p + 16);
    const unsigned w[6] = {a.x, a.y, b.x, b.y, c.x, c.y};
#pragma unroll
    for (int j = 0; j < 24; ++j) v[j] = (w[j >> 2] >> (8 * (j & 3))) & 0xffu;
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) v[3 * c + ch] = p[c * s.w + ch * s.c];
  }
}

template <bool kPacked>
__device__ __forceinline__ void store_row(uint8_t* __restrict__ p, const Strides& s,
                                          const unsigned v[24]) {
  if (kPacked) {
    unsigned w[6] = {0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 24; ++j) w[j >> 2] |= v[j] << (8 * (j & 3));
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    *reinterpret_cast<uint2*>(p + 8) = make_uint2(w[2], w[3]);
    *reinterpret_cast<uint2*>(p + 16) = make_uint2(w[4], w[5]);
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) p[c * s.w + ch * s.c] = (uint8_t)v[3 * c + ch];
  }
}

__device__ __forceinline__ float lincomb(const float m[3], float off, float x0, float x1,
                                         float x2) {
  return ((m[0] * x0 + m[1] * x1) + m[2] * x2) + off;
}

// jnp.sign: 0 at 0, never copysignf's +-1
__device__ __forceinline__ float sign_of(float v) { return (float)((v > 0.0f) - (v < 0.0f)); }

struct Qim {
  float v;     // U coefficient [2][1]
  float step;  // alpha * texture mask * luminance mask
};

// The QIM coefficient and step of the tile whose top-left pixel is (y0, x0).
template <bool kPacked>
__device__ __forceinline__ Qim tile_qim(const uint8_t* __restrict__ xb, const Strides& s, int y0,
                                        int x0, float mean, float alpha, const Params& k) {
  float c[64];  // row pass of Y: c[r * 8 + q] = sum_i Y[r][i] * D[q][i]
  float t[8];   // row pass of U against D[1] only
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    unsigned v[24];
    load_row<kPacked>(xb + (long long)(y0 + r) * s.h + (long long)x0 * s.w, s, v);
    float yv[8], uv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float b = (float)v[3 * i], g = (float)v[3 * i + 1], rr = (float)v[3 * i + 2];
      yv[i] = lincomb(k.fwd_y, k.off_y, b, g, rr);
      uv[i] = lincomb(k.fwd_u, k.off_u, b, g, rr);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float acc = yv[0] * k.d[q * 8];
#pragma unroll
      for (int i = 1; i < 8; ++i) acc = acc + yv[i] * k.d[q * 8 + i];
      c[r * 8 + q] = acc;
    }
    float acc = uv[0] * k.d[8];
#pragma unroll
    for (int i = 1; i < 8; ++i) acc = acc + uv[i] * k.d[8 + i];
    t[r] = acc;
  }
  // column pass, in place: c[p * 8 + q] = sum_r D[p][r] * rows[r][q]
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float col[8];
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      float acc = k.d[p * 8] * c[q];
#pragma unroll
      for (int r = 1; r < 8; ++r) acc = acc + k.d[p * 8 + r] * c[r * 8 + q];
      col[p] = acc;
    }
#pragma unroll
    for (int p = 0; p < 8; ++p) c[p * 8 + q] = col[p];
  }
  float u21 = k.d[16] * t[0];
#pragma unroll
  for (int r = 1; r < 8; ++r) u21 = u21 + k.d[16 + r] * t[r];

  // texture mask (vfp_tpu/wm/dct_qim.py:texture_mask)
#define A(p, q) fabsf(c[(p) * 8 + (q)])
  float total = A(0, 0);
#pragma unroll
  for (int i = 1; i < 64; ++i) total = total + fabsf(c[i]);
  const float dcl = A(0, 0) + A(0, 1) + A(0, 2) + A(1, 0) + A(1, 1) + A(2, 0);
  const float eh = total - dcl;
  const float e = A(3, 0) + A(4, 0) + A(5, 0) + A(6, 0) + A(0, 3) + A(0, 4) + A(0, 5) + A(0, 6) +
                  A(2, 1) + A(1, 2) + A(2, 2) + A(3, 3);
  const float h = eh - e;
  const float l = dcl - A(0, 0);
#undef A
  // unguarded IEEE division: a flat tile gives 0/0 = NaN or x/0 = inf here,
  // and the comparisons below then decide as the reference's do
  const float l_e = l / e;
  const float le_h = (l + e) / h;
  const bool edge_hi = ((l_e >= 1.4f) & (le_h >= 1.1f)) | ((l_e >= 1.1f) & (le_h >= 1.4f)) |
                       (le_h > 4.0f);
  const bool edge_lo = ((l_e >= 2.3f) & (le_h >= 1.6f)) | ((l_e >= 1.6f) & (le_h >= 2.3f)) |
                       (le_h > 4.0f);
  const float edge_val = (l + e <= 400.0f) ? 1.125f : 1.25f;
  const float ramp = 1.0f + 1.25f * (eh - 290.0f) / 1510.0f;
  const float hi = edge_hi ? edge_val : ramp;
  const float lo = edge_lo ? edge_val : ((e + h > 290.0f) ? ramp : 1.0f);
  const float tex = (eh > 125.0f) ? ((eh > 900.0f) ? hi : lo) : 1.0f;

  // luminance mask (vfp_tpu/kernels/fused_dct_qim.py:_lum_mask)
  const float dc = c[0] / 8.0f;
  const float m = fmaxf(90.0f, mean);
  const float f_ref = 1.0f + (m - 90.0f) * 1.0f / 165.0f;
  const float lramp = 1.0f + (dc - m) / (255.0f - m) * (2.0f - f_ref);
  const float lum = (dc > m) ? lramp : ((dc < 15.0f) ? 1.25f : ((dc < 25.0f) ? 1.125f : 1.0f));
  return Qim{u21, alpha * (tex * lum)};
}

template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
    mark_kernel(const uint8_t* __restrict__ x, Strides xs, uint8_t* __restrict__ o, Strides os,
                const float* __restrict__ wm, const float* __restrict__ means, int batch, int nbh,
                int nbw, float alpha, Params k) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)batch * nbh * nbw) return;
  const int tj = (int)(t % nbw);
  const int ti = (int)((t / nbw) % nbh);
  const long long b = t / ((long long)nbw * nbh);
  const uint8_t* xb = x + b * xs.b;
  uint8_t* ob = o + b * os.b;
  const int y0 = ti * 8, x0 = tj * 8;

  const Qim qv = tile_qim<kPacked>(xb, xs, y0, x0, means[b], alpha, k);
  const float step2 = qv.step + qv.step;
  const float sg = sign_of(qv.v);
  const float base = sg * floorf(fabsf(qv.v) / step2) * step2;
  const float target = (wm[(long long)ti * nbw + tj] == 0.0f) ? base : base + sg * qv.step;
  const float amp = target - qv.v;

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    unsigned v[24];
    load_row<kPacked>(xb + (long long)(y0 + r) * xs.h + (long long)x0 * xs.w, xs, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float du = amp * k.basis[r * 8 + i];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        if (k.bwd[ch] != 0.0f) {
          // clip before rounding; rintf is round-half-even like jnp.round
          const float f = fminf(fmaxf((float)v[3 * i + ch] + k.bwd[ch] * du, 0.0f), 255.0f);
          v[3 * i + ch] = (unsigned)rintf(f);
        }
      }
    }
    store_row<kPacked>(ob + (long long)(y0 + r) * os.h + (long long)x0 * os.w, os, v);
  }
}

template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
    extract_kernel(const uint8_t* __restrict__ x, Strides xs, float* __restrict__ bits,
                   const float* __restrict__ means, int batch, int nbh, int nbw, float alpha,
                   Params k) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)batch * nbh * nbw) return;
  const int tj = (int)(t % nbw);
  const int ti = (int)((t / nbw) % nbh);
  const long long b = t / ((long long)nbw * nbh);
  const Qim qv = tile_qim<kPacked>(x + b * xs.b, xs, ti * 8, tj * 8, means[b], alpha, k);
  const float q = rintf(qv.v / qv.step);
  // floor-mod parity, as jnp.mod: q = -3 gives 1 (fmodf would give -1)
  bits[t] = (q - 2.0f * floorf(q * 0.5f) == 1.0f) ? 1.0f : 0.0f;
}

// Stage 1 of the Y mean: block (j, b) sums Y over rows [j * rows, (j + 1) * rows)
// of frame b's h8 x w8 crop into partial[b * slots + j]; each thread takes a
// fixed set of pixels and the block sums them in a fixed tree.
__global__ void __launch_bounds__(kMeanThreads)
    y_sum_kernel(const uint8_t* __restrict__ x, Strides s, int h8, int w8, int rows, int slots,
                 double* __restrict__ partial, Params k) {
  const int b = blockIdx.y, j = blockIdx.x;
  const uint8_t* xb = x + (long long)b * s.b;
  double acc = 0.0;
  const int y1 = min(h8, (j + 1) * rows);
  for (int y = j * rows; y < y1; ++y)
    for (int xx = threadIdx.x; xx < w8; xx += kMeanThreads) {
      const uint8_t* p = xb + (long long)y * s.h + (long long)xx * s.w;
      acc += (double)lincomb(k.fwd_y, k.off_y, (float)p[0], (float)p[s.c], (float)p[2 * s.c]);
    }
  __shared__ double sh[kMeanThreads];
  sh[threadIdx.x] = acc;
  __syncthreads();
  for (int half = kMeanThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) sh[threadIdx.x] += sh[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[(long long)b * slots + j] = sh[0];
}

// Stage 2: one thread per frame sums its partials in order.
__global__ void y_mean_kernel(const double* __restrict__ partial, int blocks, int slots,
                              int batch, double count, float* __restrict__ means) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  double s = 0.0;
  for (int j = 0; j < blocks; ++j) s += partial[(long long)b * slots + j];
  means[b] = (float)(s / count);
}

Strides strides(const void* host_strides) {
  const long long* p = static_cast<const long long*>(host_strides);
  return Strides{p[0], p[1], p[2], p[3]};
}

Params params(const void* host_params) {
  Params k;
  const float* p = static_cast<const float*>(host_params);
  for (int i = 0; i < 64; ++i) k.d[i] = p[i];
  for (int i = 0; i < 64; ++i) k.basis[i] = p[64 + i];
  for (int i = 0; i < 3; ++i) k.fwd_y[i] = p[128 + i];
  for (int i = 0; i < 3; ++i) k.fwd_u[i] = p[131 + i];
  k.off_y = p[134];
  k.off_u = p[135];
  for (int i = 0; i < 3; ++i) k.bwd[i] = p[136 + i];
  return k;
}

unsigned grid_for(long long total) { return (unsigned)((total + kThreads - 1) / kThreads); }

}  // namespace
}  // namespace vfp

// Plain C interface, bound with ctypes (kernels/_build.py).  x/o/wm/means/
// bits/partial are device pointers (partial: batch x slots doubles of
// scratch); the stride arrays (4 int64: b, c, h, w) and the params array
// (139 floats in the order of vfp::Params) are host memory read before the
// launch; packed != 0 selects the 8-byte row path, which the caller allows
// only for interleaved, 8-byte aligned planes.  Returns the cudaError_t of
// the launch.

extern "C" int vfp_y_dc_mean(const void* x, const void* x_strides, void* partial,
                             void* means, int batch, int h8, int w8, int slots,
                             const void* params, void* stream) {
  if (batch == 0) return 0;
  const int rows = (h8 + slots - 1) / slots;
  const int blocks = rows > 0 ? (h8 + rows - 1) / rows : 0;  // <= slots
  if (blocks > 0) {
    vfp::y_sum_kernel<<<dim3(blocks, batch), vfp::kMeanThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)x, vfp::strides(x_strides), h8, w8, rows, slots, (double*)partial,
        vfp::params(params));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  vfp::y_mean_kernel<<<(batch + 31) / 32, 32, 0, (cudaStream_t)stream>>>(
      (const double*)partial, blocks, slots, batch, (double)h8 * (double)w8, (float*)means);
  return (int)cudaGetLastError();
}

extern "C" int vfp_fused_dct_qim_mark(const void* x, const void* x_strides, void* o,
                                      const void* o_strides, const void* wm, const void* means,
                                      int batch, int nbh, int nbw, float alpha, int packed,
                                      const void* params, void* stream) {
  const long long total = (long long)batch * nbh * nbw;
  if (total == 0) return 0;
  const vfp::Strides xs = vfp::strides(x_strides), os = vfp::strides(o_strides);
  const vfp::Params k = vfp::params(params);
  if (packed)
    vfp::mark_kernel<true><<<vfp::grid_for(total), vfp::kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)x, xs, (uint8_t*)o, os, (const float*)wm, (const float*)means, batch,
        nbh, nbw, alpha, k);
  else
    vfp::mark_kernel<false><<<vfp::grid_for(total), vfp::kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)x, xs, (uint8_t*)o, os, (const float*)wm, (const float*)means, batch,
        nbh, nbw, alpha, k);
  return (int)cudaGetLastError();
}

extern "C" int vfp_fused_dct_qim_extract(const void* x, const void* x_strides, void* bits,
                                         const void* means, int batch, int nbh, int nbw,
                                         float alpha, int packed, const void* params,
                                         void* stream) {
  const long long total = (long long)batch * nbh * nbw;
  if (total == 0) return 0;
  const vfp::Strides xs = vfp::strides(x_strides);
  const vfp::Params k = vfp::params(params);
  if (packed)
    vfp::extract_kernel<true><<<vfp::grid_for(total), vfp::kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)x, xs, (float*)bits, (const float*)means, batch, nbh, nbw, alpha, k);
  else
    vfp::extract_kernel<false><<<vfp::grid_for(total), vfp::kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)x, xs, (float*)bits, (const float*)means, batch, nbh, nbw, alpha, k);
  return (int)cudaGetLastError();
}
