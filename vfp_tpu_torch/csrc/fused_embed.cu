// The whole flagship embed and extract in one launch each, u8 planes in.
//
// Replaces the Pallas kernels of vfp_tpu/kernels/fused_embed.py:
// fused_mark_planar and fused_extract_planar.  What they compute, per 4x4
// block of the Haar LL band of one colour channel (one 8x8 pixel tile):
//
//   cp = M_FWD[chan] . (B, G, R)                    (no offset yet)
//   LL = 0.5 * ((cp00 + cp10) + off2) + 0.5 * ((cp01 + cp11) + off2)
//        with off2 = 2 * OFF_FWD[chan]: the +0.5 chroma offset folded in
//        after the row pair-sum, as the Pallas kernel folds it
//   (s0, u, v) = dominant_triplet(LL block)          (triplet.cuh)
//   mark:    du = 0.5 * (ds * (u[r] * v[c])), ds = qim_target(s0, bit) - s0,
//            on the 2x2 quad of LL entry (r, c); out_k = rint(clip(x_k +
//            M_BWD[k, chan] * du, 0, 255)), and x_k itself where
//            M_BWD[k, chan] == 0; tiles outside the nbh x nbw grid (tail rows
//            and columns) are copied through
//   extract: bit = (s0 mod scale) > scale / 2
//
// None of the Mosaic workarounds is carried over: no selection matmuls, no
// row strips or lane chunks, no u8->i32->f32 hop, and the mark writes a new
// output (no aliasing).  One thread per tile computes the LL block from the
// u8 pixels in registers, reading the planes through the strides it is given
// (so a [B, H, W, 3] frame batch viewed as [B, 3, H, W] needs no copy).
// Bound on the card: memory — 3 B/pixel read for extract, 3 B read + 3 B
// written for mark, against a few hundred FLOPs per 64 pixels.  Neighbouring
// threads take neighbouring tiles of one tile row, so a warp reads 32
// consecutive 8-pixel runs of each image row.

#include <cstdint>

#include "triplet.cuh"

namespace vfp {
namespace {

constexpr int kThreads = 128;

struct Strides {
  long long b, c, h, w;  // in elements (bytes: the planes are u8)
};

// Colour constants for one channel, from Python (ops/color.py) so they hold
// the reference's float32 bits: the forward row, the folded offset and the
// backward column.
struct Color {
  float fwd[3];
  float off2;
  float bwd[3];
};

__device__ __forceinline__ float chan_value(const uint8_t* __restrict__ p, long long sc,
                                            const Color& k) {
  return k.fwd[0] * (float)p[0] + k.fwd[1] * (float)p[sc] + k.fwd[2] * (float)p[2 * sc];
}

// LL block (row-major 4x4) of the tile whose top-left pixel is (y0, x0).
__device__ __forceinline__ void ll_block(const uint8_t* __restrict__ x, const Strides& s, int y0,
                                         int x0, const Color& k, float ll[16]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint8_t* p = x + (long long)(y0 + 2 * r) * s.h + (long long)(x0 + 2 * c) * s.w;
      const float left = (chan_value(p, s.c, k) + chan_value(p + s.h, s.c, k)) + k.off2;
      const float right = (chan_value(p + s.w, s.c, k) + chan_value(p + s.h + s.w, s.c, k)) + k.off2;
      ll[r * 4 + c] = 0.5f * left + 0.5f * right;
    }
  }
}

__global__ void mark_kernel(const uint8_t* __restrict__ x, Strides xs, uint8_t* __restrict__ o,
                            Strides os, const float* __restrict__ wm, int batch, int height,
                            int width, int nbh, int nbw, int tiles_h, int tiles_w, float scale,
                            Color k, StartVector v0) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)batch * tiles_h * tiles_w) return;
  const int tj = (int)(t % tiles_w);
  const int ti = (int)((t / tiles_w) % tiles_h);
  const long long b = t / ((long long)tiles_w * tiles_h);
  const uint8_t* xb = x + b * xs.b;
  uint8_t* ob = o + b * os.b;
  const int y0 = ti * 8, x0 = tj * 8;

  if (ti >= nbh || tj >= nbw) {  // outside the block grid: pass through
    const int y1 = min(y0 + 8, height), x1 = min(x0 + 8, width);
    for (int y = y0; y < y1; ++y)
      for (int xx = x0; xx < x1; ++xx)
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          ob[ch * os.c + y * os.h + xx * os.w] = xb[ch * xs.c + y * xs.h + xx * xs.w];
    return;
  }

  float ll[16], u[4], v[4];
  ll_block(xb, xs, y0, x0, k, ll);
  const float s0 = dominant_triplet(ll, v0, u, v);
  const float ds = qim_target(s0, wm[(long long)ti * nbw + tj], scale) - s0;

#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float du = 0.5f * (ds * (u[r] * v[c]));
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const long long y = y0 + 2 * r + dy, xx = x0 + 2 * c + dx;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            const uint8_t xv = xb[ch * xs.c + y * xs.h + xx * xs.w];
            uint8_t ov = xv;
            if (k.bwd[ch] != 0.0f) {
              // clip before rounding; rint is round-half-even like jnp.round
              const float f = fminf(fmaxf((float)xv + k.bwd[ch] * du, 0.0f), 255.0f);
              ov = (uint8_t)__float2int_rn(f);
            }
            ob[ch * os.c + y * os.h + xx * os.w] = ov;
          }
        }
      }
    }
  }
}

__global__ void extract_kernel(const uint8_t* __restrict__ x, Strides xs, float* __restrict__ bits,
                               int batch, int nbh, int nbw, float scale, Color k, StartVector v0) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)batch * nbh * nbw) return;
  const int tj = (int)(t % nbw);
  const int ti = (int)((t / nbw) % nbh);
  const long long b = t / ((long long)nbw * nbh);
  float ll[16], u[4], v[4];
  ll_block(x + b * xs.b, xs, ti * 8, tj * 8, k, ll);
  bits[t] = qim_bit(dominant_triplet(ll, v0, u, v), scale);
}

Strides strides(const void* host_strides) {
  const long long* p = static_cast<const long long*>(host_strides);
  return Strides{p[0], p[1], p[2], p[3]};
}

Color color(const void* host_color) {
  const float* p = static_cast<const float*>(host_color);
  return Color{{p[0], p[1], p[2]}, p[3], {p[4], p[5], p[6]}};
}

StartVector start_vector(const void* host_v0) {
  StartVector v0;
  const float* p = static_cast<const float*>(host_v0);
  for (int i = 0; i < 4; ++i) v0.x[i] = p[i];
  return v0;
}

unsigned grid_for(long long total) { return (unsigned)((total + kThreads - 1) / kThreads); }

}  // namespace
}  // namespace vfp

// Plain C interface, bound with ctypes (kernels/_build.py).  x/o/wm/bits are
// device pointers; the stride arrays (4 int64: b, c, h, w), the colour array
// (7 floats: fwd[3], off2, bwd[3]) and v0 (4 floats) are host memory read
// before the launch.  Returns the cudaError_t of the launch.

extern "C" int vfp_fused_mark_planar(const void* x, const void* x_strides, void* o,
                                     const void* o_strides, const void* wm, int batch, int height,
                                     int width, int nbh, int nbw, float scale,
                                     const void* color, const void* v0, void* stream) {
  const int tiles_h = (height + 7) / 8, tiles_w = (width + 7) / 8;
  const long long total = (long long)batch * tiles_h * tiles_w;
  if (total == 0) return 0;
  vfp::mark_kernel<<<vfp::grid_for(total), vfp::kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, vfp::strides(x_strides), (uint8_t*)o, vfp::strides(o_strides),
      (const float*)wm, batch, height, width, nbh, nbw, tiles_h, tiles_w, scale,
      vfp::color(color), vfp::start_vector(v0));
  return (int)cudaGetLastError();
}

extern "C" int vfp_fused_extract_planar(const void* x, const void* x_strides, void* bits,
                                        int batch, int nbh, int nbw, float scale,
                                        const void* color, const void* v0, void* stream) {
  const long long total = (long long)batch * nbh * nbw;
  if (total == 0) return 0;
  vfp::extract_kernel<<<vfp::grid_for(total), vfp::kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, vfp::strides(x_strides), (float*)bits, batch, nbh, nbw, scale,
      vfp::color(color), vfp::start_vector(v0));
  return (int)cudaGetLastError();
}
