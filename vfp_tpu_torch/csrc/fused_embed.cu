// The whole flagship embed and extract in one launch each, u8 planes in.
//
// Replaces the Pallas kernels of vfp_tpu/kernels/fused_embed.py:
// fused_mark_planar and fused_extract_planar, both of their bodies: the
// float32 one and the integer one the static int_path selects
// (vfp_tpu/kernels/fused_embed.py:127-226 and :304-334 under int_path).  What
// they compute, per 4x4 block of the Haar LL band of one colour channel (one
// 8x8 pixel tile):
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
// The integer body (kInt, Coef<true>): cp = mi . (B, G, R) in int32 with the
// colour row at 2^14 (mi = round(M_FWD[chan] * 2^14)); the row pair-sum
// cp00 + cp10 is int32 too, below 2^24 in magnitude, so its one conversion
// to float32 is exact; then (pair * 2^-14) + off2 and the same 0.5 + 0.5
// column pair, triplet and QIM.  Its mark epilogue is integer: duq =
// rint(1024 du) (half to even; 1024 du is exact), v = (x << 20) + duq * mki
// + 2^19 with mki = round(M_BWD[k, chan] * 2^10), out_k = clamp(v >> 20, 0,
// 255), the arithmetic shift rounding half up; a tile outside the grid has
// duq = 0, and x << 20 + 2^19 shifts back to x.
//
// None of the Mosaic workarounds is carried over: no selection matmuls, no
// row strips or lane chunks, no u8->i32->f32 hop, and the mark writes a new
// output (no aliasing).  Both read the planes through the strides they are
// given, so a [B, H, W, 3] frame batch viewed as [B, 3, H, W] needs no copy.
// Bound on the card: memory — 3 B/pixel read for extract, 3 B read + 3 B
// written for mark (a 1080p B=16 batch: 101.6 MB and 199.2 MB, 0.0303 ms
// and 0.0595 ms at 3.35 TB/s, for both bodies), against a few hundred FLOPs
// per 64 pixels.  In practice the float32 bodies are bound by issue: with
// --fmad=false every multiply and add issues alone, and the extract's
// byte-to-float conversions (197 I2F a tile) go through the conversion unit
// at a fraction of the float rate.  The integer body moves that work to the
// integer pipes, which issue beside the float ones: bytes unpacked by
// permutes and shifts, 3 IMADs a pixel and the pair-sums in int32, 2 exact
// conversions per LL entry (32 a tile), and a mark epilogue of IMAD, shift
// and clamp per byte.
//
// Extract: one thread per tile computes the LL block from the u8 pixels in
// registers; neighbouring threads take neighbouring tiles of one tile row,
// so a warp reads 32 consecutive 8-pixel runs of each image row.
//
// Mark (mark_tile_kernel): a block owns 8 tile rows x 16 tiles, one thread
// per tile, in three stages with a barrier between them:
//   1. the strip's 64 pixel rows of 384 bytes go to shared memory once, by
//      16-byte (W % 16 == 0) or 4-byte cp.async on the interleaved view
//      (every row is 4-byte aligned, since the wrapper demands W % 4 == 0),
//      byte by byte through the strides otherwise;
//   2. each thread reads its tile's 192 bytes from shared memory (8-byte
//      reads, conflict-free across the warp), forms the LL block in
//      ll_block's order, runs dominant_triplet and qim_target (triplet.cuh)
//      and writes du = 0.5 * (ds * (u[r] * v[c])) per LL entry to shared
//      memory (the integer body: duq = rint(1024 du)); a tile outside the
//      nbh x nbw grid gets du = 0, which leaves every byte as it is (x +
//      M_BWD * 0 is x, and x is a whole number in [0, 255]);
//   3. byte-parallel output: an item is 48 bytes (16 pixels) of one staged
//      row, where each byte's channel and LL column are compile-time; each
//      byte of a channel with M_BWD[k, chan] != 0 becomes rint(clip(x +
//      M_BWD[k, chan] * du, 0, 255)) (the integer body: clamp(((x << 20) +
//      duq * mki + 2^19) >> 20, 0, 255)), and the 48 bytes go out as three
//      16-byte or twelve 4-byte stores.
// The float32 body converts bytes to float and back exactly by integer
// permutes and float adds (staging.cuh), not by the conversion unit; the
// integer body never converts a byte.

#include <cstdint>
#include <cstring>
#include <type_traits>

#include "staging.cuh"  // cp.async, byte_to_float, float_to_byte, Strides
#include "triplet.cuh"

namespace vfp {
namespace {

constexpr int kThreads = 128;

// mark_tile_kernel's geometry
constexpr int kMarkTc = 16;                       // tiles a block row
constexpr int kMarkTr = 8;                        // tile rows a block
constexpr int kMarkThreads = kMarkTc * kMarkTr;   // one thread per tile in stage 2
constexpr int kMarkRows = 8 * kMarkTr;            // staged pixel rows (64)
constexpr int kMarkRowBytes = 3 * 8 * kMarkTc;    // staged bytes a row (384)
constexpr int kChunk = 48;                        // output bytes an item: 16 pixels
constexpr int kChunks = kMarkRowBytes / kChunk;   // items a row (8)
constexpr int kDuRow = 4 * kMarkTc;               // du entries a LL row (64)
// 6 blocks of 32 KB shared memory a SM (24 warps): at most 80 registers
constexpr int kMarkBlocks = 6;

// Colour constants for one channel, from Python (kernels/fused_embed.py) so
// they hold the reference's bits: the forward row, the folded offset and the
// backward column; float32 for the float body, the integer body's fixed
// point (fwd at 2^14, bwd at 2^10) for Coef<true>.
template <bool kInt>
struct Coef {
  float fwd[3];
  float off2;
  float bwd[3];
};

template <>
struct Coef<true> {
  int fwd[3];
  float off2;
  int bwd[3];
};

constexpr float kMacScale = 1.0f / 16384.0f;  // 2^-14, exact
constexpr int kEpiShift = 20;                  // the integer epilogue's 2^20
constexpr int kEpiHalf = 1 << (kEpiShift - 1);

__device__ __forceinline__ float chan_value(const uint8_t* __restrict__ p, long long sc,
                                            const Coef<false>& k) {
  return k.fwd[0] * (float)p[0] + k.fwd[1] * (float)p[sc] + k.fwd[2] * (float)p[2 * sc];
}

// u8 loads widen to int32 with no conversion: three IMADs a pixel
__device__ __forceinline__ int chan_value(const uint8_t* __restrict__ p, long long sc,
                                          const Coef<true>& k) {
  return k.fwd[0] * (int)p[0] + k.fwd[1] * (int)p[sc] + k.fwd[2] * (int)p[2 * sc];
}

// One LL row value of the integer body: its exact int32 pair-sum, converted
// once (exact below 2^24), scaled by 2^-14 (exact) and offset.
__device__ __forceinline__ float fixed_pair(int pair, float off2) {
  return __int2float_rn(pair) * kMacScale + off2;
}

// LL block (row-major 4x4) of the tile whose top-left pixel is (y0, x0).
template <bool kInt>
__device__ __forceinline__ void ll_block(const uint8_t* __restrict__ x, const Strides& s, int y0,
                                         int x0, const Coef<kInt>& k, float ll[16]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint8_t* p = x + (long long)(y0 + 2 * r) * s.h + (long long)(x0 + 2 * c) * s.w;
      if constexpr (kInt) {
        const float left = fixed_pair(chan_value(p, s.c, k) + chan_value(p + s.h, s.c, k), k.off2);
        const float right =
            fixed_pair(chan_value(p + s.w, s.c, k) + chan_value(p + s.h + s.w, s.c, k), k.off2);
        ll[r * 4 + c] = 0.5f * left + 0.5f * right;
      } else {
        const float left = (chan_value(p, s.c, k) + chan_value(p + s.h, s.c, k)) + k.off2;
        const float right =
            (chan_value(p + s.w, s.c, k) + chan_value(p + s.h + s.w, s.c, k)) + k.off2;
        ll[r * 4 + c] = 0.5f * left + 0.5f * right;
      }
    }
  }
}

// kVec = 16 or 4: the interleaved view (channel stride 1, pixel stride 3),
// rows and batch items kVec-byte aligned in and out; kVec = 1: any strides,
// byte by byte.  kInt: the integer body (s_du then holds duq).
template <int kVec, bool kInt>
__global__ void __launch_bounds__(kMarkThreads, kMarkBlocks)
    mark_tile_kernel(const uint8_t* __restrict__ x, Strides xs, uint8_t* __restrict__ o,
                     Strides os, const float* __restrict__ wm, int height, int width, int nbh,
                     int nbw, float scale, Coef<kInt> k, StartVector v0) {
  using Du = std::conditional_t<kInt, int, float>;
  using Du4 = std::conditional_t<kInt, int4, float4>;
  __shared__ __align__(16) uint8_t s_x[kMarkRows][kMarkRowBytes];
  __shared__ __align__(16) Du s_du[kMarkRows / 2][kDuRow];
  const int tj0 = blockIdx.x * kMarkTc, ti0 = blockIdx.y * kMarkTr;
  const int y0 = 8 * ti0, x0 = 8 * tj0;
  const int rows = min(kMarkRows, height - y0);
  const int nbytes = 3 * min(8 * kMarkTc, width - x0);  // staged bytes a row: a multiple of 12
  const long long b = blockIdx.z;
  const uint8_t* xb = x + b * xs.b;
  uint8_t* ob = o + b * os.b;

  if constexpr (kVec > 1) {
    constexpr int kUnits = kMarkRowBytes / kVec;
    for (int it = threadIdx.x; it < rows * kUnits; it += kMarkThreads) {
      const int r = it / kUnits, e = (it % kUnits) * kVec;
      if (e >= nbytes) continue;
      const uint8_t* src = xb + (long long)(y0 + r) * xs.h + 3LL * x0 + e;
      if constexpr (kVec == 16)
        cp_async16(&s_x[r][e], src);
      else
        cp_async4(&s_x[r][e], src);
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    for (int it = threadIdx.x; it < rows * kMarkRowBytes; it += kMarkThreads) {
      const int r = it / kMarkRowBytes, e = it % kMarkRowBytes;
      if (e < nbytes)
        s_x[r][e] = xb[(e % 3) * xs.c + (long long)(y0 + r) * xs.h + (long long)(x0 + e / 3) * xs.w];
    }
  }
  __syncthreads();

  {
    const int a = threadIdx.x / kMarkTc, t = threadIdx.x % kMarkTc;
    const int ti = ti0 + a, tj = tj0 + t;
    Du du[16];
    if (ti < nbh && tj < nbw) {
      float ll[16], u[4], v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        uint32_t p[2][6];  // pixel rows 8 a + 2 r and the next: the tile's 24 bytes of each
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          const uint2* src = reinterpret_cast<const uint2*>(&s_x[8 * a + 2 * r + dy][24 * t]);
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const uint2 w2 = src[j];
            p[dy][2 * j] = w2.x;
            p[dy][2 * j + 1] = w2.y;
          }
        }
        if constexpr (kInt) {
          // channel value of pixel px of row dy at 2^14: fwd . (byte 3 px, 3 px + 1, 3 px +
          // 2), each byte moved to the low end by a permute, none converted
          auto cp = [&](int dy, int px) {
            int acc = k.fwd[0] * (int)word_byte(p[dy][(3 * px) / 4], (3 * px) % 4);
            acc = acc + k.fwd[1] * (int)word_byte(p[dy][(3 * px + 1) / 4], (3 * px + 1) % 4);
            return acc + k.fwd[2] * (int)word_byte(p[dy][(3 * px + 2) / 4], (3 * px + 2) % 4);
          };
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float left = fixed_pair(cp(0, 2 * c) + cp(1, 2 * c), k.off2);
            const float right = fixed_pair(cp(0, 2 * c + 1) + cp(1, 2 * c + 1), k.off2);
            ll[r * 4 + c] = 0.5f * left + 0.5f * right;
          }
        } else {
          // channel value of pixel px of row dy: fwd . (byte 3 px, 3 px + 1, 3 px + 2)
          auto cp = [&](int dy, int px) {
            float acc = k.fwd[0] * byte_to_float(p[dy][(3 * px) / 4] >> (8 * ((3 * px) % 4)));
            acc = acc +
                  k.fwd[1] * byte_to_float(p[dy][(3 * px + 1) / 4] >> (8 * ((3 * px + 1) % 4)));
            return acc +
                   k.fwd[2] * byte_to_float(p[dy][(3 * px + 2) / 4] >> (8 * ((3 * px + 2) % 4)));
          };
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float left = (cp(0, 2 * c) + cp(1, 2 * c)) + k.off2;
            const float right = (cp(0, 2 * c + 1) + cp(1, 2 * c + 1)) + k.off2;
            ll[r * 4 + c] = 0.5f * left + 0.5f * right;
          }
        }
      }
      const float s0 = dominant_triplet(ll, v0, u, v);
      const float ds = qim_target(s0, wm[(long long)ti * nbw + tj], scale) - s0;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float d = 0.5f * (ds * (u[r] * v[c]));
          if constexpr (kInt)
            du[r * 4 + c] = __float2int_rn(1024.0f * d);  // 1024 d is exact; half to even
          else
            du[r * 4 + c] = d;
        }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) du[i] = Du(0);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<Du4*>(&s_du[4 * a + r][4 * t]) =
          Du4{du[4 * r], du[4 * r + 1], du[4 * r + 2], du[4 * r + 3]};
  }
  __syncthreads();

  for (int it = threadIdx.x; it < rows * kChunks; it += kMarkThreads) {
    const int r = it / kChunks, e0 = (it % kChunks) * kChunk;
    if (e0 >= nbytes) continue;
    uint32_t word[kChunk / 4];  // bytes e0 .. e0 + 47 of the row: pixels e0 / 3 .. + 15
#pragma unroll
    for (int j = 0; j < kChunk / 16; ++j) {
      const uint4 w4 = *reinterpret_cast<const uint4*>(&s_x[r][e0 + 16 * j]);
      word[4 * j] = w4.x, word[4 * j + 1] = w4.y, word[4 * j + 2] = w4.z, word[4 * j + 3] = w4.w;
    }
    Du d[8];  // du of pixel pairs e0 / 6 .. + 7 on LL row r / 2
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const Du4 d4 = *reinterpret_cast<const Du4*>(&s_du[r / 2][e0 / 6 + 4 * j]);
      d[4 * j] = d4.x, d[4 * j + 1] = d4.y, d[4 * j + 2] = d4.z, d[4 * j + 3] = d4.w;
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      if (k.bwd[ch] == 0) continue;  // that channel passes through
#pragma unroll
      for (int px = 0; px < kChunk / 3; ++px) {
        const int j = 3 * px + ch, s = 8 * (j % 4);
        uint32_t out;
        if constexpr (kInt) {  // (x << 20) + duq * mki + 2^19, shifted back (half up), clamped
          const int v = ((int)word_byte(word[j / 4], j % 4) << kEpiShift) + d[px / 2] * k.bwd[ch] +
                        kEpiHalf;
          out = (uint32_t)min(max(v >> kEpiShift, 0), 255);
        } else {  // clip before rounding
          const float f =
              fminf(fmaxf(byte_to_float(word[j / 4] >> s) + k.bwd[ch] * d[px / 2], 0.0f), 255.0f);
          out = float_to_byte(f);
        }
        word[j / 4] = (word[j / 4] & ~(0xffu << s)) | (out << s);
      }
    }
    const long long row = (long long)(y0 + r) * os.h;
    if constexpr (kVec == 16) {  // W % 16 == 0: nbytes is a multiple of 48
      uint4* dst = reinterpret_cast<uint4*>(ob + row + 3LL * x0 + e0);
#pragma unroll
      for (int j = 0; j < kChunk / 16; ++j)
        dst[j] = make_uint4(word[4 * j], word[4 * j + 1], word[4 * j + 2], word[4 * j + 3]);
    } else if constexpr (kVec == 4) {
      uint32_t* dst = reinterpret_cast<uint32_t*>(ob + row + 3LL * x0 + e0);
#pragma unroll
      for (int j = 0; j < kChunk / 4; ++j)
        if (e0 + 4 * j < nbytes) dst[j] = word[j];
    } else {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int e = e0 + j;
        if (e < nbytes)
          ob[(e % 3) * os.c + row + (long long)(x0 + e / 3) * os.w] = (word[j / 4] >> (8 * (j % 4))) & 0xffu;
      }
    }
  }
}

template <bool kInt>
__global__ void extract_kernel(const uint8_t* __restrict__ x, Strides xs, float* __restrict__ bits,
                               int batch, int nbh, int nbw, float scale, Coef<kInt> k,
                               StartVector v0) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)batch * nbh * nbw) return;
  const int tj = (int)(t % nbw);
  const int ti = (int)((t / nbw) % nbh);
  const long long b = t / ((long long)nbw * nbh);
  float ll[16], u[4], v[4];
  ll_block<kInt>(x + b * xs.b, xs, ti * 8, tj * 8, k, ll);
  bits[t] = qim_bit(dominant_triplet(ll, v0, u, v), scale);
}

// The 7 host words of one channel's constants (kernels/fused_embed.py):
// float32 for the float body; int32, a float32 and int32 for the integer body.
template <bool kInt>
Coef<kInt> coef(const void* host_color) {
  Coef<kInt> k;
  static_assert(sizeof(k) == 7 * 4, "7 words: fwd[3], off2, bwd[3]");
  memcpy(&k, host_color, sizeof(k));
  return k;
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

template <int kVec, bool kInt>
static int launch_mark(const void* x, const vfp::Strides& xs, void* o, const vfp::Strides& os,
                       const void* wm, int batch, int height, int width, int nbh, int nbw,
                       float scale, const void* color, const void* v0, void* stream) {
  const int tiles_h = (height + 7) / 8, tiles_w = (width + 7) / 8;
  const dim3 grid((tiles_w + vfp::kMarkTc - 1) / vfp::kMarkTc,
                  (tiles_h + vfp::kMarkTr - 1) / vfp::kMarkTr, batch);
  vfp::mark_tile_kernel<kVec, kInt><<<grid, vfp::kMarkThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, xs, (uint8_t*)o, os, (const float*)wm, height, width, nbh, nbw, scale,
      vfp::coef<kInt>(color), vfp::start_vector(v0));
  return (int)cudaGetLastError();
}

// 16-byte staging and stores where W % 16 == 0 and both views are aligned
// to it, 4-byte ones on any other aligned interleaved view, byte by byte
// through the strides for any other layout (a contiguous planar batch).
template <bool kInt>
static int mark(const void* x, const void* x_strides, void* o, const void* o_strides,
                const void* wm, int batch, int height, int width, int nbh, int nbw, float scale,
                const void* color, const void* v0, void* stream) {
  if (batch == 0 || height == 0 || width == 0) return 0;
  const vfp::Strides xs = vfp::strides(x_strides), os = vfp::strides(o_strides);
  if (width % 16 == 0 && vfp::interleaved(x, xs, 16) && vfp::interleaved(o, os, 16))
    return launch_mark<16, kInt>(x, xs, o, os, wm, batch, height, width, nbh, nbw, scale, color,
                                 v0, stream);
  if (width % 4 == 0 && vfp::interleaved(x, xs, 4) && vfp::interleaved(o, os, 4))
    return launch_mark<4, kInt>(x, xs, o, os, wm, batch, height, width, nbh, nbw, scale, color,
                                v0, stream);
  return launch_mark<1, kInt>(x, xs, o, os, wm, batch, height, width, nbh, nbw, scale, color, v0,
                              stream);
}

template <bool kInt>
static int extract(const void* x, const void* x_strides, void* bits, int batch, int nbh, int nbw,
                   float scale, const void* color, const void* v0, void* stream) {
  const long long total = (long long)batch * nbh * nbw;
  if (total == 0) return 0;
  vfp::extract_kernel<kInt><<<vfp::grid_for(total), vfp::kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, vfp::strides(x_strides), (float*)bits, batch, nbh, nbw, scale,
      vfp::coef<kInt>(color), vfp::start_vector(v0));
  return (int)cudaGetLastError();
}

// color: the float body's 7 float32 (fwd[3], off2, bwd[3]).
extern "C" int vfp_fused_mark_planar(const void* x, const void* x_strides, void* o,
                                     const void* o_strides, const void* wm, int batch, int height,
                                     int width, int nbh, int nbw, float scale,
                                     const void* color, const void* v0, void* stream) {
  return mark<false>(x, x_strides, o, o_strides, wm, batch, height, width, nbh, nbw, scale, color,
                     v0, stream);
}

extern "C" int vfp_fused_extract_planar(const void* x, const void* x_strides, void* bits,
                                        int batch, int nbh, int nbw, float scale,
                                        const void* color, const void* v0, void* stream) {
  return extract<false>(x, x_strides, bits, batch, nbh, nbw, scale, color, v0, stream);
}

// The integer bodies; color: int32 fwd[3] at 2^14, float32 off2, int32 bwd[3]
// at 2^10.
extern "C" int vfp_fused_mark_planar_int(const void* x, const void* x_strides, void* o,
                                         const void* o_strides, const void* wm, int batch,
                                         int height, int width, int nbh, int nbw, float scale,
                                         const void* color, const void* v0, void* stream) {
  return mark<true>(x, x_strides, o, o_strides, wm, batch, height, width, nbh, nbw, scale, color,
                    v0, stream);
}

extern "C" int vfp_fused_extract_planar_int(const void* x, const void* x_strides, void* bits,
                                            int batch, int nbh, int nbw, float scale,
                                            const void* color, const void* v0, void* stream) {
  return extract<true>(x, x_strides, bits, batch, nbh, nbw, scale, color, v0, stream);
}
