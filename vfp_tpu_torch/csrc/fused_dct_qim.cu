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
// output; any W % 8 == 0 width runs as it is.  Bound on the card: memory
// (3 B/pixel read, and 3 B/pixel written by mark) against about 3.7 kFLOP per
// 64 pixels; built without multiply-add contraction the float issue comes
// close to the bytes' time, so the mark is laid out for issue.
//
// Mark (mark_tile_kernel): a block owns 4 tile rows x 16 tiles (32 pixel
// rows of 384 bytes), 128 threads, in five stages with a barrier between
// them:
//   1. the strip goes to shared memory once, interleaved: by 16-byte (W % 16
//      == 0) or 8-byte cp.async on the interleaved view of a frame batch
//      (channel stride 1, pixel stride 3), by 8-byte loads of 8 pixels of a
//      channel from channel planes (a contiguous planar batch), byte by byte
//      through the strides on any other layout; from here on every layout
//      runs the same code;
//   2. row pass, one item per (tile, pixel row), a thread per tile row of 8
//      pixels: its 24 bytes by three 8-byte reads, the Y and U lincombs, the
//      8 Y row sums c[r][q] = sum_i Y[r][i] D[q][i] and the U row sum t[r] =
//      sum_i U[r][i] D[1][i], written to the tile's 72 floats of s_c;
//   3. column pass, one item per (tile, coefficient column q), in place:
//      c[p][q] = sum_r D[p][r] c[r][q];
//   4. one thread per tile: u21 = sum_r D[2][r] t[r], the texture mask (the
//      64-term sum of |c| as a left fold in index order), the luminance
//      mask, the step and the QIM target: amp to shared memory;
//   5. byte-parallel output: an item is 48 bytes (16 pixels, two tiles' row)
//      of one staged row, each byte's channel and tile column known at
//      compile time; du = amp * basis[r][i] (basis rows staged in shared
//      memory), each byte of a channel with M_BWD[k, 1] != 0 becomes
//      rint(clip(x + M_BWD[k, 1] * du, 0, 255)) (the byte read and the
//      clipped, rounded result written by the conversion unit, which the
//      float work leaves idle), and the 48 bytes go out as three 16-byte
//      (or six 8-byte) stores, as two 8-byte stores a channel plane, or byte
//      by byte.
// No thread holds more than one tile row or column, so the launch bound of 6
// blocks a SM (80 registers) costs no spill; shared memory holds 7.  Each
// sum keeps the order written above (the plain version's), so the kernel's
// bytes equal the plain version's.
//
// Extract (extract_kernel): one thread per tile keeps the 64 row-pass values
// in registers and overwrites them with the coefficients.  Neighbouring
// threads take neighbouring tiles of a tile row.  Planes are read through the
// strides they come with; where they are the interleaved view with 8-byte
// aligned rows each thread moves a tile row as three 8-byte words instead of
// 24 single bytes.  Both kernels share the mask and step (qim_step).
//
// The Y mean is a reduction across all tiles of a frame, so it is its own
// pass: a fixed-order two-stage sum in double (per-block partial sums, then
// one ordered sum per frame), with no atomics, so repeated runs decode the
// same bits.

#include <cstdint>

#include "staging.cuh"  // cp.async, byte conversions, Strides

namespace vfp {
namespace {

constexpr int kThreads = 128;
constexpr int kMeanThreads = 256;

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

// step = alpha * (texture mask * luminance mask) of one tile, from A(i) =
// |C[i / 8][i % 8]| and the DC coefficient c00 = C[0][0], in the reference's
// operation order.
template <class Abs>
__device__ __forceinline__ float qim_step(Abs abs_c, float c00, float mean, float alpha) {
  // texture mask (vfp_tpu/wm/dct_qim.py:texture_mask)
#define A(p, q) abs_c((p) * 8 + (q))
  float total = A(0, 0);
#pragma unroll
  for (int i = 1; i < 64; ++i) total = total + abs_c(i);
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
  const float dc = c00 / 8.0f;
  const float m = fmaxf(90.0f, mean);
  const float f_ref = 1.0f + (m - 90.0f) * 1.0f / 165.0f;
  const float lramp = 1.0f + (dc - m) / (255.0f - m) * (2.0f - f_ref);
  const float lum = (dc > m) ? lramp : ((dc < 15.0f) ? 1.25f : ((dc < 25.0f) ? 1.125f : 1.0f));
  return alpha * (tex * lum);
}

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

  return Qim{u21, qim_step([&](int i) { return fabsf(c[i]); }, c[0], mean, alpha)};
}

// mark_tile_kernel's geometry
constexpr int kQimTc = 16;                        // tiles a block row
constexpr int kQimTr = 4;                         // tile rows a block
constexpr int kQimTiles = kQimTc * kQimTr;        // 64
constexpr int kQimThreads = 8 * kQimTc;           // one (tile, row) item per thread and tile row
constexpr int kQimRows = 8 * kQimTr;              // staged pixel rows (32)
constexpr int kQimRowBytes = 3 * 8 * kQimTc;      // staged bytes a row (384)
constexpr int kQimChunk = 48;                     // output bytes an item: 16 pixels
constexpr int kQimChunks = kQimRowBytes / kQimChunk;  // items a row (8)
// floats a tile in s_c: the 64 row sums, then the coefficients, row-major,
// and the 8 U row sums; 72 = 8 mod 32 banks, so the column pass's 8
// columns of 4 tiles a warp hit 32 banks
constexpr int kQimC = 72;
// 30,976 bytes of shared memory a block: 6 blocks a SM need at most 80 registers
constexpr int kQimBlocks = 6;

// kVec = 16 or 8: the interleaved view (channel stride 1, pixel stride 3),
// rows and batch items kVec-byte aligned in and out (W % 8 == 0 makes every
// interleaved batch from an aligned allocation 8-byte aligned); kVec = 0: channel
// planes of unit pixel stride (a contiguous [B, 3, H, W] batch), rows,
// planes and batch items 8-byte aligned in and out, 8 pixels of a channel a
// load or store, interleaved in shared memory; kVec = 1: any strides, byte
// by byte.
template <int kVec>
__global__ void __launch_bounds__(kQimThreads, kQimBlocks)
    mark_tile_kernel(const uint8_t* __restrict__ x, Strides xs, uint8_t* __restrict__ o,
                     Strides os, const float* __restrict__ wm, const float* __restrict__ means,
                     int nbh, int nbw, float alpha, Params k) {
  __shared__ __align__(16) uint8_t s_x[kQimRows][kQimRowBytes];
  __shared__ __align__(16) float s_c[kQimTiles][kQimC];
  __shared__ __align__(16) float s_basis[64];
  __shared__ float s_amp[kQimTiles];
  const int tj0 = blockIdx.x * kQimTc, ti0 = blockIdx.y * kQimTr;
  const int y0 = 8 * ti0, x0 = 8 * tj0;
  const int trows = min(kQimTr, nbh - ti0), tcols = min(kQimTc, nbw - tj0);
  const int rows = 8 * trows, nbytes = 24 * tcols;  // staged rows and bytes a row
  const long long b = blockIdx.z;
  const uint8_t* xb = x + b * xs.b;
  uint8_t* ob = o + b * os.b;
  // stage 4's inputs, loaded now so their latency hides behind stages 1-3
  const int ma = threadIdx.x / kQimTc, mt = threadIdx.x % kQimTc;  // stage 4's tile
  const bool masker = threadIdx.x < kQimTiles && ma < trows && mt < tcols;
  const float bit = masker ? wm[(long long)(ti0 + ma) * nbw + tj0 + mt] : 0.0f;
  const float mean = masker ? means[b] : 0.0f;

  // 1. the strip, and the basis rows (constant indices: no local copy of k)
  if constexpr (kVec > 1) {
    constexpr int kUnits = kQimRowBytes / kVec;
    for (int it = threadIdx.x; it < rows * kUnits; it += kQimThreads) {
      const int r = it / kUnits, e = (it % kUnits) * kVec;
      if (e >= nbytes) continue;
      const uint8_t* src = xb + (long long)(y0 + r) * xs.h + 3LL * x0 + e;
      if constexpr (kVec == 16)
        cp_async16(&s_x[r][e], src);
      else
        cp_async8(&s_x[r][e], src);
    }
    cp_async_commit();
  } else if constexpr (kVec == 0) {
    for (int it = threadIdx.x; it < rows * kQimTc; it += kQimThreads) {
      const int r = it / kQimTc, g = it % kQimTc;  // pixels 8 g .. 8 g + 7 of staged row r
      if (g >= tcols) continue;
      const uint8_t* src = xb + (long long)(y0 + r) * xs.h + x0 + 8 * g;
      uint2 pw[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) pw[ch] = __ldg(reinterpret_cast<const uint2*>(src + ch * xs.c));
      uint32_t wd[6] = {0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const uint32_t v = ((i < 4 ? pw[ch].x : pw[ch].y) >> (8 * (i % 4))) & 0xffu;
          wd[(3 * i + ch) / 4] |= v << (8 * ((3 * i + ch) % 4));
        }
      uint2* dst = reinterpret_cast<uint2*>(&s_x[r][24 * g]);
#pragma unroll
      for (int j = 0; j < 3; ++j) dst[j] = make_uint2(wd[2 * j], wd[2 * j + 1]);
    }
  } else {
    for (int it = threadIdx.x; it < rows * kQimRowBytes; it += kQimThreads) {
      const int r = it / kQimRowBytes, e = it % kQimRowBytes;
      if (e < nbytes)
        s_x[r][e] = xb[(e % 3) * xs.c + (long long)(y0 + r) * xs.h + (long long)(x0 + e / 3) * xs.w];
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 64; i += 4)
      *reinterpret_cast<float4*>(&s_basis[i]) =
          make_float4(k.basis[i], k.basis[i + 1], k.basis[i + 2], k.basis[i + 3]);
  }
  if constexpr (kVec > 1) cp_async_wait<0>();
  __syncthreads();

  // 2. row pass: thread (r, t) takes pixel row r of tile t in each tile row
  {
    const int r = threadIdx.x / kQimTc, t = threadIdx.x % kQimTc;
    for (int a = 0; a < trows; ++a) {
      if (t >= tcols) break;
      uint32_t wd[6];  // the tile row's 24 bytes: byte 3 i + ch is channel ch of pixel i
      const uint2* src = reinterpret_cast<const uint2*>(&s_x[8 * a + r][24 * t]);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const uint2 w2 = src[j];
        wd[2 * j] = w2.x;
        wd[2 * j + 1] = w2.y;
      }
      float yv[8], uv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float bb = word_byte_to_float(wd[(3 * i) / 4], (3 * i) % 4);
        const float gg = word_byte_to_float(wd[(3 * i + 1) / 4], (3 * i + 1) % 4);
        const float rr = word_byte_to_float(wd[(3 * i + 2) / 4], (3 * i + 2) % 4);
        yv[i] = lincomb(k.fwd_y, k.off_y, bb, gg, rr);
        uv[i] = lincomb(k.fwd_u, k.off_u, bb, gg, rr);
      }
      float row[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float acc = yv[0] * k.d[q * 8];
#pragma unroll
        for (int i = 1; i < 8; ++i) acc = acc + yv[i] * k.d[q * 8 + i];
        row[q] = acc;
      }
      float acc = uv[0] * k.d[8];
#pragma unroll
      for (int i = 1; i < 8; ++i) acc = acc + uv[i] * k.d[8 + i];
      float* c = s_c[a * kQimTc + t];
      *reinterpret_cast<float4*>(&c[8 * r]) = make_float4(row[0], row[1], row[2], row[3]);
      *reinterpret_cast<float4*>(&c[8 * r + 4]) = make_float4(row[4], row[5], row[6], row[7]);
      c[64 + r] = acc;
    }
  }
  __syncthreads();

  // 3. column pass, in place: thread (t, q) takes coefficient column q of tile t
  {
    const int q = threadIdx.x % 8, t = threadIdx.x / 8;
    for (int a = 0; a < trows; ++a) {
      if (t >= tcols) break;
      float* c = s_c[a * kQimTc + t];
      float v[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) v[r] = c[r * 8 + q];
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        float acc = k.d[p * 8] * v[0];
#pragma unroll
        for (int r = 1; r < 8; ++r) acc = acc + k.d[p * 8 + r] * v[r];
        c[p * 8 + q] = acc;
      }
    }
  }
  __syncthreads();

  // 4. masks, step and QIM target: one thread per tile
  if (masker) {
    const float* c = s_c[threadIdx.x];
    float ac[64];  // |C|, read as float4
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float4 v = *reinterpret_cast<const float4*>(&c[4 * j]);
      ac[4 * j] = fabsf(v.x), ac[4 * j + 1] = fabsf(v.y);
      ac[4 * j + 2] = fabsf(v.z), ac[4 * j + 3] = fabsf(v.w);
    }
    const float4 t0 = *reinterpret_cast<const float4*>(&c[64]);
    const float4 t1 = *reinterpret_cast<const float4*>(&c[68]);
    const float tr[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
    float v = k.d[16] * tr[0];
#pragma unroll
    for (int r = 1; r < 8; ++r) v = v + k.d[16 + r] * tr[r];
    const float step = qim_step([&](int i) { return ac[i]; }, c[0], mean, alpha);
    const float step2 = step + step;
    const float sg = sign_of(v);
    const float base = sg * floorf(fabsf(v) / step2) * step2;
    const float target = (bit == 0.0f) ? base : base + sg * step;
    s_amp[threadIdx.x] = target - v;
  }
  __syncthreads();

  // 5. output: 48 bytes (pixels e0 / 3 .. + 15, tiles e0 / 24 and + 1) of staged row r
  for (int it = threadIdx.x; it < rows * kQimChunks; it += kQimThreads) {
    const int r = it / kQimChunks, e0 = (it % kQimChunks) * kQimChunk;
    if (e0 >= nbytes) continue;
    uint32_t word[kQimChunk / 4];
#pragma unroll
    for (int j = 0; j < kQimChunk / 16; ++j) {
      const uint4 w4 = *reinterpret_cast<const uint4*>(&s_x[r][e0 + 16 * j]);
      word[4 * j] = w4.x, word[4 * j + 1] = w4.y, word[4 * j + 2] = w4.z, word[4 * j + 3] = w4.w;
    }
    const float4 b0 = *reinterpret_cast<const float4*>(&s_basis[8 * (r % 8)]);
    const float4 b1 = *reinterpret_cast<const float4*>(&s_basis[8 * (r % 8) + 4]);
    const float bs[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    const float amp[2] = {s_amp[(r / 8) * kQimTc + e0 / 24], s_amp[(r / 8) * kQimTc + e0 / 24 + 1]};
    float du[16];
#pragma unroll
    for (int px = 0; px < 16; ++px) du[px] = amp[px / 8] * bs[px % 8];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      if (k.bwd[ch] == 0.0f) continue;  // that channel passes through
#pragma unroll
      for (int px = 0; px < kQimChunk / 3; ++px) {
        const int j = 3 * px + ch, sh = 8 * (j % 4);
        // rint(clip(f, 0, 255)), half to even, as one saturating conversion
        const float f = byte_to_float_cvt(word[j / 4] >> sh) + k.bwd[ch] * du[px];
        word[j / 4] = (word[j / 4] & ~(0xffu << sh)) | (float_to_byte_sat(f) << sh);
      }
    }
    const long long row = (long long)(y0 + r) * os.h;
    if constexpr (kVec == 16) {  // W % 16 == 0: nbytes is a multiple of 48
      uint4* dst = reinterpret_cast<uint4*>(ob + row + 3LL * x0 + e0);
#pragma unroll
      for (int j = 0; j < kQimChunk / 16; ++j)
        dst[j] = make_uint4(word[4 * j], word[4 * j + 1], word[4 * j + 2], word[4 * j + 3]);
    } else if constexpr (kVec == 8) {
      uint2* dst = reinterpret_cast<uint2*>(ob + row + 3LL * x0 + e0);
#pragma unroll
      for (int j = 0; j < kQimChunk / 8; ++j)
        if (e0 + 8 * j < nbytes) dst[j] = make_uint2(word[2 * j], word[2 * j + 1]);
    } else if constexpr (kVec == 0) {  // each channel's 16 pixels as two 8-byte stores
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        uint32_t pw[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int px = 0; px < 16; ++px) {
          const int j = 3 * px + ch;
          pw[px / 4] |= ((word[j / 4] >> (8 * (j % 4))) & 0xffu) << (8 * (px % 4));
        }
        uint2* dst = reinterpret_cast<uint2*>(ob + row + ch * os.c + x0 + e0 / 3);
        dst[0] = make_uint2(pw[0], pw[1]);
        if (e0 + 24 < nbytes) dst[1] = make_uint2(pw[2], pw[3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kQimChunk; ++j) {
        const int e = e0 + j;
        if (e < nbytes)
          ob[(e % 3) * os.c + row + (long long)(x0 + e / 3) * os.w] = (word[j / 4] >> (8 * (j % 4))) & 0xffu;
      }
    }
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
// launch; for extract, packed != 0 selects the 8-byte row path, which the
// caller allows only for interleaved, 8-byte aligned planes.  Returns the
// cudaError_t of the launch.

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

template <int kVec>
static int launch_mark(const void* x, const vfp::Strides& xs, void* o, const vfp::Strides& os,
                       const void* wm, const void* means, int batch, int nbh, int nbw,
                       float alpha, const vfp::Params& k, void* stream) {
  const dim3 grid((nbw + vfp::kQimTc - 1) / vfp::kQimTc, (nbh + vfp::kQimTr - 1) / vfp::kQimTr,
                  batch);
  vfp::mark_tile_kernel<kVec><<<grid, vfp::kQimThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, xs, (uint8_t*)o, os, (const float*)wm, (const float*)means, nbh, nbw,
      alpha, k);
  return (int)cudaGetLastError();
}

// Channel planes of unit pixel stride whose rows, planes and batch items are
// n-byte aligned.
static bool planar(const void* p, const vfp::Strides& s, int n) {
  return s.w == 1 && reinterpret_cast<uintptr_t>(p) % n == 0 && s.c % n == 0 && s.h % n == 0 &&
         s.b % n == 0;
}

// 16-byte staging and stores where W % 16 == 0 and both views are aligned to
// it, 8-byte ones on any other aligned interleaved view, 8-byte channel
// runs on aligned planes (a contiguous planar batch), byte by byte through the
// strides for any other layout.
extern "C" int vfp_fused_dct_qim_mark(const void* x, const void* x_strides, void* o,
                                      const void* o_strides, const void* wm, const void* means,
                                      int batch, int nbh, int nbw, float alpha,
                                      const void* params, void* stream) {
  if (batch == 0 || nbh == 0 || nbw == 0) return 0;
  const vfp::Strides xs = vfp::strides(x_strides), os = vfp::strides(o_strides);
  const vfp::Params k = vfp::params(params);
  auto both = [&](int n) { return vfp::interleaved(x, xs, n) && vfp::interleaved(o, os, n); };
  if (nbw % 2 == 0 && both(16))
    return launch_mark<16>(x, xs, o, os, wm, means, batch, nbh, nbw, alpha, k, stream);
  if (both(8)) return launch_mark<8>(x, xs, o, os, wm, means, batch, nbh, nbw, alpha, k, stream);
  if (planar(x, xs, 8) && planar(o, os, 8))
    return launch_mark<0>(x, xs, o, os, wm, means, batch, nbh, nbw, alpha, k, stream);
  return launch_mark<1>(x, xs, o, os, wm, means, batch, nbh, nbw, alpha, k, stream);
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
