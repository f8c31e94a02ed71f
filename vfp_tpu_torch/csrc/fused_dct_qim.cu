// The perceptual DCT-QIM codec's embed and extract, u8 planes in, and the
// per-frame Y mean that their luminance mask needs.
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
// Y's offset OFF_FWD[0] is 0 and its coefficients are non-negative (the
// Python module asserts both), so Y >= +0 and adding the offset changes no
// bit: the kernels leave that add out.
//
// None of the Mosaic workarounds is carried over: no selection matmuls, no
// strips or chunk widths, no padded columns, no u8->i32->f32 hop, no aliased
// output; any W % 8 == 0 width runs as it is.  Bound on the card: memory
// (3 B/pixel read, and 3 B/pixel written by mark) against about 3.5 kFLOP per
// 64 pixels; built without multiply-add contraction the float issue comes
// close to the bytes' time, so mark and extract are laid out for issue.
//
// The Y mean.  Every Y value is an exact multiple of 2^-27 below 2^8: the
// smallest Y coefficient, 0.114f, has exponent -4, so each product and each
// rounded sum keeps its lowest set bit at or above 2^-27 (all 2^24 u8
// triples are checked in tests/test_torch_dct_qim.py).  A frame's sum of
// Y * 2^27 in int64 is therefore exact for any frame under 2^28 pixels, in
// any order: the kernels reduce in whatever order suits the card, with
// atomics, and still equal the plain version bit for bit, run after run.
// The mean is __double2float_rn(double(S) * 2^-27 / count), the plain
// version's IEEE float64 steps.  Up to 2^18 such values also sum exactly in
// a double, so a thread adds a tile's or an item's Y values as doubles (one
// conversion and one add a pixel) and turns the sum into fixed point once.
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
// Extract (extract_kernel, then decide_kernel): the frame is read once, and
// the extract takes each frame's Y mean itself, as the Pallas extract does.
// Pass 1 keeps one thread per tile: the 64 row-pass values stay in
// registers and are overwritten with the coefficients; neighbouring threads
// take neighbouring tiles of a frame; a launch bound of 4 blocks a SM keeps
// it at 128 registers, 16 warps a SM, without a spill.  The extract has no output stage, so
// the mark's strip would buy it nothing: staged through shared memory, the
// mark's stages 1-4 issue more instructions a tile than this thread does
// (both are bound by issue: about 2,800 float operations a tile in a fixed
// order).  A tile row comes as three 8-byte loads from the interleaved view
// (8-byte aligned rows), or 24 bytes through the strides; each byte becomes
// a float in one conversion.  Pass 1 stores each tile's v, texture mask and
// DC / 8, and each block's exact fixed-point Y sum; pass 2 (decide_kernel)
// sums the frame's partials, takes the mean as the Y-mean kernel does, and
// decides every bit with the luminance mask, the step and the parity, the
// operations qim_step runs after the texture mask, in its order.
//
// Y mean (y_mean_kernel): one launch.  A block takes 8 rows of the frame's
// 8-aligned crop, a warp per row, each lane 4 items of 16 pixels (3 x 16
// bytes of the interleaved view) or 8 pixels (three 8-byte loads where rows
// are 8-byte aligned only), all loads issued before the first is used: about
// 48 KB in flight a block, 4 blocks a SM (64 registers).  Sums go warp by
// shuffles, block through shared memory, frame by an atomic add on its int64
// total; an arrival count tells the frame's last block, which writes the
// mean.  Any other layout reads its bytes through the strides.  The wrapper
// zeroes the totals and counts (torch.zeros).

#include <cstdint>

#include "staging.cuh"  // cp.async, byte conversions, Strides

namespace vfp {
namespace {

constexpr int kThreads = 128;       // extract: tiles a block
constexpr int kExtractBlocks = 4;   // extract: blocks a SM, so at most 128 registers
constexpr int kDecideThreads = 256; // decide_kernel: threads a block
constexpr int kDecideTiles = 1024;  // decide_kernel: tiles a block
constexpr int kMeanThreads = 256;   // y_mean_kernel: 8 warps, a pixel row each
constexpr int kMeanUnroll = 4;      // items a lane loads before it sums them

// Constants from Python (kernels/fused_dct_qim.py:_params_host), so they hold
// the reference's float32 bits.
struct Params {
  float d[64];      // D[p][i] at p * 8 + i: the orthonormal 8-point DCT-II
  float basis[64];  // outer(D[2], D[1]) at r * 8 + c: the spatial pattern of coefficient [2][1]
  float fwd_y[3], fwd_u[3];
  float off_u;
  float bwd[3];  // M_BWD[:, 1]
};

// One tile row: byte 3 * c + ch holds channel ch of pixel c, as in an
// interleaved frame.  kLayout 8: the interleaved view, rows 8-byte aligned
// (three 8-byte loads); 1: bytes through the strides.
template <int kLayout>
__device__ __forceinline__ void load_row(const uint8_t* __restrict__ p, const Strides& s,
                                         unsigned v[24]) {
  if constexpr (kLayout == 8) {
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

// Y without its zero offset (see the header)
__device__ __forceinline__ float y_of(const Params& k, float x0, float x1, float x2) {
  return (k.fwd_y[0] * x0 + k.fwd_y[1] * x1) + k.fwd_y[2] * x2;
}

// A sum of at most 2^18 Y values, taken in a double, as fixed point: exact.
__device__ __forceinline__ long long y_fixed(double y_sum) {
  return __double2ll_rn(y_sum * 0x1p27);
}

// The mean of a frame whose Y values sum to s * 2^-27 over count pixels: the
// plain version's float64 steps, then float32.
__device__ __forceinline__ float mean_of(long long s, double count) {
  return __double2float_rn(__ll2double_rn(s) * 0x1p-27 / count);
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The sum of v over the block, in thread 0; every thread must call it.
template <int kWarps>
__device__ __forceinline__ long long block_sum(long long v) {
  __shared__ long long s_part[kWarps];
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) s_part[threadIdx.x / 32] = v;
  __syncthreads();
  long long total = 0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kWarps; ++i) total += s_part[i];
  }
  return total;
}

// out[p] = sum_i D[p][i] * x[i] for p = 0..7, each a left fold over i (a row
// pass of D Y or a column pass of D Y Dᵀ).  Row 4 of the DCT-II is row 0
// with the signs + - - + + - - +, bit for bit (the Python module asserts
// it), and a product's sign flips exactly, so row 4 adds or subtracts row 0's
// products instead of forming its own: 8 of the 64 multiplies saved, every
// sum the same.
__device__ __forceinline__ bool row4_negates(int i) { return ((i + 1) >> 1) & 1; }

__device__ __forceinline__ void dct8(const Params& k, const float x[8], float out[8]) {
  float p0[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) p0[i] = x[i] * k.d[i];
  float acc0 = p0[0], acc4 = p0[0];
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    acc0 = acc0 + p0[i];
    acc4 = row4_negates(i) ? acc4 - p0[i] : acc4 + p0[i];
  }
  out[0] = acc0, out[4] = acc4;
#pragma unroll
  for (int p = 1; p < 8; ++p) {
    if (p == 4) continue;
    float acc = x[0] * k.d[p * 8];
#pragma unroll
    for (int i = 1; i < 8; ++i) acc = acc + x[i] * k.d[p * 8 + i];
    out[p] = acc;
  }
}

// jnp.sign: 0 at 0, never copysignf's +-1
__device__ __forceinline__ float sign_of(float v) { return (float)((v > 0.0f) - (v < 0.0f)); }

// The texture mask of one tile from A(i) = |C[i / 8][i % 8]|, in the
// reference's operation order (vfp_tpu/wm/dct_qim.py:texture_mask).
template <class Abs>
__device__ __forceinline__ float texture_mask(Abs abs_c) {
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
  return (eh > 125.0f) ? ((eh > 900.0f) ? hi : lo) : 1.0f;
}

// The luminance mask's terms that depend on the frame's mean Y alone
// (vfp_tpu/kernels/fused_dct_qim.py:_lum_mask): the same for every tile of
// a frame, so a thread or a block computes them once.
struct LumFrame {
  float m, f_ref, span;
};

__device__ __forceinline__ LumFrame lum_frame(float mean) {
  const float m = fmaxf(90.0f, mean);
  return LumFrame{m, 1.0f + (m - 90.0f) * 1.0f / 165.0f, 255.0f - m};
}

// step = alpha * (texture mask * luminance mask) from the texture mask, the
// tile's dc = C[0][0] / 8 and its frame's terms, in the reference's order.
__device__ __forceinline__ float lum_step(float tex, float dc, const LumFrame& f, float alpha) {
  const float lramp = 1.0f + (dc - f.m) / f.span * (2.0f - f.f_ref);
  const float lum =
      (dc > f.m) ? lramp : ((dc < 15.0f) ? 1.25f : ((dc < 25.0f) ? 1.125f : 1.0f));
  return alpha * (tex * lum);
}

template <class Abs>
__device__ __forceinline__ float qim_step(Abs abs_c, float c00, float mean, float alpha) {
  const float tex = texture_mask(abs_c);
  return lum_step(tex, c00 / 8.0f, lum_frame(mean), alpha);
}

// floor-mod parity of rint(v / step), as jnp.mod: q = -3 gives 1 (fmodf would give -1)
__device__ __forceinline__ float bit_of(float v, float step) {
  const float q = rintf(v / step);
  return (q - 2.0f * floorf(q * 0.5f) == 1.0f) ? 1.0f : 0.0f;
}

struct TileQim {
  float v;    // U coefficient [2][1]
  float tex;  // texture mask
  float dc;   // C[0][0] / 8
};

// The QIM inputs of the tile whose top-left pixel is (y0, x0); y_sum gets
// the sum of its 64 Y values (exact in a double).
template <int kLayout>
__device__ __forceinline__ TileQim tile_qim(const uint8_t* __restrict__ xb, const Strides& s,
                                            int y0, int x0, const Params& k, double& y_sum) {
  float c[64];  // row pass of Y: c[r * 8 + q] = sum_i Y[r][i] * D[q][i]
  float t[8];   // row pass of U against D[1] only
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    unsigned v[24];
    load_row<kLayout>(xb + (long long)(y0 + r) * s.h + (long long)x0 * s.w, s, v);
    float yv[8], uv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float b = (float)v[3 * i], g = (float)v[3 * i + 1], rr = (float)v[3 * i + 2];
      yv[i] = y_of(k, b, g, rr);
      uv[i] = lincomb(k.fwd_u, k.off_u, b, g, rr);
    }
    {  // a tree, so no long chain of double adds: exact in any order
      double pair[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) pair[j] = (double)yv[2 * j] + (double)yv[2 * j + 1];
      y_sum += (pair[0] + pair[1]) + (pair[2] + pair[3]);
    }
    dct8(k, yv, &c[r * 8]);
    float acc = uv[0] * k.d[8];
#pragma unroll
    for (int i = 1; i < 8; ++i) acc = acc + uv[i] * k.d[8 + i];
    t[r] = acc;
  }
  // column pass, in place: c[p * 8 + q] = sum_r D[p][r] * rows[r][q]
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float v[8], col[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) v[r] = c[r * 8 + q];
    dct8(k, v, col);
#pragma unroll
    for (int p = 0; p < 8; ++p) c[p * 8 + q] = col[p];
  }
  float u21 = k.d[16] * t[0];
#pragma unroll
  for (int r = 1; r < 8; ++r) u21 = u21 + k.d[16 + r] * t[r];

  return TileQim{u21, texture_mask([&](int i) { return fabsf(c[i]); }), c[0] / 8.0f};
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
        yv[i] = y_of(k, bb, gg, rr);
        uv[i] = lincomb(k.fwd_u, k.off_u, bb, gg, rr);
      }
      float row[8];
      dct8(k, yv, row);
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
      float v[8], col[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) v[r] = c[r * 8 + q];
      dct8(k, v, col);
#pragma unroll
      for (int p = 0; p < 8; ++p) c[p * 8 + q] = col[p];
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


// Pass 1, one tile per thread: v, tex and dc to tiles ([3][batch][nb]
// floats) and the block's fixed-point Y sum to partial[b * gridDim.x +
// blockIdx.x].  Grid: (tiles of a frame / 128, batch).
template <int kLayout>
__global__ void __launch_bounds__(kThreads, kExtractBlocks)
    extract_kernel(const uint8_t* __restrict__ x, Strides xs, float* __restrict__ tiles,
                   long long* __restrict__ partial, int nbh, int nbw, Params k) {
  const int nb = nbh * nbw;
  const int i = blockIdx.x * kThreads + threadIdx.x;  // the tile in its frame
  const int b = blockIdx.y;
  double y_sum = 0.0;
  if (i < nb) {
    const TileQim t =
        tile_qim<kLayout>(x + (long long)b * xs.b, xs, (i / nbw) * 8, (i % nbw) * 8, k, y_sum);
    const long long o = (long long)b * nb + i;
    const long long plane = (long long)gridDim.y * nb;
    tiles[o] = t.v;
    tiles[plane + o] = t.tex;
    tiles[2 * plane + o] = t.dc;
  }
  const long long s = block_sum<kThreads / 32>(y_fixed(y_sum));
  if (threadIdx.x == 0) partial[(long long)b * gridDim.x + blockIdx.x] = s;
}

// Pass 2 of the extract: a block loads its kDecideTiles tiles'
// v, tex and dc, sums its frame's `parts` partials, takes the mean and its
// luminance terms once, and decides the bits.
__global__ void __launch_bounds__(kDecideThreads)
    decide_kernel(const float* __restrict__ tiles, const long long* __restrict__ partial,
                  int parts, float* __restrict__ bits, int nb, double count, float alpha) {
  constexpr int kPer = kDecideTiles / kDecideThreads;
  __shared__ LumFrame s_frame;
  const int b = blockIdx.y;
  const long long plane = (long long)gridDim.y * nb;
  const int i0 = blockIdx.x * kDecideTiles + threadIdx.x;
  float v[kPer], tex[kPer], dc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = i0 + j * kDecideThreads;
    if (i < nb) {
      const long long o = (long long)b * nb + i;
      v[j] = tiles[o], tex[j] = tiles[plane + o], dc[j] = tiles[2 * plane + o];
    }
  }
  long long s = 0;
  for (int j = threadIdx.x; j < parts; j += kDecideThreads) s += partial[(long long)b * parts + j];
  s = block_sum<kDecideThreads / 32>(s);
  if (threadIdx.x == 0) s_frame = lum_frame(mean_of(s, count));
  __syncthreads();
  const LumFrame frame = s_frame;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = i0 + j * kDecideThreads;
    if (i < nb) bits[(long long)b * nb + i] = bit_of(v[j], lum_step(tex[j], dc[j], frame, alpha));
  }
}

// One item of a pixel row.  kLayout 16 / 8: 16 / 8 pixels of the interleaved
// view by three 16- / 8-byte loads; 1: one pixel, byte by byte through the
// strides.
template <int kLayout>
struct RowItem {
  static constexpr int kPixels = kLayout == 8 ? 8 : kLayout == 1 ? 1 : 16;
  uint32_t w[kLayout == 1 ? 3 : 3 * kPixels / 4];

  // item c of the row whose first pixel is at row
  __device__ __forceinline__ void load(const uint8_t* __restrict__ row, const Strides& s, int c) {
    if constexpr (kLayout == 16) {
      const uint4* p = reinterpret_cast<const uint4*>(row + 48LL * c);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const uint4 q = __ldg(p + j);
        w[4 * j] = q.x, w[4 * j + 1] = q.y, w[4 * j + 2] = q.z, w[4 * j + 3] = q.w;
      }
    } else if constexpr (kLayout == 8) {
      const uint2* p = reinterpret_cast<const uint2*>(row + 24LL * c);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const uint2 q = __ldg(p + j);
        w[2 * j] = q.x, w[2 * j + 1] = q.y;
      }
    } else {
      const uint8_t* p = row + (long long)c * s.w;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) w[ch] = p[ch * s.c];
    }
  }

  // channel ch of pixel i as a float, exactly
  __device__ __forceinline__ float px(int i, int ch) const {
    if constexpr (kLayout == 1)
      return byte_to_float(w[ch]);
    else
      return word_byte_to_float(w[(3 * i + ch) / 4], (3 * i + ch) % 4);
  }
};

// The Y mean of each frame's h8 x (items * kPixels) crop.  Block (j, b): rows
// 8 j .. 8 j + 7 of frame b, a warp each.  totals: [2][batch] zeroed int64,
// the frames' fixed-point sums and the blocks arrived.
template <int kLayout>
__global__ void __launch_bounds__(kMeanThreads)
    y_mean_kernel(const uint8_t* __restrict__ x, Strides s, int h8, int items, double count,
                  unsigned long long* __restrict__ totals, float* __restrict__ means, Params k) {
  using Item = RowItem<kLayout>;
  const int b = blockIdx.y;
  const int y = blockIdx.x * (kMeanThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  long long acc = 0;
  if (y < h8) {
    const uint8_t* row = x + (long long)b * s.b + (long long)y * s.h;
    for (int c0 = lane; c0 < items; c0 += 32 * kMeanUnroll) {
      Item it[kMeanUnroll];
#pragma unroll
      for (int u = 0; u < kMeanUnroll; ++u)
        if (c0 + 32 * u < items) it[u].load(row, s, c0 + 32 * u);
#pragma unroll
      for (int u = 0; u < kMeanUnroll; ++u) {
        if (c0 + 32 * u < items) {
          double sum = 0.0;
#pragma unroll
          for (int i = 0; i < Item::kPixels; ++i)
            sum += (double)y_of(k, it[u].px(i, 0), it[u].px(i, 1), it[u].px(i, 2));
          acc += y_fixed(sum);
        }
      }
    }
  }
  const long long total = block_sum<kMeanThreads / 32>(acc);
  if (threadIdx.x == 0) {
    unsigned long long* arrived = totals + gridDim.y;
    atomicAdd(&totals[b], (unsigned long long)total);
    __threadfence();  // the add is visible before the arrival is counted
    if (atomicAdd(&arrived[b], 1ull) == gridDim.x - 1) {  // the frame's last block
      __threadfence();
      means[b] = mean_of((long long)atomicAdd(&totals[b], 0ull), count);
    }
  }
}

Params params(const void* host_params) {
  Params k;
  const float* p = static_cast<const float*>(host_params);
  for (int i = 0; i < 64; ++i) k.d[i] = p[i];
  for (int i = 0; i < 64; ++i) k.basis[i] = p[64 + i];
  for (int i = 0; i < 3; ++i) k.fwd_y[i] = p[128 + i];
  for (int i = 0; i < 3; ++i) k.fwd_u[i] = p[131 + i];
  k.off_u = p[134];
  for (int i = 0; i < 3; ++i) k.bwd[i] = p[135 + i];
  return k;
}

}  // namespace
}  // namespace vfp

// Plain C interface, bound with ctypes (kernels/_build.py).  x/o/wm/means/
// bits/totals/tiles/partial are device pointers; the stride arrays (4 int64:
// b, c, h, w) and the params array (138 floats in the order of vfp::Params)
// are host memory read before the launch.  Returns the cudaError_t of the
// launch.

// Channel planes of unit pixel stride whose rows, planes and batch items are
// n-byte aligned.
static bool planar(const void* p, const vfp::Strides& s, int n) {
  return s.w == 1 && reinterpret_cast<uintptr_t>(p) % n == 0 && s.c % n == 0 && s.h % n == 0 &&
         s.b % n == 0;
}

template <int kLayout>
static int launch_mean(const void* x, const vfp::Strides& s, void* totals, void* means,
                       int batch, int h8, int w8, const vfp::Params& k, void* stream) {
  const dim3 grid(h8 > 0 ? (h8 + 7) / 8 : 1, batch);
  vfp::y_mean_kernel<kLayout><<<grid, vfp::kMeanThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, s, h8, w8 / vfp::RowItem<kLayout>::kPixels,
      (double)h8 * (double)w8, (unsigned long long*)totals, (float*)means, k);
  return (int)cudaGetLastError();
}

// totals: 2 x batch int64, zeroed.  16-byte loads of the interleaved view
// where W % 16 == 0 and rows are 16-byte aligned, 8-byte ones where rows
// are 8-byte aligned, else bytes through the strides.
extern "C" int vfp_y_dc_mean(const void* x, const void* x_strides, void* totals, void* means,
                             int batch, int h8, int w8, const void* params, void* stream) {
  if (batch == 0) return 0;
  const vfp::Strides s = vfp::strides(x_strides);
  const vfp::Params k = vfp::params(params);
  if (w8 % 16 == 0 && vfp::interleaved(x, s, 16))
    return launch_mean<16>(x, s, totals, means, batch, h8, w8, k, stream);
  if (vfp::interleaved(x, s, 8))
    return launch_mean<8>(x, s, totals, means, batch, h8, w8, k, stream);
  return launch_mean<1>(x, s, totals, means, batch, h8, w8, k, stream);
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

template <int kLayout>
static int launch_extract(const void* x, const vfp::Strides& xs, void* tiles, void* partial,
                          int batch, int nbh, int nbw, const vfp::Params& k, void* stream) {
  const dim3 grid((nbh * nbw + vfp::kThreads - 1) / vfp::kThreads, batch);
  vfp::extract_kernel<kLayout><<<grid, vfp::kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, xs, (float*)tiles, (long long*)partial, nbh, nbw, k);
  return (int)cudaGetLastError();
}

// Pass 1 of the extract: tiles (3 x batch x nbh x nbw floats) and partial
// (batch x ceil(nbh * nbw / 128) int64) are its outputs, vfp_dct_qim_decide's
// inputs.  Three 8-byte loads a tile row from the interleaved view with
// 8-byte aligned rows, else bytes through the strides.
extern "C" int vfp_fused_dct_qim_extract(const void* x, const void* x_strides, void* tiles,
                                         void* partial, int batch, int nbh, int nbw,
                                         const void* params, void* stream) {
  if (batch == 0 || nbh == 0 || nbw == 0) return 0;
  const vfp::Strides xs = vfp::strides(x_strides);
  const vfp::Params k = vfp::params(params);
  if (vfp::interleaved(x, xs, 8))
    return launch_extract<8>(x, xs, tiles, partial, batch, nbh, nbw, k, stream);
  return launch_extract<1>(x, xs, tiles, partial, batch, nbh, nbw, k, stream);
}

// Pass 2 of the extract: each frame's mean from its `parts` partial sums,
// then the bits (batch x nb floats).
extern "C" int vfp_dct_qim_decide(const void* tiles, const void* partial, int parts, void* bits,
                                  int batch, int nb, float alpha, void* stream) {
  if (batch == 0 || nb == 0) return 0;
  const dim3 grid((nb + vfp::kDecideTiles - 1) / vfp::kDecideTiles, batch);
  vfp::decide_kernel<<<grid, vfp::kDecideThreads, 0, (cudaStream_t)stream>>>(
      (const float*)tiles, (const long long*)partial, parts, (float*)bits, nb, 64.0 * nb, alpha);
  return (int)cudaGetLastError();
}
