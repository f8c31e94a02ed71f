// DT-CWT level-1 analysis with the LeGall 5/3 pair and circular indexing.
//
// Replaces the Pallas kernels of vfp_tpu/kernels/dtcwt_level1.py:
//   ll_tile_kernel<1, ...> <- dtcwt_level1_analysis_ll_y (:508) and its chained
//                         twin dtcwt_level1_ll_y_chain (:918): u8 [B, H, W, 3]
//                         -> the Y channel's 4 tree lowpasses [B, 4, H/2, W/2];
//   ll_tile_kernel<2, ...> <- dtcwt_level1_analysis_ll_color (:428) and its
//                         chained twin dtcwt_level1_ll_color_chain (:888): u8
//                         frames -> the Y and U tree lowpasses [B, 2, 4, H/2, W/2];
//   analysis_tile_kernel<8>, <2> <- dtcwt_level1_analysis (:276): f32 [B, H, W]
//                         -> the 16 planes [ll*4, lh*4, hl*4, hh*4], combos
//                         (rt, ct) row-major;
//   ll_f32_tile_kernel<kLoad> <- dtcwt_level1_analysis_ll (:347): f32 [B, H,
//                         W], read through its element strides -> the 4 tree
//                         lowpasses [B, 4, H/2, W/2] (the codecs' float-frame
//                         and odd-shape path).
//
// Per tree (rt, ct) and output (m, n): a row pass
//   lo_rt[x] = sum_k f[k] * X[(2m + rt - k) mod H][x]       (k from 0 upward)
// then a column pass
//   out[m][n] = sum_k g[k] * lo_rt[(2n + ct - k) mod W].
// With the 5-tap h0 and both phases, every output position reads rows
// 2m-4 .. 2m+1 and columns 2n-4 .. 2n+1.  Every kernel is tiled: each input
// is loaded once per tile, and each row-pass value computed once and shared
// through shared memory by the positions that read it.  The lowpass-only
// kernels share one 8 x 32 tile of positions (ll_rows, ll_columns) and differ
// in stage 1 only: for u8 input (ll_tile_kernel) each window pixel's 3 bytes
// are read once and each channel is formed once per window pixel, as
// ((M_FWD[ch,0] b + M_FWD[ch,1] g) + M_FWD[ch,2] r) + OFF_FWD[ch]; for f32
// input (ll_f32_tile_kernel) the window is copied as it is, by cp.async
// where its rows allow, else through the strides, so the Y channel of an
// interleaved YUV batch is read in place.  Modular indexing covers the
// chained and unchained Pallas twins alike: there is no pad copy, no
// selection matmul, no strip or chunk width, and no u8->i32->f32 hop.  The
// plain versions in kernels/dtcwt_level1.py fold in the same order (each sum
// from k = 0 upward, rows before columns, rounded to float32 between the
// passes); the build has --fmad=false and no fast-math.
//
// Bound on the card: memory (3 B/pixel read for the u8 kernels and 4 B
// (Y) or 8 B (Y and U) per pixel written; 4 B/pixel read and 16 B/pixel
// written for the full analysis, 4 B/pixel each way for its lowpass-only
// twin, 12 B/pixel read where that one reads the Y of interleaved YUV)
// against about 100 (190, 170, 72) FLOPs per output position.  A tile's
// window overlaps its neighbours' by 4 rows and columns; the overlap is
// served by L1/L2, not HBM.  Neighbouring threads take neighbouring n, so the
// plane stores coalesce.

#include <cstdint>

#include "qshift_passes.cuh"  // wrap_near
#include "staging.cuh"        // byte_to_float

namespace vfp {
namespace {

using qshift::wrap_near;

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

template <int kTaps>
__device__ __forceinline__ float col_pass(const float lo[6], const float* f, int ct) {
  float acc = f[0] * lo[ct + 4];
#pragma unroll
  for (int k = 1; k < kTaps; ++k) acc = acc + f[k] * lo[ct - k + 4];
  return acc;
}

// The geometry of ll_tile_kernel<kCh, kWords>: a tile of 8 x 32 level-1
// positions of one frame reads the 20 x 68 pixel window at rows 2 i0 - 4 ...
// and columns 2 j0 - 4 ...; one thread per two neighbouring positions of a
// row.  (16-row tiles of 256 threads, whose windows overlap less, ran 0-3%
// slower on an H100 at every path shape.)
struct LlTile {
  static constexpr int kTh = 8;              // output rows
  static constexpr int kTw = 32;             // output columns
  static constexpr int kWr = 2 * kTh + 4;    // window rows
  static constexpr int kWc = 2 * kTw + 4;    // window columns (68)
  static constexpr int kQuads = kWc / 4;     // runs of 4 window pixels a row (17)
  static constexpr int kThreads = kTh * kTw / 2;
};

// Stage 2 of the lowpass tiles: the row pass s_lo[ch][rt][i][c] = sum_k h0[k]
// * P[2 i + rt - k + 4][c] over the colour planes s_p, once per (channel,
// output row, window column) and tree row rt, 4 window columns an item from
// 6 float4 reads.
template <int kCh>
__device__ __forceinline__ void ll_rows(const float (&s_p)[kCh][LlTile::kWr][LlTile::kWc],
                                        float (&s_lo)[kCh][2][LlTile::kTh][LlTile::kWc],
                                        const float* h0) {
  using T = LlTile;
  constexpr int kTh = T::kTh;
  for (int it = threadIdx.x; it < kCh * kTh * T::kQuads; it += T::kThreads) {
    const int q = it % T::kQuads, i = (it / T::kQuads) % kTh, ch = it / (T::kQuads * kTh);
    float4 p[6];  // window rows 2 i .. 2 i + 5
#pragma unroll
    for (int j = 0; j < 6; ++j) p[j] = *reinterpret_cast<const float4*>(&s_p[ch][2 * i + j][4 * q]);
#pragma unroll
    for (int rt = 0; rt < 2; ++rt) {
      float4 lo = make_float4(h0[0] * p[rt + 4].x, h0[0] * p[rt + 4].y, h0[0] * p[rt + 4].z,
                              h0[0] * p[rt + 4].w);
#pragma unroll
      for (int kk = 1; kk < 5; ++kk) {
        const float4 a = p[rt - kk + 4];
        lo = make_float4(lo.x + h0[kk] * a.x, lo.y + h0[kk] * a.y, lo.z + h0[kk] * a.z,
                         lo.w + h0[kk] * a.w);
      }
      *reinterpret_cast<float4*>(&s_lo[ch][rt][i][4 * q]) = lo;
    }
  }
}

// Stage 3 of the lowpass tiles, the column pass: a thread's two neighbouring
// positions n, n + 1 read the row-pass columns 2 n - 4 .. 2 n + 3 (two
// float4), sum out = sum_k h0[k] * lo[2 n + ct - k + 4] and store each
// plane's pair as one float2 where w1 is even (the stores coalesce along n).
// out is [B, kCh, 4, h1, w1].
template <int kCh>
__device__ __forceinline__ void ll_columns(const float (&s_lo)[kCh][2][LlTile::kTh][LlTile::kWc],
                                           float* __restrict__ out, int h1, int w1, int i0,
                                           int j0, long long b, const float* h0) {
  using T = LlTile;
  const int i = threadIdx.x / (T::kTw / 2), t = threadIdx.x % (T::kTw / 2);
  const int m = i0 + i, n = j0 + 2 * t;
  if (m >= h1 || n >= w1) return;
  const long long plane = (long long)h1 * w1;
  float* ob = out + b * kCh * 4 * plane + (long long)m * w1 + n;
  const bool pairs = w1 % 2 == 0;  // n is even: the pair is 8-byte aligned and inside the row
#pragma unroll
  for (int ch = 0; ch < kCh; ++ch)
#pragma unroll
    for (int rt = 0; rt < 2; ++rt) {
      float lo[8];  // row-pass columns 2 n - 4 .. 2 n + 3
      const float4 a = *reinterpret_cast<const float4*>(&s_lo[ch][rt][i][4 * t]);
      const float4 c = *reinterpret_cast<const float4*>(&s_lo[ch][rt][i][4 * t + 4]);
      lo[0] = a.x, lo[1] = a.y, lo[2] = a.z, lo[3] = a.w;
      lo[4] = c.x, lo[5] = c.y, lo[6] = c.z, lo[7] = c.w;
#pragma unroll
      for (int ct = 0; ct < 2; ++ct) {
        const float y0 = col_pass<5>(lo, h0, ct), y1 = col_pass<5>(lo + 2, h0, ct);
        float* o = ob + (ch * 4 + rt * 2 + ct) * plane;
        if (pairs) {
          *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
        } else {
          o[0] = y0;
          if (n + 1 < w1) o[1] = y1;
        }
      }
    }
}

// The 4 (kCh = 1: Y) or 8 (kCh = 2: Y and U, out [B, 2, 4, H/2, W/2]) tree
// lowpasses of a u8 frame batch, an 8 x 32 tile of positions a block, in
// three stages with a barrier between them:
//   1. window -> colour planes s_p: one item per run of 4 window pixels of a
//      row, its row and column wrapped once (a compare and an add away from
//      the frame's edges); with kWords (W % 4 == 0, so a run never straddles
//      the wrap and its 12 bytes are word-aligned) three 4-byte loads (a
//      warp's runs lie side by side), else 12 byte loads; each channel once
//      per pixel, as a float4;
//   2. row pass s_lo[ch][rt][i][c] = sum_k h0[k] * P[2 i + rt - k + 4][c], once
//      per (channel, output row, window column) and tree row rt, 4 window
//      columns an item from 6 float4 reads;
//   3. column pass: a thread's two neighbouring positions n, n + 1 read the
//      row-pass columns 2 n - 4 .. 2 n + 3 (two float4), sum
//      out = sum_k h0[k] * lo[2 n + ct - k + 4] and store each plane's pair as
//      one float2 where W / 2 is even (the stores coalesce along n).
template <int kCh, bool kWords>
__global__ void __launch_bounds__(LlTile::kThreads)
    ll_tile_kernel(const uint8_t* __restrict__ x, float* __restrict__ out, int h, int w,
                   L1Params k) {
  using T = LlTile;
  constexpr int kTh = T::kTh;
  __shared__ __align__(16) float s_p[kCh][T::kWr][T::kWc];
  __shared__ __align__(16) float s_lo[kCh][2][kTh][T::kWc];
  const int j0 = blockIdx.x * T::kTw, i0 = blockIdx.y * kTh;
  const long long b = blockIdx.z;
  const uint8_t* xb = x + b * h * w * 3;

  for (int it = threadIdx.x; it < T::kWr * T::kQuads; it += T::kThreads) {
    const int q = it % T::kQuads, r = it / T::kQuads;
    const uint8_t* row = xb + (long long)wrap_near(2 * i0 - 4 + r, h) * w * 3;
    const int c0 = 2 * j0 - 4 + 4 * q;
    float v[4][3];
    if constexpr (kWords) {
      const uint32_t* p = reinterpret_cast<const uint32_t*>(row + wrap_near(c0, w) * 3);
      const uint32_t word[3] = {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
#pragma unroll
      for (int i = 0; i < 12; ++i) v[i / 3][i % 3] = byte_to_float(word[i / 4] >> (8 * (i % 4)));
    } else {
#pragma unroll
      for (int px = 0; px < 4; ++px) {
        const uint8_t* p = row + wrap_near(c0 + px, w) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) v[px][c] = byte_to_float(p[c]);
      }
    }
#pragma unroll
    for (int ch = 0; ch < kCh; ++ch) {
      float y[4];
#pragma unroll
      for (int px = 0; px < 4; ++px)
        y[px] = ((k.fwd[ch][0] * v[px][0] + k.fwd[ch][1] * v[px][1]) + k.fwd[ch][2] * v[px][2]) +
                k.off[ch];
      *reinterpret_cast<float4*>(&s_p[ch][r][4 * q]) = make_float4(y[0], y[1], y[2], y[3]);
    }
  }
  __syncthreads();

  ll_rows<kCh>(s_p, s_lo, k.h0);
  __syncthreads();
  ll_columns<kCh>(s_lo, out, h / 2, w / 2, i0, j0, b, k.h0);
}

// The 4 lowpasses [B, 4, H/2, W/2] of f32 planes read through their (batch,
// row, column) element strides, an 8 x 32 tile of positions a block: stage 1
// copies the 20 x 68 window into s_p, each window row and run of 4 columns
// wrapped once by a compare (wrap_near); kLoad = 2: one 16-byte cp.async a
// run (unit column stride, W % 4 == 0, rows and batch items 16-byte
// aligned); 1: four scalar loads a run, wrapped once (W % 4 == 0, any
// strides: the Y channel of an interleaved YUV batch, 12 bytes apart); 0:
// each column wrapped (W % 4 == 2).  Stages 2 and 3 are ll_tile_kernel's.
template <int kLoad>
__global__ void __launch_bounds__(LlTile::kThreads)
    ll_f32_tile_kernel(const float* __restrict__ x, float* __restrict__ out, int h, int w,
                       long long sb, long long sh, long long sw, L1Params k) {
  using T = LlTile;
  __shared__ __align__(16) float s_p[1][T::kWr][T::kWc];
  __shared__ __align__(16) float s_lo[1][2][T::kTh][T::kWc];
  const int j0 = blockIdx.x * T::kTw, i0 = blockIdx.y * T::kTh;
  const long long b = blockIdx.z;
  const float* xb = x + b * sb;

  for (int it = threadIdx.x; it < T::kWr * T::kQuads; it += T::kThreads) {
    const int q = it % T::kQuads, r = it / T::kQuads;
    const float* row = xb + (long long)wrap_near(2 * i0 - 4 + r, h) * sh;
    const int c0 = 2 * j0 - 4 + 4 * q;
    float* dst = &s_p[0][r][4 * q];
    if constexpr (kLoad == 2) {
      cp_async16(dst, row + wrap_near(c0, w));
    } else {
      const int c = wrap_near(c0, w);
      float v[4];
#pragma unroll
      for (int px = 0; px < 4; ++px)
        v[px] = __ldg(row + (long long)(kLoad == 1 ? c + px : wrap_near(c0 + px, w)) * sw);
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  if constexpr (kLoad == 2) {
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  ll_rows<1>(s_p, s_lo, k.h0);
  __syncthreads();
  ll_columns<1>(s_lo, out, h / 2, w / 2, i0, j0, b, k.h0);
}

// The geometry of analysis_tile_kernel<kTh>: a tile of kTh x 32 output
// positions of one frame reads the (2 kTh + 4) x 68 input window at rows
// 2 i0 - 4 ... and columns 2 j0 - 4 ...
template <int kTh>
struct Tile {
  static constexpr int kTw = 32;             // output columns: one warp per output row
  static constexpr int kWc = 2 * kTw + 4;    // window columns
  static constexpr int kR = kTh < 4 ? kTh : 4;  // output rows per row-pass item
  static constexpr int kItems = kWc * (kTh / kR);
  static constexpr int kThreads =
      32 * kTh > (kItems + 31) / 32 * 32 ? 32 * kTh : (kItems + 31) / 32 * 32;
  // Row-pass values sit at [parity of the window column][its half]: the
  // column pass then reads at unit stride across a warp, and kPar = 16 mod
  // 32 puts the row pass's even and odd lanes on disjoint banks.
  static constexpr int kPar = 48;
};

// All 16 planes [B, 16, H/2, W/2].  Row pass: each item is one window
// column and kR output rows; it reads its 2 kR + 4 inputs once (a warp reads
// 32 neighbouring columns: coalesced), wraps the row index by a compare
// (no modulo), and writes lo and hi at both phases to shared memory.  Column
// pass: one thread per output position reads its 6 row-pass columns per
// phase from shared memory and writes the 16 planes, each store coalescing
// along n.
template <int kTh>
__global__ void __launch_bounds__(Tile<kTh>::kThreads)
    analysis_tile_kernel(const float* __restrict__ x, float* __restrict__ out, int h, int w,
                         L1Params k) {
  using T = Tile<kTh>;
  __shared__ float s_lo[2][kTh][2][T::kPar];  // [rt][output row][column parity][column / 2]
  __shared__ float s_hi[2][kTh][2][T::kPar];
  const int h1 = h / 2, w1 = w / 2;
  const int j0 = blockIdx.x * T::kTw, i0 = blockIdx.y * kTh;
  const long long b = blockIdx.z;
  const float* xb = x + b * h * w;
  for (int it = threadIdx.x; it < T::kItems; it += T::kThreads) {
    const int c = it % T::kWc, g = it / T::kWc;
    const int col = wrap(2 * j0 - 4 + c, w);
    int row = wrap(2 * i0 - 4 + 2 * T::kR * g, h);
    float v[2 * T::kR + 4];
#pragma unroll
    for (int r = 0; r < 2 * T::kR + 4; ++r) {
      v[r] = xb[(long long)row * w + col];
      row = row + 1 == h ? 0 : row + 1;
    }
#pragma unroll
    for (int i = 0; i < T::kR; ++i)
#pragma unroll
      for (int rt = 0; rt < 2; ++rt) {
        // window row 2 (g kR + i) + rt - kk + 4 is input row 2 m + rt - kk
        float lo = k.h0[0] * v[2 * i + rt + 4];
#pragma unroll
        for (int kk = 1; kk < 5; ++kk) lo = lo + k.h0[kk] * v[2 * i + rt - kk + 4];
        float hi = k.h1[0] * v[2 * i + rt + 4];
#pragma unroll
        for (int kk = 1; kk < 3; ++kk) hi = hi + k.h1[kk] * v[2 * i + rt - kk + 4];
        s_lo[rt][g * T::kR + i][c & 1][c >> 1] = lo;
        s_hi[rt][g * T::kR + i][c & 1][c >> 1] = hi;
      }
  }
  __syncthreads();

  const int ii = threadIdx.x / T::kTw, jj = threadIdx.x % T::kTw;
  const int m = i0 + ii, n = j0 + jj;
  if (ii >= kTh || m >= h1 || n >= w1) return;
  const long long plane = (long long)h1 * w1;
  float* ob = out + b * 16 * plane + (long long)m * w1 + n;
#pragma unroll
  for (int rt = 0; rt < 2; ++rt) {
    float lo[6], hi[6];  // row-pass columns 2 n - 4 + d
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      lo[d] = s_lo[rt][ii][d & 1][jj + (d >> 1)];
      hi[d] = s_hi[rt][ii][d & 1][jj + (d >> 1)];
    }
#pragma unroll
    for (int ct = 0; ct < 2; ++ct) {
      const int combo = rt * 2 + ct;
      ob[(0 * 4 + combo) * plane] = col_pass<5>(lo, k.h0, ct);  // ll
      ob[(1 * 4 + combo) * plane] = col_pass<3>(lo, k.h1, ct);  // lh
      ob[(2 * 4 + combo) * plane] = col_pass<5>(hi, k.h0, ct);  // hl
      ob[(3 * 4 + combo) * plane] = col_pass<3>(hi, k.h1, ct);  // hh
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

}  // namespace
}  // namespace vfp

// Plain C interface, bound with ctypes (kernels/_build.py).  x/out are
// device pointers to contiguous tensors but for the strided x of
// vfp_dtcwt_level1_analysis_ll (x: u8 [B, H, W, 3] or f32 [B, H, W];
// out: f32 [B, 4, H/2, W/2], [B, 2, 4, H/2, W/2] or [B, 16, H/2, W/2]); H
// and W are even; params is host memory (16 floats in the order of
// vfp::L1Params).  Returns the launch's cudaError_t.

template <int kCh, bool kWords>
static int launch_ll_tile(const void* x, void* out, int batch, int h, int w,
                          const void* params, void* stream) {
  using T = vfp::LlTile;
  const dim3 grid((w / 2 + T::kTw - 1) / T::kTw, (h / 2 + T::kTh - 1) / T::kTh, batch);
  vfp::ll_tile_kernel<kCh, kWords><<<grid, T::kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (float*)out, h, w, vfp::params(params));
  return (int)cudaGetLastError();
}

// Word loads where every run of 4 pixels is 4-byte aligned (W % 4 == 0 and
// an aligned base).
template <int kCh>
static int launch_ll(const void* x, void* out, int batch, int h, int w, const void* params,
                     void* stream) {
  if (batch == 0 || h == 0 || w == 0) return 0;
  return w % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0
             ? launch_ll_tile<kCh, true>(x, out, batch, h, w, params, stream)
             : launch_ll_tile<kCh, false>(x, out, batch, h, w, params, stream);
}

extern "C" int vfp_dtcwt_level1_ll_y(const void* x, void* out, int batch, int h, int w,
                                     const void* params, void* stream) {
  return launch_ll<1>(x, out, batch, h, w, params, stream);
}

extern "C" int vfp_dtcwt_level1_ll_color(const void* x, void* out, int batch, int h, int w,
                                         const void* params, void* stream) {
  return launch_ll<2>(x, out, batch, h, w, params, stream);
}

template <int kTh>
static int launch_tile(const void* x, void* out, int batch, int h, int w, const void* params,
                       void* stream) {
  using T = vfp::Tile<kTh>;
  const dim3 grid((w / 2 + T::kTw - 1) / T::kTw, (h / 2 + kTh - 1) / kTh, batch);
  vfp::analysis_tile_kernel<kTh><<<grid, T::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, h, w, vfp::params(params));
  return (int)cudaGetLastError();
}

// 8-row tiles where they give at least two blocks per SM of the H100's 132,
// else 2-row tiles (the 136x240 watermark plane: 136 blocks, not 36).
extern "C" int vfp_dtcwt_level1_analysis(const void* x, void* out, int batch, int h, int w,
                                         const void* params, void* stream) {
  if (batch == 0 || h == 0 || w == 0) return 0;
  const long long tiles8 = (long long)batch * ((h / 2 + 7) / 8) * ((w / 2 + 31) / 32);
  return tiles8 >= 2 * 132 ? launch_tile<8>(x, out, batch, h, w, params, stream)
                           : launch_tile<2>(x, out, batch, h, w, params, stream);
}

// x is read through its element strides (sb, sh, sw): 16-byte cp.async where
// every run of 4 window columns is one aligned 16-byte piece of a row,
// scalar loads otherwise.
extern "C" int vfp_dtcwt_level1_analysis_ll(const void* x, void* out, int batch, int h, int w,
                                            long long sb, long long sh, long long sw,
                                            const void* params, void* stream) {
  using T = vfp::LlTile;
  if (batch == 0 || h == 0 || w == 0) return 0;
  const dim3 grid((w / 2 + T::kTw - 1) / T::kTw, (h / 2 + T::kTh - 1) / T::kTh, batch);
  const vfp::L1Params k = vfp::params(params);
  const float* xf = (const float*)x;
  float* of = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (sw == 1 && w % 4 == 0 && sh % 4 == 0 && sb % 4 == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0)
    vfp::ll_f32_tile_kernel<2><<<grid, T::kThreads, 0, s>>>(xf, of, h, w, sb, sh, sw, k);
  else if (w % 4 == 0)
    vfp::ll_f32_tile_kernel<1><<<grid, T::kThreads, 0, s>>>(xf, of, h, w, sb, sh, sw, k);
  else
    vfp::ll_f32_tile_kernel<0><<<grid, T::kThreads, 0, s>>>(xf, of, h, w, sb, sh, sw, k);
  return (int)cudaGetLastError();
}
