// The DT-CWT codecs' perceptual masks in one launch: level-2 q-shift highpass
// analysis -> 6 subband magnitudes -> cv2 2x2 mean filter (reflect-101) ->
// 2x2 mean rebin -> ceil(m / step).
//
// Replaces the Pallas kernels of vfp_tpu/kernels/dtcwt_masks.py:
// dtcwt_qshift_masks (:190) and its chained twin dtcwt_qshift_masks_chain
// (:227).  Input: the Y tree lowpasses [B, 4, h1, w1], f32, h1 and w1 % 4 == 0,
// each batch item's 4 planes contiguous and the items ``bstride`` floats apart
// (so the detect path reads the Y half of [B, 2, 4, h1, w1] in place);
// output: [B, 6, h3, w3] with h3 = h1 / 4, w3 = w1 / 4, bands [LH+, LH-, HL+,
// HL-, HH+, HH-].
//
// One block makes an 8x8 tile of mask outputs in three phases over shared
// memory, so no intermediate touches device memory:
//   1. row pass: for each tree (rt, ct) the q-shift lowpass and highpass of
//      tree rt along H, lo/hi[i][x] = sum_k f[k] * ll[(2i - k) mod h1][x], at
//      the 17 level-2 rows the tile's mean filter reads (2 r0 - 1 ..
//      2 r0 + 15, row -1 reflected to row 1) and the 46 level-1 columns that
//      its column pass reads;
//   2. column pass and magnitudes at the 17 x 17 level-2 positions:
//      lh = sum_k h1c[k] lo[2j - k], hl = sum_k h0c[k] hi[..], hh = sum_k
//      h1c[k] hi[..]; then |zp| = 0.5 sqrt((aa - bb)^2 + (ab + ba)^2), |zm| =
//      0.5 sqrt((aa + bb)^2 + (ab - ba)^2) over the 4 trees of each band;
//   3. per mask output and band: the mean filter at the 4 level-2 positions
//      it rebins, 0.25 (((x[i-1,j-1] + x[i-1,j]) + x[i,j-1]) + x[i,j]), the
//      rebin 0.25 (((m00 + m01) + m10) + m11), and ceilf(v / step).
// The reflect-101 edge of cv2's filter is at the top row and left column of
// the level-2 grid (row -1 == row 1), never the circular wrap: window row or
// column -1 is loaded from index 1.  Every other index is circular.  ceil
// turns a last-bit difference into a whole step, so the plain version in
// kernels/dtcwt_masks.py folds in this order; the build has --fmad=false and
// no fast-math, so division and sqrt are IEEE.
//
// Bound on the card: memory (16 B read per level-1 position, 24 B written
// per mask output, a 16:1 reduction) against about 3.3 kFLOP per mask
// output.  The row pass recomputes 1.4x of its columns at the tile edges.

#include <cstdint>

namespace vfp {
namespace {

constexpr int kThreads = 128;
constexpr int kTile = 8;                 // mask outputs per tile side
constexpr int kWin = 2 * kTile + 1;      // level-2 rows/cols of the window (17)
constexpr int kXWin = 4 * kTile + 14;    // level-1 columns the column pass reads (46)
constexpr int kTaps = 14;

// q-shift analysis filters from Python (kernels/dtcwt_masks.py:_params_host).
struct MaskParams {
  float h[2][2][kTaps];  // [tree a/b][h0/h1][k]
};

__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// Level-2 index of window slot s of a tile starting at level-2 index 2 t0 - 1;
// -1 reflects to 1.  Indices past the grid are left unwrapped: the level-1
// reads wrap, and the grid is exactly half the level-1 grid.
__device__ __forceinline__ int level2_index(int t0, int s) {
  const int g = 2 * t0 - 1 + s;
  return g < 0 ? 1 : g;
}

__global__ void __launch_bounds__(kThreads)
    masks_kernel(const float* __restrict__ ll4, float* __restrict__ out, int h1, int w1,
                 int bstride, float step, MaskParams k) {
  __shared__ float lohi[4][2][kWin][kXWin];
  __shared__ float mags[6][kWin][kWin];
  const int h3 = h1 / 4, w3 = w1 / 4;
  const int c0 = blockIdx.x * kTile, r0 = blockIdx.y * kTile;
  const long long b = blockIdx.z;
  const int xs = 4 * c0 - 15;  // level-1 column of lohi's column 0
  // the filters in shared memory, copied with constant indices: indexing the
  // kernel parameter block by a runtime tree would copy it to local memory
  __shared__ float filt[2][2][kTaps];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int i = 0; i < kTaps; ++i) filt[t][f][i] = k.h[t][f][i];
  }
  __syncthreads();

  // 1. row pass
  for (int it = threadIdx.x; it < 4 * 2 * kWin * kXWin; it += kThreads) {
    const int xl = it % kXWin;
    const int wr = (it / kXWin) % kWin;
    const int fi = (it / (kXWin * kWin)) % 2;
    const int ci = it / (kXWin * kWin * 2);
    const float* f = filt[ci >> 1][fi];
    const float* src = ll4 + b * bstride + (long long)ci * h1 * w1 + wrap(xs + xl, w1);
    const int row0 = wrap(2 * level2_index(r0, wr), h1);
    float acc = f[0] * src[(long long)row0 * w1];
#pragma unroll
    for (int kk = 1; kk < kTaps; ++kk) {
      const int row = row0 - kk;
      acc = acc + f[kk] * src[(long long)(row < 0 ? wrap(row, h1) : row) * w1];
    }
    lohi[ci][fi][wr][xl] = acc;
  }
  __syncthreads();

  // 2. column pass and magnitudes
  for (int it = threadIdx.x; it < kWin * kWin; it += kThreads) {
    const int wc = it % kWin, wr = it / kWin;
    const int xl = 2 * level2_index(c0, wc) - xs;  // lohi column of tap 0
    float hp[3][4];
#pragma unroll
    for (int ci = 0; ci < 4; ++ci) {
      const float* h0c = filt[ci & 1][0];
      const float* h1c = filt[ci & 1][1];
      const float* lo = lohi[ci][0][wr];
      const float* hi = lohi[ci][1][wr];
      float lh = h1c[0] * lo[xl], hl = h0c[0] * hi[xl], hh = h1c[0] * hi[xl];
#pragma unroll
      for (int kk = 1; kk < kTaps; ++kk) {
        lh = lh + h1c[kk] * lo[xl - kk];
        hl = hl + h0c[kk] * hi[xl - kk];
        hh = hh + h1c[kk] * hi[xl - kk];
      }
      hp[0][ci] = lh;
      hp[1][ci] = hl;
      hp[2][ci] = hh;
    }
#pragma unroll
    for (int band = 0; band < 3; ++band) {
      const float aa = hp[band][0], ab = hp[band][1], ba = hp[band][2], bb = hp[band][3];
      float d = aa - bb, e = ab + ba;
      mags[2 * band][wr][wc] = 0.5f * sqrtf(d * d + e * e);
      d = aa + bb;
      e = ab - ba;
      mags[2 * band + 1][wr][wc] = 0.5f * sqrtf(d * d + e * e);
    }
  }
  __syncthreads();

  // 3. mean filter, rebin, quantize
  for (int it = threadIdx.x; it < 6 * kTile * kTile; it += kThreads) {
    const int tc = it % kTile, tr = (it / kTile) % kTile, s = it / (kTile * kTile);
    const int r = r0 + tr, c = c0 + tc;
    if (r >= h3 || c >= w3) continue;
    float m[2][2];
#pragma unroll
    for (int di = 0; di < 2; ++di)
#pragma unroll
      for (int dj = 0; dj < 2; ++dj) {
        const int wi = 2 * tr + 1 + di, wj = 2 * tc + 1 + dj;  // window slot of (2r+di, 2c+dj)
        m[di][dj] = 0.25f * (((mags[s][wi - 1][wj - 1] + mags[s][wi - 1][wj]) +
                              mags[s][wi][wj - 1]) + mags[s][wi][wj]);
      }
    const float v = (((m[0][0] + m[0][1]) + m[1][0]) + m[1][1]) * 0.25f;
    out[((b * 6 + s) * h3 + r) * w3 + c] = ceilf(v / step);
  }
}

MaskParams params(const void* host_params) {
  MaskParams k;
  const float* p = static_cast<const float*>(host_params);
  for (int t = 0; t < 2; ++t)
    for (int f = 0; f < 2; ++f)
      for (int i = 0; i < kTaps; ++i) k.h[t][f][i] = p[(t * 2 + f) * kTaps + i];
  return k;
}

}  // namespace
}  // namespace vfp

// Plain C interface, bound with ctypes (kernels/_build.py).  ll4/out are
// device pointers to f32 [B, 4, h1, w1] (batch stride ``bstride`` floats,
// the rest contiguous) and a contiguous [B, 6, h1/4, w1/4]; params is host
// memory (56 floats: h0a, h1a, h0b, h1b).  Returns the launch's cudaError_t.
extern "C" int vfp_dtcwt_qshift_masks(const void* ll4, void* out, int batch, int h1, int w1,
                                      int bstride, float step, const void* params,
                                      void* stream) {
  const int h3 = h1 / 4, w3 = w1 / 4;
  if (batch == 0 || h3 == 0 || w3 == 0) return 0;
  const dim3 grid((w3 + vfp::kTile - 1) / vfp::kTile, (h3 + vfp::kTile - 1) / vfp::kTile, batch);
  vfp::masks_kernel<<<grid, vfp::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)ll4, (float*)out, h1, w1, bstride, step, vfp::params(params));
  return (int)cudaGetLastError();
}
