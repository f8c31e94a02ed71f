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
// The q-shift kernels: one thread per output sample computes every
// intermediate it needs in registers (7 rows of lo and hi, each 7 column
// taps), reading the input circularly; the filters sit in shared memory (a
// parameter block indexed by a runtime tap parity or tree would go to local
// memory), and the 7 row and 7 column indices are taken once per output.
// The rereads of neighbouring inputs are served by L1/L2: the full kernel
// reads each input 49 times from L1 and does about 400 FLOPs per output, so
// L1 traffic and the FLOPs, not HBM, set its time.  No tiling yet.
//
// The LeGall kernels (the three modes share one template): one block of 256
// threads makes a 32 x 64 output tile of one frame.
// - Load: the tile's input window, 19 x 35 per band (16 + 3 rows and 32 + 3
//   columns: the 3- and 5-tap filters and the roll), goes to shared memory
//   once, by cp.async, coalesced along the row, tree by tree in four commit
//   groups, so that tree 0's stages run while trees 1-3 still arrive.  Each
//   thread wraps its one window column and its 3 window rows once, by a
//   compare (a modulo only for planes smaller than the window).
// - Column stage, per tree: lo and hi at every (window row, output column),
//   2 columns a thread, read at unit stride, into shared memory: computed
//   once, not once per output row that needs them.
// - Row stage, per tree: each thread makes 2 rows x 4 columns of outputs
//   from 16-byte reads of lo and hi, and adds the tree into registers,
//   (((t0 + t1) + t2) + t3) * 0.25 at the end.
// - An output's tap parities follow from its place in the tile and the
//   parity of the roll (kE, a template argument), so every tap is a
//   compile-time operand of the kernel's parameter block and every window
//   index a constant offset.
// - Stores: one float4 per thread and row where 2w % 4 == 0.
// Bound on the card: memory (16, 4 or 12 planes of h x w read, 16 B written
// per input position) against about 80 float32 operations per output; the
// windows overlap by 3 rows and columns (1.30 x the input), served by L2.

#include <cstdint>

#include "qshift_passes.cuh"  // wrap, wrap_near

namespace vfp {
namespace {

using qshift::wrap;
using qshift::wrap_near;

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

// -- the LeGall level 1: one block per kLTh x kLTw output tile --------------------

constexpr int kLTh = 32, kLTw = 64;    // output rows and columns per tile
constexpr int kLWr = kLTh / 2 + 3;     // input rows of its window (19)
constexpr int kLWc = kLTw / 2 + 3;     // input columns of its window (35)
constexpr int kLThreads = 256;
constexpr int kLoadGroups = kLThreads / kLWc;           // 7 row groups of kLWc threads
constexpr int kLoadRows = (kLWr + kLoadGroups - 1) / kLoadGroups;  // rows a thread loads (3)
static_assert(kLTh % 2 == 0 && kLTw % 4 == 0 && (kLTh / 2) * (kLTw / 4) == kLThreads,
              "row stage: 2 x 4 outputs a thread");

// bands per tree and where each sits among them (-1: a zero band)
template <int kMode>
struct Bands {
  static constexpr int n = kMode == kAll ? 4 : kMode == kLl ? 1 : 3;
  static constexpr int ll = kMode == kHp ? -1 : 0;
  static constexpr int lh = kMode == kAll ? 1 : kMode == kHp ? 0 : -1;
  static constexpr int hl = kMode == kAll ? 2 : kMode == kHp ? 1 : -1;
  static constexpr int hh = kMode == kAll ? 3 : kMode == kHp ? 2 : -1;
};

template <int kMode>
constexpr int legall_smem_bytes() {
  return 4 * (4 * Bands<kMode>::n * kLWr * kLWc + (kMode == kLl ? 1 : 2) * kLWr * kLTw);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One up2 stage at an output whose taps hit the input at parity kK0: sum_k
// f[k] * y[((kOff - k) / 2) * kStride], k = kK0, kK0 + 2, ... < kTaps, in
// that order (kOff - kK0 is even).  Taps and indices are compile-time.
template <int kTaps, int kK0, int kOff, int kStride>
__device__ __forceinline__ float up2_tile(const float* f, const float* y) {
  float acc = f[kK0] * y[(kOff - kK0) / 2 * kStride];
#pragma unroll
  for (int k = kK0 + 2; k < kTaps; k += 2) acc = acc + f[k] * y[(kOff - k) / 2 * kStride];
  return acc;
}

// the same on 4 neighbouring outputs at once, each lane its own column
template <int kTaps, int kK0, int kOff, int kStride>
__device__ __forceinline__ float4 up2_tile4(const float* f, const float* y) {
  const float4 y0 = *reinterpret_cast<const float4*>(y + (kOff - kK0) / 2 * kStride);
  float4 acc = make_float4(f[kK0] * y0.x, f[kK0] * y0.y, f[kK0] * y0.z, f[kK0] * y0.w);
#pragma unroll
  for (int k = kK0 + 2; k < kTaps; k += 2) {
    const float4 yk = *reinterpret_cast<const float4*>(y + (kOff - k) / 2 * kStride);
    acc = make_float4(acc.x + f[k] * yk.x, acc.y + f[k] * yk.y, acc.z + f[k] * yk.z,
                      acc.w + f[k] * yk.w);
  }
  return acc;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Column stage of tree (., kCt) at window input row a, output column 2p +
// kT: lo = up2(ll, g0) + up2(lh, g1), hi = up2(hl, g0) + up2(hh, g1) (zero
// bands left out), from the tree's bands in shared memory (``in`` points at
// row a, column p of its first band).
template <int kMode, int kE, int kCt, int kT>
__device__ __forceinline__ void column_stage(const float* in, const SynParams& p, float& lo,
                                             float& hi) {
  using B = Bands<kMode>;
  constexpr int kK0 = (kE + 1 + kT - kCt) & 1, kOff = 5 + kE + kT - kCt;
  constexpr int kBand = kLWr * kLWc;
  if constexpr (B::ll >= 0) {
    lo = up2_tile<kG0, kK0, kOff, 1>(p.g0, in + B::ll * kBand);
    if constexpr (B::lh >= 0) lo = lo + up2_tile<kG1, kK0, kOff, 1>(p.g1, in + B::lh * kBand);
  } else {
    lo = up2_tile<kG1, kK0, kOff, 1>(p.g1, in + B::lh * kBand);
  }
  if constexpr (B::hl >= 0)
    hi = up2_tile<kG0, kK0, kOff, 1>(p.g0, in + B::hl * kBand) +
         up2_tile<kG1, kK0, kOff, 1>(p.g1, in + B::hh * kBand);
}

// Row stage of tree (kRt, .) at output row 2 rp + kDi, columns 4q .. 4q + 3:
// up2(lo, g0) + up2(hi, g1) along H (taps below 3 of g0, all of g1)
template <int kMode, int kE, int kRt, int kDi>
__device__ __forceinline__ float4 row_stage(const float* lo, const float* hi, const SynParams& p) {
  constexpr int kK0 = (kE + 1 + kDi - kRt) & 1, kOff = 5 + kE + kDi - kRt;
  const float4 a = up2_tile4<kG0, kK0, kOff, kLTw>(p.g0, lo);
  if constexpr (kMode == kLl) return a;
  else return add4(a, up2_tile4<kG1, kK0, kOff, kLTw>(p.g1, hi));
}

template <int kMode, int kE, int kCi>
__device__ __forceinline__ void legall_tree(const float* in, float* lo, float* hi,
                                            const SynParams& p, float4 (&acc)[2]) {
  constexpr int kRt = kCi >> 1, kCt = kCi & 1;
  cp_async_wait<3 - kCi>();  // this tree's bands are in
  __syncthreads();           // for every thread; the last tree's row stage is done
  const float* tin = in + kCi * Bands<kMode>::n * kLWr * kLWc;
  for (int it = threadIdx.x; it < kLWr * (kLTw / 2); it += kLThreads) {
    const int a = it / (kLTw / 2), pp = it % (kLTw / 2);
    const float* src = tin + a * kLWc + pp;
    float lo0, lo1, hi0 = 0.0f, hi1 = 0.0f;
    column_stage<kMode, kE, kCt, 0>(src, p, lo0, hi0);
    column_stage<kMode, kE, kCt, 1>(src, p, lo1, hi1);
    *reinterpret_cast<float2*>(lo + a * kLTw + 2 * pp) = make_float2(lo0, lo1);
    if constexpr (kMode != kLl)
      *reinterpret_cast<float2*>(hi + a * kLTw + 2 * pp) = make_float2(hi0, hi1);
  }
  __syncthreads();
  const int rp = threadIdx.x / (kLTw / 4), q = threadIdx.x % (kLTw / 4);
  const float* l = lo + rp * kLTw + 4 * q;
  const float* h = hi + rp * kLTw + 4 * q;
  const float4 t0 = row_stage<kMode, kE, kRt, 0>(l, h, p);
  const float4 t1 = row_stage<kMode, kE, kRt, 1>(l, h, p);
  if constexpr (kCi == 0) {  // (((t0 + t1) + t2) + t3)
    acc[0] = t0;
    acc[1] = t1;
  } else {
    acc[0] = add4(acc[0], t0);
    acc[1] = add4(acc[1], t1);
  }
}

template <int kMode, int kE>
__global__ void __launch_bounds__(kLThreads, 4)
    legall_kernel(const float* __restrict__ d, float* __restrict__ out, int h, int w,
                  SynParams p) {
  using B = Bands<kMode>;
  extern __shared__ __align__(16) float smem[];
  float* in = smem;                          // [tree][band][kLWr][kLWc]
  float* lo = in + 4 * B::n * kLWr * kLWc;   // [kLWr][kLTw]
  float* hi = lo + kLWr * kLTw;              // [kLWr][kLTw], not for kLl
  const int oh = 2 * h, ow = 2 * w;
  const int i0 = blockIdx.y * kLTh, j0 = blockIdx.x * kLTw;
  const long long plane = (long long)h * w;
  const float* db = d + (long long)blockIdx.z * 4 * B::n * plane;

  // load the window, input rows br .. br + kLWr - 1 and columns bc .. bc +
  // kLWc - 1 (mod h, w) of every band, tree by tree, one commit group each:
  // thread (g, c) takes window column c and rows g, g + 7, g + 14
  {
    const int br = (i0 - p.roll - 5) >> 1, bc = (j0 - p.roll - 5) >> 1;
    const int g = threadIdx.x / kLWc, c = threadIdx.x % kLWc;
    int off[kLoadRows];
    if (g < kLoadGroups) {
      const int col = wrap_near(bc + c, w);
#pragma unroll
      for (int j = 0; j < kLoadRows; ++j)
        off[j] = wrap_near(br + g + kLoadGroups * j, h) * w + col;
    }
#pragma unroll
    for (int ci = 0; ci < 4; ++ci) {
      if (g < kLoadGroups) {
#pragma unroll
        for (int bi = 0; bi < B::n; ++bi) {
          const float* src = db + (bi * 4 + ci) * plane;
          float* dst = in + ((ci * B::n + bi) * kLWr + g) * kLWc + c;
#pragma unroll
          for (int j = 0; j < kLoadRows; ++j)
            if (g + kLoadGroups * j < kLWr) cp_async4(dst + kLoadGroups * j * kLWc, src + off[j]);
        }
      }
      cp_async_commit();
    }
  }

  float4 acc[2];
  legall_tree<kMode, kE, 0>(in, lo, hi, p, acc);
  legall_tree<kMode, kE, 1>(in, lo, hi, p, acc);
  legall_tree<kMode, kE, 2>(in, lo, hi, p, acc);
  legall_tree<kMode, kE, 3>(in, lo, hi, p, acc);

  // out[i][j], rows i0 + 2 rp + di, columns j0 + 4q .. j0 + 4q + 3
  const int rp = threadIdx.x / (kLTw / 4), q = threadIdx.x % (kLTw / 4);
  const int j = j0 + 4 * q;
  const bool vec = (ow & 3) == 0 && j + 4 <= ow;
#pragma unroll
  for (int di = 0; di < 2; ++di) {
    const int i = i0 + 2 * rp + di;
    if (i >= oh) continue;
    const float4 v = make_float4(acc[di].x * 0.25f, acc[di].y * 0.25f, acc[di].z * 0.25f,
                                 acc[di].w * 0.25f);
    float* o = out + ((long long)blockIdx.z * oh + i) * ow + j;
    if (vec) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (j + t < ow) o[t] = vs[t];
    }
  }
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

template <int kMode, int kE>
int launch_legall_tiles(const float* d, float* out, int batch, int h, int w, const SynParams& p,
                        cudaStream_t stream) {
  constexpr int bytes = legall_smem_bytes<kMode>();
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        legall_kernel<kMode, kE>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((2 * w + kLTw - 1) / kLTw, (2 * h + kLTh - 1) / kLTh, batch);
  legall_kernel<kMode, kE><<<grid, kLThreads, bytes, stream>>>(d, out, h, w, p);
  return (int)cudaGetLastError();
}

template <int kMode>
int launch_legall(const void* d, void* out, int batch, int h, int w, const void* params,
                  void* stream) {
  if (batch == 0 || h == 0 || w == 0) return 0;
  const SynParams p = syn_params(params);
  // kE: the parity of the window origin 2 i0 - roll - 5 (i0 even), which
  // fixes each output's tap parities at compile time
  return (p.roll + 1) & 1
             ? launch_legall_tiles<kMode, 1>((const float*)d, (float*)out, batch, h, w, p,
                                            (cudaStream_t)stream)
             : launch_legall_tiles<kMode, 0>((const float*)d, (float*)out, batch, h, w, p,
                                            (cudaStream_t)stream);
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
