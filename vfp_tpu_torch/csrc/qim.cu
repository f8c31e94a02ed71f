// QIM block kernels on structure-of-arrays blocks m [B, 16, N] (float32,
// contiguous): entry r*4+c of block n of frame b sits at m[(b*16 + r*4+c)*N + n].
//
// Replaces the Pallas kernels of vfp_tpu/kernels/qim.py: qim_triplet_soa,
// qim_decode_soa and qim_embed_soa, three epilogues on one _triplet_core.
// One thread per block index n: neighbouring threads read neighbouring
// addresses in each of the 16 rows, so the SoA layout is already coalesced.
// Bound on the card: memory.  A block is 64 B read and 36 B (triplet), 4 B
// (decode) or 64 B (embed) written, against a few hundred FLOPs of register
// math, so the design keeps every intermediate in registers and touches
// device memory once per input and output value.

#include <cstdint>

#include "triplet.cuh"

namespace vfp {
namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void load_block(const float* __restrict__ m, long long base, int n_blocks,
                                           float blk[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) blk[i] = m[base + (long long)i * n_blocks];
}

__global__ void triplet_kernel(const float* __restrict__ m, float* __restrict__ out, int batch,
                               int n_blocks, StartVector v0) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)batch * n_blocks) return;
  const long long b = t / n_blocks, n = t % n_blocks;
  float blk[16], u[4], v[4];
  load_block(m, b * 16 * n_blocks + n, n_blocks, blk);
  const float s0 = dominant_triplet(blk, v0, u, v);
  // out [B, 9, N]: row 0 = s0, rows 1..4 = u, rows 5..8 = v
  float* o = out + b * 9 * n_blocks + n;
  o[0] = s0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[(long long)(1 + i) * n_blocks] = u[i];
    o[(long long)(5 + i) * n_blocks] = v[i];
  }
}

__global__ void decode_kernel(const float* __restrict__ m, float* __restrict__ out, int batch,
                              int n_blocks, float scale, StartVector v0) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)batch * n_blocks) return;
  const long long b = t / n_blocks, n = t % n_blocks;
  float blk[16], u[4], v[4];
  load_block(m, b * 16 * n_blocks + n, n_blocks, blk);
  out[t] = qim_bit(dominant_triplet(blk, v0, u, v), scale);
}

__global__ void embed_kernel(const float* __restrict__ m, const float* __restrict__ wm,
                             float* __restrict__ out, int batch, int n_blocks, float scale,
                             StartVector v0) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)batch * n_blocks) return;
  const long long b = t / n_blocks, n = t % n_blocks;
  const long long base = b * 16 * n_blocks + n;
  float blk[16], u[4], v[4];
  load_block(m, base, n_blocks, blk);
  const float s0 = dominant_triplet(blk, v0, u, v);
  const float ds = qim_target(s0, wm[n], scale) - s0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      out[base + (long long)(r * 4 + c) * n_blocks] = blk[r * 4 + c] + ds * (u[r] * v[c]);
    }
  }
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

// Plain C interface, bound with ctypes (kernels/_build.py).  Pointers to
// tensors are device pointers; v0 points to 4 host floats.  Each launcher
// enqueues on the given stream, does not synchronise, and returns the
// cudaError_t of the launch (0 on success).

extern "C" int vfp_qim_triplet_soa(const void* m, void* out, int batch, int n_blocks,
                                   const void* v0, void* stream) {
  const long long total = (long long)batch * n_blocks;
  if (total == 0) return 0;
  vfp::triplet_kernel<<<vfp::grid_for(total), vfp::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)m, (float*)out, batch, n_blocks, vfp::start_vector(v0));
  return (int)cudaGetLastError();
}

extern "C" int vfp_qim_decode_soa(const void* m, void* out, int batch, int n_blocks, float scale,
                                  const void* v0, void* stream) {
  const long long total = (long long)batch * n_blocks;
  if (total == 0) return 0;
  vfp::decode_kernel<<<vfp::grid_for(total), vfp::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)m, (float*)out, batch, n_blocks, scale, vfp::start_vector(v0));
  return (int)cudaGetLastError();
}

extern "C" int vfp_qim_embed_soa(const void* m, const void* wm, void* out, int batch, int n_blocks,
                                 float scale, const void* v0, void* stream) {
  const long long total = (long long)batch * n_blocks;
  if (total == 0) return 0;
  vfp::embed_kernel<<<vfp::grid_for(total), vfp::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)m, (const float*)wm, (float*)out, batch, n_blocks, scale,
      vfp::start_vector(v0));
  return (int)cudaGetLastError();
}

extern "C" const char* vfp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
