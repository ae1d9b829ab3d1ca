// Coarse ANN block scores for Hopper (sm_90a):
//   out[u, b] = (sum_d ue[u, d] * float(cq[b, d])) * scale[b]
//               + sqrt(sum_d ue[u, d]^2) * radius[b]
// ue f32[B, D]; cq i8[nb, D] (the int8 block centroids, converted to float
// without their scale, as the reference does); scale, radius f32[nb];
// out f32[B, nb]. With radius = 0 it is the IVF probing affinity.
//
// Replaces src/repro/kernels/ann.py:ann_block_scores_pallas (_kernel).
//
// Bound: at the serving shapes (B <= 64 users, 832 blocks, D = 128) the
// call reads ~0.15 MB and does ~14 MFLOP, well under a microsecond at the
// card's peaks, so it is bound by its launch. For a whole-sweep staging
// (B = 16,384) it is bound by operations: 2*B*nb*D fp32 FLOP against
// B*nb*4 bytes written.
//
// Design: one 256-thread block per (64 users x 64 centroids) output tile.
// D runs in chunks of 32: each chunk stages the users' f32 rows and the
// centroids' int8 rows (converted to float on load) in shared memory, and
// every thread accumulates a 4 x 4 sub-tile with fp32 FMAs. Threads 0..63
// also sum their user's squares from the staged chunk, so the norm costs
// no second pass over ue. Every edge (B, nb and D ragged, nb = 1) is
// masked on load and store. The epilogue rounds as the plain version does:
// dots * scale and norm * radius each rounded, then added (__fmul_rn /
// __fadd_rn, no FMA contraction), so integer-valued inputs give bitwise
// equal results; the block selection orders blocks by these bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileU = 64;
constexpr int kTileB = 64;
constexpr int kChunk = 32;
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
ann_block_scores_kernel(const float* __restrict__ ue, const int8_t* __restrict__ cq,
                        const float* __restrict__ scale,
                        const float* __restrict__ radius, float* __restrict__ out,
                        int n_users, int n_blocks, int d) {
  __shared__ float us[kTileU][kChunk + 1];
  __shared__ float cs[kTileB][kChunk + 1];
  __shared__ float sumsq[kTileU];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // centroid lane
  const int ty = tid / 16;  // user lane
  const int b0 = blockIdx.x * kTileB;
  const int u0 = blockIdx.y * kTileU;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float ss = 0.f;  // threads 0..63: user u0 + tid's sum of squares

  for (int c0 = 0; c0 < d; c0 += kChunk) {
    for (int i = tid; i < kTileU * kChunk; i += kThreads) {
      const int r = i / kChunk, c = i % kChunk;
      const int gu = u0 + r, gc = c0 + c;
      us[r][c] = (gu < n_users && gc < d) ? ue[(long long)gu * d + gc] : 0.f;
      const int gb = b0 + r;
      cs[r][c] = (gb < n_blocks && gc < d) ? (float)cq[(long long)gb * d + gc] : 0.f;
    }
    __syncthreads();
    if (tid < kTileU) {
      for (int c = 0; c < kChunk; ++c) {
        const float x = us[tid][c];
        ss = __fadd_rn(ss, __fmul_rn(x, x));
      }
    }
#pragma unroll 8
    for (int c = 0; c < kChunk; ++c) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = us[ty + 16 * i][c];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = cs[tx + 16 * j][c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (tid < kTileU) sumsq[tid] = ss;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lu = ty + 16 * i;
    const int u = u0 + lu;
    if (u >= n_users) continue;
    const float unorm = __fsqrt_rn(sumsq[lu]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = b0 + tx + 16 * j;
      if (b >= n_blocks) continue;
      out[(long long)u * n_blocks + b] =
          __fadd_rn(__fmul_rn(acc[i][j], scale[b]), __fmul_rn(unorm, radius[b]));
    }
  }
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// ue f32[n_users, d]; cq i8[n_blocks, d]; scale, radius f32[n_blocks];
// out f32[n_users, n_blocks]. n_users and n_blocks must be > 0.
extern "C" int ann_block_scores_f32(const void* ue, const void* cq, const void* scale,
                                    const void* radius, void* out, int n_users,
                                    int n_blocks, int d, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_blocks + kTileB - 1) / kTileB, (n_users + kTileU - 1) / kTileU);
  ann_block_scores_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ue), static_cast<const int8_t*>(cq),
      static_cast<const float*>(scale), static_cast<const float*>(radius),
      static_cast<float*>(out), n_users, n_blocks, d);
  return (int)cudaGetLastError();
}
