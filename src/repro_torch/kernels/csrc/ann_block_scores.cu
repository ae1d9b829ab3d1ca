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
// card's peaks, so what it takes is latency: the launch, one round of
// loads, and the longest thread's dot products. For a whole-sweep staging
// (B = 16,384) it is bound by operations: 2*B*nb*D fp32 FLOP against
// B*nb*4 bytes written.
//
// Design: one block per (TU users x TB centroids) output tile, the tile
// chosen by the shape.
//   * A serving batch (fewer 64 x 64 tiles than SMs) takes 16 x 32 tiles of
//     128 threads, 2 x 2 outputs each: B = 64 against 832 blocks is 104
//     blocks on the 132 SMs, where 64 x 64 tiles gave 13 (16 x 16 tiles of
//     1 x 2 outputs, 208 blocks, were slower: each thread's shared loads
//     feed fewer FMAs). The user and centroid rows are staged in shared
//     memory once for D <= 224 (D = 128 on the main path); wider rows go in
//     chunks of 224 columns, the most that static shared memory holds (a
//     dynamic allocation that held 256 was slower at D = 128).
//   * A sweep keeps 64 x 64 tiles of 256 threads, 4 x 4 outputs each, over
//     D in chunks of 32 columns.
// Rows are loaded 16 bytes at a time (a float4 of the users, 16 int8 of the
// centroids, converted to float as they are stored) when D % 16 == 0, else
// one value at a time; every edge (B, nb and D ragged, nb = 1) is masked on
// load and store. The dot products read the staged rows 16 bytes at a time
// too (a row is KC + 4 floats, an odd number of 16-byte quads, so a
// quarter-warp's reads of 8 rows hit distinct banks). The threads of a user
// sum its squares from the staged rows over strided columns and combine
// them by shuffle, so the norm costs no second pass over ue. The epilogue
// rounds as the plain version does: dots * scale and norm * radius each
// rounded, then added (__fmul_rn / __fadd_rn, no FMA contraction), so
// integer-valued inputs give bitwise equal results; the block selection
// orders blocks by these bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

// TU users x TB centroids per block, MU x MB outputs per thread, D staged
// KC columns at a time. Static shared memory (at most 48 KB) holds the
// staged rows, KC + 4 floats each, then the users' sums of squares.
template <int TU, int TB, int MU, int MB, int KC, bool kVec>
__global__ void __launch_bounds__((TU / MU) * (TB / MB))
ann_block_scores_kernel(const float* __restrict__ ue, const int8_t* __restrict__ cq,
                        const float* __restrict__ scale,
                        const float* __restrict__ radius, float* __restrict__ out,
                        int n_users, int n_blocks, int d) {
  constexpr int kTU = TU / MU;                // threads along users
  constexpr int kTB = TB / MB;                // threads along centroids
  constexpr int kThreads = kTU * kTB;
  constexpr int kNorm = kThreads / TU;        // threads per user's norm
  static_assert(kNorm >= 1 && kNorm <= 32 && (kNorm & (kNorm - 1)) == 0,
                "a user's norm lanes must be a power-of-two group of a warp");
  static_assert(KC % 16 == 0, "KC must hold whole 16-byte centroid loads");
  // a row is an odd number of 16-byte quads: 8 rows read at one column hit
  // distinct banks; a compile-time stride keeps the address arithmetic out
  // of the inner loop
  constexpr int stride = KC + 4;
  static_assert((stride / 4) % 2 == 1, "rows must be an odd number of quads");
  __shared__ __align__(16) float smem[(TU + TB) * stride + TU];
  float* us = smem;                 // [TU][stride]
  float* cs = us + TU * stride;     // [TB][stride]
  float* sumsq = cs + TB * stride;  // [TU]

  const int tid = threadIdx.x;
  const int tx = tid % kTB;  // centroid lane
  const int ty = tid / kTB;  // user lane
  const int nu = tid / kNorm, nl = tid % kNorm;
  const int b0 = blockIdx.x * TB;
  const int u0 = blockIdx.y * TU;

  float acc[MU][MB];
#pragma unroll
  for (int i = 0; i < MU; ++i)
#pragma unroll
    for (int j = 0; j < MB; ++j) acc[i][j] = 0.f;
  float ss = 0.f;  // user u0 + nu's squares over columns nl, nl + kNorm, ...

  for (int c0 = 0; c0 < d; c0 += KC) {
    const int kc = min(KC, d - c0);
    const int kc4 = (kc + 3) & ~3;  // staged width: zeros past d add nothing
    if (kVec) {  // d % 16 == 0, so kc % 16 == 0 and every row is 16-byte aligned
      const int q4 = kc / 4;
      for (int i = tid; i < TU * q4; i += kThreads) {
        const int r = i / q4, c = (i % q4) * 4, gu = u0 + r;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gu < n_users)
          v = *reinterpret_cast<const float4*>(ue + (long long)gu * d + c0 + c);
        *reinterpret_cast<float4*>(&us[r * stride + c]) = v;
      }
      const int q16 = kc / 16;
      for (int i = tid; i < TB * q16; i += kThreads) {
        const int r = i / q16, c = (i % q16) * 16, gb = b0 + r;
        int4 v = make_int4(0, 0, 0, 0);
        if (gb < n_blocks)
          v = *reinterpret_cast<const int4*>(cq + (long long)gb * d + c0 + c);
        const int8_t* q = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int k = 0; k < 16; k += 4)
          *reinterpret_cast<float4*>(&cs[r * stride + c + k]) =
              make_float4((float)q[k], (float)q[k + 1], (float)q[k + 2], (float)q[k + 3]);
      }
    } else {
      for (int i = tid; i < TU * kc4; i += kThreads) {
        const int r = i / kc4, c = i % kc4, gu = u0 + r;
        us[r * stride + c] = gu < n_users && c < kc ? ue[(long long)gu * d + c0 + c] : 0.f;
      }
      for (int i = tid; i < TB * kc4; i += kThreads) {
        const int r = i / kc4, c = i % kc4, gb = b0 + r;
        cs[r * stride + c] = gb < n_blocks && c < kc ? (float)cq[(long long)gb * d + c0 + c] : 0.f;
      }
    }
    __syncthreads();
    for (int c = nl; c < kc; c += kNorm) {
      const float x = us[nu * stride + c];
      ss = __fadd_rn(ss, __fmul_rn(x, x));
    }
    // four columns per step, 16-byte shared loads; each output still adds
    // its products in column order
#pragma unroll 4
    for (int c = 0; c < kc4; c += 4) {
      float4 a[MU], w[MB];
#pragma unroll
      for (int i = 0; i < MU; ++i) a[i] = *reinterpret_cast<const float4*>(&us[(ty + kTU * i) * stride + c]);
#pragma unroll
      for (int j = 0; j < MB; ++j) w[j] = *reinterpret_cast<const float4*>(&cs[(tx + kTB * j) * stride + c]);
#pragma unroll
      for (int i = 0; i < MU; ++i)
#pragma unroll
        for (int j = 0; j < MB; ++j) {
          acc[i][j] = fmaf(a[i].x, w[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, w[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, w[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, w[j].w, acc[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int o = kNorm / 2; o > 0; o /= 2)
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
  if (nl == 0) sumsq[nu] = ss;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < MU; ++i) {
    const int lu = ty + kTU * i;
    const int u = u0 + lu;
    if (u >= n_users) continue;
    const float unorm = __fsqrt_rn(sumsq[lu]);
#pragma unroll
    for (int j = 0; j < MB; ++j) {
      const int b = b0 + tx + kTB * j;
      if (b >= n_blocks) continue;
      out[(long long)u * n_blocks + b] =
          __fadd_rn(__fmul_rn(acc[i][j], scale[b]), __fmul_rn(unorm, radius[b]));
    }
  }
}

template <int TU, int TB, int MU, int MB, int KC>
void launch(bool vec, const float* ue, const int8_t* cq, const float* scale,
            const float* radius, float* out, int n_users, int n_blocks, int d,
            cudaStream_t stream) {
  const dim3 grid((n_blocks + TB - 1) / TB, (n_users + TU - 1) / TU);
  constexpr int threads = (TU / MU) * (TB / MB);
  auto kernel = vec ? ann_block_scores_kernel<TU, TB, MU, MB, KC, true>
                    : ann_block_scores_kernel<TU, TB, MU, MB, KC, false>;
  kernel<<<grid, threads, 0, stream>>>(ue, cq, scale, radius, out, n_users, n_blocks, d);
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// ue f32[n_users, d]; cq i8[n_blocks, d]; scale, radius f32[n_blocks];
// out f32[n_users, n_blocks]. n_users and n_blocks must be > 0. vec16 != 0
// promises d % 16 == 0 and 16-byte aligned ue and cq.
extern "C" int ann_block_scores_f32(const void* ue, const void* cq, const void* scale,
                                    const void* radius, void* out, int n_users,
                                    int n_blocks, int d, int vec16, int device,
                                    void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const float* u = static_cast<const float*>(ue);
  const int8_t* c = static_cast<const int8_t*>(cq);
  const float* s = static_cast<const float*>(scale);
  const float* r = static_cast<const float*>(radius);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long big_tiles = (long long)((n_users + 63) / 64) * ((n_blocks + 63) / 64);
  if (big_tiles >= sms)
    launch<64, 64, 4, 4, 32>(vec16 != 0, u, c, s, r, o, n_users, n_blocks, d, st);
  else
    launch<16, 32, 2, 2, 224>(vec16 != 0, u, c, s, r, o, n_users, n_blocks, d, st);
  return (int)cudaGetLastError();
}
