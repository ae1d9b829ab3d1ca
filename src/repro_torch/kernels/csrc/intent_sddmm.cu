// Per-edge, per-intent dots over a CSR for Hopper (sm_90a), DGCF's routing
// agreement:
//   s[e, q] = sum_{c in intent q} a[row_e, c] * b[src[e], c]
// for every edge e of the CSR (row_e its row), with D = K * dk columns and
// intent q the columns [q * dk, (q + 1) * dk). s is f32[E, K].
//
// Replaces no TPU kernel: the JAX package has no DGCF, so there is no
// src/repro/kernels/ counterpart. It was added for DGCF's routing, which
// scores every edge in every intent (kernels/intent.py).
//
// Bound: memory. Each edge reads one source row of D floats (E*D*4 bytes of
// gathers, mostly L2 hits on 14-90 MB tables) and its index (E*4 bytes),
// and writes its K dots (E*K*4 bytes); each row of a is read once per row
// segment. Arithmetic is one multiply and one add per gathered float.
//
// Design: every edge's output is its own, so there are no partials and no
// second pass; the merge-path partition (row_split.cuh) is kept for its
// balance: one warp walks `chunk` items of rows + edges, so a row of 256k
// edges is spread over ~250 warps, and a run of short rows costs one item
// each. A warp holds its row of a in registers while it walks the row's
// edges. An edge takes width = D / 4 float4 lanes (D / 32 floats without
// float4), so a warp scores 32 / width edges at once: two at D = 64. Each
// lane multiplies its float4 of a and b and adds the four products in
// order; the dk / 4 lanes of one intent then add their sums by a butterfly
// of __shfl_xor_sync, and the first of them writes s[e, q]. The warp loads
// 32 edge indices at a time and broadcasts them with __shfl_sync; the edge
// loop is unrolled by kUnroll, so 2 * kUnroll row loads are in flight per
// warp at D = 64. Products and sums are rounded one at a time (no FMA
// contraction).
#include <cuda_runtime.h>

#include "launch.cuh"
#include "row_split.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

__device__ __forceinline__ float dot(float a, float b) { return __fmul_rn(a, b); }

__device__ __forceinline__ float dot(float4 a, float4 b) {
  float s = __fmul_rn(a.x, b.x);
  s = __fadd_rn(s, __fmul_rn(a.y, b.y));
  s = __fadd_rn(s, __fmul_rn(a.z, b.z));
  return __fadd_rn(s, __fmul_rn(a.w, b.w));
}

template <typename T>
__device__ __forceinline__ T zero();

template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }

template <>
__device__ __forceinline__ float4 zero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// One warp scores the edges [lo, hi) of one row, whose column `col` (units
// of T) of a this lane holds in `av`. Lane group g takes the edges j + g,
// j + g + groups, ... of each pass. Every lane calls it with the same lo and
// hi, and every lane takes part in each shuffle.
template <typename T>
__device__ __forceinline__ void agree_edges(T av, const T* __restrict__ bs,
                                            const int* __restrict__ src,
                                            float* __restrict__ out, long long lo, long long hi,
                                            int width, int col, int g, int groups,
                                            int per_intent, int qq, int k, int lane) {
  for (long long base = lo; base < hi; base += 32) {
    const int cnt = (int)min(32LL, hi - base);
    int mine = 0;
    if (lane < cnt) mine = src[base + lane];
    for (int j = 0; j < cnt; j += groups * kUnroll) {
      T bv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int slot = j + u * groups + g;
        const int rb = __shfl_sync(kFull, mine, slot & 31);
        bv[u] = slot < cnt ? bs[(long long)rb * width + col] : zero<T>();
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int slot = j + u * groups + g;
        float p = dot(av, bv[u]);
        for (int off = per_intent >> 1; off > 0; off >>= 1)
          p = __fadd_rn(p, __shfl_xor_sync(kFull, p, off));
        if (slot < cnt && col % per_intent == 0) out[(base + slot) * k + qq] = p;
      }
    }
  }
}

// T = float4 (dk % 4 == 0, 16-byte aligned) or float. width = d / (floats
// in T) lanes an edge, a power of two <= 32, and width / k lanes an intent,
// a power of two. One warp per chunk.
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
intent_agree_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const long long* __restrict__ indptr, const int* __restrict__ src,
                    const long long* __restrict__ chunk_row, float* __restrict__ out,
                    int n_rows, long long n_chunks, int d, int k, long long chunk) {
  const long long c = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= n_chunks) return;  // whole warp leaves together
  const int lane = threadIdx.x & 31;
  const row_split::Chunk ch = row_split::bounds(indptr, chunk_row, c, chunk);
  constexpr int kPer = sizeof(T) / sizeof(float);
  const int width = d / kPer;
  const int groups = 32 / width;
  const int g = lane / width;
  const int col = lane % width;
  const int per_intent = width / k;
  const int qq = col / per_intent;
  const T* as = reinterpret_cast<const T*>(a);
  const T* bs = reinterpret_cast<const T*>(b);
  // the rows whose markers lie in the chunk, then the row it leaves open
  for (long long r = ch.i0; r <= ch.i1 && r < n_rows; ++r) {
    const long long lo = r == ch.i0 ? ch.j0 : indptr[r];
    const long long hi = r < ch.i1 ? indptr[r + 1] : ch.j1;
    if (lo >= hi) continue;
    agree_edges<T>(as[r * width + col], bs, src, out, lo, hi, width, col, g, groups,
                   per_intent, qq, k, lane);
  }
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// a f32[n_rows, d]; b f32[N_src, d]; indptr i64[n_rows + 1] with
// indptr[n_rows] = E; src i32[E]; chunk_row i64[n_chunks + 1]
// (row_split.cuh); out f32[E, k]. vec4 != 0 promises (d / k) % 4 == 0 and
// 16-byte aligned rows; d / (vec4 ? 4 : 1) is a power of two <= 32 and
// d / (vec4 ? 4 : 1) / k a power of two. n_chunks must be > 0.
extern "C" int intent_sddmm_f32(const void* a, const void* b, const void* indptr,
                                const void* src, const void* chunk_row, void* out, int n_rows,
                                long long n_chunks, long long chunk, int d, int k, int vec4,
                                int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const long long* ip = static_cast<const long long*>(indptr);
  const int* s = static_cast<const int*>(src);
  const long long* cr = static_cast<const long long*>(chunk_row);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long blocks = (n_chunks + kWarps - 1) / kWarps;
  if (vec4)
    intent_agree_kernel<float4><<<(unsigned)blocks, kThreads, 0, st>>>(
        af, bf, ip, s, cr, o, n_rows, n_chunks, d, k, chunk);
  else
    intent_agree_kernel<float><<<(unsigned)blocks, kThreads, 0, st>>>(
        af, bf, ip, s, cr, o, n_rows, n_chunks, d, k, chunk);
  return (int)cudaGetLastError();
}
