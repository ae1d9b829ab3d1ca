// Intent-weighted CSR aggregation for Hopper (sm_90a), DGCF's routed
// neighbourhood sum:
//   out[v, c] = sum_{e in [indptr[v], indptr[v+1])} w[e, c / dk] * x[src[e], c]
// with D = K * dk columns, K intents of dk columns each, and one weight per
// edge and intent. A row with no edges gives 0.
//
// Replaces no TPU kernel: the JAX package has no DGCF, so there is no
// src/repro/kernels/ counterpart. It was added for DGCF's routing, whose
// aggregation weights change inside the step (kernels/intent.py).
//
// Bound: memory. Each edge reads one source row of D floats (E*D*4 bytes of
// gathers, most of them L2 hits: the tables are 14-90 MB at D = 64), its K
// weights (E*K*4 bytes, streamed) and its index (E*4 bytes), and the call
// writes n*D*4 bytes. Arithmetic is one multiply and one add per gathered
// float.
//
// Design: spmm_csr.cu's, with a weight on each term. The edges are split
// evenly, not the rows: a merge-path partition (row_split.cuh) cuts rows +
// edges into chunks of `chunk` items, one warp walks one chunk, so the Zipf
// degree tail does not set the time. A row that ends in its chunk is summed
// in registers and written directly; the part of a row that crosses a chunk
// boundary leaves a partial sum in a workspace (head and open slots), and a
// second pass sums each split row's partials in chunk order. No atomics:
// the result is the same bits on every call.
// Lanes hold the row's D floats in registers: one float4 per lane per 128
// columns when dk % 4 == 0 (16-byte loads; a float4 never straddles two
// intents), else one float per lane per 32 columns. At D = 64 that is 16
// float4 lanes a row, lane l weighted by w[e, l / (dk / 4)]. The warp loads
// 32 edge indices at a time and broadcasts them with __shfl_sync; the edge
// loop is unrolled by kUnroll so that several row loads are in flight. Each
// lane reads its intent's weight of each edge itself: the lanes of one
// intent read one address, which the L1 serves as one load.
// Edges are accumulated in CSR order, each term rounded as a product and
// then added (no FMA contraction), as the plain version rounds it.
#include <cuda_runtime.h>

#include "launch.cuh"
#include "row_split.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

__device__ __forceinline__ float mac(float acc, float w, float x) {
  return __fadd_rn(acc, __fmul_rn(w, x));
}

__device__ __forceinline__ float4 mac(float4 acc, float w, float4 x) {
  return make_float4(mac(acc.x, w, x.x), mac(acc.y, w, x.y), mac(acc.z, w, x.z),
                     mac(acc.w, w, x.w));
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(add(a.x, b.x), add(a.y, b.y), add(a.z, b.z), add(a.w, b.w));
}

template <typename T>
__device__ __forceinline__ T zero();

template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }

template <>
__device__ __forceinline__ float4 zero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// One warp sums w[e, kk] * x[src[e]] over the edges [lo, hi) at column `col`
// (in units of T) of intent kk, in CSR order. Every lane calls it with the
// same lo and hi.
template <typename T>
__device__ __forceinline__ T intent_edges(const T* __restrict__ xs, const float* __restrict__ w,
                                          const int* __restrict__ src, long long lo,
                                          long long hi, int width, int col, int kk, int k,
                                          bool active, int lane) {
  T acc = zero<T>();
  for (long long base = lo; base < hi; base += 32) {
    const int cnt = (int)min(32LL, hi - base);
    int mine = 0;
    if (lane < cnt) mine = src[base + lane];
    for (int j = 0; j < cnt; j += kUnroll) {
      T v[kUnroll];
      float wv[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int r = __shfl_sync(kFull, mine, (j + q) & 31);
        if (active && j + q < cnt) {
          v[q] = xs[(long long)r * width + col];
          wv[q] = w[(base + j + q) * k + kk];
        }
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        if (active && j + q < cnt) acc = mac(acc, wv[q], v[q]);
      }
    }
  }
  return acc;
}

// T = float4 (dk % 4 == 0, 16-byte aligned) or float (any dk). One warp per
// chunk; partial is f32[n_chunks, 2, d]: slot 0 the head, slot 1 the open row.
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
intent_chunk_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const long long* __restrict__ indptr, const int* __restrict__ src,
                    const long long* __restrict__ chunk_row, float* __restrict__ out,
                    float* __restrict__ partial, int n_rows, long long n_chunks, int d, int k,
                    long long chunk) {
  const long long c = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= n_chunks) return;  // whole warp leaves together
  const int lane = threadIdx.x & 31;
  const row_split::Chunk ch = row_split::bounds(indptr, chunk_row, c, chunk);
  constexpr int kPer = sizeof(T) / sizeof(float);
  const int width = d / kPer;       // columns in units of T
  const int per_intent = width / k; // units of T in one intent's chunk
  const T* xs = reinterpret_cast<const T*>(x);
  T* dst = reinterpret_cast<T*>(out);
  T* head = reinterpret_cast<T*>(partial) + 2 * c * width;
  T* open = head + width;

  for (int c0 = 0; c0 < width; c0 += 32) {
    const int col = c0 + lane;
    const bool active = col < width;
    const int kk = active ? col / per_intent : 0;
    for (long long r = ch.i0; r < ch.i1; ++r) {
      const long long lo = r == ch.i0 ? ch.j0 : indptr[r];
      const T acc = intent_edges<T>(xs, w, src, lo, indptr[r + 1], width, col, kk, k, active,
                                    lane);
      if (!active) continue;
      if (r == ch.i0 && ch.head_split)
        head[col] = acc;
      else
        dst[r * width + col] = acc;
    }
    if (ch.i1 < n_rows) {
      const long long lo = ch.i1 == ch.i0 ? ch.j0 : indptr[ch.i1];
      const T acc = intent_edges<T>(xs, w, src, lo, ch.j1, width, col, kk, k, active, lane);
      if (active) open[col] = acc;
    }
  }
}

// One warp per chunk; the chunks that complete a split row sum its partials:
// the open slots of the chunks it crossed, then their own head.
template <typename T>
__global__ void __launch_bounds__(kThreads)
intent_combine_kernel(const long long* __restrict__ indptr,
                      const long long* __restrict__ chunk_row,
                      const float* __restrict__ partial, float* __restrict__ out,
                      long long n_chunks, int d, long long chunk) {
  const long long c = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= n_chunks) return;
  const row_split::Chunk ch = row_split::bounds(indptr, chunk_row, c, chunk);
  if (!ch.head_split) return;
  const long long first = row_split::first_chunk(indptr, ch.i0, chunk);
  constexpr int kPer = sizeof(T) / sizeof(float);
  const int width = d / kPer;
  const T* part = reinterpret_cast<const T*>(partial);
  T* dst = reinterpret_cast<T*>(out) + ch.i0 * width;
  for (int col = threadIdx.x & 31; col < width; col += 32) {
    T acc = part[(2 * first + 1) * width + col];
    for (long long q = first + 1; q < c; ++q) acc = add(acc, part[(2 * q + 1) * width + col]);
    dst[col] = add(acc, part[2 * c * width + col]);
  }
}

template <typename T>
void launch(const float* x, const float* w, const long long* indptr, const int* src,
            const long long* chunk_row, float* partial, float* out, int n_rows,
            long long n_chunks, int d, int k, long long chunk, cudaStream_t stream) {
  const long long blocks = (n_chunks + kWarps - 1) / kWarps;
  intent_chunk_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, w, indptr, src, chunk_row, out, partial, n_rows, n_chunks, d, k, chunk);
  intent_combine_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      indptr, chunk_row, partial, out, n_chunks, d, chunk);
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x f32[N_src, d]; w f32[E, k]; indptr i64[n_rows + 1]; src i32[E];
// chunk_row i64[n_chunks + 1] (row_split.cuh); partial f32[n_chunks, 2, d]
// workspace; out f32[n_rows, d]. k divides d. vec4 != 0 promises
// (d / k) % 4 == 0 and 16-byte aligned rows. n_chunks must be > 0.
extern "C" int intent_spmm_f32(const void* x, const void* w, const void* indptr,
                               const void* src, const void* chunk_row, void* partial,
                               void* out, int n_rows, long long n_chunks, long long chunk,
                               int d, int k, int vec4, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const long long* ip = static_cast<const long long*>(indptr);
  const int* s = static_cast<const int*>(src);
  const long long* cr = static_cast<const long long*>(chunk_row);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec4)
    launch<float4>(xf, wf, ip, s, cr, p, o, n_rows, n_chunks, d, k, chunk, st);
  else
    launch<float>(xf, wf, ip, s, cr, p, o, n_rows, n_chunks, d, k, chunk, st);
  return (int)cudaGetLastError();
}
