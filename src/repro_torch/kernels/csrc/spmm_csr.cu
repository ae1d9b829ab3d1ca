// CSR SpMM for Hopper (sm_90a): out[v] = reduce_{e in [indptr[v], indptr[v+1])}
// of values[src_sorted[e]] (gather) or values[e] (no gather), reduce = sum | max.
// An empty max row gives 0 (the -inf seed is mapped through isfinite ? v : 0).
//
// Replaces src/repro/kernels/spmm.py:spmm_csr_pallas (_kernel).
//
// Bound: memory. Each edge reads one source row of D floats (E*D*4 bytes of
// gathers, most of them L2 hits on a 27-179 MB table), plus E*4 bytes of
// indices and n*D*4 bytes written. Arithmetic is one add per gathered float.
//
// Design: the edges are split evenly, not the rows, so the Zipf degree tail
// (one row can hold 1.7% of all edges) no longer sets the time. A merge-path
// partition (row_split.cuh) cuts rows + edges into chunks of `chunk` items;
// one warp walks one chunk. Rows that end in the chunk are reduced in
// registers and written directly; the part of a row that crosses a chunk
// boundary goes to a partial in a workspace (two slots per chunk), and a
// second, small pass combines each split row's partials in chunk order.
// No atomics: the result is the same bits on every call, and max works.
// Lanes hold the row's D floats in registers: one float4 per lane per 128
// columns when D % 4 == 0 (16-byte loads, a 512-byte coalesced row read per
// warp instruction), else one float per lane per 32 columns. The warp loads
// 32 edge indices at a time (one per lane) and broadcasts them with
// __shfl_sync; the edge loop is unrolled by kUnroll (4) so that several row
// loads are in flight per warp. Edge and merge offsets are 64-bit.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "launch.cuh"
#include "row_split.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

__device__ __forceinline__ float op(float a, float b, bool is_max) {
  return is_max ? fmaxf(a, b) : a + b;
}

__device__ __forceinline__ float4 op(float4 a, float4 b, bool is_max) {
  return make_float4(op(a.x, b.x, is_max), op(a.y, b.y, is_max),
                     op(a.z, b.z, is_max), op(a.w, b.w, is_max));
}

__device__ __forceinline__ float fin(float v) { return isfinite(v) ? v : 0.f; }

__device__ __forceinline__ float4 fin(float4 v) {
  return make_float4(fin(v.x), fin(v.y), fin(v.z), fin(v.w));
}

template <typename T>
__device__ __forceinline__ T seed(bool is_max);

template <>
__device__ __forceinline__ float seed<float>(bool is_max) {
  return is_max ? -CUDART_INF_F : 0.f;
}

template <>
__device__ __forceinline__ float4 seed<float4>(bool is_max) {
  const float s = seed<float>(is_max);
  return make_float4(s, s, s, s);
}

// One warp reduces the edges [lo, hi) at column `col` (in units of T), in
// CSR order. Every lane of the warp calls it with the same lo and hi.
template <typename T, bool kMax, bool kGather>
__device__ __forceinline__ T reduce_edges(const T* __restrict__ vals,
                                          const int* __restrict__ src, long long lo,
                                          long long hi, int width, int col,
                                          bool active, int lane) {
  T acc = seed<T>(kMax);
  for (long long base = lo; base < hi; base += 32) {
    const int cnt = (int)min(32LL, hi - base);
    long long mine = 0;
    if (lane < cnt) mine = kGather ? (long long)src[base + lane] : base + lane;
    for (int j = 0; j < cnt; j += kUnroll) {
      T v[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const long long r = __shfl_sync(kFull, mine, (j + q) & 31);
        if (active && j + q < cnt) v[q] = vals[r * width + col];
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        if (active && j + q < cnt) acc = op(acc, v[q], kMax);
      }
    }
  }
  return acc;
}

// T = float4 (D % 4 == 0, 16-byte aligned) or float (any D). One warp per
// chunk; partial is f32[n_chunks, 2, d]: slot 0 the head, slot 1 the open row.
// At most 64 registers (4 blocks, 32 warps per SM): more warps in flight
// hide more of the gathers' latency than a deeper unroll in fewer warps.
template <typename T, bool kMax, bool kGather>
__global__ void __launch_bounds__(kThreads, 4)
spmm_chunk_kernel(const float* __restrict__ values, const long long* __restrict__ indptr,
                  const int* __restrict__ src, const long long* __restrict__ chunk_row,
                  float* __restrict__ out, float* __restrict__ partial, int n_rows,
                  long long n_chunks, int d, long long chunk) {
  const long long c = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= n_chunks) return;  // whole warp leaves together
  const int lane = threadIdx.x & 31;
  const row_split::Chunk ch = row_split::bounds(indptr, chunk_row, c, chunk);
  constexpr int kPer = sizeof(T) / sizeof(float);
  const int width = d / kPer;  // columns in units of T
  const T* vals = reinterpret_cast<const T*>(values);
  T* dst = reinterpret_cast<T*>(out);
  T* head = reinterpret_cast<T*>(partial) + 2 * c * width;
  T* open = head + width;

  for (int c0 = 0; c0 < width; c0 += 32) {
    const int col = c0 + lane;
    const bool active = col < width;
    for (long long r = ch.i0; r < ch.i1; ++r) {
      const long long lo = r == ch.i0 ? ch.j0 : indptr[r];
      const T acc = reduce_edges<T, kMax, kGather>(vals, src, lo, indptr[r + 1],
                                                   width, col, active, lane);
      if (!active) continue;
      if (r == ch.i0 && ch.head_split)
        head[col] = acc;
      else
        dst[r * width + col] = kMax ? fin(acc) : acc;
    }
    if (ch.i1 < n_rows) {
      const long long lo = ch.i1 == ch.i0 ? ch.j0 : indptr[ch.i1];
      const T acc = reduce_edges<T, kMax, kGather>(vals, src, lo, ch.j1, width,
                                                   col, active, lane);
      if (active) open[col] = acc;
    }
  }
}

// One warp per chunk; the chunks that complete a split row combine its
// partials: the open slots of the chunks it crossed, then their own head.
template <typename T, bool kMax>
__global__ void __launch_bounds__(kThreads)
spmm_combine_kernel(const long long* __restrict__ indptr,
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
    for (long long k = first + 1; k < c; ++k)
      acc = op(acc, part[(2 * k + 1) * width + col], kMax);
    acc = op(acc, part[2 * c * width + col], kMax);
    dst[col] = kMax ? fin(acc) : acc;
  }
}

template <typename T, bool kMax, bool kGather>
void launch(const float* values, const long long* indptr, const int* src,
            const long long* chunk_row, float* partial, float* out, int n_rows,
            long long n_chunks, int d, long long chunk, cudaStream_t stream) {
  const long long blocks = (n_chunks + kWarps - 1) / kWarps;
  spmm_chunk_kernel<T, kMax, kGather><<<(unsigned)blocks, kThreads, 0, stream>>>(
      values, indptr, src, chunk_row, out, partial, n_rows, n_chunks, d, chunk);
  spmm_combine_kernel<T, kMax><<<(unsigned)blocks, kThreads, 0, stream>>>(
      indptr, chunk_row, partial, out, n_chunks, d, chunk);
}

template <typename T>
void dispatch(bool is_max, bool gather, const float* v, const long long* ip,
              const int* s, const long long* cr, float* p, float* o, int n_rows,
              long long n_chunks, int d, long long chunk, cudaStream_t st) {
  if (is_max) {
    if (gather)
      launch<T, true, true>(v, ip, s, cr, p, o, n_rows, n_chunks, d, chunk, st);
    else
      launch<T, true, false>(v, ip, s, cr, p, o, n_rows, n_chunks, d, chunk, st);
  } else {
    if (gather)
      launch<T, false, true>(v, ip, s, cr, p, o, n_rows, n_chunks, d, chunk, st);
    else
      launch<T, false, false>(v, ip, s, cr, p, o, n_rows, n_chunks, d, chunk, st);
  }
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// values f32[*, d]; indptr i64[n_rows + 1]; src_sorted i32[E] (read iff
// gather); chunk_row i64[n_chunks + 1] (row_split.cuh); partial
// f32[n_chunks, 2, d] workspace; out f32[n_rows, d]. vec4 != 0 promises
// d % 4 == 0 and 16-byte aligned rows. n_chunks must be > 0.
extern "C" int spmm_csr_f32(const void* values, const void* indptr, const void* src_sorted,
                            const void* chunk_row, void* partial, void* out, int n_rows,
                            long long n_chunks, long long chunk, int d, int gather,
                            int reduce_max, int vec4, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const float* v = static_cast<const float*>(values);
  const long long* ip = static_cast<const long long*>(indptr);
  const int* s = static_cast<const int*>(src_sorted);
  const long long* cr = static_cast<const long long*>(chunk_row);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec4)
    dispatch<float4>(reduce_max != 0, gather != 0, v, ip, s, cr, p, o, n_rows, n_chunks, d,
                     chunk, st);
  else
    dispatch<float>(reduce_max != 0, gather != 0, v, ip, s, cr, p, o, n_rows, n_chunks, d,
                    chunk, st);
  return (int)cudaGetLastError();
}
