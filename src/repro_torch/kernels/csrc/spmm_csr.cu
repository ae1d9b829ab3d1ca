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
// Design: one warp owns one destination row, so no atomics and no shared
// memory are needed. Lanes hold the row's D floats in registers: one float4
// per lane per 128 columns when D % 4 == 0 (16-byte loads, a 512-byte
// coalesced row read per warp instruction), else one float per lane per 32
// columns. The warp loads 32 edge indices at a time (one per lane) and
// broadcasts them with __shfl_sync; the edge loop is unrolled by UNROLL so
// that many row loads are in flight per warp. Edges are accumulated in CSR
// order. Known slow spot: a warp per row leaves a long tail on Zipf graphs
// (one item row can hold 1.7% of all edges); splitting long rows is future
// work.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kUnroll = 8;

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

// T = float4 (D % 4 == 0, 16-byte aligned) or float (any D).
template <typename T, bool kMax, bool kGather>
__global__ void __launch_bounds__(kThreads)
spmm_kernel(const float* __restrict__ values, const long long* __restrict__ indptr,
            const int* __restrict__ src, float* __restrict__ out, int n_rows, int d) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // whole warp leaves together
  const int lane = threadIdx.x & 31;
  const long long lo = indptr[row];
  const long long hi = indptr[row + 1];
  constexpr int kPer = sizeof(T) / sizeof(float);
  const int width = d / kPer;  // columns in units of T
  const T* vals = reinterpret_cast<const T*>(values);
  T* dst = reinterpret_cast<T*>(out) + row * width;

  for (int c0 = 0; c0 < width; c0 += 32) {
    const int c = c0 + lane;
    const bool active = c < width;
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
          if (active && j + q < cnt) v[q] = vals[r * width + c];
        }
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          if (active && j + q < cnt) acc = op(acc, v[q], kMax);
        }
      }
    }
    if (active) dst[c] = kMax ? fin(acc) : acc;
  }
}

template <typename T>
void launch(bool is_max, bool gather, const float* values, const long long* indptr,
            const int* src, float* out, int n_rows, int d, cudaStream_t stream) {
  const int blocks = (n_rows + kThreads / 32 - 1) / (kThreads / 32);
  if (is_max) {
    if (gather)
      spmm_kernel<T, true, true><<<blocks, kThreads, 0, stream>>>(values, indptr, src, out, n_rows, d);
    else
      spmm_kernel<T, true, false><<<blocks, kThreads, 0, stream>>>(values, indptr, src, out, n_rows, d);
  } else {
    if (gather)
      spmm_kernel<T, false, true><<<blocks, kThreads, 0, stream>>>(values, indptr, src, out, n_rows, d);
    else
      spmm_kernel<T, false, false><<<blocks, kThreads, 0, stream>>>(values, indptr, src, out, n_rows, d);
  }
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// values f32[*, d]; indptr i64[n_rows + 1]; src_sorted i32[E] (read iff gather);
// out f32[n_rows, d]. vec4 != 0 promises d % 4 == 0 and 16-byte aligned rows.
extern "C" int spmm_csr_f32(const void* values, const void* indptr, const void* src_sorted,
                            void* out, int n_rows, int d, int gather, int reduce_max,
                            int vec4, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* v = static_cast<const float*>(values);
  const long long* ip = static_cast<const long long*>(indptr);
  const int* s = static_cast<const int*>(src_sorted);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec4)
    launch<float4>(reduce_max != 0, gather != 0, v, ip, s, o, n_rows, d, st);
  else
    launch<float>(reduce_max != 0, gather != 0, v, ip, s, o, n_rows, d, st);
  return (int)cudaGetLastError();
}
