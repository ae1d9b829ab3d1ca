// Fused gather-Hadamard-aggregate for Hopper (sm_90a):
//   out[v] = leaky(scale[v] * sum_{e in [indptr[v], indptr[v+1])} x[x_idx[e]] * y[y_idx[e]])
// with the scale and the leaky-relu (v >= 0 ? v : v * slope) both optional.
// A row with no edges gives 0 after the epilogue. The [E, D] product is
// never stored: each edge's two rows meet in registers, or, where x_idx and
// y_idx are one index (NGCF's d_x), the product is formed once per node.
//
// Replaces src/repro/kernels/hadamard_spmm.py:hadamard_spmm_pallas (_kernel).
//
// Bound: memory. Each edge reads two source rows of D floats (2*E*D*4 bytes
// of gathers, most of them L2 hits: NGCF's tables are 27-179 MB), plus
// 2*E*4 bytes of indices and n*D*4 bytes written. Arithmetic is one
// multiply and one add per gathered pair of floats. With a shared index an
// edge reads one row of the product table p = x * y (E*D*4 bytes of
// gathers, E*4 of indices), and forming p streams 3*rows*D*4 bytes.
//
// Design: the edges are split evenly, not the rows, as in spmm_csr.cu, so
// the Zipf degree tail (one item row holds 1.7% of all edges) no longer
// sets the time. A merge-path partition (row_split.cuh) cuts rows + edges
// into chunks of `chunk` items; one warp walks one chunk. A row that ends
// in its chunk is summed in registers and written directly, with the
// epilogue. The part of a row that crosses a chunk boundary leaves a
// pre-epilogue partial sum in a workspace (two slots per chunk: head and
// open), and a second pass, the combine kernel, sums each split row's
// partials in chunk order and only then applies the scale and the
// leaky-relu, so the epilogue never sees a partial sum. No atomics: the
// result is the same bits on every call.
// Lanes hold the row's D floats in registers: one float4 per lane per 128
// columns when D % 4 == 0 (16-byte loads), else one float per lane per 32
// columns. The warp loads 32 (x_idx, y_idx) pairs at a time, one pair per
// lane, and broadcasts them with __shfl_sync; the edge loop is unrolled by
// kUnroll so that 2 * kUnroll row loads are in flight per warp. (Keeping
// the y row in registers while a group's y_idx repeats, as it does where y
// rides the destination, measured slower: the second code path cost
// registers and spills.)
// Shared index (the entry hadamard_spmm_shared_f32, chosen by the wrapper
// when x_idx and y_idx are one tensor): a product kernel first writes
// p[r] = x[r] * y[r] over the rows both tables hold, into a workspace; the
// chunk kernel's kShared variant then gathers one row of p per edge, with
// one index per edge, kUnroll rows in flight per warp, and the same combine
// pass follows. (Unrolling it by 8, to keep as many loads in flight as the
// general variant's 4 pairs, spilled registers and measured slower on the
// H100: 1.06 against 0.89 ms for NGCF's item-table d_x.)
// Each term is the same rounded product, added in the same order with the
// same chunk split, so both routes give the same bits.
// Edges are accumulated in CSR order, each term rounded as a product and
// then added (no FMA contraction), as the plain version rounds it.
// kUnroll 4 and kMinBlocks 4 (with chunks of 1,024, an argument) came out
// of a sweep on the H100 over chunks 256-4,096, unroll 2/4/8 and 2/3/4/6
// blocks per SM: unroll 8 or 6 blocks per SM spilled registers (10.5-34.1
// ms for one layer's four calls).
#include <cuda_runtime.h>

#include "launch.cuh"
#include "row_split.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kMinBlocks = 4;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

__device__ __forceinline__ float4 mul(float4 a, float4 b) {
  return make_float4(mul(a.x, b.x), mul(a.y, b.y), mul(a.z, b.z), mul(a.w, b.w));
}

__device__ __forceinline__ float mac(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

__device__ __forceinline__ float4 mac(float4 acc, float4 a, float4 b) {
  return make_float4(mac(acc.x, a.x, b.x), mac(acc.y, a.y, b.y),
                     mac(acc.z, a.z, b.z), mac(acc.w, a.w, b.w));
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(add(a.x, b.x), add(a.y, b.y), add(a.z, b.z), add(a.w, b.w));
}

__device__ __forceinline__ float epi(float v, float s, bool leaky, float slope) {
  v = __fmul_rn(v, s);
  return (leaky && !(v >= 0.f)) ? __fmul_rn(v, slope) : v;
}

__device__ __forceinline__ float4 epi(float4 v, float s, bool leaky, float slope) {
  return make_float4(epi(v.x, s, leaky, slope), epi(v.y, s, leaky, slope),
                     epi(v.z, s, leaky, slope), epi(v.w, s, leaky, slope));
}

template <typename T>
__device__ __forceinline__ T zero();

template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }

template <>
__device__ __forceinline__ float4 zero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// One warp sums x[x_idx[e]] * y[y_idx[e]] over the edges [lo, hi) at column
// `col` (in units of T), in CSR order. kShared: x_idx is y_idx and xs is the
// product table p = x * y, so each edge gathers one row and adds it (ys and
// y_idx unused). Every lane calls it with the same lo and hi.
template <typename T, bool kShared>
__device__ __forceinline__ T hadamard_edges(const T* __restrict__ xs, const T* __restrict__ ys,
                                            const int* __restrict__ x_idx,
                                            const int* __restrict__ y_idx, long long lo,
                                            long long hi, int width, int col, bool active,
                                            int lane) {
  T acc = zero<T>();
  for (long long base = lo; base < hi; base += 32) {
    const int cnt = (int)min(32LL, hi - base);
    int mx = 0, my = 0;
    if (lane < cnt) {
      mx = x_idx[base + lane];
      if constexpr (!kShared) my = y_idx[base + lane];
    }
    for (int j = 0; j < cnt; j += kUnroll) {
      T a[kUnroll];
      [[maybe_unused]] T b[kShared ? 1 : kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int rx = __shfl_sync(kFull, mx, (j + q) & 31);
        if constexpr (kShared) {
          if (active && j + q < cnt) a[q] = xs[(long long)rx * width + col];
        } else {
          const int ry = __shfl_sync(kFull, my, (j + q) & 31);
          if (active && j + q < cnt) {
            a[q] = xs[(long long)rx * width + col];
            b[q] = ys[(long long)ry * width + col];
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        if (active && j + q < cnt) {
          if constexpr (kShared)
            acc = add(acc, a[q]);
          else
            acc = mac(acc, a[q], b[q]);
        }
      }
    }
  }
  return acc;
}

// p = x * y over the first n elements (in units of T) of both tables: the
// rows they share, each product rounded as mac rounds it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
hadamard_product_kernel(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ p,
                        long long n) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads)
    p[i] = mul(x[i], y[i]);
}

// T = float4 (D % 4 == 0, 16-byte aligned) or float (any D). One warp per
// chunk; partial is f32[n_chunks, 2, d]: slot 0 the head, slot 1 the open
// row, both before the epilogue. kShared: x is the product table, y unused.
template <typename T, bool kShared>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
hadamard_chunk_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      const long long* __restrict__ indptr, const int* __restrict__ x_idx,
                      const int* __restrict__ y_idx, const long long* __restrict__ chunk_row,
                      const float* __restrict__ scale, int leaky, float slope,
                      float* __restrict__ out, float* __restrict__ partial, int n_rows,
                      long long n_chunks, int d, long long chunk) {
  const long long c = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= n_chunks) return;  // whole warp leaves together
  const int lane = threadIdx.x & 31;
  const row_split::Chunk ch = row_split::bounds(indptr, chunk_row, c, chunk);
  constexpr int kPer = sizeof(T) / sizeof(float);
  const int width = d / kPer;  // columns in units of T
  const T* xs = reinterpret_cast<const T*>(x);
  const T* ys = reinterpret_cast<const T*>(y);
  T* dst = reinterpret_cast<T*>(out);
  T* head = reinterpret_cast<T*>(partial) + 2 * c * width;
  T* open = head + width;

  for (int c0 = 0; c0 < width; c0 += 32) {
    const int col = c0 + lane;
    const bool active = col < width;
    for (long long r = ch.i0; r < ch.i1; ++r) {
      const long long lo = r == ch.i0 ? ch.j0 : indptr[r];
      const T acc = hadamard_edges<T, kShared>(xs, ys, x_idx, y_idx, lo, indptr[r + 1],
                                               width, col, active, lane);
      if (!active) continue;
      if (r == ch.i0 && ch.head_split)
        head[col] = acc;
      else
        dst[r * width + col] = epi(acc, scale != nullptr ? scale[r] : 1.f, leaky != 0, slope);
    }
    if (ch.i1 < n_rows) {
      const long long lo = ch.i1 == ch.i0 ? ch.j0 : indptr[ch.i1];
      const T acc = hadamard_edges<T, kShared>(xs, ys, x_idx, y_idx, lo, ch.j1, width, col,
                                               active, lane);
      if (active) open[col] = acc;
    }
  }
}

// One warp per chunk; the chunks that complete a split row sum its partials
// (the open slots of the chunks it crossed, then their own head) in chunk
// order, then apply the epilogue once. It reads only the partials, so both
// variants of the chunk kernel share it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
hadamard_combine_kernel(const long long* __restrict__ indptr,
                        const long long* __restrict__ chunk_row,
                        const float* __restrict__ partial, const float* __restrict__ scale,
                        int leaky, float slope, float* __restrict__ out, long long n_chunks,
                        int d, long long chunk) {
  const long long c = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= n_chunks) return;
  const row_split::Chunk ch = row_split::bounds(indptr, chunk_row, c, chunk);
  if (!ch.head_split) return;
  const long long first = row_split::first_chunk(indptr, ch.i0, chunk);
  constexpr int kPer = sizeof(T) / sizeof(float);
  const int width = d / kPer;
  const T* part = reinterpret_cast<const T*>(partial);
  T* dst = reinterpret_cast<T*>(out) + ch.i0 * width;
  const float s = scale != nullptr ? scale[ch.i0] : 1.f;
  for (int col = threadIdx.x & 31; col < width; col += 32) {
    T acc = part[(2 * first + 1) * width + col];
    for (long long k = first + 1; k < c; ++k) acc = add(acc, part[(2 * k + 1) * width + col]);
    acc = add(acc, part[2 * c * width + col]);
    dst[col] = epi(acc, s, leaky != 0, slope);
  }
}

// kShared: x is the product table the caller formed, y unused.
template <typename T, bool kShared>
void launch(const float* x, const float* y, const long long* indptr, const int* x_idx,
            const int* y_idx, const long long* chunk_row, const float* scale, int leaky,
            float slope, float* partial, float* out, int n_rows, long long n_chunks, int d,
            long long chunk, cudaStream_t stream) {
  const long long blocks = (n_chunks + kWarps - 1) / kWarps;
  hadamard_chunk_kernel<T, kShared><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, y, indptr, x_idx, y_idx, chunk_row, scale, leaky, slope, out, partial, n_rows,
      n_chunks, d, chunk);
  hadamard_combine_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      indptr, chunk_row, partial, scale, leaky, slope, out, n_chunks, d, chunk);
}

template <typename T>
void launch_product(const float* x, const float* y, float* prod, long long n_shared, int d,
                    cudaStream_t stream) {
  const long long n = n_shared * (d / (int)(sizeof(T) / sizeof(float)));
  if (n == 0) return;
  const long long need = (n + kThreads - 1) / kThreads;
  const long long blocks = need < (1LL << 16) ? need : (1LL << 16);  // grid-stride beyond
  hadamard_product_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const T*>(x), reinterpret_cast<const T*>(y), reinterpret_cast<T*>(prod),
      n);
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x f32[Nx, d]; y f32[Ny, d]; indptr i64[n_rows + 1]; x_idx, y_idx i32[E];
// chunk_row i64[n_chunks + 1] (row_split.cuh); partial f32[n_chunks, 2, d]
// workspace; scale f32[n_rows] or null; leaky != 0 applies the leaky-relu
// with slope; out f32[n_rows, d]. vec4 != 0 promises d % 4 == 0 and 16-byte
// aligned rows. n_chunks must be > 0.
extern "C" int hadamard_spmm_f32(const void* x, const void* y, const void* indptr,
                                 const void* x_idx, const void* y_idx, const void* chunk_row,
                                 void* partial, const void* scale, int leaky, float slope,
                                 void* out, int n_rows, long long n_chunks, long long chunk,
                                 int d, int vec4, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const long long* ip = static_cast<const long long*>(indptr);
  const int* xi = static_cast<const int*>(x_idx);
  const int* yi = static_cast<const int*>(y_idx);
  const long long* cr = static_cast<const long long*>(chunk_row);
  const float* sc = static_cast<const float*>(scale);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (vec4)
    launch<float4, false>(xf, yf, ip, xi, yi, cr, sc, leaky, slope, p, o, n_rows, n_chunks, d,
                          chunk, st);
  else
    launch<float, false>(xf, yf, ip, xi, yi, cr, sc, leaky, slope, p, o, n_rows, n_chunks, d,
                         chunk, st);
  return (int)cudaGetLastError();
}

// The same sum where x_idx and y_idx are one index `idx` i32[E]: prod
// f32[n_shared, d] is a workspace that takes x * y over the first n_shared
// rows of x and y (every idx < n_shared), then one row of it is gathered
// per edge. The other arguments are hadamard_spmm_f32's; vec4 also promises
// prod 16-byte aligned. The output is the same bits as hadamard_spmm_f32
// with idx passed as both indices.
extern "C" int hadamard_spmm_shared_f32(const void* x, const void* y, long long n_shared,
                                        const void* indptr, const void* idx,
                                        const void* chunk_row, void* prod, void* partial,
                                        const void* scale, int leaky, float slope, void* out,
                                        int n_rows, long long n_chunks, long long chunk, int d,
                                        int vec4, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const long long* ip = static_cast<const long long*>(indptr);
  const int* ix = static_cast<const int*>(idx);
  const long long* cr = static_cast<const long long*>(chunk_row);
  const float* sc = static_cast<const float*>(scale);
  float* pr = static_cast<float*>(prod);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (vec4) {
    launch_product<float4>(xf, yf, pr, n_shared, d, st);
    launch<float4, true>(pr, nullptr, ip, ix, nullptr, cr, sc, leaky, slope, p, o, n_rows,
                         n_chunks, d, chunk, st);
  } else {
    launch_product<float>(xf, yf, pr, n_shared, d, st);
    launch<float, true>(pr, nullptr, ip, ix, nullptr, cr, sc, leaky, slope, p, o, n_rows,
                        n_chunks, d, chunk, st);
  }
  return (int)cudaGetLastError();
}
