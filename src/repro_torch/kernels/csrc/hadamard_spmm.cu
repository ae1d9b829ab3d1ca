// Fused gather-Hadamard-aggregate for Hopper (sm_90a):
//   out[v] = leaky(scale[v] * sum_{e in [indptr[v], indptr[v+1])} x[x_idx[e]] * y[y_idx[e]])
// with the scale and the leaky-relu (v >= 0 ? v : v * slope) both optional.
// A row with no edges gives 0 after the epilogue. The [E, D] product is
// never stored: each edge's two rows meet in registers.
//
// Replaces src/repro/kernels/hadamard_spmm.py:hadamard_spmm_pallas (_kernel).
//
// Bound: memory. Each edge reads two source rows of D floats (2*E*D*4 bytes
// of gathers, most of them L2 hits: NGCF's tables are 27-179 MB), plus
// 2*E*4 bytes of indices and n*D*4 bytes written. Arithmetic is one
// multiply and one add per gathered pair of floats.
//
// Design: the same layout as spmm_csr.cu. One warp owns one destination
// row, so no atomics and no shared memory are needed. Lanes hold the row's
// D floats in registers: one float4 per lane per 128 columns when
// D % 4 == 0 (16-byte loads), else one float per lane per 32 columns. The
// warp loads 32 (x_idx, y_idx) pairs at a time, one pair per lane, and
// broadcasts them with __shfl_sync; the edge loop is unrolled by kUnroll so
// 2 * kUnroll row loads are in flight per warp. Edges are accumulated in CSR
// order, each term rounded as a product and then added (no FMA contraction),
// as the plain version rounds it. The Pallas kernel's double-buffered row
// DMAs become the unrolled in-flight loads. Known slow spot, as for
// spmm_csr: a warp per row leaves a long tail on Zipf graphs (one item row
// can hold 1.7% of all edges); splitting long rows is future work.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float mac(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

__device__ __forceinline__ float4 mac(float4 acc, float4 a, float4 b) {
  return make_float4(mac(acc.x, a.x, b.x), mac(acc.y, a.y, b.y),
                     mac(acc.z, a.z, b.z), mac(acc.w, a.w, b.w));
}

__device__ __forceinline__ float epi(float v, float s, bool leaky, float slope) {
  v = v * s;
  return (leaky && !(v >= 0.f)) ? v * slope : v;
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

// T = float4 (D % 4 == 0, 16-byte aligned) or float (any D).
template <typename T>
__global__ void __launch_bounds__(kThreads)
hadamard_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const long long* __restrict__ indptr, const int* __restrict__ x_idx,
                const int* __restrict__ y_idx, const float* __restrict__ scale,
                int leaky, float slope, float* __restrict__ out, int n_rows, int d) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // whole warp leaves together
  const int lane = threadIdx.x & 31;
  const long long lo = indptr[row];
  const long long hi = indptr[row + 1];
  constexpr int kPer = sizeof(T) / sizeof(float);
  const int width = d / kPer;  // columns in units of T
  const T* xs = reinterpret_cast<const T*>(x);
  const T* ys = reinterpret_cast<const T*>(y);
  T* dst = reinterpret_cast<T*>(out) + row * width;
  const float s = scale != nullptr ? scale[row] : 1.f;

  for (int c0 = 0; c0 < width; c0 += 32) {
    const int c = c0 + lane;
    const bool active = c < width;
    T acc = zero<T>();
    for (long long base = lo; base < hi; base += 32) {
      const int cnt = (int)min(32LL, hi - base);
      long long mx = 0, my = 0;
      if (lane < cnt) {
        mx = x_idx[base + lane];
        my = y_idx[base + lane];
      }
      for (int j = 0; j < cnt; j += kUnroll) {
        T a[kUnroll], b[kUnroll];
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          const long long rx = __shfl_sync(kFull, mx, (j + q) & 31);
          const long long ry = __shfl_sync(kFull, my, (j + q) & 31);
          if (active && j + q < cnt) {
            a[q] = xs[rx * width + c];
            b[q] = ys[ry * width + c];
          }
        }
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          if (active && j + q < cnt) acc = mac(acc, a[q], b[q]);
        }
      }
    }
    if (active) dst[c] = epi(acc, s, leaky != 0, slope);
  }
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x f32[Nx, d]; y f32[Ny, d]; indptr i64[n_rows + 1]; x_idx, y_idx i32[E];
// scale f32[n_rows] or null; leaky != 0 applies the leaky-relu with slope;
// out f32[n_rows, d]. vec4 != 0 promises d % 4 == 0 and 16-byte aligned rows.
extern "C" int hadamard_spmm_f32(const void* x, const void* y, const void* indptr,
                                 const void* x_idx, const void* y_idx, const void* scale,
                                 int leaky, float slope, void* out, int n_rows, int d,
                                 int vec4, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_rows + kThreads / 32 - 1) / (kThreads / 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const long long* ip = static_cast<const long long*>(indptr);
  const int* xi = static_cast<const int*>(x_idx);
  const int* yi = static_cast<const int*>(y_idx);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  if (vec4)
    hadamard_kernel<float4><<<blocks, kThreads, 0, st>>>(xf, yf, ip, xi, yi, sc, leaky,
                                                         slope, o, n_rows, d);
  else
    hadamard_kernel<float><<<blocks, kThreads, 0, st>>>(xf, yf, ip, xi, yi, sc, leaky,
                                                        slope, o, n_rows, d);
  return (int)cudaGetLastError();
}
