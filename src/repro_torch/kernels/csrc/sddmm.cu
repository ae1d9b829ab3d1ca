// Sampled dense-dense op per edge (SDDMM) for Hopper (sm_90a):
//   mul:  out[e, :] = x[src[e], :] * y[dst[e], :]
//   add:  out[e, :] = x[src[e], :] + y[dst[e], :]
//   dot:  out[e]    = sum_k x[src[e], k] * y[dst[e], k]
//   copy: out[e, :] = coeff[e] * x[src[e], :]   (x[src[e], :] when coeff is null)
// A masked edge (mask[e] == 0) gives +0.0 and loads no row.
//
// Replaces src/repro/kernels/sddmm.py:sddmm_pallas (_kernel).
//
// Bound: memory. The output (E * D floats, written once) is most of the
// traffic: NGCF's O3 message matrix is 7.7 GB per layer, against ~0.3 GB of
// tables and indices. The gathered rows are re-read many times (Zipf
// degrees), partly from L2.
//
// Design, from the TPU kernel's nt-write intent (paper section 6): each output
// row is produced once and never re-read, so it is stored with streaming
// hints (__stcs, st.global.cs) that keep it from evicting the gathered rows
// out of L2, and the gathered rows are loaded through the read-only path
// (__ldg). One warp owns a group of 32 consecutive edges: lane l loads the
// (src, dst, mask, coeff) of edge base + l, and the warp walks the group's
// edges, broadcasting each edge's indices with __shfl_sync; lanes cover the
// row's D floats, 16 bytes each when D % 4 == 0 (else 4 bytes), and kUnroll
// edges' rows are in flight at once. 'dot' sums each lane's products and
// reduces across the warp with __shfl_xor_sync; lane j keeps edge j's sum, so
// the group's 32 sums are stored by one coalesced write. Each product and sum
// is rounded on its own (__fmul_rn, __fadd_rn: no FMA contraction), as the
// plain version rounds it, so 'mul', 'add' and 'copy' equal it bit for bit.
// Every element offset is computed in 64 bits: E * D passes 2^31 at the
// main shape's scale.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

enum Op { kMul = 0, kAdd = 1, kDot = 2, kCopy = 3 };

__device__ __forceinline__ float4 ld(const float4* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ void st(float4* p, float4 v) { __stcs(p, v); }
__device__ __forceinline__ void st(float* p, float v) { __stcs(p, v); }

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 zero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float4 mul(float4 a, float4 b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y), __fmul_rn(a.z, b.z),
                     __fmul_rn(a.w, b.w));
}
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ float scale(float a, float c) { return __fmul_rn(a, c); }
__device__ __forceinline__ float4 scale(float4 a, float c) {
  return make_float4(__fmul_rn(a.x, c), __fmul_rn(a.y, c), __fmul_rn(a.z, c),
                     __fmul_rn(a.w, c));
}
// this lane's share of <a, b>: products rounded, then summed left to right
__device__ __forceinline__ float dot_part(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dot_part(float4 a, float4 b) {
  float s = __fmul_rn(a.x, b.x);
  s = __fadd_rn(s, __fmul_rn(a.y, b.y));
  s = __fadd_rn(s, __fmul_rn(a.z, b.z));
  return __fadd_rn(s, __fmul_rn(a.w, b.w));
}

// T = float4 (D % 4 == 0, 16-byte aligned rows) or float (any D).
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
sddmm_kernel(const float* __restrict__ x, const float* __restrict__ y,
             const int* __restrict__ src, const int* __restrict__ dst,
             const unsigned char* __restrict__ mask, const float* __restrict__ coeff,
             float* __restrict__ out, long long n_edges, int d) {
  const long long base = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
  if (base >= n_edges) return;  // whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int cnt = (int)min(32LL, n_edges - base);
  constexpr int kPer = sizeof(T) / sizeof(float);
  const int width = d / kPer;  // columns in units of T
  const T* xs = reinterpret_cast<const T*>(x);
  const T* ys = reinterpret_cast<const T*>(y);
  T* os = reinterpret_cast<T*>(out);

  int my_src = 0, my_dst = 0, my_live = 0;
  float my_coeff = 1.f;
  if (lane < cnt) {
    my_src = src[base + lane];
    if (OP != kCopy) my_dst = dst[base + lane];
    my_live = mask[base + lane] != 0;
    if (OP == kCopy && coeff != nullptr) my_coeff = coeff[base + lane];
  }
  float my_dot = 0.f;  // 'dot': the sum of edge base + lane

  for (int j0 = 0; j0 < cnt; j0 += kUnroll) {
    long long rs[kUnroll], rd[kUnroll];
    bool live[kUnroll];
    float cf[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const int j = (j0 + q) & 31;
      rs[q] = __shfl_sync(kFull, my_src, j);
      rd[q] = __shfl_sync(kFull, my_dst, j);
      live[q] = __shfl_sync(kFull, my_live, j) != 0 && j0 + q < cnt;
      cf[q] = __shfl_sync(kFull, my_coeff, j);
    }
    float part[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) part[q] = 0.f;

    for (int c0 = 0; c0 < width; c0 += 32) {
      const int c = c0 + lane;
      const bool active = c < width;
      T a[kUnroll], b[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        a[q] = zero<T>();
        b[q] = zero<T>();
        if (active && live[q]) {
          a[q] = ld(xs + rs[q] * width + c);
          if (OP != kCopy) b[q] = ld(ys + rd[q] * width + c);
        }
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        if (!active || j0 + q >= cnt) continue;
        if (OP == kDot) {
          if (live[q]) part[q] = __fadd_rn(part[q], dot_part(a[q], b[q]));
        } else {
          T v = zero<T>();
          if (live[q]) {
            if (OP == kMul) v = mul(a[q], b[q]);
            else if (OP == kAdd) v = add(a[q], b[q]);
            else v = coeff != nullptr ? scale(a[q], cf[q]) : a[q];
          }
          st(os + (base + j0 + q) * width + c, v);
        }
      }
    }

    if (OP == kDot) {
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        float s = part[q];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
        if (lane == ((j0 + q) & 31)) my_dot = live[q] ? s : 0.f;
      }
    }
  }
  if (OP == kDot && lane < cnt) st(out + base + lane, my_dot);
}

template <typename T>
void launch(int op, const float* x, const float* y, const int* src, const int* dst,
            const unsigned char* mask, const float* coeff, float* out, long long n_edges,
            int d, cudaStream_t st) {
  const long long warps = (n_edges + 31) / 32;
  const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  switch (op) {
    case kMul:
      sddmm_kernel<T, kMul><<<blocks, kThreads, 0, st>>>(x, y, src, dst, mask, coeff, out,
                                                         n_edges, d);
      break;
    case kAdd:
      sddmm_kernel<T, kAdd><<<blocks, kThreads, 0, st>>>(x, y, src, dst, mask, coeff, out,
                                                         n_edges, d);
      break;
    case kDot:
      sddmm_kernel<T, kDot><<<blocks, kThreads, 0, st>>>(x, y, src, dst, mask, coeff, out,
                                                         n_edges, d);
      break;
    default:
      sddmm_kernel<T, kCopy><<<blocks, kThreads, 0, st>>>(x, y, src, dst, mask, coeff, out,
                                                          n_edges, d);
  }
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// op: 0 mul, 1 add, 2 dot, 3 copy. x f32[Nx, d]; y f32[Ny, d] (unused by copy);
// src, dst i32[E] (dst unused by copy); mask u8[E]; coeff f32[E] or null (read
// by copy only); out f32[E, d], or f32[E] for dot. vec4 != 0 promises
// d % 4 == 0 and 16-byte aligned x, y and out.
extern "C" int sddmm_f32(int op, const void* x, const void* y, const void* src,
                         const void* dst, const void* mask, const void* coeff, void* out,
                         long long n_edges, int d, int vec4, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (op < kMul || op > kCopy) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const int* s = static_cast<const int*>(src);
  const int* t = static_cast<const int*>(dst);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  const float* c = static_cast<const float*>(coeff);
  float* o = static_cast<float*>(out);
  if (vec4)
    launch<float4>(op, xf, yf, s, t, m, c, o, n_edges, d, st);
  else
    launch<float>(op, xf, yf, s, t, m, c, o, n_edges, d, st);
  return (int)cudaGetLastError();
}
