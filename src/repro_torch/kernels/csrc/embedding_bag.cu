// Embedding bag for Hopper (sm_90a): out[b] = sum_l mask[b, l] * table[ids[b, l]];
// combiner 'mean' divides by max(count, 1). Masked slots are never read; a
// null mask means every slot is live.
//
// Replaces src/repro/kernels/embedding_bag.py:embedding_bag_pallas (_kernel).
//
// Bound: memory. B*L*D*4 bytes of table rows read (live slots only), B*L
// bytes of ids (4 or 8 each) and of mask, B*D*4 bytes written; one add per
// float read.
//
// Design: one warp owns one bag. Lanes hold the bag's D floats in registers,
// one float4 per lane per 128 columns when D % 4 == 0 (16-byte coalesced
// loads), else one float per lane per 32 columns. The warp walks the bag's L
// slots in order, so the sum order is the slot order. No shared memory, no
// atomics. On the serving path L = 1: the kernel is a row gather, and the
// caller's ids (int32 or int64) go in as they are, without a mask, so the
// gather is one allocation and one launch. At that size the device time is
// the launch itself: repro_noop launches an empty kernel through the same
// path, to measure that floor.
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void add(float& a, float b) { a += b; }
__device__ __forceinline__ void add(float4& a, float4 b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}
__device__ __forceinline__ void divide(float& a, float n) { a = a / n; }
__device__ __forceinline__ void divide(float4& a, float n) {
  a.x = a.x / n; a.y = a.y / n; a.z = a.z / n; a.w = a.w / n;
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ float4 zero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }

template <typename T, typename Id>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const float* __restrict__ table, const Id* __restrict__ ids,
                     const unsigned char* __restrict__ mask, float* __restrict__ out,
                     int n_bags, int bag_len, int d, bool mean) {
  const long long bag = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (bag >= n_bags) return;
  const int lane = threadIdx.x & 31;
  constexpr int kPer = sizeof(T) / sizeof(float);
  const int width = d / kPer;
  const T* rows = reinterpret_cast<const T*>(table);
  const Id* bag_ids = ids + bag * bag_len;
  const unsigned char* bag_mask = mask ? mask + bag * bag_len : nullptr;
  T* dst = reinterpret_cast<T*>(out) + bag * width;
  for (int c = lane; c < width; c += 32) {
    T acc = zero<T>();
    int count = 0;
    for (int l = 0; l < bag_len; ++l) {
      if (bag_mask && !bag_mask[l]) continue;
      ++count;
      add(acc, rows[(long long)bag_ids[l] * width + c]);
    }
    if (mean) divide(acc, (float)max(count, 1));
    dst[c] = acc;
  }
}

__global__ void noop_kernel() {}

template <typename Id>
void launch(const void* table, const void* ids, const void* mask, void* out, int n_bags,
            int bag_len, int d, bool mean, bool vec4, cudaStream_t st) {
  const int blocks = (n_bags + kThreads / 32 - 1) / (kThreads / 32);
  const float* t = static_cast<const float*>(table);
  const Id* i = static_cast<const Id*>(ids);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  float* o = static_cast<float*>(out);
  if (vec4)
    embedding_bag_kernel<float4, Id><<<blocks, kThreads, 0, st>>>(t, i, m, o, n_bags, bag_len, d, mean);
  else
    embedding_bag_kernel<float, Id><<<blocks, kThreads, 0, st>>>(t, i, m, o, n_bags, bag_len, d, mean);
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// table f32[V, d]; ids i32[n_bags, bag_len] (ids64 == 0) or i64 (ids64 != 0);
// mask u8[n_bags, bag_len] or null (every slot live); out f32[n_bags, d].
// vec4 != 0 promises d % 4 == 0 and 16-byte aligned rows.
extern "C" int embedding_bag_f32(const void* table, const void* ids, const void* mask,
                                 void* out, int n_bags, int bag_len, int d, int mean,
                                 int vec4, int ids64, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ids64)
    launch<long long>(table, ids, mask, out, n_bags, bag_len, d, mean != 0, vec4 != 0, st);
  else
    launch<int>(table, ids, mask, out, n_bags, bag_len, d, mean != 0, vec4 != 0, st);
  return (int)cudaGetLastError();
}

// One empty kernel (1 block of 32 threads) through the same path: the launch floor.
extern "C" int repro_noop(int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
