// Embedding bag for Hopper (sm_90a): out[b] = sum_l mask[b, l] * table[ids[b, l]];
// combiner 'mean' divides by max(count, 1). Masked slots are never read.
//
// Replaces src/repro/kernels/embedding_bag.py:embedding_bag_pallas (_kernel).
//
// Bound: memory. B*L*D*4 bytes of table rows read (live slots only), B*L*5
// bytes of ids and mask, B*D*4 bytes written; one add per float read.
//
// Design: one warp owns one bag. Lanes hold the bag's D floats in registers,
// one float4 per lane per 128 columns when D % 4 == 0 (16-byte coalesced
// loads), else one float per lane per 32 columns. The warp walks the bag's L
// slots in order, so the sum order is the slot order. No shared memory, no
// atomics. On the serving path L = 1: the kernel is a row gather.
#include <cuda_runtime.h>

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const float* __restrict__ table, const int* __restrict__ ids,
                     const unsigned char* __restrict__ mask, float* __restrict__ out,
                     int n_bags, int bag_len, int d, bool mean) {
  const long long bag = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (bag >= n_bags) return;
  const int lane = threadIdx.x & 31;
  constexpr int kPer = sizeof(T) / sizeof(float);
  const int width = d / kPer;
  const T* rows = reinterpret_cast<const T*>(table);
  const int* bag_ids = ids + bag * bag_len;
  const unsigned char* bag_mask = mask + bag * bag_len;
  T* dst = reinterpret_cast<T*>(out) + bag * width;
  for (int c = lane; c < width; c += 32) {
    T acc = zero<T>();
    int count = 0;
    for (int l = 0; l < bag_len; ++l) {
      if (!bag_mask[l]) continue;
      ++count;
      add(acc, rows[(long long)bag_ids[l] * width + c]);
    }
    if (mean) divide(acc, (float)max(count, 1));
    dst[c] = acc;
  }
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// table f32[V, d]; ids i32[n_bags, bag_len]; mask u8[n_bags, bag_len];
// out f32[n_bags, d]. vec4 != 0 promises d % 4 == 0 and 16-byte aligned rows.
extern "C" int embedding_bag_f32(const void* table, const void* ids, const void* mask,
                                 void* out, int n_bags, int bag_len, int d, int mean,
                                 int vec4, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_bags + kThreads / 32 - 1) / (kThreads / 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const int* i = static_cast<const int*>(ids);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  float* o = static_cast<float*>(out);
  if (vec4)
    embedding_bag_kernel<float4><<<blocks, kThreads, 0, st>>>(t, i, m, o, n_bags, bag_len, d, mean != 0);
  else
    embedding_bag_kernel<float><<<blocks, kThreads, 0, st>>>(t, i, m, o, n_bags, bag_len, d, mean != 0);
  return (int)cudaGetLastError();
}
