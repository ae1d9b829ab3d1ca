// Fused score + seen-mask + top-K for Hopper (sm_90a).
//
// For each user b: scores = ue[b] . table[i] for i < n_items; a score equal to
// zero becomes +0.0; ids >= n_items and live seen ids become -inf; the result
// is the first K of all (score, id) pairs plus K (-inf, -1) seed slots in the
// order (score desc, id asc). The seeds sort before any (-inf, id >= 0), so
// short slots are (-inf, -1) exactly as in the TPU kernel.
//
// Replaces src/repro/kernels/topk_score.py:fused_topk_score_pallas (_kernel).
//
// Bound: operations. 2*B*I*D fp32 FLOPs per call against the card's fp32
// CUDA-core peak (dots are fp32 FMA, never TF32); the table (I*D*4 bytes)
// is read from L2 by every user tile.
//
// Design, three kernels on one stream:
//   1. seen_bits: one block per user turns its padded seen list into a bit
//      row over the catalogue (global scratch), so masking is O(1) per score
//      instead of O(L) per item tile.
//   2. topk_partial: grid (user tiles of 16, item splits). A block stages its
//      users in shared memory and streams 64-row item tiles through shared
//      memory (row stride D|1, so the per-lane row reads hit distinct banks).
//      Each thread computes 16 of the 16x64 scores as sequential fp32 FMAs.
//      Each warp then merges its users' 64 candidates into a per-user top-K
//      kept sorted in shared memory: a ballot against the current K-th entry
//      filters candidates, and each survivor is inserted at its rank (a
//      warp-wide count of better entries) with an explicit
//      (score desc, id asc) comparison. The top-K of a union is the top-K of
//      the per-split top-Ks, so the splits only fill the card with blocks.
//   3. topk_merge: one warp per user merges the splits' lists the same way.
// The result depends on neither the tile nor the split count.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUserTile = 16;
constexpr int kItemTile = 64;
constexpr int kMaxK = 256;
constexpr int kUserGroups = kThreads / kItemTile;      // 4
constexpr int kUsersPerThread = kUserTile / kUserGroups;  // 4

__device__ __forceinline__ bool better(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

// Warp-cooperative: each lane offers one candidate (cs, ci) to the list
// (ls, li) of length k, sorted best first. All 32 lanes must call.
__device__ void warp_offer(float* ls, int* li, int k, float cs, int ci, bool live, int lane) {
  unsigned pending = __ballot_sync(kFull, live && better(cs, ci, ls[k - 1], li[k - 1]));
  while (pending) {
    const int from = __ffs(pending) - 1;
    pending &= pending - 1;
    const float s = __shfl_sync(kFull, cs, from);
    const int id = __shfl_sync(kFull, ci, from);
    if (!better(s, id, ls[k - 1], li[k - 1])) continue;  // warp-uniform
    int rank = 0;
    for (int j = lane; j < k; j += 32) rank += better(ls[j], li[j], s, id) ? 1 : 0;
#pragma unroll
    for (int o = 16; o; o >>= 1) rank += __shfl_xor_sync(kFull, rank, o);
    float rs[kMaxK / 32];
    int ri[kMaxK / 32];
#pragma unroll
    for (int m = 0; m < kMaxK / 32; ++m) {
      const int j = lane + 32 * m;
      if (j < k && j > rank) { rs[m] = ls[j - 1]; ri[m] = li[j - 1]; }
    }
    __syncwarp();
#pragma unroll
    for (int m = 0; m < kMaxK / 32; ++m) {
      const int j = lane + 32 * m;
      if (j < k && j > rank) { ls[j] = rs[m]; li[j] = ri[m]; }
      else if (j == rank) { ls[j] = s; li[j] = id; }
    }
    __syncwarp();
  }
}

__global__ void seen_bits_kernel(const int* __restrict__ seen, const unsigned char* __restrict__ mask,
                                 unsigned* __restrict__ bits, int seen_len, int n_items, int words) {
  const long long b = blockIdx.x;
  unsigned* row = bits + b * words;
  for (int w = threadIdx.x; w < words; w += blockDim.x) row[w] = 0u;
  __syncthreads();
  const int* ids = seen + b * seen_len;
  const unsigned char* live = mask + b * seen_len;
  for (int l = threadIdx.x; l < seen_len; l += blockDim.x) {
    const int id = ids[l];
    if (live[l] && id >= 0 && id < n_items) atomicOr(&row[id >> 5], 1u << (id & 31));
  }
}

__global__ void __launch_bounds__(kThreads)
topk_partial_kernel(const float* __restrict__ ue, const float* __restrict__ table,
                    const unsigned* __restrict__ bits, float* __restrict__ part_s,
                    int* __restrict__ part_i, int n_users, int d, long long n_rows,
                    int n_items, int words, int k, int tiles_per_split) {
  extern __shared__ float smem[];
  const int stride = d | 1;
  float* s_items = smem;                              // kItemTile x stride
  float* s_ue = s_items + kItemTile * stride;         // kUserTile x d
  float* s_score = s_ue + kUserTile * d;              // kUserTile x kItemTile
  float* l_s = s_score + kUserTile * kItemTile;       // kUserTile x k
  int* l_i = reinterpret_cast<int*>(l_s + kUserTile * k);  // kUserTile x k

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int u0 = blockIdx.x * kUserTile;
  const int split = blockIdx.y;
  const int n_tiles = (n_items + kItemTile - 1) / kItemTile;
  const int tile_lo = split * tiles_per_split;
  const int tile_hi = min(n_tiles, tile_lo + tiles_per_split);

  for (int f = t; f < kUserTile * d; f += kThreads) {
    const int u = f / d;
    s_ue[f] = (u0 + u < n_users) ? ue[(long long)(u0 + u) * d + (f - u * d)] : 0.f;
  }
  for (int f = t; f < kUserTile * k; f += kThreads) {
    l_s[f] = -CUDART_INF_F;
    l_i[f] = -1;
  }
  const int item = t & (kItemTile - 1);
  const int group = t / kItemTile;

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int i0 = tile * kItemTile;
    __syncthreads();  // last tile's merge is done with s_score and s_items
    for (int f = t; f < kItemTile * d; f += kThreads) {
      const int r = f / d;
      const long long g = (long long)i0 + r;
      s_items[r * stride + (f - r * d)] = g < n_rows ? table[g * d + (f - r * d)] : 0.f;
    }
    __syncthreads();
    float acc[kUsersPerThread];
#pragma unroll
    for (int m = 0; m < kUsersPerThread; ++m) acc[m] = 0.f;
    const float* row = s_items + item * stride;
    for (int c = 0; c < d; ++c) {
      const float x = row[c];
#pragma unroll
      for (int m = 0; m < kUsersPerThread; ++m)
        acc[m] = fmaf(s_ue[(group + kUserGroups * m) * d + c], x, acc[m]);
    }
    const int gid = i0 + item;
#pragma unroll
    for (int m = 0; m < kUsersPerThread; ++m) {
      const int u = group + kUserGroups * m;
      float s = acc[m] == 0.f ? 0.f : acc[m];
      if (gid >= n_items) {
        s = -CUDART_INF_F;
      } else if (u0 + u < n_users &&
                 ((bits[(long long)(u0 + u) * words + (gid >> 5)] >> (gid & 31)) & 1u)) {
        s = -CUDART_INF_F;
      }
      s_score[u * kItemTile + item] = s;
    }
    __syncthreads();
    for (int u = warp; u < kUserTile; u += kWarps) {
      if (u0 + u >= n_users) continue;  // warp-uniform
      float* ls = l_s + u * k;
      int* li = l_i + u * k;
      warp_offer(ls, li, k, s_score[u * kItemTile + lane], i0 + lane, true, lane);
      warp_offer(ls, li, k, s_score[u * kItemTile + 32 + lane], i0 + 32 + lane, true, lane);
    }
  }
  __syncthreads();
  for (int u = warp; u < kUserTile; u += kWarps) {
    if (u0 + u >= n_users) continue;
    const long long base = ((long long)split * n_users + u0 + u) * k;
    for (int j = lane; j < k; j += 32) {
      part_s[base + j] = l_s[u * k + j];
      part_i[base + j] = l_i[u * k + j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i,
                  float* __restrict__ out_s, int* __restrict__ out_i, int n_users, int k,
                  int splits) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= n_users) return;  // whole warp leaves together
  float* ls = smem + warp * k;
  int* li = reinterpret_cast<int*>(smem + kWarps * k) + warp * k;
  for (int j = lane; j < k; j += 32) {
    ls[j] = -CUDART_INF_F;
    li[j] = -1;
  }
  __syncwarp();
  const long long n = (long long)splits * k;
  for (long long base = 0; base < n; base += 32) {
    const long long f = base + lane;
    const bool live = f < n;
    float cs = -CUDART_INF_F;
    int ci = -1;
    if (live) {
      const long long sp = f / k, j = f - sp * k;
      const long long at = (sp * n_users + b) * k + j;
      cs = part_s[at];
      ci = part_i[at];
    }
    warp_offer(ls, li, k, cs, ci, live, lane);
  }
  for (int j = lane; j < k; j += 32) {
    out_s[(long long)b * k + j] = ls[j];
    out_i[(long long)b * k + j] = li[j];
  }
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Shared memory bytes of topk_partial_kernel for width d and k.
extern "C" long long fused_topk_score_smem(int d, int k) {
  return (long long)sizeof(float) *
         ((long long)kItemTile * (d | 1) + (long long)kUserTile * d +
          kUserTile * kItemTile + 2LL * kUserTile * k);
}

// ue f32[n_users, d]; table f32[n_rows, d]; seen i32[n_users, seen_len];
// seen_mask u8[n_users, seen_len]; out_s f32[n_users, k]; out_i i32[n_users, k].
// Scratch: bits u32[n_users, ceil(n_items / 32)]; part_s/part_i [splits, n_users, k]
// (may alias out_s/out_i when splits == 1).
extern "C" int fused_topk_score_f32(const void* ue, const void* table, const void* seen,
                                    const void* seen_mask, void* out_s, void* out_i,
                                    void* part_s, void* part_i, void* bits, int n_users,
                                    int d, long long n_rows, int n_items, int seen_len,
                                    int k, int tiles_per_split, int splits, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int words = (n_items + 31) / 32;
  seen_bits_kernel<<<n_users, kThreads, 0, st>>>(
      static_cast<const int*>(seen), static_cast<const unsigned char*>(seen_mask),
      static_cast<unsigned*>(bits), seen_len, n_items, words);
  const long long smem = fused_topk_score_smem(d, k);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(topk_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n_users + kUserTile - 1) / kUserTile, splits);
  topk_partial_kernel<<<grid, kThreads, (size_t)smem, st>>>(
      static_cast<const float*>(ue), static_cast<const float*>(table),
      static_cast<const unsigned*>(bits), static_cast<float*>(part_s),
      static_cast<int*>(part_i), n_users, d, n_rows, n_items, words, k, tiles_per_split);
  if (splits > 1) {
    const size_t merge_smem = sizeof(float) * 2 * kWarps * (size_t)k;
    topk_merge_kernel<<<(n_users + kWarps - 1) / kWarps, kThreads, merge_smem, st>>>(
        static_cast<const float*>(part_s), static_cast<const int*>(part_i),
        static_cast<float*>(out_s), static_cast<int*>(out_i), n_users, k, splits);
  }
  return (int)cudaGetLastError();
}
