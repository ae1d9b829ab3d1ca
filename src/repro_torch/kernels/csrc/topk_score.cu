// Fused score + seen-mask + top-K for Hopper (sm_90a).
//
// For each user b: scores = ue[b] . table[i] for i < n_items; a score equal to
// zero becomes +0.0; ids >= n_items and live seen ids become -inf; the result
// is the first K of all (score, id) pairs plus K (-inf, -1) seed slots in the
// order (score desc, id asc), scores in IEEE total order (order_key). The
// seeds sort before any (-inf, id >= 0) and any -NaN, so short slots are
// (-inf, -1) exactly as in the TPU kernel. Any K is taken.
//
// Replaces src/repro/kernels/topk_score.py:fused_topk_score_pallas (_kernel).
//
// Bound: operations. 2*B*I*D fp32 FLOPs per call against the card's fp32
// CUDA-core peak (dots are fp32 FMA, never TF32, so the tie order stays the
// plain version's on integer inputs); the table (I*D*4 bytes) is read from
// L2 by every user tile.
//
// Design, three kernels on one stream:
//   1. seen_bits: one block per user turns its padded seen list into a bit
//      row over the catalogue (global scratch), so masking is O(1) per score.
//   2. topk_partial: grid (user tiles of 64, item splits). A block computes
//      64 users x 128 items per item tile as a register-blocked fp32 product:
//      warp w owns users 8w..8w+7, lane l owns items l, l+32, l+64, l+96, so
//      each thread holds 8 x 4 scores. D is walked 32 columns per pipeline
//      step; each step's user and item rows are copied into shared memory
//      with cp.async (16-byte copies when D % 4 == 0 and the rows are
//      aligned, else 4-byte ones, zero-filled past D and past the
//      catalogue) into a ring of kStages buffers, so the next steps' copies
//      run under this step's FMAs. Rows lie in shared memory with a stride of
//      36 floats: a thread reads 4 consecutive columns of a row as one float4,
//      the user rows as broadcasts and the 32 lanes' item rows without bank
//      conflicts, so 12 16-byte shared loads feed 128 FMAs.
//      After a tile's last step each warp merges its own 8 users, so the
//      merge needs no block barrier: a user's current K-th entry is its
//      threshold, read once per tile; only the scores better() than it
//      under the explicit (score desc, id asc) comparison are offered (ties
//      at the threshold with a lower id get in), and the threshold only
//      rises, so the filter drops nothing that belongs in the result. The
//      per-user lists live in shared memory while 64 of them fit beside the
//      ring, else in the global scratch part_s/part_i, each block owning its
//      rows there. For K <= 32 a user's list is loaded one entry per lane
//      while its tile is merged: a group of 32 candidates with many
//      survivors goes in by a warp bitonic sort and merge, a few go in one
//      at a time (a ballot gives the rank, a shuffle the shift). Past 32,
//      the list stays in memory and is shifted in place through its own
//      memory, 32 entries at a time from its last real entry: a group with
//      many survivors is sorted in the warp and goes in at once (each
//      survivor's rank by a binary search, each entry's move by a count of
//      the survivors ahead of it), a few go in one at a time.
//   3. topk_merge: one warp per user merges the splits' sorted lists, by a
//      bitonic merge per split for K <= 32, else by offering each list in
//      order, 32 entries at a time, and leaving it at its first entry that
//      fails the threshold.
// The top-K of a union is the top-K of the per-split top-Ks, so the result
// depends on neither the tile nor the split count.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "launch.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUserTile = 64;
constexpr int kItemTile = 128;
constexpr int kUsersPerWarp = kUserTile / kWarps;  // 8
constexpr int kItemsPerLane = kItemTile / 32;      // 4
constexpr int kDepth = 32;                         // columns of D per step
constexpr int kStride = kDepth + 4;                // shared row stride, floats
constexpr int kStages = 3;
constexpr int kStageFloats = (kUserTile + kItemTile) * kStride;
constexpr long long kRingBytes = sizeof(float) * (long long)kStages * kStageFloats;
constexpr long long kSmemLimit = 232448;  // bytes of shared memory a block may use
constexpr long long kMergeSmemLimit = 48 * 1024;
constexpr long long kFillBytes = sizeof(int) * kUserTile;  // the static s_fill
static_assert(kUsersPerWarp * kItemsPerLane == 32, "one seen-bit word per lane");
// a group of 32 candidates with more than kSortAt survivors goes into a list
// by one sort and merge, fewer one at a time
constexpr int kSortAt = 6;
constexpr int kWorstId = 0x7fffffff;  // the id of the worst possible entry

// IEEE total order as an int32 compare (the order lax.top_k sorts by): +NaN
// above +inf, -NaN below -inf and so below the (-inf, -1) seeds, so a -NaN
// never enters a list; NaNs among themselves by payload.
__device__ __forceinline__ int order_key(float s) {
  const int b = __float_as_int(s);
  return b ^ ((b >> 31) & 0x7fffffff);
}

// Every comparison of two scores in this file goes through better().
__device__ __forceinline__ bool better(float s1, int i1, float s2, int i2) {
  const int k1 = order_key(s1), k2 = order_key(s2);
  return k1 > k2 || (k1 == k2 && i1 < i2);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* src, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* src, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Warp-cooperative: insert (s, id), which the caller found better() than the
// list's last entry (ts, ti), into the list (ls, li) of length k, sorted best
// first; `fill` counts its entries that are not (-inf, -1) seeds. Returns
// the new last entry in (ts, ti). All 32 lanes call with the same (s, id).
// One pass from the last entry that can move (the first seed, or the tail),
// 32 positions at a time, shifts the list in place through its own memory:
// position j takes list[j - 1] while that entry is not ahead of (s, id), and
// (s, id) lands on the first position whose predecessor is ahead of it. The
// seeds past the fill are all equal, so moving them changes nothing. The
// pass stops at the chunk holding the new entry, so one that lands near the
// tail, as most do once the list has filled, costs one chunk whatever k is;
// no register holds more than one entry.
__device__ __noinline__ void warp_insert(float* ls, int* li, int k, int fill, float s, int id,
                                         float& ts, int& ti, int lane) {
  bool above_ahead = false;  // is the entry before position top + 1 ahead?
  for (int top = min(fill, k - 1); top >= 0; top -= 32) {
    const int j = top - lane;
    float us = 0.f;
    int ui = 0;
    bool ahead = true;  // list[j - 1] is ahead of (s, id); true before the head
    if (j >= 1) {
      us = ls[j - 1];
      ui = li[j - 1];
      ahead = better(us, ui, s, id);
    }
    // the same flag for position j + 1: lane - 1's, or the chunk above's
    const bool up = __shfl_up_sync(kFull, ahead, 1);
    const bool next_ahead = lane == 0 ? above_ahead : up;
    __syncwarp();
    if (j >= 0) {
      if (!ahead) {
        ls[j] = us;
        li[j] = ui;
      } else if (!next_ahead) {
        ls[j] = s;
        li[j] = id;
      }
    }
    if (top == k - 1) {  // the new last entry is lane 0's
      ts = __shfl_sync(kFull, ahead ? s : us, 0);
      ti = __shfl_sync(kFull, ahead ? id : ui, 0);
    }
    __syncwarp();
    above_ahead = __shfl_sync(kFull, ahead, 31);
    if (__ballot_sync(kFull, j >= 0 && !ahead) != __ballot_sync(kFull, j >= 0)) break;
  }
}

// One compare-exchange step of a bitonic network across the warp: this lane
// keeps the better of its entry and lane ^ stride's when `keep_better`.
__device__ __forceinline__ void exchange(float& s, int& i, int stride, bool keep_better) {
  const float os = __shfl_xor_sync(kFull, s, stride);
  const int oi = __shfl_xor_sync(kFull, i, stride);
  if (keep_better == better(os, oi, s, i)) {
    s = os;
    i = oi;
  }
}

// Sorts one entry per lane best first across the warp (bitonic, 15 steps).
__device__ __forceinline__ void warp_sort(float& s, int& i, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      exchange(s, i, stride, ((lane & stride) == 0) == ((lane & size) == 0));
}

// Sorts a bitonic sequence of one entry per lane best first (5 steps).
__device__ __forceinline__ void warp_bitonic_merge(float& s, int& i, int lane) {
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) exchange(s, i, stride, (lane & stride) == 0);
}

// Warp-cooperative: insert the c candidates of lanes 0..c-1 (cs, ci), sorted
// best first and each better() than the list's last entry, into the list
// (ls, li) of length k whose first `fill` entries are not seeds, at once.
// Each candidate's rank r among the list is a binary search; list entry i
// moves down by the number of candidates ahead of it (the lanes whose
// r <= i, found by a binary search over the lanes' r, which rise with the
// lane), 32 entries at a time from the last one that moves, so every entry
// is read before its position is written; then each candidate lands at its
// lane + r. Positions past k drop out.
__device__ __noinline__ void warp_insert_sorted(float* ls, int* li, int k, int fill, float cs,
                                                int ci, int c, int lane) {
  int r = kWorstId;
  if (lane < c) {
    int lo = 0, hi = fill;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (better(ls[mid], li[mid], cs, ci))
        lo = mid + 1;
      else
        hi = mid;
    }
    r = lo;
  }
  const int r0 = __shfl_sync(kFull, r, 0);
  for (int base = fill - 1; base >= r0; base -= 32) {
    const int i = base - lane;
    int ahead = 0;  // candidates ahead of entry i
#pragma unroll
    for (int b = 16; b > 0; b >>= 1) {
      const int rq = __shfl_sync(kFull, r, ahead + b - 1);
      if (rq <= i) ahead += b;
    }
    const int rq = __shfl_sync(kFull, r, ahead);
    if (rq <= i) ++ahead;
    const bool move = i >= r0;
    float es = 0.f;
    int ei = 0;
    if (move) {
      es = ls[i];
      ei = li[i];
    }
    __syncwarp();
    if (move && i + ahead < k) {
      ls[i + ahead] = es;
      li[i + ahead] = ei;
    }
    __syncwarp();
  }
  if (lane < c && lane + r < k) {
    ls[lane + r] = cs;
    li[lane + r] = ci;
  }
  __syncwarp();
}

// Offers one candidate per lane (cs, ci) to the list (ls, li) whose last
// entry is (ts, ti) and whose fill is `fill`, both updated as entries go in.
// More than kSortAt survivors go in at once (sorted first unless `sorted`
// says lanes 0..c-1 already hold them best first), fewer one at a time.
// Returns the ballot of the lanes whose candidate beat the threshold it
// started from.
__device__ __forceinline__ unsigned warp_offer(float* ls, int* li, int k, float cs, int ci,
                                               bool live, bool sorted, float& ts, int& ti,
                                               int& fill, int lane) {
  const bool pass = live && better(cs, ci, ts, ti);
  const unsigned offered = __ballot_sync(kFull, pass);
  const int c = __popc(offered);
  if (c > kSortAt) {
    float s = pass ? cs : -CUDART_INF_F;
    int i = pass ? ci : kWorstId;
    if (!sorted) warp_sort(s, i, lane);
    warp_insert_sorted(ls, li, k, fill, s, i, c, lane);
    fill = min(fill + c, k);
    ts = ls[k - 1];
    ti = li[k - 1];
    return offered;
  }
  unsigned pending = offered;
  while (pending) {
    const int from = __ffs(pending) - 1;
    pending &= pending - 1;
    const float s = __shfl_sync(kFull, cs, from);
    const int id = __shfl_sync(kFull, ci, from);
    if (better(s, id, ts, ti)) {  // warp-uniform
      warp_insert(ls, li, k, fill, s, id, ts, ti, lane);
      fill = min(fill + 1, k);
    }
  }
  return offered;
}

// The first 32 of the union of the window (ws, wi), sorted best first, and
// the candidates (cs, ci), one per lane in any order: the candidates are
// sorted, reversed against the window, the better of each pair kept (a
// bitonic sequence holding the first 32), and that sequence merged.
__device__ __forceinline__ void window_merge(float& ws, int& wi, float cs, int ci, int lane) {
  warp_sort(cs, ci, lane);
  const float rs = __shfl_sync(kFull, cs, 31 - lane);
  const int ri = __shfl_sync(kFull, ci, 31 - lane);
  if (better(rs, ri, ws, wi)) {
    ws = rs;
    wi = ri;
  }
  warp_bitonic_merge(ws, wi, lane);
}

// A tile's scores of one user, kItemsPerLane per lane, offered to the user's
// list (ls, li) of length k <= 32, held one entry per lane in registers (the
// window) while the tile is merged: a group of 32 candidates with more than
// kSortAt beating the threshold goes in by one warp sort and merge, fewer go
// in one at a time by a ballot for the rank and a shuffle for the shift.
// Lanes >= k hold the worst possible entry (-inf, INT_MAX) and are not
// stored.
__device__ __noinline__ void offer_window(float* ls, int* li, int k, float4 sc, int4 ids,
                                          int lane) {
  const float cand_s[kItemsPerLane] = {sc.x, sc.y, sc.z, sc.w};
  const int cand_i[kItemsPerLane] = {ids.x, ids.y, ids.z, ids.w};
  float ws = lane < k ? ls[lane] : -CUDART_INF_F;
  int wi = lane < k ? li[lane] : kWorstId;
  float ts = __shfl_sync(kFull, ws, k - 1);
  int ti = __shfl_sync(kFull, wi, k - 1);
#pragma unroll
  for (int j = 0; j < kItemsPerLane; ++j) {
    const bool pass = better(cand_s[j], cand_i[j], ts, ti);
    unsigned pending = __ballot_sync(kFull, pass);
    if (__popc(pending) > kSortAt) {
      window_merge(ws, wi, pass ? cand_s[j] : -CUDART_INF_F, pass ? cand_i[j] : kWorstId, lane);
      if (lane >= k) {
        ws = -CUDART_INF_F;
        wi = kWorstId;
      }
      ts = __shfl_sync(kFull, ws, k - 1);
      ti = __shfl_sync(kFull, wi, k - 1);
    } else {
      while (pending) {
        const int from = __ffs(pending) - 1;
        pending &= pending - 1;
        const float s = __shfl_sync(kFull, cand_s[j], from);
        const int id = __shfl_sync(kFull, cand_i[j], from);
        if (!better(s, id, ts, ti)) continue;  // warp-uniform
        const int rank = __popc(__ballot_sync(kFull, lane < k && better(ws, wi, s, id)));
        const float us = __shfl_up_sync(kFull, ws, 1);
        const int ui = __shfl_up_sync(kFull, wi, 1);
        if (lane < k && lane > rank) {
          ws = us;
          wi = ui;
        } else if (lane == rank) {
          ws = s;
          wi = id;
        }
        ts = __shfl_sync(kFull, ws, k - 1);
        ti = __shfl_sync(kFull, wi, k - 1);
      }
    }
  }
  if (lane < k) {
    ls[lane] = ws;
    li[lane] = wi;
  }
  __syncwarp();
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

// Copies step `step`'s user rows [u0, u0 + 64) and item rows of its tile,
// columns [c0, c0 + 32), into ring buffer step % kStages; rows past the
// users, past min(n_rows, n_items) and columns past d are zero-filled.
template <bool kVec4>
__device__ __forceinline__ void stage_copy(float* smem, const float* __restrict__ ue,
                                           const float* __restrict__ table, int step,
                                           int tile_lo, int n_depth, int u0, int n_users,
                                           long long item_limit, int d, int t) {
  const long long i0 = (long long)(tile_lo + step / n_depth) * kItemTile;
  const int c0 = (step % n_depth) * kDepth;
  float* su = smem + (step % kStages) * kStageFloats;
  float* si = su + kUserTile * kStride;
  if (kVec4) {
    constexpr int kPerRow = kDepth / 4;
#pragma unroll
    for (int f0 = 0; f0 < kUserTile * kPerRow; f0 += kThreads) {
      const int f = f0 + t, r = f / kPerRow, q = (f % kPerRow) * 4;
      const bool ok = u0 + r < n_users && c0 + q < d;
      cp_async16(su + r * kStride + q, ok ? ue + (long long)(u0 + r) * d + c0 + q : ue, ok);
    }
#pragma unroll
    for (int f0 = 0; f0 < kItemTile * kPerRow; f0 += kThreads) {
      const int f = f0 + t, r = f / kPerRow, q = (f % kPerRow) * 4;
      const bool ok = i0 + r < item_limit && c0 + q < d;
      cp_async16(si + r * kStride + q, ok ? table + (i0 + r) * d + c0 + q : table, ok);
    }
  } else {
#pragma unroll
    for (int f0 = 0; f0 < kUserTile * kDepth; f0 += kThreads) {
      const int f = f0 + t, r = f / kDepth, q = f % kDepth;
      const bool ok = u0 + r < n_users && c0 + q < d;
      cp_async4(su + r * kStride + q, ok ? ue + (long long)(u0 + r) * d + c0 + q : ue, ok);
    }
#pragma unroll
    for (int f0 = 0; f0 < kItemTile * kDepth; f0 += kThreads) {
      const int f = f0 + t, r = f / kDepth, q = f % kDepth;
      const bool ok = i0 + r < item_limit && c0 + q < d;
      cp_async4(si + r * kStride + q, ok ? table + (i0 + r) * d + c0 + q : table, ok);
    }
  }
}

// 4 columns [c, c + 4) of the 8 x 4 register block: each score adds its
// products in column order, one fp32 FMA each.
__device__ __forceinline__ void fma_columns(float (&acc)[kUsersPerWarp][kItemsPerLane],
                                            const float* su, const float* si, int c) {
  float4 x[kItemsPerLane];
#pragma unroll
  for (int j = 0; j < kItemsPerLane; ++j)
    x[j] = *reinterpret_cast<const float4*>(si + j * 32 * kStride + c);
#pragma unroll
  for (int m = 0; m < kUsersPerWarp; ++m) {
    const float4 u = *reinterpret_cast<const float4*>(su + m * kStride + c);
#pragma unroll
    for (int j = 0; j < kItemsPerLane; ++j) {
      float a = acc[m][j];
      a = fmaf(u.x, x[j].x, a);
      a = fmaf(u.y, x[j].y, a);
      a = fmaf(u.z, x[j].z, a);
      a = fmaf(u.w, x[j].w, a);
      acc[m][j] = a;
    }
  }
}

// kWindow: k <= 32, the lists merged one entry per lane (offer_window);
// else in memory, in shared memory with kSmemLists, else in part_s/part_i.
template <bool kVec4, bool kSmemLists, bool kWindow>
__global__ void __launch_bounds__(kThreads, 2)
topk_partial_kernel(const float* __restrict__ ue, const float* __restrict__ table,
                    const unsigned* __restrict__ bits, float* __restrict__ part_s,
                    int* __restrict__ part_i, int n_users, int d, long long n_rows,
                    int n_items, int words, int k, int tiles_per_split) {
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int u0 = blockIdx.x * kUserTile;
  const int split = blockIdx.y;
  const int n_tiles = (n_items + kItemTile - 1) / kItemTile;
  const int tile_lo = split * tiles_per_split;
  const int tile_hi = min(n_tiles, tile_lo + tiles_per_split);
  const int n_depth = (d + kDepth - 1) / kDepth;
  const int n_steps = max(0, tile_hi - tile_lo) * n_depth;
  const long long item_limit = min(n_rows, (long long)n_items);
  const int wu = u0 + warp * kUsersPerWarp;  // the warp's first user

  float* lists_s;
  int* lists_i;
  if (kSmemLists) {
    float* lists = smem + kStages * kStageFloats;
    lists_s = lists + (long long)warp * kUsersPerWarp * k;
    lists_i = reinterpret_cast<int*>(lists + (long long)kUserTile * k) +
              (long long)warp * kUsersPerWarp * k;
  } else {
    const long long at = ((long long)split * n_users + wu) * k;
    lists_s = part_s + at;
    lists_i = part_i + at;
  }
  __shared__ int s_fill[kUserTile];  // entries of each list that are not seeds
  int* fills = s_fill + warp * kUsersPerWarp;
  for (int m = 0; m < kUsersPerWarp; ++m) {
    if (wu + m >= n_users) break;
    for (int j = lane; j < k; j += 32) {
      lists_s[(long long)m * k + j] = -CUDART_INF_F;
      lists_i[(long long)m * k + j] = -1;
    }
    if (lane == 0) fills[m] = 0;
  }
  __syncwarp();

  float acc[kUsersPerWarp][kItemsPerLane];
#pragma unroll
  for (int m = 0; m < kUsersPerWarp; ++m)
#pragma unroll
    for (int j = 0; j < kItemsPerLane; ++j) acc[m][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps)
      stage_copy<kVec4>(smem, ue, table, s, tile_lo, n_depth, u0, n_users, item_limit, d, t);
    cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this step's rows have landed; the step before is done
    if (step + kStages - 1 < n_steps)
      stage_copy<kVec4>(smem, ue, table, step + kStages - 1, tile_lo, n_depth, u0, n_users,
                        item_limit, d, t);
    cp_async_commit();
    const float* stage = smem + (step % kStages) * kStageFloats;
    const float* su = stage + warp * kUsersPerWarp * kStride;
    const float* si = stage + kUserTile * kStride + lane * kStride;
    const int depth = step % n_depth;
    const int cols = min(kDepth, d - depth * kDepth);
    const int i0 = (tile_lo + step / n_depth) * kItemTile;
    unsigned seen_word = 0u;  // lane 4m + j: user wu + m's bits of items i0 + 32j ..
    if (depth == n_depth - 1) {  // loaded under this step's FMAs
      const int u = wu + lane / kItemsPerLane, w = i0 / 32 + lane % kItemsPerLane;
      if (u < n_users && w < words) seen_word = bits[(long long)u * words + w];
    }
    if (cols == kDepth) {
#pragma unroll
      for (int c = 0; c < kDepth; c += 4) fma_columns(acc, su, si, c);
    } else {
      for (int c = 0; c < cols; c += 4) fma_columns(acc, su, si, c);
    }
    if (depth != n_depth - 1) continue;

    // the tile's scores are complete: each warp merges its own users
#pragma unroll
    for (int m = 0; m < kUsersPerWarp; ++m) {
      const int u = wu + m;
      if (u < n_users) {  // warp-uniform
        float* ls = lists_s + (long long)m * k;
        int* li = lists_i + (long long)m * k;
        float sc[kItemsPerLane];
        int ids[kItemsPerLane];
        float ts = ls[k - 1];  // the threshold, read once per tile
        int ti = li[k - 1];
        bool pass = false;
#pragma unroll
        for (int j = 0; j < kItemsPerLane; ++j) {
          ids[j] = i0 + 32 * j + lane;
          const unsigned word = __shfl_sync(kFull, seen_word, m * kItemsPerLane + j);
          sc[j] = acc[m][j] == 0.f ? 0.f : acc[m][j];
          if (ids[j] >= n_items || ((word >> lane) & 1u)) sc[j] = -CUDART_INF_F;
          pass |= better(sc[j], ids[j], ts, ti);
        }
        if (__any_sync(kFull, pass)) {
          if (kWindow) {
            offer_window(ls, li, k, make_float4(sc[0], sc[1], sc[2], sc[3]),
                         make_int4(ids[0], ids[1], ids[2], ids[3]), lane);
          } else {
            int fill = fills[m];
#pragma unroll
            for (int j = 0; j < kItemsPerLane; ++j)
              warp_offer(ls, li, k, sc[j], ids[j], true, false, ts, ti, fill, lane);
            __syncwarp();
            if (lane == 0) fills[m] = fill;
            __syncwarp();
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kItemsPerLane; ++j) acc[m][j] = 0.f;
    }
  }
  if (kSmemLists) {
    for (int m = 0; m < kUsersPerWarp; ++m) {
      if (wu + m >= n_users) break;
      const long long base = ((long long)split * n_users + wu + m) * k;
      for (int j = lane; j < k; j += 32) {
        part_s[base + j] = lists_s[(long long)m * k + j];
        part_i[base + j] = lists_i[(long long)m * k + j];
      }
    }
  }
}

// One warp per user merges the splits' lists, each sorted best first. For
// k <= 32 the user's list is a window of one entry per lane and each split's
// list goes in by one bitonic merge; past that the list lives in shared
// memory (or, past kMergeSmemLimit, in the output itself) and each split's
// list is offered in order, left at its first entry that fails the
// threshold.
template <bool kSmemLists>
__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i,
                  float* __restrict__ out_s, int* __restrict__ out_i, int n_users, int k,
                  int splits) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= n_users) return;  // whole warp leaves together
  const long long stride = (long long)n_users * k;  // one split's lists
  const long long own = (long long)b * k;
  if (k <= 32) {
    float ws = lane < k ? part_s[own + lane] : -CUDART_INF_F;
    int wi = lane < k ? part_i[own + lane] : kWorstId;
    float ns = -CUDART_INF_F;  // the next split's list, loaded while this
    int ni = kWorstId;         // one is merged
    if (splits > 1 && lane < k) {
      ns = part_s[stride + own + lane];
      ni = part_i[stride + own + lane];
    }
    for (int sp = 1; sp < splits; ++sp) {
      const float cs = ns;
      const int ci = ni;
      if (sp + 1 < splits && lane < k) {
        ns = part_s[(sp + 1) * stride + own + lane];
        ni = part_i[(sp + 1) * stride + own + lane];
      }
      // the split's best against the window's last: nothing to do if it loses
      if (!better(__shfl_sync(kFull, cs, 0), __shfl_sync(kFull, ci, 0),
                  __shfl_sync(kFull, ws, k - 1), __shfl_sync(kFull, wi, k - 1)))
        continue;
      const float rs = __shfl_sync(kFull, cs, 31 - lane);
      const int ri = __shfl_sync(kFull, ci, 31 - lane);
      if (better(rs, ri, ws, wi)) {
        ws = rs;
        wi = ri;
      }
      warp_bitonic_merge(ws, wi, lane);
      if (lane >= k) {
        ws = -CUDART_INF_F;
        wi = kWorstId;
      }
    }
    if (lane < k) {
      out_s[own + lane] = ws;
      out_i[own + lane] = wi;
    }
    return;
  }
  float* ls;
  int* li;
  if (kSmemLists) {
    ls = smem + (long long)warp * k;
    li = reinterpret_cast<int*>(smem + (long long)kWarps * k) + (long long)warp * k;
  } else {
    ls = out_s + own;
    li = out_i + own;
  }
  int fill = 0;
  for (int base = 0; base < k; base += 32) {  // the first split's list as it is
    const int j = base + lane;
    int id = -1;
    if (j < k) {
      id = part_i[own + j];
      ls[j] = part_s[own + j];
      li[j] = id;
    }
    fill += __popc(__ballot_sync(kFull, id >= 0));
  }
  __syncwarp();
  float ts = ls[k - 1];
  int ti = li[k - 1];
  float next_s = -CUDART_INF_F;  // the next split's first 32 entries, loaded
  int next_i = -1;               // while this split is offered
  if (splits > 1) {
    next_s = part_s[stride + own + lane];
    next_i = part_i[stride + own + lane];
  }
  for (int sp = 1; sp < splits; ++sp) {
    const long long at = sp * stride + own;
    float cs = next_s;
    int ci = next_i;
    if (sp + 1 < splits) {
      next_s = part_s[at + stride + lane];
      next_i = part_i[at + stride + lane];
    }
    for (int base = 0; base < k; base += 32) {
      const int j = base + lane;
      const bool live = j < k;
      if (base > 0) {
        cs = live ? part_s[at + j] : -CUDART_INF_F;
        ci = live ? part_i[at + j] : -1;
      }
      const unsigned offered = warp_offer(ls, li, k, cs, ci, live, true, ts, ti, fill, lane);
      // each list is sorted best first and the threshold only rises: past
      // the first entry that did not beat it, nothing of this list will
      if (offered != __ballot_sync(kFull, live)) break;
    }
  }
  if (kSmemLists) {
    for (int j = lane; j < k; j += 32) {
      out_s[own + j] = ls[j];
      out_i[own + j] = li[j];
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, long long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct PartialArgs {
  dim3 grid;
  long long smem;
  cudaStream_t st;
  const float* ue;
  const float* table;
  const unsigned* bits;
  float* part_s;
  int* part_i;
  int n_users, d;
  long long n_rows;
  int n_items, words, k, tiles_per_split;
};

template <bool kVec4, bool kSmemLists, bool kWindow>
cudaError_t launch_partial(const PartialArgs& a) {
  auto kernel = topk_partial_kernel<kVec4, kSmemLists, kWindow>;
  const cudaError_t err = allow_smem(kernel, a.smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.grid, kThreads, (size_t)a.smem, a.st>>>(a.ue, a.table, a.bits, a.part_s, a.part_i,
                                                     a.n_users, a.d, a.n_rows, a.n_items,
                                                     a.words, a.k, a.tiles_per_split);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// ue f32[n_users, d]; table f32[n_rows, d]; seen i32[n_users, seen_len];
// seen_mask u8[n_users, seen_len]; out_s f32[n_users, k]; out_i i32[n_users, k].
// Scratch: bits u32[n_users, ceil(n_items / 32)]; part_s/part_i [splits, n_users, k]
// (may alias out_s/out_i when splits == 1). vec4 != 0 promises d % 4 == 0
// and 16-byte aligned ue and table. k >= 1.
extern "C" int fused_topk_score_f32(const void* ue, const void* table, const void* seen,
                                    const void* seen_mask, void* out_s, void* out_i,
                                    void* part_s, void* part_i, void* bits, int n_users,
                                    int d, long long n_rows, int n_items, int seen_len,
                                    int k, int tiles_per_split, int splits, int vec4,
                                    int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int words = (n_items + 31) / 32;
  seen_bits_kernel<<<n_users, kThreads, 0, st>>>(
      static_cast<const int*>(seen), static_cast<const unsigned char*>(seen_mask),
      static_cast<unsigned*>(bits), seen_len, n_items, words);
  const long long list_bytes = 2LL * sizeof(float) * kUserTile * k;
  const bool smem_lists = kRingBytes + list_bytes + kFillBytes <= kSmemLimit;
  const long long smem = kRingBytes + (smem_lists ? list_bytes : 0);
  const dim3 grid((n_users + kUserTile - 1) / kUserTile, splits);
  const float* uf = static_cast<const float*>(ue);
  const float* tf = static_cast<const float*>(table);
  const unsigned* bf = static_cast<const unsigned*>(bits);
  float* ps = static_cast<float*>(part_s);
  int* pi = static_cast<int*>(part_i);
  const PartialArgs args{grid, smem, st, uf, tf, bf, ps, pi, n_users, d, n_rows,
                         n_items, words, k, tiles_per_split};
  const bool window = k <= 32;  // implies smem_lists
  if (vec4)
    err = window ? launch_partial<true, true, true>(args)
          : smem_lists ? launch_partial<true, true, false>(args)
                       : launch_partial<true, false, false>(args);
  else
    err = window ? launch_partial<false, true, true>(args)
          : smem_lists ? launch_partial<false, true, false>(args)
                       : launch_partial<false, false, false>(args);
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    const long long merge_bytes = 2LL * sizeof(float) * kWarps * k;
    const dim3 blocks((n_users + kWarps - 1) / kWarps);
    float* os = static_cast<float*>(out_s);
    int* oi = static_cast<int*>(out_i);
    if (merge_bytes <= kMergeSmemLimit)
      topk_merge_kernel<true><<<blocks, kThreads, (size_t)merge_bytes, st>>>(
          ps, pi, os, oi, n_users, k, splits);
    else
      topk_merge_kernel<false><<<blocks, kThreads, 0, st>>>(ps, pi, os, oi, n_users, k,
                                                            splits);
  }
  return (int)cudaGetLastError();
}
