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
// tables and indices. What keeps a kernel from that bound is the gathered
// rows: the COO graph's edges lie in random order, and the user table (179
// MB at the smoke's shape) does not fit in the 50 MB L2, so an edge-order
// walk fetches nearly every edge's user row from device memory again, as
// many bytes again as the output.
//
// Design: the edges are walked in an order grouped by one endpoint, the
// "key" (for NGCF the user), given once per graph as perm (edge ids stably
// sorted by key) with the key, the other endpoint and the mask in that
// order (kernels/sddmm.py:group_edges). One warp takes kChunk consecutive
// sorted positions; lanes load 32 positions' (perm, key, other, mask) at a
// time, coalesced, and the warp walks them kUnroll edges at a time. The
// key's row (the "grouped" table g: x when the groups key src, y when they
// key dst) is loaded into registers only when the key changes from the
// previous live edge: the test is warp-uniform, so it costs no divergence,
// and each user row leaves device memory about once per chunk. The other
// row (table o, 27 MB of items here, served from L2) is gathered per edge
// through the read-only path (__ldg), kUnroll rows in flight. A long group
// spans several chunks and each loads its row once; every edge's output is
// its own, so no combine pass and no atomics. Edge perm[j]'s output row is
// stored whole at out[perm[j]] with streaming hints (__stcs, st.global.cs),
// the TPU kernel's nt-write intent (paper section 6), so the output does not
// evict the item rows from L2. Without groups (perm null) the same kernel
// walks the edges in their own order, keyed by src: the previous design's
// access pattern, with no sort.
//
// Lanes cover the row's D floats, 16 bytes each when D % 4 == 0 (else 4
// bytes); the grouped row's first 32 lane columns are held in registers
// (the whole row when D <= 128 on 16-byte lanes, as in NGCF), and wider
// rows load the rest per live edge. 'dot' sums each lane's products in column
// order and reduces across the warp with __shfl_xor_sync; lane j keeps
// position j's sum. Each product and sum is rounded on its own (__fmul_rn,
// __fadd_rn: no FMA contraction), and products and sums of two terms
// commute exactly, so every op equals the edge-order design bit for bit,
// and 'mul', 'add' and 'copy' equal the plain version bit for bit. Every
// element offset is computed in 64 bits: E * D passes 2^31 at the main
// shape's scale.
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Tuned on the H100 at D = 128 over chunk, unroll and minimum blocks:
// unroll 2 at 4 blocks (<= 64 registers) took 'mul' 3.553 ms and 'dot'
// 1.668; unroll 4 at 1 block (90 registers) 3.554 and 2.069; unroll 4 at
// 3-4 blocks and unroll 8 3.73-4.42 ms (spills, or one block per SM);
// chunks of 128-1,024 within 1 %.
constexpr int kUnroll = 2;  // edges in flight per warp
constexpr int kChunk = 256;  // sorted positions per warp
constexpr int kMinBlocks = 4;  // resident blocks per SM asked of ptxas
static_assert(kChunk % 32 == 0, "a chunk is whole batches of 32 positions");

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

// Lane column c of kUnroll edges: a holds the grouped rows, b the other
// rows; 'dot' adds to part, the other ops store their output rows.
template <typename T, int OP>
__device__ __forceinline__ void finish(const T (&a)[kUnroll], const T (&b)[kUnroll],
                                       const bool (&lv)[kUnroll], const float (&cf)[kUnroll],
                                       const int (&re)[kUnroll], float (&part)[kUnroll],
                                       bool scaled, int left, bool active, T* outs,
                                       int width, int c) {
#pragma unroll
  for (int q = 0; q < kUnroll; ++q) {
    if (!active || q >= left) continue;
    if (OP == kDot) {
      if (lv[q]) part[q] = __fadd_rn(part[q], dot_part(a[q], b[q]));
    } else {
      T v = zero<T>();
      if (lv[q]) {
        if (OP == kMul) v = mul(a[q], b[q]);
        else if (OP == kAdd) v = add(a[q], b[q]);
        else v = scaled ? scale(a[q], cf[q]) : a[q];
      }
      st(outs + (long long)re[q] * width + c, v);
    }
  }
}

// T = float4 (D % 4 == 0, 16-byte aligned rows) or float (any D). g is the
// grouped table (indexed by key), o the other one (indexed by other); perm
// null walks the edges in their own order.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sddmm_kernel(const float* __restrict__ g, const float* __restrict__ o,
             const int* __restrict__ perm, const int* __restrict__ key,
             const int* __restrict__ other, const unsigned char* __restrict__ live,
             const float* __restrict__ coeff, float* __restrict__ out,
             long long n_edges, int d) {
  const long long begin = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kChunk;
  if (begin >= n_edges) return;  // whole warp leaves together
  const long long end = min(begin + (long long)kChunk, n_edges);
  const int lane = threadIdx.x & 31;
  constexpr int kPer = sizeof(T) / sizeof(float);
  const int width = d / kPer;  // columns in units of T
  const int slabs = (width + 31) / 32;
  const T* gs = reinterpret_cast<const T*>(g);
  const T* os = reinterpret_cast<const T*>(o);
  T* outs = reinterpret_cast<T*>(out);

  T held = zero<T>();  // this lane's first column of the row of key `cur`
  int cur = -1;        // the key of the last live edge; -1 before the first

  for (long long base = begin; base < end; base += 32) {
    const int cnt = (int)min(32LL, end - base);
    int my_perm = 0, my_key = 0, my_other = 0, my_live = 0;
    float my_coeff = 1.f;
    if (lane < cnt) {
      const long long p = base + lane;
      my_perm = perm != nullptr ? perm[p] : (int)p;
      my_key = key[p];
      if (OP != kCopy) my_other = other[p];
      my_live = live[p] != 0;
      if (OP == kCopy && coeff != nullptr) my_coeff = coeff[my_perm];
    }
    float my_dot = 0.f;  // 'dot': the sum of position base + lane

    for (int j0 = 0; j0 < cnt; j0 += kUnroll) {
      int rk[kUnroll], ro[kUnroll], re[kUnroll];  // key, other, output rows
      bool lv[kUnroll], fresh[kUnroll];
      float cf[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int j = (j0 + q) & 31;
        const int k = __shfl_sync(kFull, my_key, j);
        rk[q] = k;
        ro[q] = __shfl_sync(kFull, my_other, j);
        re[q] = __shfl_sync(kFull, my_perm, j);
        lv[q] = __shfl_sync(kFull, my_live, j) != 0 && j0 + q < cnt;
        cf[q] = __shfl_sync(kFull, my_coeff, j);
        fresh[q] = lv[q] && k != cur;  // warp-uniform
        if (lv[q]) cur = k;
      }
      float part[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) part[q] = 0.f;
      const int left = cnt - j0;

      // the first lane column, held in registers: load the grouped row
      // only where the key changes, all loads issued before any is used
      {
        const bool active = lane < width;
        T a[kUnroll], b[kUnroll];
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          a[q] = zero<T>();
          b[q] = zero<T>();
          if (active && fresh[q]) a[q] = ld(gs + (long long)rk[q] * width + lane);
          if (OP != kCopy && active && lv[q]) b[q] = ld(os + (long long)ro[q] * width + lane);
        }
#pragma unroll
        for (int q = 0; q < kUnroll; ++q)
          if (!fresh[q]) a[q] = q == 0 ? held : a[q - 1];
        held = a[kUnroll - 1];
        finish<T, OP>(a, b, lv, cf, re, part, coeff != nullptr, left, active, outs, width,
                      lane);
      }
      // lane columns past the first (D > 32 * kPer): the grouped row per
      // live edge
      for (int s = 1; s < slabs; ++s) {
        const int c = s * 32 + lane;
        const bool active = c < width;
        T a[kUnroll], b[kUnroll];
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          a[q] = zero<T>();
          b[q] = zero<T>();
          if (active && lv[q]) {
            a[q] = ld(gs + (long long)rk[q] * width + c);
            if (OP != kCopy) b[q] = ld(os + (long long)ro[q] * width + c);
          }
        }
        finish<T, OP>(a, b, lv, cf, re, part, coeff != nullptr, left, active, outs, width,
                      c);
      }

      if (OP == kDot) {
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          float s = part[q];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
          if (lane == ((j0 + q) & 31)) my_dot = lv[q] ? s : 0.f;
        }
      }
    }
    if (OP == kDot && lane < cnt) st(out + my_perm, my_dot);
  }
}

template <typename T>
void launch(int op, const float* g, const float* o, const int* perm, const int* key,
            const int* other, const unsigned char* live, const float* coeff, float* out,
            long long n_edges, int d, cudaStream_t st) {
  const long long warps = (n_edges + kChunk - 1) / kChunk;
  const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
#define SDDMM_LAUNCH(OP)                                                                 \
  sddmm_kernel<T, OP><<<blocks, kThreads, 0, st>>>(g, o, perm, key, other, live, coeff, out, \
                                                   n_edges, d)
  switch (op) {
    case kMul: SDDMM_LAUNCH(kMul); break;
    case kAdd: SDDMM_LAUNCH(kAdd); break;
    case kDot: SDDMM_LAUNCH(kDot); break;
    default: SDDMM_LAUNCH(kCopy);
  }
#undef SDDMM_LAUNCH
}

}  // namespace

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// op: 0 mul, 1 add, 2 dot, 3 copy. g f32[Ng, d], the table the groups key
// (x when they key src, y when they key dst); o f32[No, d], the other table
// (unused by copy). perm i32[E] or null (identity): edge ids in walking
// order; key, other i32[E] and live u8[E]: each position's key, other
// endpoint and mask, in that order (other unused by copy); coeff f32[E] by
// edge id, or null (read by copy only); out f32[E, d], or f32[E] for dot,
// by edge id. copy needs the groups to key src. vec4 != 0 promises
// d % 4 == 0 and 16-byte aligned g, o and out.
extern "C" int sddmm_f32(int op, const void* g, const void* o, const void* perm,
                         const void* key, const void* other, const void* live,
                         const void* coeff, void* out, long long n_edges, int d, int vec4,
                         int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (op < kMul || op > kCopy) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* of = static_cast<const float*>(o);
  const int* p = static_cast<const int*>(perm);
  const int* k = static_cast<const int*>(key);
  const int* t = static_cast<const int*>(other);
  const unsigned char* m = static_cast<const unsigned char*>(live);
  const float* c = static_cast<const float*>(coeff);
  float* out_f = static_cast<float*>(out);
  if (vec4)
    launch<float4>(op, gf, of, p, k, t, m, c, out_f, n_edges, d, st);
  else
    launch<float>(op, gf, of, p, k, t, m, c, out_f, n_edges, d, st);
  return (int)cudaGetLastError();
}
