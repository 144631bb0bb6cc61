// Device helpers shared by the port's kernels (sm_90a).
//
// * the selection counts of topk_mask.cu (count_ge) and packed_topk.cu
//   (packed_hist): the rank of an element among 32 non-increasing,
//   NaN-free candidates by a branchless 6-compare search (Ranker), the
//   32-compare count for candidates that are not sorted (count_ge1), and
//   the last-CTA ticket that lets one launch finish a reduction across
//   CTAs (last_cta).  Counts are int32, added with atomics, so they are
//   exact and independent of the order in which CTAs run;
// * the value_dtype round trip of the compress (cast_value), shared by the
//   packed apply and the per-leaf apply (ssm_apply.cu);
// * float32 / bfloat16 element access: every per-leaf kernel is a template
//   on the element type, computes in float32 and rounds to nearest even on
//   store, and moves 16 bytes per thread and step where the pointers allow.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int kBins = 32;  // candidates per threshold count
constexpr int kRanks = kBins + 1;  // rank 32: below every candidate, or NaN

// cnt[j] += (a >= edges[j]) for the 32 candidates.
__device__ __forceinline__ void count_ge1(int (&cnt)[kBins],
                                          const float* s_edges, float a) {
#pragma unroll
  for (int j = 0; j < kBins; ++j) cnt[j] += (a >= s_edges[j]);
}

// The rank of a among non-increasing, NaN-free candidates e: the number of
// j with !(a >= e_j), i.e. the first j with a >= e_j, or 32 (a NaN a
// ranks 32).  Ties among candidates only need the predicate to be
// monotone, not strict.  A branchless binary search: the first level
// compares with e_15 held in a register, the next four with the
// candidates in shared memory (passed at each call, so that the compiler
// addresses them as shared memory, by index), the last with e_31.
struct Ranker {
  float e15, e31;

  Ranker() = default;
  __device__ __forceinline__ explicit Ranker(const float* e)
      : e15(e[15]), e31(e[31]) {}

  __device__ __forceinline__ int operator()(float a, const float* e) const {
    int p = a >= e15 ? 0 : 16;
    p += a >= e[p + 7] ? 0 : 8;
    p += a >= e[p + 3] ? 0 : 4;
    p += a >= e[p + 1] ? 0 : 2;
    p += a >= e[p] ? 0 : 1;  // p = min(rank, 31)
    return p + !(a >= e31);
  }
};

// True, in every thread of the CTA, for the CTA that arrives last at
// `ticket`; that CTA also puts the ticket back to zero.  Every atomic a
// thread of any CTA made before the call is visible to the last CTA.
__device__ __forceinline__ bool last_cta(unsigned* ticket) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (s_last) atomicExch(ticket, 0u);
  }
  __syncthreads();
  return s_last;
}

// x.astype(value_dtype).astype(float32): 0 none, 1 bfloat16, 2 float16,
// rounding to nearest even as XLA's and PyTorch's casts do.
__device__ __forceinline__ float cast_value(float x, int vdt) {
  if (vdt == 1) return __bfloat162float(__float2bfloat16_rn(x));
  if (vdt == 2) return __half2float(__float2half_rn(x));
  return x;
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// N elements moved as one vector: by default 16 bytes, one vector load or
// store per thread and step.  A loop over streams of several element types
// takes the smallest default N of them (ssm_apply.cu), so that every
// stream moves the same elements per step.
template <typename T, int N = 16 / sizeof(T)>
struct alignas(sizeof(T) * N) Pack {
  static constexpr int kN = N;
  T v[N];
};

template <typename T, int N = 16 / sizeof(T)>
__device__ __forceinline__ Pack<T, N> load_pack(const T* p, int64_t i) {
  return reinterpret_cast<const Pack<T, N>*>(p)[i];
}

template <typename T, int N>
__device__ __forceinline__ void store_pack(T* p, int64_t i,
                                           const Pack<T, N>& x) {
  reinterpret_cast<Pack<T, N>*>(p)[i] = x;
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Grid of a grid-stride loop over `work` items of 256 threads: enough CTAs
// to fill the card's 132 SMs several times over, never more than needed.
__host__ __forceinline__ int stride_grid(int64_t work, int threads) {
  const int64_t need = (work + threads - 1) / threads;
  const int64_t cap = 132 * 8;
  return static_cast<int>(need < 1 ? 1 : (need < cap ? need : cap));
}

}  // namespace repro
