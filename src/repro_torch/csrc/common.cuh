// Device helpers shared by the port's kernels (sm_90a).
//
// * the 32-candidate ">= edge" count and its CTA flush, used by the packed
//   cohort histogram (packed_topk.cu; the per-leaf count of topk_mask.cu
//   takes the count alone, for candidates that are not sorted): counts are
//   int32 in registers, reduced per warp, per CTA in shared memory, and
//   added to global memory with one atomicAdd per bin, so they are exact
//   and independent of the order in which CTAs run;
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

// cnt[j] += (a >= edges[j]) for the 32 candidates.
__device__ __forceinline__ void count_ge1(int (&cnt)[kBins],
                                          const float* s_edges, float a) {
#pragma unroll
  for (int j = 0; j < kBins; ++j) cnt[j] += (a >= s_edges[j]);
}

// Adds the CTA's per-thread counts into out[0..31] and zeroes them.  Every
// thread of the CTA must call it; s_hist (32 ints of shared memory) must
// be zero on entry and is zero again on exit.
__device__ __forceinline__ void hist_flush(int (&cnt)[kBins], int* s_hist,
                                           int* out) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kBins; ++j) {
    const int s = __reduce_add_sync(0xffffffffu, cnt[j]);
    if (lane == 0 && s != 0) atomicAdd(&s_hist[j], s);
    cnt[j] = 0;
  }
  __syncthreads();
  if (threadIdx.x < kBins) {
    const int h = s_hist[threadIdx.x];
    if (h != 0) atomicAdd(&out[threadIdx.x], h);
    s_hist[threadIdx.x] = 0;
  }
  __syncthreads();
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
