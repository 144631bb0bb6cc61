// Per-leaf threshold selection passes for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/topk_mask/topk_mask.py:
//   * absmax_2d     (pl.pallas_call at line 55, body _absmax_kernel at :40-48)
//   * count_ge_2d   (pl.pallas_call at line 89, body _count_kernel at :70-81)
//   * apply_mask_2d (pl.pallas_call at line 115, body _apply_kernel at
//     :106-108)
//
// absmax: max |x| as float32 over a leaf of float32 or bfloat16.
// count_ge: out[j] += count(|x| >= taus[j]) for the 32 candidates.
// apply_mask: mask[i] = |x[i]| >= tau, one byte per element (0 or 1, the
// bytes of a torch.bool tensor and of the TPU's int8 mask); tau is a
// float32 in device memory (select_tau's result), so the host never waits.
// All three run over the leaf as it lies (any length, no padding).
//
// What bounds them on the H100: absmax and apply_mask are bound by
// device-memory bytes (2 or 4 bytes read per element, one compare; the
// mask adds 1 byte written).  count_ge reads the same bytes but does 32
// compares and 32 integer adds per element: for a bfloat16 leaf that is 32
// operations per byte, above the ~20 float32 operations per byte the card
// affords, so it is bound by operations.
//
// What the design does about it:
//   * a grid-stride loop with 16-byte loads (8 bfloat16 or 4 float32 per
//     thread and step), the ragged tail element by element;
//   * absmax keeps the maximum as the bits of a non-negative float, which
//     order as unsigned integers (a NaN's bits exceed infinity's, so a NaN
//     wins as jnp.max's does), reduces a warp with __reduce_max_sync and
//     writes one atomicMax per CTA into an output the wrapper zeroed: the
//     TPU kernel's running max from zero, exact in any CTA order;
//   * count_ge shares the packed histogram's counting code (common.cuh):
//     int32 counts in registers, warp and CTA reductions, one atomicAdd per
//     bin and CTA.  The TPU summed float32 counts across grid steps; integer
//     counts are exact in any order and equal those wherever the float32
//     sums are exact (below 2^24).  The 32 candidates sit in shared memory;
//   * apply_mask loads 16 bytes of the leaf per thread and step and stores
//     its 4 or 8 mask bytes as one 4- or 8-byte word.

#include "common.cuh"

namespace {

using repro::count_ge1;
using repro::hist_flush;
using repro::kBins;
using repro::load_pack;
using repro::Pack;
using repro::to_f32;

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ unsigned abs_bits(T x) {
  return __float_as_uint(fabsf(to_f32(x)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const T* __restrict__ x, unsigned* __restrict__ out, int64_t n,
              int vectorized) {
  __shared__ unsigned s_max[kThreads / 32];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  unsigned mx = 0u;
  int64_t head = 0;
  if (vectorized) {
    constexpr int N = Pack<T>::kN;
    const int64_t nv = n / N;
    for (int64_t i = tid; i < nv; i += stride) {
      const Pack<T> p = load_pack(x, i);
#pragma unroll
      for (int e = 0; e < N; ++e) mx = max(mx, abs_bits(p.v[e]));
    }
    head = nv * N;
  }
  for (int64_t i = head + tid; i < n; i += stride) mx = max(mx, abs_bits(x[i]));
  mx = __reduce_max_sync(0xffffffffu, mx);
  if ((threadIdx.x & 31) == 0) s_max[threadIdx.x / 32] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) mx = max(mx, s_max[w]);
    if (mx != 0u) atomicMax(out, mx);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
count_ge_kernel(const float* __restrict__ taus, const T* __restrict__ x,
                int* __restrict__ out, int64_t n, int vectorized) {
  __shared__ float s_edges[kBins];
  __shared__ int s_hist[kBins];
  if (threadIdx.x < kBins) {
    s_edges[threadIdx.x] = taus[threadIdx.x];
    s_hist[threadIdx.x] = 0;
  }
  __syncthreads();
  int cnt[kBins];
#pragma unroll
  for (int j = 0; j < kBins; ++j) cnt[j] = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t head = 0;
  if (vectorized) {
    constexpr int N = Pack<T>::kN;
    const int64_t nv = n / N;
    for (int64_t i = tid; i < nv; i += stride) {
      const Pack<T> p = load_pack(x, i);
#pragma unroll
      for (int e = 0; e < N; ++e) count_ge1(cnt, s_edges, fabsf(to_f32(p.v[e])));
    }
    head = nv * N;
  }
  for (int64_t i = head + tid; i < n; i += stride)
    count_ge1(cnt, s_edges, fabsf(to_f32(x[i])));
  hist_flush(cnt, s_hist, out);
}

// The mask bytes of one Pack<T>: N = 4 (float32) or 8 (bfloat16) bytes,
// stored as one or two 32-bit words.
template <int N>
struct alignas(N) MaskWords {
  uint32_t w[N / 4];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
apply_mask_kernel(const float* __restrict__ tau_p, const T* __restrict__ x,
                  uint8_t* __restrict__ mask, int64_t n, int vectorized) {
  const float tau = *tau_p;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t head = 0;
  if (vectorized) {
    constexpr int N = Pack<T>::kN;
    const int64_t nv = n / N;
    for (int64_t i = tid; i < nv; i += stride) {
      const Pack<T> p = load_pack(x, i);
      MaskWords<N> o;
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        uint32_t word = 0u;
#pragma unroll
        for (int b = 0; b < 4; ++b)  // little-endian: byte b is element 4q+b
          word |= static_cast<uint32_t>(fabsf(to_f32(p.v[4 * q + b])) >= tau)
                  << (8 * b);
        o.w[q] = word;
      }
      reinterpret_cast<MaskWords<N>*>(mask)[i] = o;
    }
    head = nv * N;
  }
  for (int64_t i = head + tid; i < n; i += stride)
    mask[i] = static_cast<uint8_t>(fabsf(to_f32(x[i])) >= tau);
}

template <typename T>
int launch_absmax(const void* x, unsigned* out, int64_t n, cudaStream_t st) {
  const bool vec = repro::aligned16(x);
  const int64_t work = vec ? n / Pack<T>::kN + Pack<T>::kN : n;
  absmax_kernel<T><<<repro::stride_grid(work, kThreads), kThreads, 0, st>>>(
      static_cast<const T*>(x), out, n, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_count(const float* taus, const void* x, int* out, int64_t n,
                 cudaStream_t st) {
  const bool vec = repro::aligned16(x);
  const int64_t work = vec ? n / Pack<T>::kN + Pack<T>::kN : n;
  count_ge_kernel<T><<<repro::stride_grid(work, kThreads), kThreads, 0, st>>>(
      taus, static_cast<const T*>(x), out, n, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_apply_mask(const float* tau, const void* x, uint8_t* mask,
                      int64_t n, cudaStream_t st) {
  const bool vec = repro::aligned16(x) && repro::aligned16(mask);
  const int64_t work = vec ? n / Pack<T>::kN + Pack<T>::kN : n;
  apply_mask_kernel<T><<<repro::stride_grid(work, kThreads), kThreads, 0,
                         st>>>(tau, static_cast<const T*>(x), mask, n,
                               vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  out: one uint32, zeroed by the caller,
// receives the bits of max|x|.
extern "C" int repro_absmax(const void* x, unsigned* out, int64_t n, int dtype,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_absmax<float>(x, out, n, st);
  if (dtype == 1) return launch_absmax<__nv_bfloat16>(x, out, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out: 32 int32 counts, zeroed by the caller.
extern "C" int repro_count_ge(const float* taus, const void* x, int* out,
                              int64_t n, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_count<float>(taus, x, out, n, st);
  if (dtype == 1) return launch_count<__nv_bfloat16>(taus, x, out, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// mask: n bytes, written whole (0 or 1 each).
extern "C" int repro_apply_mask(const float* tau, const void* x, uint8_t* mask,
                                int64_t n, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_apply_mask<float>(tau, x, mask, n, st);
  if (dtype == 1) return launch_apply_mask<__nv_bfloat16>(tau, x, mask, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
