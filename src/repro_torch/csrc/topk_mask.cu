// Per-leaf threshold selection passes for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/topk_mask/topk_mask.py:
//   * absmax_2d     (pl.pallas_call at line 55, body _absmax_kernel at :40-48)
//   * count_ge_2d   (pl.pallas_call at line 89, body _count_kernel at :70-81)
//   * apply_mask_2d (pl.pallas_call at line 115, body _apply_kernel at
//     :106-108)
//
// absmax: max |x| as float32 over a leaf of float32 or bfloat16.
// count_ge: the float32 counts of |x| >= taus[j] for 32 candidates, over the
// leaf followed by `pad` zeros (the zero padding the TPU wrapper adds up to
// a whole tile; 0 for the leaf alone).
// apply_mask: mask[i] = |x[i]| >= tau, one byte per element (0 or 1, the
// bytes of a torch.bool tensor and of the TPU's int8 mask); tau is a
// float32 in device memory (select_tau's result), so the host never waits.
// All three run over the leaf as it lies (any length, no padding).
//
// What bounds them on the H100: device-memory bytes (2 or 4 bytes read per
// element; the mask adds 1 byte written).  absmax and apply_mask do one
// compare per element.  count_ge compared every element with all 32
// candidates (32 compares and 32 integer adds, above the ~20 float32
// operations per byte the card affords on a bfloat16 leaf); by rank it
// does a few instructions per element.
//
// What the design does about it:
//   * a grid-stride loop with 16-byte loads (8 bfloat16 or 4 float32 per
//     thread and step), the ragged tail element by element;
//   * one launch per call: every CTA adds its partial result into a small
//     int32 workspace with one atomic per bin, takes a ticket after a
//     __threadfence(), and the CTA that takes the last ticket writes the
//     float32 result and zeroes the workspace for the next call.  The
//     wrapper keeps one workspace per device and stream, zeroed once, so
//     no fill launch precedes the kernel and no cast launch follows it;
//   * absmax keeps the maximum as the bits of a non-negative float, which
//     order as unsigned integers (a NaN's bits exceed infinity's, so a NaN
//     wins as jnp.max's does), reduces a warp with __reduce_max_sync and
//     takes one atomicMax per CTA: the TPU kernel's running max from zero,
//     exact in any CTA order;
//   * count_ge by rank.  Both candidate rows of select_tau descend, so the
//     32 predicates |x| >= tau_j hold for a suffix of j: the element's rank
//     j0, the first j whose predicate holds (32 if none does), says it all.
//     The element adds one to its thread's private counter
//     hist[j0][threadIdx.x] in shared memory (33 x 256 int32; the bank is
//     the lane: no conflicts, no atomics).  At the end each rank is summed
//     over the CTA, and the prefix sum over ranks gives count[j] = sum of
//     hist[b] for b <= j, added into the workspace with one atomicAdd per
//     bin and CTA.  A bfloat16 element takes its rank from a table: every
//     CTA first ranks all 32768 |bfloat16| bit patterns (keys) into 32 KB
//     of shared memory, so the element costs a mask, one byte load and
//     the counter's add.  A float32 element finds its rank by a branchless
//     binary search in 6 compares (common.cuh): the first against tau_15
//     in a register, the next four from shared memory by index, the last
//     against tau_31.  Each step
//     tests !(a >= e), so a NaN element ranks 32 and counts nowhere, as in
//     the plain version; the table gives NaN keys rank 32.  Ties among
//     candidates only need the predicate to be monotone, not strict.  One
//     warp first checks that the candidates are non-increasing and
//     NaN-free; where they are not, the CTA runs the 32-compare loop
//     instead (common.cuh), so the kernel is exact for any candidates.
//     Integer counts are exact in any CTA order; the TPU summed float32
//     counts, equal wherever those are exact (below 2^24);
//   * apply_mask loads 16 bytes of the leaf per thread and step and stores
//     its 4 or 8 mask bytes as one 4- or 8-byte word.

#include <type_traits>

#include "common.cuh"

namespace {

using repro::count_ge1;
using repro::kBins;
using repro::kRanks;
using repro::last_cta;
using repro::load_pack;
using repro::Pack;
using repro::Ranker;
using repro::to_f32;

constexpr int kThreads = 256;

// The workspace (int32 words, all zero between calls): count_ge's 32
// partial counts and its ticket, then absmax's bits and its ticket.
constexpr int kWsCount = 0;
constexpr int kWsAbsmax = kBins + 1;

template <typename T>
__device__ __forceinline__ unsigned abs_bits(T x) {
  return __float_as_uint(fabsf(to_f32(x)));
}

// ws: 2 words, zero on entry and on exit; out: one float32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const T* __restrict__ x, unsigned* __restrict__ ws,
              float* __restrict__ out, int64_t n, int vectorized) {
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
    if (mx != 0u) atomicMax(&ws[0], mx);
  }
  if (last_cta(&ws[1]) && threadIdx.x == 0)
    *out = __uint_as_float(atomicExch(&ws[0], 0u));
}

// The |bfloat16| bit patterns (sign cleared): keys 0 .. 0x7f80 are the
// values +0 .. +inf in increasing order, larger keys are NaN.
constexpr unsigned kKeys = 0x8000;
constexpr unsigned kInfKey = 0x7f80;

// The rank of every |bfloat16| key, for non-increasing NaN-free candidates
// e, into lut (kKeys bytes of shared memory).  bound[j] (32 words of
// shared memory) receives the first key whose value is >= e_j; the rank
// of key u is the number of j with u < bound[j], a prefix of j: 32 below
// bound[31], 0 from bound[0] on, and between the two the same 6-step
// search over the bounds (a log2 row spans about 2,000 keys, a linear
// refine row about 64, so most keys take no search).  NaN keys rank 32.
// Every thread of the CTA must call it.
__device__ __forceinline__ void build_key_ranks(const float* e,
                                                unsigned* bound,
                                                uint8_t* lut) {
  const int t = threadIdx.x;
  if (t < kBins) {
    const unsigned u = __float_as_uint(e[t]);
    bound[t] = e[t] > 0.0f ? (u >> 16) + ((u & 0xffffu) != 0u) : 0u;
  }
  __syncthreads();
  const unsigned top = bound[0], low = bound[kBins - 1];
  auto rank = [bound, top, low](unsigned u) -> unsigned {
    if (u > kInfKey || u < low) return kBins;
    if (u >= top) return 0u;
    unsigned p = 0;  // the rank, 1 .. 31 here
#pragma unroll
    for (unsigned step = 16; step >= 1; step >>= 1)
      p += bound[p + step - 1] > u ? step : 0u;
    return p;
  };
  // word w holds keys 4w .. 4w+3; neighbouring threads write neighbouring
  // words, so the stores meet no bank conflict
  auto* words = reinterpret_cast<unsigned*>(lut);
  for (unsigned w = t; w < kKeys / 4; w += kThreads)
    words[w] = rank(4 * w) | rank(4 * w + 1) << 8 | rank(4 * w + 2) << 16 |
               rank(4 * w + 3) << 24;
  __syncthreads();
}

// Shared memory of count_ge_kernel<T> beyond its static arrays: the
// per-thread rank counters, and for a bfloat16 leaf the key ranks.
template <typename T>
constexpr size_t count_smem() {
  return sizeof(int) * kRanks * kThreads +
         (std::is_same<T, __nv_bfloat16>::value ? kKeys : 0);
}

// ws: 33 words (32 counts and a ticket), zero on entry and on exit; out:
// 32 float32 counts, each over x and `pad` zeros after it.
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
count_ge_kernel(const float* __restrict__ taus, const T* __restrict__ x,
                int* __restrict__ ws, float* __restrict__ out, int64_t n,
                int pad, int vectorized) {
  extern __shared__ int s_dyn[];
  int* s_hist = s_dyn;  // [rank][thread]
  __shared__ float s_edges[kBins];
  __shared__ unsigned s_bound[kBins];
  __shared__ int s_tot[kBins];
  __shared__ int s_sorted;
  const int t = threadIdx.x, lane = t & 31;
  if (t < kBins) s_edges[t] = taus[t];
#pragma unroll
  for (int r = 0; r < kRanks; ++r) s_hist[r * kThreads + t] = 0;
  __syncthreads();
  if (t < 32) {
    const float e = s_edges[lane], next = s_edges[min(lane + 1, kBins - 1)];
    const int ok = __all_sync(0xffffffffu, e == e && e >= next);
    if (lane == 0) s_sorted = ok;
  }
  __syncthreads();
  const bool sorted = s_sorted != 0;  // uniform over the CTA

  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + t;
  constexpr int N = Pack<T>::kN;
  const int64_t nv = vectorized ? n / N : 0, head = nv * N;
  int* hist = s_hist + t;
  if (sorted) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      // one shared-memory byte gives each element its rank
      uint8_t* lut = reinterpret_cast<uint8_t*>(s_hist + kRanks * kThreads);
      build_key_ranks(s_edges, s_bound, lut);
      const auto* xv = reinterpret_cast<const uint4*>(x);
      for (int64_t i = tid; i < nv; i += stride) {
        const uint4 q = xv[i];
        const unsigned w[4] = {q.x, q.y, q.z, q.w};
        int r[8];  // all 8 ranks first: the table reads wait on no counter
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          r[2 * k] = lut[w[k] & 0x7fffu];
          r[2 * k + 1] = lut[(w[k] >> 16) & 0x7fffu];
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) hist[r[e] * kThreads] += 1;
      }
      const auto* xs = reinterpret_cast<const uint16_t*>(x);
      for (int64_t i = head + tid; i < n; i += stride)
        hist[lut[xs[i] & 0x7fffu] * kThreads] += 1;
    } else {
      const Ranker rank(s_edges);
      for (int64_t i = tid; i < nv; i += stride) {
        const Pack<T> p = load_pack(x, i);
#pragma unroll
        for (int e = 0; e < N; ++e)
          hist[rank(fabsf(to_f32(p.v[e])), s_edges) * kThreads] += 1;
      }
      for (int64_t i = head + tid; i < n; i += stride)
        hist[rank(fabsf(to_f32(x[i])), s_edges) * kThreads] += 1;
    }
  } else {
    int cnt[kBins];
#pragma unroll
    for (int j = 0; j < kBins; ++j) cnt[j] = 0;
    for (int64_t i = tid; i < nv; i += stride) {
      const Pack<T> p = load_pack(x, i);
#pragma unroll
      for (int e = 0; e < N; ++e)
        count_ge1(cnt, s_edges, fabsf(to_f32(p.v[e])));
    }
    for (int64_t i = head + tid; i < n; i += stride)
      count_ge1(cnt, s_edges, fabsf(to_f32(x[i])));
#pragma unroll
    for (int j = 0; j < kBins; ++j) hist[j * kThreads] = cnt[j];
  }
  __syncthreads();
  // per-bin totals over the CTA's threads (rank 32 counts nowhere)
  for (int b = t / 32; b < kBins; b += kThreads / 32) {
    int sum = 0;
#pragma unroll
    for (int i = lane; i < kThreads; i += 32) sum += s_hist[b * kThreads + i];
    sum = __reduce_add_sync(0xffffffffu, sum);
    if (lane == 0) s_tot[b] = sum;
  }
  __syncthreads();
  if (t < 32) {
    int c = s_tot[lane];
    if (sorted) {  // count[j] = sum of the ranks b <= j
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, c, d);
        if (lane >= d) c += up;
      }
    }
    if (c != 0) atomicAdd(&ws[lane], c);
  }
  if (last_cta(reinterpret_cast<unsigned*>(&ws[kBins])) && t < kBins)
    out[t] = __int2float_rn(atomicExch(&ws[t], 0) +
                            (0.0f >= s_edges[t] ? pad : 0));
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
int launch_absmax(const void* x, unsigned* ws, float* out, int64_t n,
                  cudaStream_t st) {
  const bool vec = repro::aligned16(x);
  const int64_t work = vec ? n / Pack<T>::kN + Pack<T>::kN : n;
  absmax_kernel<T><<<repro::stride_grid(work, kThreads), kThreads, 0, st>>>(
      static_cast<const T*>(x), ws, out, n, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// The count's CTAs hold much shared memory: its grid is the CTAs the card
// keeps resident at once (every SM full, one wave, so that no second,
// partial wave follows the first), at most one per 256 vector steps.
template <typename T>
int launch_count(const float* taus, const void* x, int* ws, float* out,
                 int64_t n, int pad, cudaStream_t st) {
  constexpr size_t smem = count_smem<T>();
  static const int resident = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaFuncSetAttribute(count_ge_kernel<T>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, count_ge_kernel<T>,
                                                  kThreads, smem);
    return sms * (per_sm > 0 ? per_sm : 1);
  }();
  const bool vec = repro::aligned16(x);
  const int64_t work = vec ? n / Pack<T>::kN + Pack<T>::kN : n;
  const int64_t need = (work + kThreads - 1) / kThreads;
  const int grid =
      static_cast<int>(need < 1 ? 1 : (need < resident ? need : resident));
  count_ge_kernel<T><<<grid, kThreads, smem, st>>>(
      taus, static_cast<const T*>(x), ws, out, n, pad, vec ? 1 : 0);
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

// dtype: 0 float32, 1 bfloat16.  ws: the wrapper's workspace of
// repro_topk_workspace_words() int32 words, zero between calls (each
// kernel leaves it zero); out: one float32, max |x|.
extern "C" int repro_absmax(const void* x, int* ws, float* out, int64_t n,
                            int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* w = reinterpret_cast<unsigned*>(ws + kWsAbsmax);
  if (dtype == 0) return launch_absmax<float>(x, w, out, n, st);
  if (dtype == 1) return launch_absmax<__nv_bfloat16>(x, w, out, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out: 32 float32 counts over x and `pad` zeros after it; ws as above.
extern "C" int repro_count_ge(const float* taus, const void* x, int* ws,
                              float* out, int64_t n, int pad, int dtype,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* w = ws + kWsCount;
  if (dtype == 0) return launch_count<float>(taus, x, w, out, n, pad, st);
  if (dtype == 1)
    return launch_count<__nv_bfloat16>(taus, x, w, out, n, pad, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// int32 words of the workspace repro_absmax and repro_count_ge share.
extern "C" int repro_topk_workspace_words() { return kWsAbsmax + 2; }

// mask: n bytes, written whole (0 or 1 each).
extern "C" int repro_apply_mask(const float* tau, const void* x, uint8_t* mask,
                                int64_t n, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_apply_mask<float>(tau, x, mask, n, st);
  if (dtype == 1) return launch_apply_mask<__nv_bfloat16>(tau, x, mask, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
