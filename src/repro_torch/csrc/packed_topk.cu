// Packed cohort threshold selection for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/packed_topk/packed_topk.py:
//   * packed_hist_2d  (pl.pallas_call at line 91, body _hist_kernel)
//   * packed_apply_2d (pl.pallas_call at line 233, body _make_apply_kernel)
//
// Layout (core/sparsify.PackedLayout): every pytree leaf is zero-padded to
// a multiple of one (8, 128) block = 1024 float32 values and the leaves are
// concatenated into one (R, 128) buffer; seg_ids[b] names the tau segment
// of block b.
//
// What bounds these kernels on the H100: device-memory bytes.  The
// histogram reads 4 bytes per element and does 32 compares per element
// (about 8 operations per byte, far below the card's ~20 float32
// operations per byte of bandwidth); the apply pass reads 3 streams and
// writes 3-4, all elementwise.
//
// What the design does about it:
//   * every thread loads one float4 (16 bytes) per (8, 128) block, so a warp
//     reads 512 contiguous bytes per load;
//   * the histogram counts in int32 registers (32 per thread), reduces a
//     warp with __reduce_add_sync, a CTA in shared memory, and adds into the
//     (L, 32) global histogram with one atomicAdd per (segment, bin) per
//     CTA (common.cuh, shared with the per-leaf count of topk_mask.cu).  Integer counts are exact and order-free, so run-to-run atomics
//     order cannot change a bit.  They equal the TPU's float32 counts
//     wherever those are exact (below 2^24 per segment);
//   * the TPU ran the apply as one (2, nb) grid whose first sweep counts and
//     whose second applies, relying on in-order grid steps.  A GPU grid has
//     no order, so the count sweep is a second launch of the histogram
//     kernel with the refine candidates as edges, and the pick/apply kernel
//     below reads w/m/v exactly once: three launches per client compress
//     where the TPU spent two.
//   * tau is picked as a select (first candidate whose count reaches k,
//     index 0 when none does, as jnp.argmax does), never computed, so it is
//     bitwise one of the host's refine candidates.

#include "common.cuh"

namespace {

using repro::cast_value;
using repro::count_ge1;
using repro::hist_flush;
using repro::kBins;

constexpr int kBlockElems = 1024;      // one (8, 128) packed block
constexpr int kThreads = 256;          // 256 threads x float4 = one block
constexpr int kHistBlocksPerCta = 8;   // packed blocks walked by one CTA

// out[seg, j] += count(|x| >= edges[seg, j]) over the CTA's blocks.
__global__ void __launch_bounds__(kThreads)
packed_hist_kernel(const float* __restrict__ x,
                   const int* __restrict__ seg_ids,
                   const float* __restrict__ edges,
                   int* __restrict__ out, int nb) {
  __shared__ float s_edges[kBins];
  __shared__ int s_hist[kBins];
  const int b0 = blockIdx.x * kHistBlocksPerCta;
  const int b1 = min(b0 + kHistBlocksPerCta, nb);
  int seg = seg_ids[b0];
  if (threadIdx.x < kBins) {
    s_edges[threadIdx.x] = edges[seg * kBins + threadIdx.x];
    s_hist[threadIdx.x] = 0;
  }
  __syncthreads();

  int cnt[kBins];
#pragma unroll
  for (int j = 0; j < kBins; ++j) cnt[j] = 0;

  for (int b = b0; b < b1; ++b) {
    const int sb = seg_ids[b];            // uniform across the CTA
    if (sb != seg) {
      hist_flush(cnt, s_hist, out + seg * kBins);
      seg = sb;
      if (threadIdx.x < kBins)
        s_edges[threadIdx.x] = edges[seg * kBins + threadIdx.x];
      __syncthreads();
    }
    const float4 v = reinterpret_cast<const float4*>(
        x + static_cast<size_t>(b) * kBlockElems)[threadIdx.x];
    count_ge1(cnt, s_edges, fabsf(v.x));
    count_ge1(cnt, s_edges, fabsf(v.y));
    count_ge1(cnt, s_edges, fabsf(v.z));
    count_ge1(cnt, s_edges, fabsf(v.w));
  }
  hist_flush(cnt, s_hist, out + seg * kBins);
}

__device__ __forceinline__ float4 apply4(const float4 x, const bool k[4],
                                         int vdt) {
  float4 s;
  s.x = k[0] ? cast_value(x.x, vdt) : 0.0f;
  s.y = k[1] ? cast_value(x.y, vdt) : 0.0f;
  s.z = k[2] ? cast_value(x.z, vdt) : 0.0f;
  s.w = k[3] ? cast_value(x.w, vdt) : 0.0f;
  return s;
}

// One CTA per packed block: pick the block's segment tau from the refine
// counts c2, then write where(|score| >= tau, cast(x), 0) for every stream,
// the optional residual x0 - s0, and (once per run of a segment) taus/counts.
__global__ void __launch_bounds__(kThreads)
packed_apply_kernel(const float* __restrict__ taus2,
                    const int* __restrict__ c2,
                    const int* __restrict__ seg_ids,
                    const float* __restrict__ ks,
                    const float* __restrict__ ns,
                    const float* __restrict__ score,
                    const float* __restrict__ x0,
                    const float* __restrict__ x1,
                    const float* __restrict__ x2,
                    float* __restrict__ s0, float* __restrict__ s1,
                    float* __restrict__ s2, float* __restrict__ err,
                    float* __restrict__ taus_out,
                    float* __restrict__ counts_out,
                    int n_streams, int vdt) {
  __shared__ float s_tau;
  const int b = blockIdx.x;
  const int seg = seg_ids[b];
  if (threadIdx.x < 32) {
    const int j = threadIdx.x;
    const float k = ks[seg];
    const float n = ns[seg];
    const int c = c2[seg * kBins + j];
    const float t = taus2[seg * kBins + j];
    const unsigned hit = __ballot_sync(0xffffffffu, static_cast<float>(c) >= k);
    const int idx = hit ? __ffs(hit) - 1 : 0;
    float tau = __shfl_sync(0xffffffffu, t, idx);
    float cnt = static_cast<float>(__shfl_sync(0xffffffffu, c, idx));
    if (k >= n) {
      tau = 0.0f;
      cnt = n;
    }
    if (j == 0) {
      s_tau = tau;
      if (b == 0 || seg_ids[b - 1] != seg) {
        taus_out[seg] = tau;
        counts_out[seg] = cnt;
      }
    }
  }
  __syncthreads();
  const float tau = s_tau;
  const size_t i4 = static_cast<size_t>(b) * (kBlockElems / 4) + threadIdx.x;
  const float4 w = reinterpret_cast<const float4*>(x0)[i4];
  const float4 sc =
      score != nullptr ? reinterpret_cast<const float4*>(score)[i4] : w;
  const bool keep[4] = {fabsf(sc.x) >= tau, fabsf(sc.y) >= tau,
                        fabsf(sc.z) >= tau, fabsf(sc.w) >= tau};
  const float4 o0 = apply4(w, keep, vdt);
  reinterpret_cast<float4*>(s0)[i4] = o0;
  if (err != nullptr) {
    float4 e;
    e.x = w.x - o0.x;
    e.y = w.y - o0.y;
    e.z = w.z - o0.z;
    e.w = w.w - o0.w;
    reinterpret_cast<float4*>(err)[i4] = e;
  }
  if (n_streams == 3) {
    reinterpret_cast<float4*>(s1)[i4] =
        apply4(reinterpret_cast<const float4*>(x1)[i4], keep, vdt);
    reinterpret_cast<float4*>(s2)[i4] =
        apply4(reinterpret_cast<const float4*>(x2)[i4], keep, vdt);
  }
}

}  // namespace

extern "C" int repro_packed_hist(const float* x, const int* seg_ids,
                                 const float* edges, int* out, int nb,
                                 void* stream) {
  const int grid = (nb + kHistBlocksPerCta - 1) / kHistBlocksPerCta;
  packed_hist_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, seg_ids, edges, out, nb);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_packed_apply(const float* taus2, const int* c2,
                                  const int* seg_ids, const float* ks,
                                  const float* ns, const float* score,
                                  const float* x0, const float* x1,
                                  const float* x2, float* s0, float* s1,
                                  float* s2, float* err, float* taus_out,
                                  float* counts_out, int nb, int n_streams,
                                  int vdt, void* stream) {
  packed_apply_kernel<<<nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      taus2, c2, seg_ids, ks, ns, score, x0, x1, x2, s0, s1, s2, err,
      taus_out, counts_out, n_streams, vdt);
  return static_cast<int>(cudaGetLastError());
}
