// Packed cohort threshold selection for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/packed_topk/packed_topk.py:
//   * packed_hist_2d  (pl.pallas_call at line 91, body _hist_kernel at :61)
//   * packed_apply_2d (pl.pallas_call at line 233, body _make_apply_kernel
//     at :112)
//
// Layout (core/sparsify.PackedLayout): every pytree leaf is zero-padded to
// a multiple of one (8, 128) block = 1024 float32 values and the leaves are
// concatenated into one (R, 128) buffer; seg_ids[b] names the tau segment
// of block b.
//
// packed_hist: the (L, 32) float32 counts of |x| >= edges[seg, j].
// packed_apply: the same count over the refine candidates taus2, the pick
// of each segment's tau (the first candidate whose count reaches k, index
// 0 when none does, tau 0 and count n where k >= n), then
// where(|score| >= tau, cast(x), 0) over 1 or 3 streams and the optional
// residual x0 - s0.
//
// What bounds them on the H100.  At VGG-11's 9.7 M elements, device-memory
// bytes: the count reads 4 bytes per element, the apply 8-28.  At the
// CNN's 445 blocks (1.8 MB) the data takes half a microsecond to move, and
// the launch floor and the chain of the last CTA's ticket are what remain.
// The TPU's count compared each element with all 32 edges (64 instructions
// per 4-byte element, above the ~20 float32 operations per byte the card
// affords); even by rank, the count's instructions per element decide
// whether it keeps up with the bytes.
//
// What the design does about it:
//   * count by rank: when a CTA enters a segment, one warp sorts its 32
//     edges largest first (a bitonic sort over shuffles, skipped where they
//     already descend, as the selection's log2 and refine rows do; a NaN
//     edge, which no element reaches, stands as +inf and its bin is written
//     0).  The 32 predicates |x| >= e then hold for a suffix of the sorted
//     edges, so an element's rank among them (the first that holds, 32 for
//     none or NaN; the binary search of common.cuh, 6 compares) says it
//     all, and the kernel is exact for any edges with one path.  Each
//     element adds one to its warp's rank histogram in shared memory (8
//     warps x 33 int32, shared atomics).  Rank 32 adds into a slot never
//     read: skipping its add behind a branch was slower on the H100, 14%
//     for the count at VGG-11 (PERF.md).
//     On a segment change and at the end one warp sums the warps, takes
//     the prefix sum over ranks, reads each edge's count at its sorted
//     position and adds it into the workspace, one atomicAdd per (segment,
//     bin).  Integer counts are exact in any CTA order; the TPU summed
//     float32 counts, equal wherever those are exact (below 2^24);
//   * fill the card: the count's grid is the CTAs the card keeps resident,
//     each over a contiguous chunk of ceil(nb / resident) blocks (the CNN's
//     445 blocks become 445 CTAs on 132 SMs), every thread with 16-byte
//     loads of 4 blocks in flight.  Measured on the H100 at VGG-11 and the
//     CNN (PERF.md): the rank search's instructions decide the
//     count's time, so private per-thread counters, a cp.async ring, TMA
//     bulk copies and a prefetch of the next blocks were all slower; the
//     apply is a grid-stride loop over blocks sized the same way, each
//     thread loading both blocks of a step of every stream before it
//     stores;
//   * one launch per count: CTAs add into an int32 workspace of L * 32 + 1
//     words (the ticket, then the counts) that the wrapper keeps per device
//     and stream, zeroed once.  Each CTA takes a ticket after a
//     __threadfence(); the last writes the float32 result and zeroes the
//     workspace, so no fill launch precedes the kernel and no cast follows;
//   * pick in the epilogue: in packed_apply the count's last CTA picks
//     every segment's tau from the finished counts (a ballot over the 32
//     candidates, a select, so tau is bitwise one of them) and writes taus
//     and counts; the apply reads taus[seg_ids[b]] once per block.  The
//     TPU's two-sweep grid relied on in-order grid steps; here the two
//     sweeps are two launches.

#include <algorithm>

#include "common.cuh"

namespace {

using repro::cast_value;
using repro::kBins;
using repro::kRanks;
using repro::last_cta;
using repro::Ranker;

constexpr int kBlockElems = 1024;       // one (8, 128) packed block
constexpr int kThreads = 256;           // 256 threads x float4 = one block
constexpr int kWarps = kThreads / 32;
constexpr int kCountUnroll = 4;         // blocks a count thread has in flight
constexpr int kApplyUnroll = 2;         // blocks an apply thread has in flight
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float4 load_block(const float* x, int b) {
  return reinterpret_cast<const float4*>(
      x + static_cast<size_t>(b) * kBlockElems)[threadIdx.x];
}

// The count over the blocks of this CTA's chunk.  ws: the ticket, then the
// (n_seg, 32) counts, all zero on entry and on exit.  The last CTA writes
// out[seg, j] (kPick false), or (kPick true) picks each segment's tau
// among the candidates `edges` for ks/ns into taus_out and counts_out.
template <bool kPick>
__global__ void __launch_bounds__(kThreads, 4)
packed_count_kernel(const float* __restrict__ x,
                    const int* __restrict__ seg_ids,
                    const float* __restrict__ edges, int* __restrict__ ws,
                    int nb, int chunk, int n_seg, float* __restrict__ out,
                    const float* __restrict__ ks,
                    const float* __restrict__ ns,
                    float* __restrict__ taus_out,
                    float* __restrict__ counts_out) {
  __shared__ float s_sorted[kBins];  // the segment's edges, non-increasing
  __shared__ int s_pos[kBins];       // edge j's position among them
  __shared__ int s_hist[kWarps * kRanks];  // [warp][rank]
  const int t = threadIdx.x, lane = t & 31;
  int* const hist = s_hist + (t >> 5) * kRanks;
  int* const counts = ws + 1;
  for (int i = t; i < kWarps * kRanks; i += kThreads) s_hist[i] = 0;

  int seg = -1;  // the segment being counted (uniform over the CTA)
  Ranker rank;

  // Adds the CTA's counts of `seg` into the workspace and zeroes them, then
  // sorts the edges of segment `next` (none for -1).  Every thread calls it.
  auto enter = [&](int next) {
    __syncthreads();
    if (t < 32) {
      if (seg >= 0) {
        int c = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          c += s_hist[w * kRanks + lane];
          s_hist[w * kRanks + lane] = 0;
        }
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {  // position k: the ranks <= k
          const int up = __shfl_up_sync(kAll, c, d);
          if (lane >= d) c += up;
        }
        // bin j counts what its edge's position does; a NaN edge nothing
        const float e = edges[seg * kBins + lane];
        c = __shfl_sync(kAll, c, s_pos[lane]);
        if (e == e && c != 0) atomicAdd(&counts[seg * kBins + lane], c);
      }
      if (next >= 0) {
        // bitonic sort of the 32 edges, largest first, each with its index,
        // where they are not already in that order.  A NaN edge holds for
        // no element: as +inf it holds for +inf alone, and its bin is
        // written as 0 above.
        const float e = edges[next * kBins + lane];
        float key = e == e ? e : __int_as_float(0x7f800000);
        int idx = lane;
        const float below = __shfl_down_sync(kAll, e, 1);  // lane 31: e
        if (!__all_sync(kAll, e == e && e >= below)) {
#pragma unroll
          for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
            for (int stride = size / 2; stride > 0; stride >>= 1) {
              const float other = __shfl_xor_sync(kAll, key, stride);
              const int other_idx = __shfl_xor_sync(kAll, idx, stride);
              // keep the larger where this lane's half of the pair and its
              // run's direction agree (the last run is descending)
              const bool larger =
                  ((lane & stride) == 0) == ((lane & size) == 0);
              if (larger ? other > key : other < key) {
                key = other;
                idx = other_idx;
              }
            }
          }
        }
        s_sorted[lane] = key;
        s_pos[idx] = lane;
      }
    }
    __syncthreads();
    seg = next;
    rank = Ranker(s_sorted);
  };

  const int b0 = blockIdx.x * chunk;
  const int b1 = min(b0 + chunk, nb);
  for (int b = b0; b < b1; b += kCountUnroll) {
    float4 v[kCountUnroll];
    int s[kCountUnroll];
#pragma unroll
    for (int u = 0; u < kCountUnroll; ++u) {
      if (b + u < b1) {
        v[u] = load_block(x, b + u);
        s[u] = seg_ids[b + u];
      }
    }
#pragma unroll
    for (int u = 0; u < kCountUnroll; ++u) {
      if (b + u >= b1) break;
      if (s[u] != seg) enter(s[u]);  // uniform: every thread read s[u]
      // rank 32 (below every edge, or NaN) goes to a slot never read:
      // an unconditional add is cheaper than a branch around it
      const float a[4] = {fabsf(v[u].x), fabsf(v[u].y), fabsf(v[u].z),
                          fabsf(v[u].w)};
      int r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) r[e] = rank(a[e], s_sorted);
#pragma unroll
      for (int e = 0; e < 4; ++e) atomicAdd(&hist[r[e]], 1);
    }
  }
  enter(-1);

  if (!last_cta(reinterpret_cast<unsigned*>(ws))) return;
  if constexpr (!kPick) {
    for (int i = t; i < n_seg * kBins; i += kThreads)
      out[i] = __int2float_rn(atomicExch(&counts[i], 0));
  } else {
    // ref.pick_taus as a select: idx = the first j with count >= k, else 0
    for (int sg = t >> 5; sg < n_seg; sg += kWarps) {
      const int c = atomicExch(&counts[sg * kBins + lane], 0);
      const float k = ks[sg], n = ns[sg];
      const unsigned hit = __ballot_sync(kAll, __int2float_rn(c) >= k);
      const int idx = hit ? __ffs(hit) - 1 : 0;
      float tau = __shfl_sync(kAll, edges[sg * kBins + lane], idx);
      float cnt = __int2float_rn(__shfl_sync(kAll, c, idx));
      if (k >= n) {
        tau = 0.0f;
        cnt = n;
      }
      if (lane == 0) {
        taus_out[sg] = tau;
        counts_out[sg] = cnt;
      }
    }
  }
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

// One packed block's float4 of every stream, and its segment's tau.
struct BlockIn {
  float4 w, sc, m, v;
  float tau;
};

// where(|score| >= taus[seg_ids[b]], cast(x), 0) for every stream, and the
// residual x0 - s0 where err is given; a grid-stride loop over blocks.
__global__ void __launch_bounds__(kThreads)
packed_apply_kernel(const float* __restrict__ taus,
                    const int* __restrict__ seg_ids,
                    const float* __restrict__ score,
                    const float* __restrict__ x0,
                    const float* __restrict__ x1,
                    const float* __restrict__ x2,
                    float* __restrict__ s0, float* __restrict__ s1,
                    float* __restrict__ s2, float* __restrict__ err, int nb,
                    int n_streams, int vdt) {
  const int step = gridDim.x;
  for (int b = blockIdx.x; b < nb; b += kApplyUnroll * step) {
    BlockIn in[kApplyUnroll];
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) {
      const int bu = b + u * step;
      if (bu >= nb) break;
      in[u].w = load_block(x0, bu);
      in[u].sc = score != nullptr ? load_block(score, bu) : in[u].w;
      if (n_streams == 3) {
        in[u].m = load_block(x1, bu);
        in[u].v = load_block(x2, bu);
      }
      in[u].tau = taus[seg_ids[bu]];
    }
#pragma unroll
    for (int u = 0; u < kApplyUnroll; ++u) {
      const int bu = b + u * step;
      if (bu >= nb) break;
      const BlockIn& q = in[u];
      const size_t i4 = static_cast<size_t>(bu) * (kBlockElems / 4) +
                        threadIdx.x;
      const bool keep[4] = {fabsf(q.sc.x) >= q.tau, fabsf(q.sc.y) >= q.tau,
                            fabsf(q.sc.z) >= q.tau, fabsf(q.sc.w) >= q.tau};
      const float4 o0 = apply4(q.w, keep, vdt);
      reinterpret_cast<float4*>(s0)[i4] = o0;
      if (err != nullptr) {
        float4 e;
        e.x = q.w.x - o0.x;
        e.y = q.w.y - o0.y;
        e.z = q.w.z - o0.z;
        e.w = q.w.w - o0.w;
        reinterpret_cast<float4*>(err)[i4] = e;
      }
      if (n_streams == 3) {
        reinterpret_cast<float4*>(s1)[i4] = apply4(q.m, keep, vdt);
        reinterpret_cast<float4*>(s2)[i4] = apply4(q.v, keep, vdt);
      }
    }
  }
}

// An empty kernel: its device time is the card's floor for one launch.
__global__ void empty_kernel() {}

template <typename Kernel>
int resident_ctas(Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return sms * (per_sm > 0 ? per_sm : 1);
}

// The count's grid and blocks per CTA over nb blocks: one wave of the
// CTAs the card keeps resident, each over a contiguous chunk.
template <bool kPick>
void count_shape(int nb, int* grid, int* chunk) {
  static const int resident = resident_ctas(packed_count_kernel<kPick>);
  *chunk = std::max(1, (nb + resident - 1) / resident);
  *grid = (nb + *chunk - 1) / *chunk;
}

// The apply's grid over nb blocks (each CTA strides over the rest).
int apply_grid(int nb) {
  static const int resident = resident_ctas(packed_apply_kernel);
  return std::max(1, std::min(nb, resident));
}

}  // namespace

// ws: the wrapper's workspace of at least n_seg * 32 + 1 int32 words, zero
// between calls (each launch leaves it zero).  Without ks (nullptr): out
// receives the (n_seg, 32) float32 counts.  With ks, ns, taus_out and
// counts_out: each segment's picked tau and its count instead (out unused).
extern "C" int repro_packed_hist(const float* x, const int* seg_ids,
                                 const float* edges, int* ws, float* out,
                                 const float* ks, const float* ns,
                                 float* taus_out, float* counts_out, int nb,
                                 int n_seg, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int grid = 0, chunk = 0;
  if (ks == nullptr) {
    count_shape<false>(nb, &grid, &chunk);
    packed_count_kernel<false><<<grid, kThreads, 0, st>>>(
        x, seg_ids, edges, ws, nb, chunk, n_seg, out, ks, ns, taus_out,
        counts_out);
  } else {
    count_shape<true>(nb, &grid, &chunk);
    packed_count_kernel<true><<<grid, kThreads, 0, st>>>(
        x, seg_ids, edges, ws, nb, chunk, n_seg, out, ks, ns, taus_out,
        counts_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// taus: (n_seg,) float32, repro_packed_hist's picked taus.
extern "C" int repro_packed_apply(const float* taus, const int* seg_ids,
                                  const float* score, const float* x0,
                                  const float* x1, const float* x2, float* s0,
                                  float* s1, float* s2, float* err, int nb,
                                  int n_streams, int vdt, void* stream) {
  packed_apply_kernel<<<apply_grid(nb), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      taus, seg_ids, score, x0, x1, x2, s0, s1, s2, err, nb, n_streams, vdt);
  return static_cast<int>(cudaGetLastError());
}

// shape[0..1]: the grid and blocks per CTA of the launches over nb blocks
// of the count (kind 0), the count with the pick (kind 1) or the apply
// (kind 2, its most blocks per CTA).
extern "C" int repro_packed_launch_shape(int nb, int kind, int* shape) {
  if (kind == 0) count_shape<false>(nb, &shape[0], &shape[1]);
  if (kind == 1) count_shape<true>(nb, &shape[0], &shape[1]);
  if (kind == 2) {
    shape[0] = apply_grid(nb);
    shape[1] = (nb + shape[0] - 1) / shape[0];
  }
  return kind >= 0 && kind <= 2 ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// One launch of an empty kernel, the floor chip_smoke.py sets beside the
// packed kernels' times at the CNN's shapes.
extern "C" int repro_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
