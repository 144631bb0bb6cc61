// Shared-mask applies for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/ssm_apply/ssm_apply.py:
//   * ssm_apply_ef_2d (pl.pallas_call at line 110, body _make_ef_kernel at
//     :59-90), the fused apply with error feedback:
//
//       keep = |score or dw| >= tau
//       sw, sm, sv = where(keep, cast(dw / dm / dv), 0)
//       err = dw - sw                 (float32 subtract, rounded back)
//
//     cast(x) = x.astype(value_dtype).astype(x.dtype), each rounding to
//     nearest even;
//   * ssm_apply_2d (pl.pallas_call at line 46, body _kernel at :32-38), the
//     3-in/3-out apply without cast, residual or score:
//
//       keep = |dw| >= tau;  sw, sm, sv = where(keep, dw / dm / dv, 0)
//
//     kept elements pass through as their bits.
//
// ssm_apply_ef takes one leaf of float32 or bfloat16 (dw, dm, dv and the
// outputs in that dtype) and a score of float32 or bfloat16 (the
// fairness_top rule's float32 scores beside bfloat16 streams, as the TPU
// kernel takes a score of any type); ssm_apply takes dw, dm and dv each in float32 or
// bfloat16 (8 instantiations), each output in its input's dtype and zero
// in that dtype, as the JAX kernel does.  tau is a float32 in device
// memory (select_tau's result), so the compress never waits on the host.
//
// What bounds them on the H100: device-memory bytes.  Three or four streams
// in, three or four out, a compare and a select per element.
//
// What the design does about it: one pass.  A single compare of the score
// drives all three selects and the residual, the score defaults to the dw
// stream already in registers (no second read), and a grid-stride loop
// moves 16 bytes per stream, thread and step (with streams of two dtypes,
// the score's included, 4 elements: 16 bytes of each float32 stream, 8 of
// each bfloat16 one);
// the ragged tail and misaligned leaves go element by element.  The TPU
// kernels' wrappers padded every leaf to an (8, 1024) tile and sent
// smaller leaves to the jnp oracle; these kernels take any length.

#include "common.cuh"

namespace {

using repro::cast_value;
using repro::from_f32;
using repro::load_pack;
using repro::Pack;
using repro::store_pack;
using repro::to_f32;

constexpr int kThreads = 256;

// One element.  kEF: the fused apply (value_dtype round trip, residual);
// otherwise the plain apply, kept elements passing through as their bits.
// s: the score, widened to float32.
template <typename Tw, typename Tm, typename Tv, bool kEF>
__device__ __forceinline__ void apply1(float tau, int vdt, float s, Tw w,
                                       Tm m, Tv v, Tw& sw, Tm& sm, Tv& sv,
                                       Tw& err) {
  const bool keep = fabsf(s) >= tau;
  if constexpr (kEF) {
    sw = keep ? from_f32<Tw>(cast_value(to_f32(w), vdt)) : from_f32<Tw>(0.0f);
    sm = keep ? from_f32<Tm>(cast_value(to_f32(m), vdt)) : from_f32<Tm>(0.0f);
    sv = keep ? from_f32<Tv>(cast_value(to_f32(v), vdt)) : from_f32<Tv>(0.0f);
    err = from_f32<Tw>(__fsub_rn(to_f32(w), to_f32(sw)));
  } else {
    sw = keep ? w : from_f32<Tw>(0.0f);
    sm = keep ? m : from_f32<Tm>(0.0f);
    sv = keep ? v : from_f32<Tv>(0.0f);
  }
}

template <int A, int B>
__host__ __device__ constexpr int min_c() { return A < B ? A : B; }

// Elements per vector step: 16 bytes of the widest stream's type.
template <typename Tw, typename Tm, typename Tv, typename Ts>
__host__ __device__ constexpr int vec_n() {
  return min_c<min_c<Pack<Tw>::kN, Pack<Ts>::kN>(),
               min_c<Pack<Tm>::kN, Pack<Tv>::kN>()>();
}

// The grid-stride loop both kernels run: packs of vec_n elements while
// every pointer is aligned, then element by element.  score (of type Ts)
// and err may be null.
template <typename Tw, typename Tm, typename Tv, typename Ts, bool kEF>
__device__ __forceinline__ void apply_loop(
    float tau, const Ts* __restrict__ score, const Tw* __restrict__ w,
    const Tm* __restrict__ m, const Tv* __restrict__ v, Tw* __restrict__ sw,
    Tm* __restrict__ sm, Tv* __restrict__ sv, Tw* __restrict__ err, int64_t n,
    int vdt, int vectorized) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t head = 0;
  if (vectorized) {
    constexpr int N = vec_n<Tw, Tm, Tv, Ts>();
    const int64_t nv = n / N;
    for (int64_t i = tid; i < nv; i += stride) {
      const Pack<Tw, N> pw = load_pack<Tw, N>(w, i);
      Pack<Ts, N> ps{};
      if (score != nullptr) ps = load_pack<Ts, N>(score, i);
      const Pack<Tm, N> pm = load_pack<Tm, N>(m, i);
      const Pack<Tv, N> pv = load_pack<Tv, N>(v, i);
      Pack<Tw, N> ow, oe;
      Pack<Tm, N> om;
      Pack<Tv, N> ov;
#pragma unroll
      for (int e = 0; e < N; ++e)
        apply1<Tw, Tm, Tv, kEF>(
            tau, vdt, score != nullptr ? to_f32(ps.v[e]) : to_f32(pw.v[e]),
            pw.v[e], pm.v[e], pv.v[e], ow.v[e], om.v[e], ov.v[e], oe.v[e]);
      store_pack(sw, i, ow);
      store_pack(sm, i, om);
      store_pack(sv, i, ov);
      if (kEF && err != nullptr) store_pack(err, i, oe);
    }
    head = nv * N;
  }
  for (int64_t i = head + tid; i < n; i += stride) {
    Tw ow, oe;
    Tm om;
    Tv ov;
    const Tw wi = w[i];
    apply1<Tw, Tm, Tv, kEF>(tau, vdt,
                            score != nullptr ? to_f32(score[i]) : to_f32(wi),
                            wi, m[i], v[i], ow, om, ov, oe);
    sw[i] = ow;
    sm[i] = om;
    sv[i] = ov;
    if (kEF && err != nullptr) err[i] = oe;
  }
}

// Two entry points, so that a profile tells the two apart.
template <typename T, typename Ts>
__global__ void __launch_bounds__(kThreads)
ssm_apply_ef_kernel(const float* __restrict__ tau_p,
                    const Ts* __restrict__ score, const T* __restrict__ w,
                    const T* __restrict__ m, const T* __restrict__ v,
                    T* __restrict__ sw, T* __restrict__ sm,
                    T* __restrict__ sv, T* __restrict__ err, int64_t n,
                    int vdt, int vectorized) {
  apply_loop<T, T, T, Ts, true>(*tau_p, score, w, m, v, sw, sm, sv, err, n,
                                vdt, vectorized);
}

template <typename Tw, typename Tm, typename Tv>
__global__ void __launch_bounds__(kThreads)
ssm_apply_kernel(const float* __restrict__ tau_p, const Tw* __restrict__ w,
                 const Tm* __restrict__ m, const Tv* __restrict__ v,
                 Tw* __restrict__ sw, Tm* __restrict__ sm, Tv* __restrict__ sv,
                 int64_t n, int vectorized) {
  apply_loop<Tw, Tm, Tv, Tw, false>(*tau_p, nullptr, w, m, v, sw, sm, sv,
                                    nullptr, n, 0, vectorized);
}

// A launch's pointers and sizes (score and err null where not given).
struct Args {
  const float* tau;
  const void *score, *w, *m, *v;
  void *sw, *sm, *sv, *err;
  int64_t n;
  int vdt;
  cudaStream_t st;
};

template <typename Tw, typename Tm, typename Tv, typename Ts, bool kEF>
int launch(const Args& a) {
  const bool vec = repro::aligned16(a.score) && repro::aligned16(a.w) &&
                   repro::aligned16(a.m) && repro::aligned16(a.v) &&
                   repro::aligned16(a.sw) && repro::aligned16(a.sm) &&
                   repro::aligned16(a.sv) && repro::aligned16(a.err);
  constexpr int N = vec_n<Tw, Tm, Tv, Ts>();
  const int64_t work = vec ? a.n / N + N : a.n;
  const int grid = repro::stride_grid(work, kThreads);
  const auto* tw = static_cast<const Tw*>(a.w);
  const auto* tm = static_cast<const Tm*>(a.m);
  const auto* tv = static_cast<const Tv*>(a.v);
  if constexpr (kEF)
    ssm_apply_ef_kernel<Tw, Ts><<<grid, kThreads, 0, a.st>>>(
        a.tau, static_cast<const Ts*>(a.score), tw, tm, tv,
        static_cast<Tw*>(a.sw), static_cast<Tm*>(a.sm),
        static_cast<Tv*>(a.sv), static_cast<Tw*>(a.err), a.n, a.vdt,
        vec ? 1 : 0);
  else
    ssm_apply_kernel<Tw, Tm, Tv><<<grid, kThreads, 0, a.st>>>(
        a.tau, tw, tm, tv, static_cast<Tw*>(a.sw), static_cast<Tm*>(a.sm),
        static_cast<Tv*>(a.sv), a.n, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// Calls f with a value of the element type of dtype code 0 (float32) or 1
// (bfloat16).
template <typename F>
int with_type(int dtype, F&& f) {
  if (dtype == 0) return f(float{});
  if (dtype == 1) return f(__nv_bfloat16{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype (dw, dm, dv), score_dtype: 0 float32, 1 bfloat16; vdt: 0 none, 1
// bfloat16, 2 float16.  score and err may be null (score = dw, and
// score_dtype is then dtype; no residual).
extern "C" int repro_ssm_apply_ef(const float* tau, const void* score,
                                  const void* w, const void* m, const void* v,
                                  void* sw, void* sm, void* sv, void* err,
                                  int64_t n, int dtype, int score_dtype,
                                  int vdt, void* stream) {
  const Args a{tau, score, w, m, v, sw, sm, sv, err, n, vdt,
               static_cast<cudaStream_t>(stream)};
  return with_type(dtype, [&](auto t) {
    return with_type(score_dtype, [&](auto ts) {
      using T = decltype(t);
      return launch<T, T, T, decltype(ts), true>(a);
    });
  });
}

// dtype_w, dtype_m, dtype_v: 0 float32, 1 bfloat16, one per stream (each
// output in its input's dtype).
extern "C" int repro_ssm_apply(const float* tau, const void* w, const void* m,
                               const void* v, void* sw, void* sm, void* sv,
                               int64_t n, int dtype_w, int dtype_m,
                               int dtype_v, void* stream) {
  const Args a{tau, nullptr, w, m, v, sw, sm, sv, nullptr, n, 0,
               static_cast<cudaStream_t>(stream)};
  return with_type(dtype_w, [&](auto tw) {
    return with_type(dtype_m, [&](auto tm) {
      return with_type(dtype_v, [&](auto tv) {
        return launch<decltype(tw), decltype(tm), decltype(tv),
                      decltype(tw), false>(a);
      });
    });
  });
}
