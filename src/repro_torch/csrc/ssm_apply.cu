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
// Both take one leaf of float32 or bfloat16 (every stream of the call in
// that dtype).  tau is a float32 in device memory (select_tau's result),
// so the compress never waits on the host.
//
// What bounds them on the H100: device-memory bytes.  Three or four streams
// in, three or four out, a compare and a select per element.
//
// What the design does about it: one pass.  A single compare of the score
// drives all three selects and the residual, the score defaults to the dw
// stream already in registers (no second read), and a grid-stride loop
// moves 16 bytes per stream, thread and step; the ragged tail and
// misaligned leaves go element by element.  The TPU kernels' wrappers
// padded every leaf to an (8, 1024) tile and sent smaller leaves to the
// jnp oracle; these kernels take any length.

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
template <typename T, bool kEF>
__device__ __forceinline__ void apply1(float tau, int vdt, T s, T w, T m, T v,
                                       T& sw, T& sm, T& sv, T& err) {
  const bool keep = fabsf(to_f32(s)) >= tau;
  const T zero = from_f32<T>(0.0f);
  if constexpr (kEF) {
    sw = keep ? from_f32<T>(cast_value(to_f32(w), vdt)) : zero;
    sm = keep ? from_f32<T>(cast_value(to_f32(m), vdt)) : zero;
    sv = keep ? from_f32<T>(cast_value(to_f32(v), vdt)) : zero;
    err = from_f32<T>(__fsub_rn(to_f32(w), to_f32(sw)));
  } else {
    sw = keep ? w : zero;
    sm = keep ? m : zero;
    sv = keep ? v : zero;
  }
}

// The grid-stride loop both kernels run: 16-byte packs while every pointer
// is aligned, then element by element.  score and err may be null.
template <typename T, bool kEF>
__device__ __forceinline__ void apply_loop(
    float tau, const T* __restrict__ score, const T* __restrict__ w,
    const T* __restrict__ m, const T* __restrict__ v, T* __restrict__ sw,
    T* __restrict__ sm, T* __restrict__ sv, T* __restrict__ err, int64_t n,
    int vdt, int vectorized) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t head = 0;
  if (vectorized) {
    constexpr int N = Pack<T>::kN;
    const int64_t nv = n / N;
    for (int64_t i = tid; i < nv; i += stride) {
      const Pack<T> pw = load_pack(w, i);
      const Pack<T> ps = score != nullptr ? load_pack(score, i) : pw;
      const Pack<T> pm = load_pack(m, i), pv = load_pack(v, i);
      Pack<T> ow, om, ov, oe;
#pragma unroll
      for (int e = 0; e < N; ++e)
        apply1<T, kEF>(tau, vdt, ps.v[e], pw.v[e], pm.v[e], pv.v[e], ow.v[e],
                       om.v[e], ov.v[e], oe.v[e]);
      store_pack(sw, i, ow);
      store_pack(sm, i, om);
      store_pack(sv, i, ov);
      if (kEF && err != nullptr) store_pack(err, i, oe);
    }
    head = nv * N;
  }
  for (int64_t i = head + tid; i < n; i += stride) {
    T ow, om, ov, oe;
    const T wi = w[i];
    apply1<T, kEF>(tau, vdt, score != nullptr ? score[i] : wi, wi, m[i], v[i],
                   ow, om, ov, oe);
    sw[i] = ow;
    sm[i] = om;
    sv[i] = ov;
    if (kEF && err != nullptr) err[i] = oe;
  }
}

// Two entry points, so that a profile tells the two apart.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_apply_ef_kernel(const float* __restrict__ tau_p,
                    const T* __restrict__ score, const T* __restrict__ w,
                    const T* __restrict__ m, const T* __restrict__ v,
                    T* __restrict__ sw, T* __restrict__ sm,
                    T* __restrict__ sv, T* __restrict__ err, int64_t n,
                    int vdt, int vectorized) {
  apply_loop<T, true>(*tau_p, score, w, m, v, sw, sm, sv, err, n, vdt,
                      vectorized);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_apply_kernel(const float* __restrict__ tau_p, const T* __restrict__ w,
                 const T* __restrict__ m, const T* __restrict__ v,
                 T* __restrict__ sw, T* __restrict__ sm, T* __restrict__ sv,
                 int64_t n, int vectorized) {
  apply_loop<T, false>(*tau_p, nullptr, w, m, v, sw, sm, sv, nullptr, n, 0,
                       vectorized);
}

template <typename T, bool kEF>
int launch(const float* tau, const void* score, const void* w, const void* m,
           const void* v, void* sw, void* sm, void* sv, void* err, int64_t n,
           int vdt, cudaStream_t st) {
  const bool vec = repro::aligned16(score) && repro::aligned16(w) &&
                   repro::aligned16(m) && repro::aligned16(v) &&
                   repro::aligned16(sw) && repro::aligned16(sm) &&
                   repro::aligned16(sv) && repro::aligned16(err);
  const int64_t work = vec ? n / Pack<T>::kN + Pack<T>::kN : n;
  const int grid = repro::stride_grid(work, kThreads);
  const auto* tw = static_cast<const T*>(w);
  const auto* tm = static_cast<const T*>(m);
  const auto* tv = static_cast<const T*>(v);
  if constexpr (kEF)
    ssm_apply_ef_kernel<T><<<grid, kThreads, 0, st>>>(
        tau, static_cast<const T*>(score), tw, tm, tv, static_cast<T*>(sw),
        static_cast<T*>(sm), static_cast<T*>(sv), static_cast<T*>(err), n,
        vdt, vec ? 1 : 0);
  else
    ssm_apply_kernel<T><<<grid, kThreads, 0, st>>>(
        tau, tw, tm, tv, static_cast<T*>(sw), static_cast<T*>(sm),
        static_cast<T*>(sv), n, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; vdt: 0 none, 1 bfloat16, 2 float16.
// score and err may be null (score = dw; no residual).
extern "C" int repro_ssm_apply_ef(const float* tau, const void* score,
                                  const void* w, const void* m, const void* v,
                                  void* sw, void* sm, void* sv, void* err,
                                  int64_t n, int dtype, int vdt,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, true>(tau, score, w, m, v, sw, sm, sv, err, n, vdt,
                               st);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(tau, score, w, m, v, sw, sm, sv, err,
                                       n, vdt, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 float32, 1 bfloat16 (all six streams).
extern "C" int repro_ssm_apply(const float* tau, const void* w, const void* m,
                               const void* v, void* sw, void* sm, void* sv,
                               int64_t n, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, false>(tau, nullptr, w, m, v, sw, sm, sv, nullptr, n,
                                0, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(tau, nullptr, w, m, v, sw, sm, sv,
                                        nullptr, n, 0, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
