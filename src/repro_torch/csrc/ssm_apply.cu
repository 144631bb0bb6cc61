// Fused shared-mask apply with error feedback for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/ssm_apply/ssm_apply.py:
//   * ssm_apply_ef_2d (pl.pallas_call at line 110, body _make_ef_kernel at
//     :59-90)
//
//   keep = |score or dw| >= tau
//   sw, sm, sv = where(keep, cast(dw / dm / dv), 0)
//   err = dw - sw                     (float32 subtract, rounded back)
//
// over one leaf of float32 or bfloat16 (every stream of the call in that
// dtype), cast(x) = x.astype(value_dtype).astype(x.dtype), each rounding to
// nearest even.  tau is a float32 in device memory (select_tau's result),
// so the compress never waits on the host.
//
// What bounds it on the H100: device-memory bytes.  Three or four streams
// in, three or four out, a compare and a select per element.
//
// What the design does about it: one pass.  A single compare of the score
// drives all three selects and the residual, the score defaults to the dw
// stream already in registers (no second read), and a grid-stride loop
// moves 16 bytes per stream, thread and step; the ragged tail and
// misaligned leaves go element by element.  The TPU kernel's wrapper
// padded every leaf to an (8, 1024) tile and sent smaller leaves to the
// jnp oracle; this kernel takes any length.

#include "common.cuh"

namespace {

using repro::cast_value;
using repro::from_f32;
using repro::load_pack;
using repro::Pack;
using repro::store_pack;
using repro::to_f32;

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ void apply1(float tau, int vdt, T s, T w, T m, T v,
                                       T& sw, T& sm, T& sv, T& err) {
  const bool keep = fabsf(to_f32(s)) >= tau;
  const T zero = from_f32<T>(0.0f);
  sw = keep ? from_f32<T>(cast_value(to_f32(w), vdt)) : zero;
  sm = keep ? from_f32<T>(cast_value(to_f32(m), vdt)) : zero;
  sv = keep ? from_f32<T>(cast_value(to_f32(v), vdt)) : zero;
  err = from_f32<T>(__fsub_rn(to_f32(w), to_f32(sw)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_apply_ef_kernel(const float* __restrict__ tau_p,
                    const T* __restrict__ score, const T* __restrict__ w,
                    const T* __restrict__ m, const T* __restrict__ v,
                    T* __restrict__ sw, T* __restrict__ sm,
                    T* __restrict__ sv, T* __restrict__ err, int64_t n,
                    int vdt, int vectorized) {
  const float tau = *tau_p;
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
        apply1(tau, vdt, ps.v[e], pw.v[e], pm.v[e], pv.v[e], ow.v[e], om.v[e],
               ov.v[e], oe.v[e]);
      store_pack(sw, i, ow);
      store_pack(sm, i, om);
      store_pack(sv, i, ov);
      if (err != nullptr) store_pack(err, i, oe);
    }
    head = nv * N;
  }
  for (int64_t i = head + tid; i < n; i += stride) {
    T ow, om, ov, oe;
    const T wi = w[i];
    apply1(tau, vdt, score != nullptr ? score[i] : wi, wi, m[i], v[i], ow, om,
           ov, oe);
    sw[i] = ow;
    sm[i] = om;
    sv[i] = ov;
    if (err != nullptr) err[i] = oe;
  }
}

template <typename T>
int launch(const float* tau, const void* score, const void* w, const void* m,
           const void* v, void* sw, void* sm, void* sv, void* err, int64_t n,
           int vdt, cudaStream_t st) {
  const bool vec = repro::aligned16(score) && repro::aligned16(w) &&
                   repro::aligned16(m) && repro::aligned16(v) &&
                   repro::aligned16(sw) && repro::aligned16(sm) &&
                   repro::aligned16(sv) && repro::aligned16(err);
  const int64_t work = vec ? n / Pack<T>::kN + Pack<T>::kN : n;
  ssm_apply_ef_kernel<T><<<repro::stride_grid(work, kThreads), kThreads, 0,
                           st>>>(
      tau, static_cast<const T*>(score), static_cast<const T*>(w),
      static_cast<const T*>(m), static_cast<const T*>(v), static_cast<T*>(sw),
      static_cast<T*>(sm), static_cast<T*>(sv), static_cast<T*>(err), n, vdt,
      vec ? 1 : 0);
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
    return launch<float>(tau, score, w, m, v, sw, sm, sv, err, n, vdt, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(tau, score, w, m, v, sw, sm, sv, err, n, vdt,
                                 st);
  return static_cast<int>(cudaErrorInvalidValue);
}
