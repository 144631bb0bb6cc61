// Fused Adam update for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/fused_adam/fused_adam.py:
//   * fused_adam_2d (pl.pallas_call at line 56, body _kernel at :28-40)
//
//   m' = b1*m + (1-b1)*g;  v' = b2*v + (1-b2)*g*g;
//   w' = w - lr * m' * rsqrt(v' + eps)
//
// in float32 from a leaf of float32 or bfloat16 (w, g, m, v of one dtype),
// each result rounded to the leaf's dtype (nearest even).  The scalars
// (lr, b1, b2, eps) arrive as a float32[4] in device memory, bias
// correction already folded into lr and eps by the wrapper, so a step never
// waits on the host.  1-b1 and 1-b2 are formed here in float32 from the
// float32 scalars, as the Pallas kernel does.
//
// What bounds it on the H100: device-memory bytes.  Four streams in, three
// out (14 bytes per bfloat16 element, 28 per float32) against about 12
// float32 operations per element: under one operation per byte, far below
// the ~20 float32 operations per byte the card can afford.
//
// What the design does about it: one pass over the leaf.  A grid-stride
// loop moves 16 bytes per stream and thread and step (8 bfloat16 or 4
// float32 elements), so a warp reads 512 contiguous bytes of each stream
// per load; the ragged tail, and a leaf whose pointers are not 16-byte
// aligned, go element by element.  No padding: the TPU kernel worked on
// (8, 1024) tiles, so its wrapper padded every leaf and sent leaves below
// one tile to the jnp oracle; this kernel takes any length, norm scales
// included.
//
// Rounding: every product and sum is an explicit round-to-nearest intrinsic
// (__fmul_rn / __fadd_rn / __fsub_rn), which nvcc never contracts into an
// FMA, so the arithmetic is the plain PyTorch version's op for op.  The
// root is rsqrtf, the function PyTorch's CUDA torch.rsqrt calls.

#include "common.cuh"

namespace {

using repro::from_f32;
using repro::load_pack;
using repro::Pack;
using repro::store_pack;
using repro::to_f32;

constexpr int kThreads = 256;

struct Scalars {
  float lr, b1, omb1, b2, omb2, eps;
};

template <typename T>
__device__ __forceinline__ void adam1(const Scalars& s, T w, T g, T m, T v,
                                      T& wo, T& mo, T& vo) {
  const float gf = to_f32(g);
  const float mf = __fadd_rn(__fmul_rn(s.b1, to_f32(m)), __fmul_rn(s.omb1, gf));
  const float vf = __fadd_rn(__fmul_rn(s.b2, to_f32(v)),
                             __fmul_rn(__fmul_rn(s.omb2, gf), gf));
  const float upd = __fmul_rn(mf, rsqrtf(__fadd_rn(vf, s.eps)));
  wo = from_f32<T>(__fsub_rn(to_f32(w), __fmul_rn(s.lr, upd)));
  mo = from_f32<T>(mf);
  vo = from_f32<T>(vf);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(const float* __restrict__ scalars, const T* __restrict__ w,
                  const T* __restrict__ g, const T* __restrict__ m,
                  const T* __restrict__ v, T* __restrict__ wo,
                  T* __restrict__ mo, T* __restrict__ vo, int64_t n,
                  int vectorized) {
  Scalars s;
  s.lr = scalars[0];
  s.b1 = scalars[1];
  s.b2 = scalars[2];
  s.eps = scalars[3];
  s.omb1 = __fsub_rn(1.0f, s.b1);
  s.omb2 = __fsub_rn(1.0f, s.b2);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t head = 0;
  if (vectorized) {
    constexpr int N = Pack<T>::kN;
    const int64_t nv = n / N;
    for (int64_t i = tid; i < nv; i += stride) {
      const Pack<T> pw = load_pack(w, i), pg = load_pack(g, i);
      const Pack<T> pm = load_pack(m, i), pv = load_pack(v, i);
      Pack<T> ow, om, ov;
#pragma unroll
      for (int e = 0; e < N; ++e)
        adam1(s, pw.v[e], pg.v[e], pm.v[e], pv.v[e], ow.v[e], om.v[e], ov.v[e]);
      store_pack(wo, i, ow);
      store_pack(mo, i, om);
      store_pack(vo, i, ov);
    }
    head = nv * N;
  }
  for (int64_t i = head + tid; i < n; i += stride)
    adam1(s, w[i], g[i], m[i], v[i], wo[i], mo[i], vo[i]);
}

template <typename T>
int launch(const float* scalars, const void* w, const void* g, const void* m,
           const void* v, void* wo, void* mo, void* vo, int64_t n,
           cudaStream_t stream) {
  const bool vec = repro::aligned16(w) && repro::aligned16(g) &&
                   repro::aligned16(m) && repro::aligned16(v) &&
                   repro::aligned16(wo) && repro::aligned16(mo) &&
                   repro::aligned16(vo);
  const int64_t work = vec ? n / Pack<T>::kN + Pack<T>::kN : n;
  fused_adam_kernel<T><<<repro::stride_grid(work, kThreads), kThreads, 0,
                         stream>>>(
      scalars, static_cast<const T*>(w), static_cast<const T*>(g),
      static_cast<const T*>(m), static_cast<const T*>(v), static_cast<T*>(wo),
      static_cast<T*>(mo), static_cast<T*>(vo), n, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (all of w, g, m, v and the outputs).
extern "C" int repro_fused_adam(const float* scalars, const void* w,
                                const void* g, const void* m, const void* v,
                                void* wo, void* mo, void* vo, int64_t n,
                                int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(scalars, w, g, m, v, wo, mo, vo, n, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(scalars, w, g, m, v, wo, mo, vo, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
