// Wire-format word packing for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/wirepack/wirepack.py:
//   * pack_words_2d   (pl.pallas_call at line 92, body _make_pack_kernel)
//   * unpack_words_2d (pl.pallas_call at line 111, body _make_unpack_kernel)
//
// Format: an (R, 128) int32 code buffer, R % 32 == 0, codes in [0, 2^b),
// b in {1, 2, 4, 8}, T = 32 / b.  Each (32, 128) block i becomes b word
// rows:  word[i*b + q, c] = sum_t code[i*32 + q*T + t, c] << (t*b)
// (uint32, wrapping).  This is lane-major within a block: the bits of one
// word run DOWN a column.  A warp ballot over 32 consecutive elements would
// give the flat order of core/wire.py:pack_bits_1d instead, which is a
// different wire; the bytes here must equal the JAX package's.
//
// What bounds these kernels on the H100: device-memory bytes (4 bytes read
// per code, b/8 bytes written; a handful of integer operations each).
//
// What the design does about it: one thread per word.  Thread (row, c)
// walks the T codes of column c with a stride of 128 elements, so the 32
// threads of a warp (32 neighbouring columns) read 128 contiguous bytes on
// every step and write 128 contiguous bytes of words.  Unpacking is the
// mirror image: one thread reads one word and writes its T codes down the
// column.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kCodeRows = 32;
constexpr int kThreads = 256;

template <int BITS>
__global__ void __launch_bounds__(kThreads)
pack_words_kernel(const int32_t* __restrict__ codes,
                  uint32_t* __restrict__ words, int64_t n_words) {
  constexpr int T = 32 / BITS;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (tid >= n_words) return;
  const int64_t row = tid / kLanes;
  const int c = static_cast<int>(tid % kLanes);
  const int64_t i = row / BITS;
  const int q = static_cast<int>(row % BITS);
  const int32_t* col = codes + (i * kCodeRows + q * T) * kLanes + c;
  uint32_t w = 0;
#pragma unroll
  for (int t = 0; t < T; ++t)
    w += static_cast<uint32_t>(col[t * kLanes]) << (t * BITS);
  words[tid] = w;
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
unpack_words_kernel(const uint32_t* __restrict__ words,
                    int32_t* __restrict__ codes, int64_t n_words) {
  constexpr int T = 32 / BITS;
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (tid >= n_words) return;
  const int64_t row = tid / kLanes;
  const int c = static_cast<int>(tid % kLanes);
  const int64_t i = row / BITS;
  const int q = static_cast<int>(row % BITS);
  const uint32_t w = words[tid];
  int32_t* col = codes + (i * kCodeRows + q * T) * kLanes + c;
#pragma unroll
  for (int t = 0; t < T; ++t)
    col[t * kLanes] = static_cast<int32_t>((w >> (t * BITS)) & kMask);
}

int grid_for(int64_t n_words) {
  return static_cast<int>((n_words + kThreads - 1) / kThreads);
}

}  // namespace

// Returns cudaErrorInvalidValue for an unsupported code width.
extern "C" int repro_pack_words(const int32_t* codes, uint32_t* words,
                                int64_t n_words, int bits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = grid_for(n_words);
  switch (bits) {
    case 1: pack_words_kernel<1><<<grid, kThreads, 0, s>>>(codes, words, n_words); break;
    case 2: pack_words_kernel<2><<<grid, kThreads, 0, s>>>(codes, words, n_words); break;
    case 4: pack_words_kernel<4><<<grid, kThreads, 0, s>>>(codes, words, n_words); break;
    case 8: pack_words_kernel<8><<<grid, kThreads, 0, s>>>(codes, words, n_words); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_unpack_words(const uint32_t* words, int32_t* codes,
                                  int64_t n_words, int bits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = grid_for(n_words);
  switch (bits) {
    case 1: unpack_words_kernel<1><<<grid, kThreads, 0, s>>>(words, codes, n_words); break;
    case 2: unpack_words_kernel<2><<<grid, kThreads, 0, s>>>(words, codes, n_words); break;
    case 4: unpack_words_kernel<4><<<grid, kThreads, 0, s>>>(words, codes, n_words); break;
    case 8: unpack_words_kernel<8><<<grid, kThreads, 0, s>>>(words, codes, n_words); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
