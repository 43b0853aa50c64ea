// bitslice128: the GF(2^128) bit-slicing layout transform and its inverse,
// layout/bitslicing.py's bitslice_transpose and bitslice_untranspose on
// rows of 128 words.
//
// A compact row holds 32 elements of four words, element-major (element j
// at words 4 j .. 4 j + 3, word 0 least significant); its sliced form holds
// 128 bit-planes: bit j of sliced word 32 q + p is bit p of element j's
// word q.  So a row is four 32x32 bit transposes, one of the elements'
// words q each, interleaved (32, 4) -> (4, 32).
//
// Replaces no Pallas kernel: the JAX package's layout is jnp
// (binius_ntt_tpu/layout/bitslicing.py), and the port ran it as torch ops,
// five ladder levels of shifts, XORs, ANDs and a stack, each writing an
// array-sized temporary.  Added because that layout was 71% of the compact
// AdditiveNTT128.apply on the H100 (35.5 of 50 ms at 2^24, rate 2: 6.5 ms
// in, 29 ms out).
//
// Bound on this card: device memory.  Every word is read once and written
// once (8 bytes) for ten integer operations and five shuffles a word
// (transpose32::lanes1: two operations and one shuffle a register and a
// stage): at the memory rate, a quarter of the card's int32 rate and of
// its shuffle rate.  Keeping the memory busy takes ~15-20 KB in flight an SM
// (Little's law at 3.35 TB/s and ~0.7 us).
//
// Design: a warp a row.  Transpose: lane j loads element j's four words
// (one 16-byte load), so register q holds word j of group q, and
// transpose32::lanes1 runs all five ladder stages across lanes on the four
// registers; lane p then holds sliced word 32 q + p in register q: four
// coalesced 128-byte stores of 4 bytes a lane.  Untranspose: the same in
// reverse, four coalesced 4-byte loads and one 16-byte store.  A warp loads
// TILES rows before it transposes any (64 bytes in flight a thread, 8
// blocks of 256 threads an SM), and the blocks, as many as fit on the card
// at once, walk the rows grid-stride.  Loads and stores are streaming
// (__ldcs, __stcs: each byte is touched once).  Row offsets are 64-bit:
// the capacity sizes pass 2^31 words.
//
// In place: the untranspose reads each of a warp's rows whole into
// registers before it writes any of it, and no other warp touches the row,
// so src == dst is allowed (its pointers are not __restrict__); the
// apply's output is untransposed in its own buffer.  The transpose is out
// of place: its input is the caller's.
#include <cuda_runtime.h>

#include <cstdint>

#include "transpose32.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILES = 4;                // rows a warp loads at once

// compact rows -> sliced rows
__global__ void __launch_bounds__(THREADS)
    bitslice128_transpose_kernel(const uint4* __restrict__ src,
                                 uint32_t* __restrict__ dst, long long rows) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  const long long stride = static_cast<long long>(gridDim.x) * WARPS * TILES;
  for (long long r0 = warp * TILES; r0 < rows; r0 += stride) {
    uint4 v[TILES];
#pragma unroll
    for (int u = 0; u < TILES; ++u)
      if (r0 + u < rows) v[u] = __ldcs(&src[(r0 + u) * 32 + lane]);
#pragma unroll
    for (int u = 0; u < TILES; ++u) {
      if (r0 + u >= rows) break;        // the same for the whole warp
      uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      transpose32::lanes1(w);
      uint32_t* row = dst + (r0 + u) * 128 + lane;
#pragma unroll
      for (int q = 0; q < 4; ++q) __stcs(&row[32 * q], w[q]);
    }
  }
}

// sliced rows -> compact rows; src may be dst
__global__ void __launch_bounds__(THREADS)
    bitslice128_untranspose_kernel(const uint32_t* src, uint4* dst,
                                   long long rows) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  const long long stride = static_cast<long long>(gridDim.x) * WARPS * TILES;
  for (long long r0 = warp * TILES; r0 < rows; r0 += stride) {
    uint32_t v[TILES][4];
#pragma unroll
    for (int u = 0; u < TILES; ++u)
      if (r0 + u < rows) {
        const uint32_t* row = src + (r0 + u) * 128 + lane;
#pragma unroll
        for (int q = 0; q < 4; ++q) v[u][q] = __ldcs(&row[32 * q]);
      }
#pragma unroll
    for (int u = 0; u < TILES; ++u) {
      if (r0 + u >= rows) break;        // the same for the whole warp
      transpose32::lanes1(v[u]);
      __stcs(&dst[(r0 + u) * 32 + lane],
             make_uint4(v[u][0], v[u][1], v[u][2], v[u][3]));
    }
  }
}

bool bad_rows(const void* src, const void* dst, long long n_words) {
  return n_words <= 0 || n_words % 128 != 0 ||
         reinterpret_cast<uintptr_t>(src) % 16 ||
         reinterpret_cast<uintptr_t>(dst) % 16;
}

// the two buffers of n_words words share a byte
bool overlap(const void* a, const void* b, long long n_words) {
  const uintptr_t x = reinterpret_cast<uintptr_t>(a);
  const uintptr_t y = reinterpret_cast<uintptr_t>(b);
  const uintptr_t n = static_cast<uintptr_t>(n_words) * 4;
  return x < y + n && y < x + n;
}

template <typename Src, typename Dst>
int launch(void (*kernel)(Src, Dst, long long), const void* src, void* dst,
           long long n_words, void* stream) {
  const long long rows = n_words / 128;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long needed = (rows + WARPS * TILES - 1) / (WARPS * TILES);
  const long long resident = static_cast<long long>(sms) * per_sm;
  const long long blocks = needed < resident ? needed : resident;
  kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<Src>(src), static_cast<Dst>(dst), rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src, dst: n_words uint32 words (whole 128-word rows), 16-byte aligned,
// sharing no byte.  Returns the first CUDA error of the launch (0 =
// launched).
extern "C" int bntt_bitslice128_transpose(const void* src, void* dst,
                                          long long n_words, void* stream) {
  if (bad_rows(src, dst, n_words) || overlap(src, dst, n_words))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(bitslice128_transpose_kernel, src, dst, n_words, stream);
}

// As bntt_bitslice128_transpose, but dst may also be src (in place).
extern "C" int bntt_bitslice128_untranspose(const void* src, void* dst,
                                            long long n_words, void* stream) {
  if (bad_rows(src, dst, n_words) ||
      (src != dst && overlap(src, dst, n_words)))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(bitslice128_untranspose_kernel, src, dst, n_words, stream);
}
