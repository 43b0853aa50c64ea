// bitslice_lane_groups: the 32x32 bit transpose of every aligned group of
// 32 words, which takes compact GF(2^32) words to the packed bit-sliced
// layout of the GF(2^32) additive NTT and back (it is its own inverse).
//
// Replaces binius_ntt_tpu/ntt/pallas_fused32.py::bitslice_lane_groups_pallas
// (pallas_call at :157; the same function as additive._bitslice_lane_groups
// and as layout.bitslicing.transpose32 on the (R, 4, 32) view): word i of a
// group is row i of the bit matrix, little-endian, so after the transpose
// bit j of word p is bit p of input word j.
//
// Bound on this card: device memory.  Every word is read once and written
// once (8 bytes) for about 25 integer ops, far below the card's ops-per-byte
// balance, so the kernel moves the bytes once and nothing else.
//
// Design: one warp per group, word i in lane i, so a warp's load and store
// are each one coalesced 128-byte line.  The Hacker's Delight ladder pairs
// words i and i ^ j for j = 16, 8, 4, 2, 1; each lane gets its partner's
// word with __shfl_xor_sync and applies its half of the swap.  Out of place:
// the input (the caller's compact words) is left as it is.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    bitslice_lane_groups_kernel(const uint32_t* __restrict__ src,
                                uint32_t* __restrict__ dst,
                                long long n_words) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  // n_words is a multiple of 32, so a warp is wholly in range or wholly out
  if (i >= n_words) return;
  const int lane = threadIdx.x & 31;
  uint32_t x = src[i];
  uint32_t m = 0x0000FFFFu;
#pragma unroll
  for (int j = 16; j != 0; j >>= 1) {
    const uint32_t y = __shfl_xor_sync(0xFFFFFFFFu, x, j);
    if (lane & j)
      x ^= ((y >> j) ^ x) & m;          // the upper word of the pair
    else
      x ^= (((x >> j) ^ y) & m) << j;   // the lower word
    m ^= m << (j >> 1);
  }
  dst[i] = x;
}

}  // namespace

// src, dst: n_words uint32 words (a multiple of 32), distinct buffers.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int bntt_bitslice_lane_groups(const void* src, void* dst,
                                         long long n_words, void* stream) {
  if (n_words <= 0 || n_words % 32 != 0 || src == dst)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n_words + THREADS - 1) / THREADS;
  bitslice_lane_groups_kernel<<<(unsigned)blocks, THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), static_cast<uint32_t*>(dst),
      n_words);
  return static_cast<int>(cudaGetLastError());
}
