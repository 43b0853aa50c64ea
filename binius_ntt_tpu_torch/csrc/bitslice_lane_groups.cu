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
// balance, so the kernel moves the bytes once and nothing else.  Keeping
// the memory busy takes ~15-20 KB in flight an SM (Little's law at 3.35
// TB/s and ~0.7 us); one 4-byte load a thread, 2048 threads an SM, leaves
// 8 KB, about half the rate.
//
// Design: a warp's tile is one (128-word) row, four groups: one 16-byte
// load a lane, lane l holding words 4 (l % 8) .. 4 (l % 8) + 3 of group
// l / 8, and csrc/transpose32.cuh's lanes4 ladder on those four registers
// (three shuffle stages, two in-thread ones).  A warp loads TILES rows
// before it transposes any (64 bytes in flight a thread), and the blocks,
// as many as fit on the card at once, walk the rows grid-stride.  Loads
// and stores are streaming (__ldcs, __stcs: each byte is touched once),
// 3% faster than plain ones.  Out of place: the input (the caller's
// compact words) is left as it is.
#include <cuda_runtime.h>

#include <cstdint>

#include "transpose32.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILES = 4;                // rows a warp loads at once

__global__ void __launch_bounds__(THREADS)
    bitslice_lane_groups_kernel(const uint4* __restrict__ src,
                                uint4* __restrict__ dst, long long rows) {
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
      transpose32::lanes4(w);
      __stcs(&dst[(r0 + u) * 32 + lane],
             make_uint4(w[0], w[1], w[2], w[3]));
    }
  }
}

}  // namespace

// src, dst: n_words uint32 words (whole 128-word rows), distinct 16-byte
// aligned buffers.  Returns the first CUDA error of the launch (0 =
// launched).
extern "C" int bntt_bitslice_lane_groups(const void* src, void* dst,
                                         long long n_words, void* stream) {
  if (n_words <= 0 || n_words % 128 != 0 || src == dst ||
      reinterpret_cast<uintptr_t>(src) % 16 ||
      reinterpret_cast<uintptr_t>(dst) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = n_words / 128;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bitslice_lane_groups_kernel, THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long needed = (rows + WARPS * TILES - 1) / (WARPS * TILES);
  const long long resident = static_cast<long long>(sms) * per_sm;
  const long long blocks = needed < resident ? needed : resident;
  bitslice_lane_groups_kernel<<<(unsigned)blocks, THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), rows);
  return static_cast<int>(cudaGetLastError());
}
