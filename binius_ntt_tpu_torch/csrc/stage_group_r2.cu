// stage_group_r2: one stage group of the radix-2 BB31 NTT, in place.
//
// Replaces binius_ntt_tpu/ntt/pallas_fused_bb31.py::stage_group_r2
// (pallas_call at :266).
//
// x is the flat (n,) array of Montgomery words (BB31, P = 15 * 2^27 + 1).
// The group runs the DIF stages s0 .. s0+k-1 (gpuntt.cuh:65-124): at stage
// s, element i with bit s clear pairs with i + 2^s, the twiddle is
// w = tw[i >> (s+1)] from the bit-reversed (n/2,) table, and the butterfly
// is U = u + v, V = (u - v) * w.  The top stage (s = log_n - 1) has
// w = tw[0] = enc(1) and skips the multiply (pallas_fused_bb31.py:122).
// Flags: bit 0 encodes the canonical input on load (the first group), bit 1
// decodes on store (the last group), bit 2 loads element i from
// src[bitrev(i)] (the transform's input permutation, gpuntt.cuh:163-168,
// which the reference runs as a gather outside its kernels; the group is
// then out of place, src != x).
//
// Bound on this card: at 2^24, 24 stages x 2^23 butterflies of about 15
// integer operations (a 32x32->64 multiply and REDC, two modular
// add/subtracts) are ~3e9 operations, 0.18 ms at the int32 lane rate; the
// three launches move 3 x 128 MiB, 0.12 ms at 3.35 TB/s.  Neither
// dominates, so the design keeps both low: each word is read and written
// once per group, and every stage of the group works in shared memory.
//
// Design: a block holds a tile of 2^k rows (stride 2^s0) by 2^c
// consecutive columns, at most 2^12 words (16 KB), where the TPU kernel
// split lane stages from row stages to suit Mosaic.  The first group takes
// 2^k consecutive words (c = 0); an upper group takes 16 or more columns,
// so its loads and stores are whole 64-byte segments.  Each stage is one
// pass of 256 threads over the tile's 2^(k+c-1) butterflies, then a
// barrier.  Twiddles come from the compact table by index (32 MB at 2^24,
// held in L2), not from the TPU kernel's host-expanded lane planes (7n
// words).  The Montgomery product uses the card's 32x32->64 multiply and
// the reference's REDC (baby_bear.py:83-99) with one conditional subtract.
// The bit-reversing load reads one word of each 32-byte sector per thread;
// its blocks take their tiles in bit-reversed order, so that the blocks in
// flight together read the other words of those sectors from L2; in
// launch order they would be far apart, and the load took twice as long.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t P = 0x78000001u;
constexpr uint32_t M = 0x88000001u;  // P^-1 mod 2^32
constexpr uint32_t R2 = 1172168163u;  // 2^64 mod P
constexpr int TILE_LOG = 12;
constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t bb_add(uint32_t a, uint32_t b) {
  const uint32_t r = a + b;
  return r >= P ? r - P : r;
}

__device__ __forceinline__ uint32_t bb_sub(uint32_t a, uint32_t b) {
  const uint32_t r = a - b;
  return r > P ? r + P : r;
}

// REDC(a * b) = a * b * 2^-32 mod P for a * b < 2^32 * P; risc0_baby_bear.h
// :172-179: ret = hi(ab) + hi(red * P) + (lo(ab) != 0), red = -(lo(ab) * M).
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b) {
  const uint64_t ab = static_cast<uint64_t>(a) * b;
  const uint32_t lo = static_cast<uint32_t>(ab);
  const uint32_t red = 0u - lo * M;
  const uint32_t ret = static_cast<uint32_t>(ab >> 32) + __umulhi(red, P) +
                       (lo != 0u ? 1u : 0u);
  return ret >= P ? ret - P : ret;
}

__global__ void __launch_bounds__(THREADS)
    stage_group_r2_kernel(uint32_t* __restrict__ x,
                          const uint32_t* src,  // may be x
                          const uint32_t* __restrict__ tw, int log_n, int s0,
                          int k, int log_cols, int flags) {
  __shared__ uint32_t tile[1 << TILE_LOG];
  const uint32_t n_tile = 1u << (k + log_cols);
  const uint32_t cmask = (1u << log_cols) - 1u;
  const bool encode = flags & 1, decode = flags & 2, bitrev = flags & 4;
  // A bit-reversing load reads word rev(i): blocks take their tiles in
  // bit-reversed order, so that blocks launched together read neighbouring
  // words and share 32-byte sectors in L2.
  const int tile_bits = log_n - k - log_cols;
  const uint32_t tile_id = bitrev && tile_bits > 0
                               ? __brev(blockIdx.x) >> (32 - tile_bits)
                               : blockIdx.x;
  const int chunk_bits = s0 - log_cols;  // column chunks per row block
  const uint32_t hi = tile_id >> chunk_bits;
  const uint32_t chunk = tile_id & ((1u << chunk_bits) - 1u);
  const uint32_t base = (hi << (s0 + k)) + (chunk << log_cols);

  for (uint32_t e = threadIdx.x; e < n_tile; e += THREADS) {
    const uint32_t g = base + ((e >> log_cols) << s0) + (e & cmask);
    uint32_t v = bitrev ? src[__brev(g) >> (32 - log_n)] : x[g];
    tile[e] = encode ? mont_mul(v, R2) : v;
  }
  __syncthreads();

  for (int j = 0; j < k; ++j) {
    const bool top = s0 + j == log_n - 1;
    const uint32_t low = (1u << j) - 1u;
#pragma unroll 2
    for (uint32_t b = threadIdx.x; b < n_tile / 2; b += THREADS) {
      const uint32_t p = b >> log_cols;          // pair index within a column
      const uint32_t t = ((p & ~low) << 1) | (p & low);
      const uint32_t iu = (t << log_cols) | (b & cmask);
      const uint32_t iv = iu + (1u << (j + log_cols));
      const uint32_t u = tile[iu], v = tile[iv];
      const uint32_t d = bb_sub(u, v);
      tile[iu] = bb_add(u, v);
      tile[iv] = top ? d : mont_mul(d, __ldg(tw + ((hi << (k - j - 1)) +
                                                   (t >> (j + 1)))));
    }
    __syncthreads();
  }

  for (uint32_t e = threadIdx.x; e < n_tile; e += THREADS) {
    const uint32_t g = base + ((e >> log_cols) << s0) + (e & cmask);
    const uint32_t v = tile[e];
    x[g] = decode ? mont_mul(v, 1u) : v;
  }
}

}  // namespace

// x, src: (2^log_n,) uint32 (src == x unless flags bit 2); tw: (2^log_n/2,)
// bit-reversed Montgomery twiddles.  Stages s0 .. s0+k-1, tiles of 2^k rows
// by 2^log_cols columns (k + log_cols <= 12, log_cols <= s0).  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int bntt_stage_group_r2(void* x, const void* src, const void* tw,
                                   int log_n, int s0, int k, int log_cols,
                                   int flags, void* stream) {
  if (log_n < 1 || log_n > 30 || k < 1 || s0 < 0 || s0 + k > log_n ||
      log_cols < 0 || log_cols > s0 || k + log_cols > TILE_LOG ||
      ((flags & 4) && src == x))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = 1u << (log_n - k - log_cols);
  stage_group_r2_kernel<<<blocks, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(x), static_cast<const uint32_t*>(src),
      static_cast<const uint32_t*>(tw), log_n, s0, k, log_cols, flags);
  return static_cast<int>(cudaGetLastError());
}
