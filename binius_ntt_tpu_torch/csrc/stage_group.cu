// stage_group: one in-place stage group of the bit-sliced GF(2^128)
// additive NTT.
//
// Replaces binius_ntt_tpu/ntt/pallas_fused.py::stage_group (pallas_call at
// :410; body _group_body :184, _low_stages128 :284, _parity_planes :116;
// multiply _mul_vmem_sl/_mul_planes, pallas_kernels.py:75/51).
//
// x is (n_inst, 2^k, post, 128) uint32: instance q = coset * pre + pre_idx,
// tile row t, column j.  High stage st (0-based within the group) pairs
// rows t and t | 2^p, p = k-1-st, and computes u' = u ^ w*v, v' = u' ^ v.
// Bit i of the twiddle is parity(blk & mtile[st][i]) ^ parity(q &
// minst[st][i]) with blk = t >> (p+1), expanded to 0 or 0xFFFFFFFF: the
// same parity-mask tables the Pallas kernel reads, applied with direct
// indexing instead of its constant-geometry (Pease) row rotation.  The
// bottom group (include_low, post == 1) then runs the 5 in-word stages on
// each pair of rows (2j, 2j+1) exactly as _low_stages128 does: the v-halves
// of both rows pack into one multiply, a static shift-16 butterfly, then
// the 4-swap out-shuffle that rotates the next stage's bit to the top (the
// lanes rows are pre-permuted for that loop).
//
// Bound on this card: integer ALU.  Two routes, one template argument,
// chosen on the host from the tables (ntt/cuda_fused.py::subfield_tables):
//
//   * CHUNK32, taken when no plane >= 32 of mtile, minst or lanes is set,
//     so that every twiddle lies in the subfield GF(2^32) (true of every
//     domain of at most 2^32 points, so of every table the card can hold).
//     GF(2^128) is then a 4-dimensional GF(2^32)-vector space
//     (fields/bitsliced.py::mul_subfield_chunks): w*v is the four GF(2^32)
//     products w*v[32c, 32c+32), 4 x 1,059 = 4,236 three-input LOP3
//     operations (chip_smoke.tower_mul_ops) where one GF(2^128) product
//     takes 10,326.  The packing and the out-shuffle of the in-word stages
//     act within a word, so the four chunks never mix and a group is four
//     independent GF(2^32)-linear transforms.  A block owns one 32-plane
//     chunk of a tile in shared memory (32 KB at k = 8, one column), loads
//     it once, runs every stage on it with a barrier between stages, and
//     stores it once; a thread runs whole (row pair, chunk) butterflies,
//     each an inline tower_mul32 in registers (loops around it rolled, as
//     in stage_group32.cu), and in the bottom group keeps its two 32-plane
//     chunks in registers through all five in-word stages.
//   * general, for tables with higher planes: one block per (instance,
//     `cols` columns), the tile in global memory (L2) between stages, and
//     every butterfly one 128-plane multiply, the out-of-line tower_mul128
//     (~510 planes live, so it goes through local memory; see
//     tower_mul.cuh), for 2 KB of row traffic; a thread owns a row pair for
//     all five in-word stages, reading and writing it at each.
//
// Stages flagged in zero_mask have an all-zero twiddle and skip the
// multiply.
//
// A sharded transform (parallel/ntt128_sharded.py) runs each shard's local
// groups with the device bits of the indicator as one more GF(2)-linear
// part of every twiddle: dplanes (n_stages, 128), all-ones or zero planes,
// XORed into each stage's twiddle planes (pallas_fused.py :251-252 high,
// :322-323 low).  A template flag, DPL, carries it, so that the
// single-device path (null dplanes) compiles to the code it had.
#include <cuda_runtime.h>

#include <cstdint>

#include "tower_mul.cuh"

namespace {

constexpr int W = 128;
constexpr int C32 = 32;             // planes of one GF(2^32) chunk
constexpr int NCHUNK = W / C32;     // chunks of a row
constexpr int N_LOW = 5;            // in-word stages 4..0
constexpr int MAX_THREADS = 256;
// shared memory on this card: an SM's, the most one block may have, and
// what the runtime reserves for each block.  Where two CHUNK32 blocks fit
// on an SM they take MAX_THREADS / 2 threads each (the registers hold 8
// warps an SM), so that one block's barriers leave the other running.
constexpr int SM_SMEM = 228 * 1024;
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr int SMEM_RESERVED = 1024;
constexpr uint32_t UM = 0x0000FFFFu;
constexpr uint32_t VM = 0xFFFF0000u;

__device__ __forceinline__ uint32_t parity_plane(uint32_t idx, uint32_t mask) {
  return 0u - static_cast<uint32_t>(__popc(idx & mask) & 1);
}

// bit p = b*16 + j -> 2j + b: rotate the 5-bit in-word position left by 1
__device__ __forceinline__ uint32_t outshuffle(uint32_t x) {
  uint32_t t;
  t = ((x >> 8) ^ x) & 0x0000FF00u; x ^= t ^ (t << 8);
  t = ((x >> 4) ^ x) & 0x00F000F0u; x ^= t ^ (t << 4);
  t = ((x >> 2) ^ x) & 0x0C0C0C0Cu; x ^= t ^ (t << 2);
  t = ((x >> 1) ^ x) & 0x22222222u; x ^= t ^ (t << 1);
  return x;
}

// plane i of a stage's twiddle correction, or 0 without one
template <bool DPL>
__device__ __forceinline__ uint32_t dplane(const uint32_t* __restrict__ dp,
                                           int i) {
  if constexpr (DPL)
    return __ldg(dp + i);
  else
    return 0u;
}

__device__ __forceinline__ void load_row(const uint32_t* src, uint32_t* dst) {
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < W / 4; ++i) {
    const uint4 v = s4[i];
    dst[4 * i] = v.x; dst[4 * i + 1] = v.y; dst[4 * i + 2] = v.z; dst[4 * i + 3] = v.w;
  }
}

// ---- general route: 128-plane twiddles ----

// u' = u ^ w*v, v' = u' ^ v for one row pair at one high stage
template <bool DPL>
__device__ __forceinline__ void butterfly(uint32_t* u, uint32_t* v,
                                          uint32_t blk, uint32_t q,
                                          const uint32_t* __restrict__ mt,
                                          const uint32_t* __restrict__ mi,
                                          const uint32_t* __restrict__ dp,
                                          bool zero) {
  uint32_t vv[W], prod[W];
  load_row(v, vv);
  if (zero) {
#pragma unroll
    for (int i = 0; i < W; ++i) prod[i] = 0u;
  } else {
    uint32_t w[W];
#pragma unroll
    for (int i = 0; i < W; ++i)
      w[i] = parity_plane(blk, __ldg(mt + i)) ^
             parity_plane(q, __ldg(mi + i)) ^ dplane<DPL>(dp, i);
    tower_mul128(w, vv, prod);
  }
  uint4* u4 = reinterpret_cast<uint4*>(u);
  uint4* v4 = reinterpret_cast<uint4*>(v);
#pragma unroll
  for (int i = 0; i < W / 4; ++i) {
    uint4 uu = u4[i];
    uu.x ^= prod[4 * i]; uu.y ^= prod[4 * i + 1];
    uu.z ^= prod[4 * i + 2]; uu.w ^= prod[4 * i + 3];
    u4[i] = uu;
    v4[i] = make_uint4(uu.x ^ vv[4 * i], uu.y ^ vv[4 * i + 1],
                       uu.z ^ vv[4 * i + 2], uu.w ^ vv[4 * i + 3]);
  }
}

// one in-word stage on rows r0 = tile row t0 (even) and r1 = t0 + 1
template <bool DPL>
__device__ __forceinline__ void low_step(uint32_t* r0, uint32_t* r1,
                                         uint32_t t0, uint32_t q,
                                         const uint32_t* __restrict__ mt,
                                         const uint32_t* __restrict__ mi,
                                         const uint32_t* __restrict__ ln,
                                         const uint32_t* __restrict__ dp,
                                         bool zero) {
  uint32_t prod[W];
  if (zero) {
#pragma unroll
    for (int i = 0; i < W; ++i) prod[i] = 0u;
  } else {
    uint32_t wc[W], cp[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint32_t m = __ldg(mt + i);
      const uint32_t base = parity_plane(q, __ldg(mi + i)) ^ __ldg(ln + i) ^
                            dplane<DPL>(dp, i);
      const uint32_t w0 = parity_plane(t0, m) ^ base;
      const uint32_t w1 = parity_plane(t0 + 1, m) ^ base;
      // even row's v-lanes into the u-slots, odd row's stay in the v-slots
      cp[i] = ((r0[i] >> 16) & UM) | (r1[i] & VM);
      wc[i] = (w0 & UM) | ((w1 & UM) << 16);
    }
    tower_mul128(wc, cp, prod);
  }
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const uint32_t x0 = r0[i], x1 = r1[i];
    const uint32_t un0 = x0 ^ (prod[i] & UM);
    const uint32_t un1 = x1 ^ ((prod[i] & VM) >> 16);
    r0[i] = outshuffle((un0 & UM) | ((x0 ^ (un0 << 16)) & VM));
    r1[i] = outshuffle((un1 & UM) | ((x1 ^ (un1 << 16)) & VM));
  }
}

template <bool DPL>
__device__ __forceinline__ void group_general(
    uint32_t* __restrict__ x, const uint32_t* __restrict__ mtile,
    const uint32_t* __restrict__ minst, const uint32_t* __restrict__ lanes,
    const uint32_t* __restrict__ dplanes, int k, int post, int cols,
    int n_chunks, int include_low, int zero_mask) {
  const uint32_t q = blockIdx.x / n_chunks;
  const int j0 = (blockIdx.x % n_chunks) * cols;
  const size_t row_stride = static_cast<size_t>(post) * W;
  uint32_t* tile = x + ((static_cast<size_t>(q) << k) * post + j0) * W;
  const int half = 1 << (k - 1);
  const int n_bfly = half * cols;
  for (int st = 0; st < k; ++st) {
    const int p = k - 1 - st;
    const uint32_t lowm = (1u << p) - 1u;
    const bool zero = (zero_mask >> st) & 1;
    for (int i = threadIdx.x; i < n_bfly; i += blockDim.x) {
      const uint32_t b = i / cols;   // butterfly index in [0, half)
      const int c = i % cols;
      const uint32_t t = ((b & ~lowm) << 1) | (b & lowm);   // bit p clear
      uint32_t* u = tile + t * row_stride + c * W;
      butterfly<DPL>(u, u + (static_cast<size_t>(1) << p) * row_stride,
                     t >> (p + 1), q, mtile + st * W, minst + st * W,
                     dplanes + st * W, zero);
    }
    __syncthreads();
  }

  if (include_low) {   // post == cols == 1: rows are contiguous
    for (int j = threadIdx.x; j < half; j += blockDim.x) {
      uint32_t* r0 = tile + static_cast<size_t>(2 * j) * W;
      for (int i = 0; i < N_LOW; ++i) {
        const int st = k + i;
        low_step<DPL>(r0, r0 + W, 2 * j, q, mtile + st * W,
                      minst + st * W, lanes + i * W, dplanes + st * W,
                      (zero_mask >> st) & 1);
      }
    }
  }
}

// ---- CHUNK32 route: GF(2^32) twiddles, one 32-plane chunk a block ----
//
// A block owns one 32-plane chunk of one tile: 2^k x cols slots of 128
// bytes in shared memory, loaded once, run through every stage of the
// group, and stored once.  Slot s = t * cols + c keeps its 8 uint4 at
// positions j ^ (s & 7), so that 8 neighbouring slots read in one phase
// fall on distinct banks.

// plane of the twiddle parity(blk & mt) ^ parity(q & mi), as 0 or ~0
__device__ __forceinline__ uint32_t twiddle_plane(uint32_t blk, uint32_t mt,
                                                  uint32_t q, uint32_t mi) {
  return parity_plane((blk & mt) ^ (q & mi), ~0u);
}

__device__ __forceinline__ uint32_t* slot_vec(uint32_t* sm, int s, int j) {
  return sm + s * C32 + ((j ^ (s & 7)) << 2);
}

__device__ __forceinline__ void lds_chunk(uint32_t* sm, int s, uint32_t* d) {
#pragma unroll
  for (int j = 0; j < C32 / 4; ++j) {
    const uint4 v = *reinterpret_cast<const uint4*>(slot_vec(sm, s, j));
    d[4 * j] = v.x; d[4 * j + 1] = v.y; d[4 * j + 2] = v.z; d[4 * j + 3] = v.w;
  }
}

__device__ __forceinline__ void sts_chunk(uint32_t* sm, int s,
                                          const uint32_t* d) {
#pragma unroll
  for (int j = 0; j < C32 / 4; ++j)
    *reinterpret_cast<uint4*>(slot_vec(sm, s, j)) =
        make_uint4(d[4 * j], d[4 * j + 1], d[4 * j + 2], d[4 * j + 3]);
}

// u' = u ^ w*v, v' = u' ^ v on the chunk of slots su, sv; w is planes
// 0..31 of the stage's twiddle (of its correction too: the route holds
// only tables whose higher planes are zero)
template <bool DPL>
__device__ __forceinline__ void chunk_butterfly(
    uint32_t* sm, int su, int sv, uint32_t blk, uint32_t q,
    const uint32_t* __restrict__ mt, const uint32_t* __restrict__ mi,
    const uint32_t* __restrict__ dp, bool zero) {
  uint32_t a[C32], b[C32], prod[C32];
  lds_chunk(sm, sv, b);
  if (zero) {
#pragma unroll
    for (int i = 0; i < C32; ++i) prod[i] = 0u;
  } else {
    uint32_t w[C32];
#pragma unroll
    for (int i = 0; i < C32; ++i)
      w[i] = twiddle_plane(blk, __ldg(mt + i), q, __ldg(mi + i)) ^
             dplane<DPL>(dp, i);
    tower_mul32(w, b, prod);
  }
  lds_chunk(sm, su, a);
#pragma unroll
  for (int i = 0; i < C32; ++i) {
    a[i] ^= prod[i];
    b[i] ^= a[i];
  }
  sts_chunk(sm, su, a);
  sts_chunk(sm, sv, b);
}

// low_step on one chunk of rows t0 (even) and t0 + 1, held in registers
// (x0, x1).  Only lo (both rows' u-lanes: the even row's low, the odd
// row's high) and cp (their v-lanes, packed as low_step packs them) stay
// live across the multiply: u' = lo ^ w*cp and v' = u' ^ cp for both rows
// at once.  t0 is even, so parity((t0 + 1) & m) = parity(t0 & m) ^ (m & 1).
template <bool DPL>
__device__ __forceinline__ void low_step32(uint32_t* x0, uint32_t* x1,
                                           uint32_t t0, uint32_t q,
                                           const uint32_t* __restrict__ mt,
                                           const uint32_t* __restrict__ mi,
                                           const uint32_t* __restrict__ ln,
                                           const uint32_t* __restrict__ dp,
                                           bool zero) {
  uint32_t lo[C32], cp[C32], prod[C32];
#pragma unroll
  for (int i = 0; i < C32; ++i) {
    lo[i] = (x0[i] & UM) | (x1[i] << 16);
    cp[i] = (x0[i] >> 16) | (x1[i] & VM);
  }
  if (zero) {
#pragma unroll
    for (int i = 0; i < C32; ++i) prod[i] = 0u;
  } else {
    uint32_t wc[C32];
#pragma unroll
    for (int i = 0; i < C32; ++i) {
      const uint32_t m = __ldg(mt + i);
      const uint32_t w0 = twiddle_plane(t0, m, q, __ldg(mi + i)) ^
                          __ldg(ln + i) ^ dplane<DPL>(dp, i);
      const uint32_t w1 = w0 ^ (0u - (m & 1u));
      wc[i] = (w0 & UM) | (w1 << 16);
    }
    tower_mul32(wc, cp, prod);
  }
#pragma unroll
  for (int i = 0; i < C32; ++i) {
    const uint32_t un = lo[i] ^ prod[i];
    const uint32_t vn = cp[i] ^ un;
    x0[i] = outshuffle((un & UM) | (vn << 16));
    x1[i] = outshuffle((un >> 16) | (vn & VM));
  }
}

template <bool DPL>
__device__ __forceinline__ void group_chunk32(
    uint32_t* __restrict__ x, const uint32_t* __restrict__ mtile,
    const uint32_t* __restrict__ minst, const uint32_t* __restrict__ lanes,
    const uint32_t* __restrict__ dplanes, int k, int post, int cols,
    int n_chunks, int include_low, int zero_mask) {
  extern __shared__ uint4 smem4[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(smem4);
  const int ch = blockIdx.x % NCHUNK;   // neighbouring blocks: one tile
  const int blk = blockIdx.x / NCHUNK;
  const uint32_t q = blk / n_chunks;
  const int j0 = (blk % n_chunks) * cols;
  const size_t row_stride = static_cast<size_t>(post) * W;
  uint32_t* tile =
      x + ((static_cast<size_t>(q) << k) * post + j0) * W + ch * C32;
  const int half = 1 << (k - 1);
  const int n_vec = (2 * half) * cols * (C32 / 4);

  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    const int s = i / (C32 / 4), j = i % (C32 / 4);
    const uint32_t* src = tile + (s / cols) * row_stride + (s % cols) * W;
    *reinterpret_cast<uint4*>(slot_vec(sm, s, j)) =
        *reinterpret_cast<const uint4*>(src + 4 * j);
  }
  __syncthreads();

  for (int st = 0; st < k; ++st) {
    const int p = k - 1 - st;
    const uint32_t lowm = (1u << p) - 1u;
    const bool zero = (zero_mask >> st) & 1;
#pragma unroll 1
    for (int i = threadIdx.x; i < half * cols; i += blockDim.x) {
      const uint32_t b = i / cols;   // butterfly index in [0, half)
      const int c = i % cols;
      const uint32_t t = ((b & ~lowm) << 1) | (b & lowm);   // bit p clear
      const int su = t * cols + c;
      chunk_butterfly<DPL>(sm, su, su + (cols << p), t >> (p + 1), q,
                           mtile + st * W, minst + st * W, dplanes + st * W,
                           zero);
    }
    __syncthreads();
  }

  if (include_low) {   // post == cols == 1: slot s is tile row s
#pragma unroll 1
    for (int j = threadIdx.x; j < half; j += blockDim.x) {
      uint32_t x0[C32], x1[C32];
      lds_chunk(sm, 2 * j, x0);
      lds_chunk(sm, 2 * j + 1, x1);
#pragma unroll 1
      for (int s = 0; s < N_LOW; ++s) {
        const int st = k + s;
        low_step32<DPL>(x0, x1, 2 * j, q, mtile + st * W, minst + st * W,
                        lanes + s * W, dplanes + st * W,
                        (zero_mask >> st) & 1);
      }
      sts_chunk(sm, 2 * j, x0);
      sts_chunk(sm, 2 * j + 1, x1);
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    const int s = i / (C32 / 4), j = i % (C32 / 4);
    uint32_t* dst = tile + (s / cols) * row_stride + (s % cols) * W;
    *reinterpret_cast<uint4*>(dst + 4 * j) =
        *reinterpret_cast<const uint4*>(slot_vec(sm, s, j));
  }
}

template <bool CHUNK32, bool DPL>
__global__ void __launch_bounds__(MAX_THREADS)
    stage_group_kernel(uint32_t* __restrict__ x,
                       const uint32_t* __restrict__ mtile,
                       const uint32_t* __restrict__ minst,
                       const uint32_t* __restrict__ lanes,
                       const uint32_t* __restrict__ dplanes, int k, int post,
                       int cols, int n_chunks, int include_low,
                       int zero_mask) {
  if constexpr (CHUNK32)
    group_chunk32<DPL>(x, mtile, minst, lanes, dplanes, k, post, cols,
                       n_chunks, include_low, zero_mask);
  else
    group_general<DPL>(x, mtile, minst, lanes, dplanes, k, post, cols,
                       n_chunks, include_low, zero_mask);
}

template <bool CHUNK32, bool DPL>
void launch(unsigned blocks, int threads, int smem, cudaStream_t s,
            uint32_t* x, const uint32_t* mt, const uint32_t* mi,
            const uint32_t* ln, const uint32_t* dp, int k, int post,
            int cols, int n_chunks, int include_low, int zero_mask) {
  if constexpr (CHUNK32)
    cudaFuncSetAttribute(stage_group_kernel<CHUNK32, DPL>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  stage_group_kernel<CHUNK32, DPL><<<blocks, threads, smem, s>>>(
      x, mt, mi, ln, dp, k, post, cols, n_chunks, include_low, zero_mask);
}

}  // namespace

// x: (n_inst, 2^k, post, 128) uint32, updated in place; mtile, minst:
// (k + 5*include_low, 128); lanes: (5, 128) or null; dplanes: (k +
// 5*include_low, 128), XORed into every stage's twiddle, or null.  A
// general block covers `cols` columns (cols divides post; post == cols ==
// 1 when include_low); a CHUNK32 block one 32-plane chunk of them, 2^k *
// cols * 128 bytes of shared memory, which must be at most SMEM_LIMIT
// (the host picks cols: ntt/cuda_fused.py::chunk32_cols).  chunk32 != 0 takes the
// CHUNK32 route, valid only for tables with no plane >= 32 set.  Returns
// cudaErrorInvalidValue for arguments the kernel cannot take, else
// cudaGetLastError() after the launch (0 = launched).
extern "C" int bntt_stage_group(void* x, const void* mtile, const void* minst,
                                const void* lanes, const void* dplanes,
                                int n_inst, int k, int post, int cols,
                                int include_low, int zero_mask, int chunk32,
                                void* stream) {
  if (k < 1 || cols < 1 || post % cols != 0 ||
      (include_low && (post != 1 || lanes == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  int smem = 0;
  if (chunk32) {
    if ((static_cast<long long>(cols) << k) * C32 * 4 > SMEM_LIMIT)
      return static_cast<int>(cudaErrorInvalidValue);
    smem = (cols << k) * C32 * 4;
  }
  const int n_chunks = post / cols;
  const long long blocks =
      static_cast<long long>(n_inst) * n_chunks * (chunk32 ? NCHUNK : 1);
  const int work = (1 << (k - 1)) * cols;
  const int cap = chunk32 && 2 * (smem + SMEM_RESERVED) <= SM_SMEM
                      ? MAX_THREADS / 2 : MAX_THREADS;
  const int threads = work < cap ? work : cap;
  uint32_t* xx = static_cast<uint32_t*>(x);
  const uint32_t* mt = static_cast<const uint32_t*>(mtile);
  const uint32_t* mi = static_cast<const uint32_t*>(minst);
  const uint32_t* ln = static_cast<const uint32_t*>(lanes);
  const uint32_t* dp = static_cast<const uint32_t*>(dplanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nb = static_cast<unsigned>(blocks);
  if (chunk32 && dp)
    launch<true, true>(nb, threads, smem, s, xx, mt, mi, ln, dp, k, post,
                       cols, n_chunks, include_low, zero_mask);
  else if (chunk32)
    launch<true, false>(nb, threads, smem, s, xx, mt, mi, ln, dp, k, post,
                        cols, n_chunks, include_low, zero_mask);
  else if (dp)
    launch<false, true>(nb, threads, smem, s, xx, mt, mi, ln, dp, k, post,
                        cols, n_chunks, include_low, zero_mask);
  else
    launch<false, false>(nb, threads, smem, s, xx, mt, mi, ln, dp, k, post,
                         cols, n_chunks, include_low, zero_mask);
  return static_cast<int>(cudaGetLastError());
}
