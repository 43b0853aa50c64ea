// stage_group32: one in-place stage group of the GF(2^32) additive NTT on
// the packed bit-sliced layout.
//
// Replaces binius_ntt_tpu/ntt/pallas_fused32.py::stage_group32 (pallas_call
// at :444; body _group_body32 :328, _cj_stages32 :263, _parity_pm :108;
// multiply _mul32/_mul32_pm :373/:84 through pallas_kernels._mul_planes).
//
// Layout: a packed row is 128 words, lane group c = words [32c, 32c + 32),
// the 32 bit-planes of one block of 32 GF(2^32) elements.  x is
// (n_inst, 2^k, post, 128) uint32: instance q = coset * pre + pre_idx, tile
// row t, column j.
//
//   * Row stage st (0-based; p = k-1-st, global stage 7 + t0 + p) pairs
//     rows t and t + 2^p.  Plane i of the twiddle is
//     parity((t >> (p+1)) & mtile[st][i]) ^ parity(q & minst[st][i]), the
//     same for all four lane groups; a butterfly is one (row pair, lane
//     group, column): u' = u ^ w*v, v' = u' ^ v over 32 planes.  The four
//     lane groups of a row never mix in the row stages.
//   * The bottom group (include_low, post == 1) then runs the seven low
//     stages on each row, with base twiddle parity(t & mlo_t[i]) ^
//     parity(q & mlo_i[i]): stage 6 pairs lane groups h and h + 2 (plus
//     cpl[0][h]), stage 5 pairs 2h and 2h + 1 (plus cpl[1][2h]); stages
//     4..0 are in-word, and lane groups 2h and 2h + 1 pack their v-halves
//     into one composite multiply, with lpl[i] adding the per-lane part
//     (_cj_stages32).
//
// Bound on this card: integer ALU.  A butterfly is one GF(2^32) bit-sliced
// multiply (tower_mul32: 243 AND plus the combine XORs, 1,388 two-input
// gates, 1,059 three-input LOP3 operations), inline in registers.
//
// Design: every group runs on a tile in shared memory, loaded from global
// memory once and stored once; a slot is one 128-byte lane group of one
// tile row, its 8 uint4 kept at positions j ^ (s & 7) so that 8
// neighbouring slots read in one phase fall on distinct banks (as in
// csrc/stage_group.cu).
//
//   * Upper groups (stage_group32_kernel<false>): one block per (instance,
//     `cols` tile columns, lane group c), 2^k * cols slots, slot
//     t * cols + j for column j of row t (64 KB at k = 9, where cols = 1;
//     the host widens a block of a small group to more columns,
//     ntt/cuda_fused32.py::group_cols32).  One thread per (row pair,
//     column) butterfly per stage, a barrier between stages.
//   * The bottom group (<true>): one block per instance holds all four
//     lane groups of its 2^k rows (slot 4t + c, 128 KB at k = 8), since
//     the low section mixes them.  The k row stages run as above on the
//     four slot sets, then stage 6 as one more pass of slot butterflies
//     (t, h) x (t, h + 2), then, after a barrier, one thread per (row t,
//     pair h) loads lane groups 2h and 2h + 1 into registers and runs
//     stage 5 and the in-word stages 4..0 there.  Across each multiply
//     only the pair's u lanes (lo) and v lanes (cp) stay live, packed as
//     the in-word stage packs them: u' = lo ^ w*cp and v' = u' ^ cp for
//     both lane groups at once (the form of stage_group.cu::low_step32).
//
// Loops around a multiply stay rolled, so that ptxas can give the circuit
// the registers.  Blocks get 128 threads where two fit an SM's shared
// memory (the registers hold 8 warps an SM either way), so that one
// block's barriers leave the other running.  Stages flagged in zero_mask
// have an all-zero twiddle and skip the multiply.
#include <cuda_runtime.h>

#include <cstdint>

#include "tower_mul.cuh"

namespace {

constexpr int W32 = 32;            // planes of one block
constexpr int PACK = 4;            // blocks (lane groups) per packed row
constexpr int ROW = PACK * W32;    // words per packed row
constexpr int N_LOW = 7;           // low stages 6..0
constexpr int MAX_THREADS = 256;
// shared memory on this card: an SM's, the most one block may have, and
// what the runtime reserves for each block
constexpr int SM_SMEM = 228 * 1024;
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr int SMEM_RESERVED = 1024;

__device__ __forceinline__ uint32_t parity_plane(uint32_t idx, uint32_t mask) {
  return 0u - static_cast<uint32_t>(__popc(idx & mask) & 1);
}

// plane of the twiddle parity(blk & mt) ^ parity(q & mi), as 0 or ~0
__device__ __forceinline__ uint32_t twiddle_plane(uint32_t blk, uint32_t mt,
                                                  uint32_t q, uint32_t mi) {
  return parity_plane((blk & mt) ^ (q & mi), ~0u);
}

// lanes whose in-word position has bit s clear (the u lanes of stage s)
__device__ __forceinline__ uint32_t lane_mask(int s) {
  switch (s) {
    case 0: return 0x55555555u;
    case 1: return 0x33333333u;
    case 2: return 0x0F0F0F0Fu;
    case 3: return 0x00FF00FFu;
    default: return 0x0000FFFFu;
  }
}

__device__ __forceinline__ uint32_t* slot_vec(uint32_t* sm, int s, int j) {
  return sm + s * W32 + ((j ^ (s & 7)) << 2);
}

__device__ __forceinline__ void lds_slot(uint32_t* sm, int s, uint32_t* d) {
#pragma unroll
  for (int j = 0; j < W32 / 4; ++j) {
    const uint4 v = *reinterpret_cast<const uint4*>(slot_vec(sm, s, j));
    d[4 * j] = v.x; d[4 * j + 1] = v.y; d[4 * j + 2] = v.z; d[4 * j + 3] = v.w;
  }
}

__device__ __forceinline__ void sts_slot(uint32_t* sm, int s,
                                         const uint32_t* d) {
#pragma unroll
  for (int j = 0; j < W32 / 4; ++j)
    *reinterpret_cast<uint4*>(slot_vec(sm, s, j)) =
        make_uint4(d[4 * j], d[4 * j + 1], d[4 * j + 2], d[4 * j + 3]);
}

// u' = u ^ w*v, v' = u' ^ v on slots su, sv
__device__ __forceinline__ void slot_butterfly(uint32_t* sm, int su, int sv,
                                               const uint32_t* w, bool zero) {
  uint32_t a[W32], b[W32], prod[W32];
  lds_slot(sm, sv, b);
  if (zero) {
#pragma unroll
    for (int i = 0; i < W32; ++i) prod[i] = 0u;
  } else {
    tower_mul32(w, b, prod);
  }
  lds_slot(sm, su, a);
#pragma unroll
  for (int i = 0; i < W32; ++i) {
    a[i] ^= prod[i];
    b[i] ^= a[i];
  }
  sts_slot(sm, su, a);
  sts_slot(sm, sv, b);
}

// Stage 5 and the in-word stages 4..0 on lane groups x0 = 2h and
// x1 = 2h + 1 of row t, held in registers.  Each stage packs the pair's u
// lanes into lo and its v lanes into cp (stage 5: lo = x0, cp = x1; stage
// s: x0's lanes in the low slots, x1's in the high ones, as
// pallas_fused32.py:301-322 packs them), so that one multiply by the packed
// twiddle wc serves both: u' = lo ^ wc*cp, v' = u' ^ cp.
__device__ __forceinline__ void pair_walk(
    uint32_t* x0, uint32_t* x1, uint32_t t, uint32_t q, int h,
    const uint32_t* __restrict__ mlo_t, const uint32_t* __restrict__ mlo_i,
    const uint32_t* __restrict__ cpl, const uint32_t* __restrict__ lpl,
    int zero_low) {
#pragma unroll 1
  for (int i = 1; i < N_LOW; ++i) {
    const int s = 6 - i;
    const int sh = 1 << s;             // 32 at stage 5, which does not pack
    const uint32_t um = lane_mask(s);
    const uint32_t vm = um << (sh & 31);
    uint32_t lo[W32], cp[W32], prod[W32];
    if (i == 1) {
#pragma unroll
      for (int p = 0; p < W32; ++p) { lo[p] = x0[p]; cp[p] = x1[p]; }
    } else {
#pragma unroll
      for (int p = 0; p < W32; ++p) {
        lo[p] = (x0[p] & um) | ((x1[p] & um) << sh);
        cp[p] = ((x0[p] >> sh) & um) | (x1[p] & vm);
      }
    }
    if ((zero_low >> i) & 1) {
#pragma unroll
      for (int p = 0; p < W32; ++p) prod[p] = 0u;
    } else {
      const uint32_t* mt = mlo_t + i * W32;
      const uint32_t* mi = mlo_i + i * W32;
      const uint32_t* c0 = cpl + (i * PACK + 2 * h) * W32;
      uint32_t wc[W32];
      if (i == 1) {
#pragma unroll
        for (int p = 0; p < W32; ++p)
          wc[p] = twiddle_plane(t, __ldg(mt + p), q, __ldg(mi + p)) ^
                  __ldg(c0 + p);
      } else {
        const uint32_t* ln = lpl + i * W32;
#pragma unroll
        for (int p = 0; p < W32; ++p) {
          const uint32_t base =
              twiddle_plane(t, __ldg(mt + p), q, __ldg(mi + p)) ^
              __ldg(ln + p);
          const uint32_t w0 = base ^ __ldg(c0 + p);
          const uint32_t w1 = base ^ __ldg(c0 + W32 + p);
          wc[p] = (w0 & um) | ((w1 & um) << sh);
        }
      }
      tower_mul32(wc, cp, prod);
    }
    if (i == 1) {
#pragma unroll
      for (int p = 0; p < W32; ++p) {
        x0[p] = lo[p] ^ prod[p];
        x1[p] = cp[p] ^ x0[p];
      }
    } else {
#pragma unroll
      for (int p = 0; p < W32; ++p) {
        const uint32_t un = lo[p] ^ prod[p];
        const uint32_t vn = cp[p] ^ un;
        x0[p] = (un & um) | ((vn & um) << sh);
        x1[p] = ((un & vm) >> sh) | (vn & vm);
      }
    }
  }
}

// LOW = false: an upper group, a block per (instance, 2^lgc columns, lane
// group); LOW = true: the bottom group (post == 1), a block per instance
// with all four lane groups of its rows and the seven low stages.
template <bool LOW>
__global__ void __launch_bounds__(MAX_THREADS)
    stage_group32_kernel(uint32_t* __restrict__ x,
                         const uint32_t* __restrict__ mtile,
                         const uint32_t* __restrict__ minst,
                         const uint32_t* __restrict__ mlo_t,
                         const uint32_t* __restrict__ mlo_i,
                         const uint32_t* __restrict__ cpl,
                         const uint32_t* __restrict__ lpl, int k, int post,
                         int lgc, int zero_mask) {
  extern __shared__ uint4 smem4[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(smem4);
  // a tile row's slots: 2^lg of them, `unit` words apart in x
  const int lg = LOW ? 2 : lgc;
  const int unit = LOW ? W32 : ROW;
  const int c = LOW ? 0 : blockIdx.x % PACK;   // neighbouring blocks: one tile
  const int blk = LOW ? blockIdx.x : blockIdx.x / PACK;
  const int n_chunks = post >> lgc;
  const uint32_t q = blk / n_chunks;
  const int j0 = (blk % n_chunks) << lgc;
  const size_t row_stride = static_cast<size_t>(post) * ROW;
  uint32_t* tile =
      x + ((static_cast<size_t>(q) << k) * post + j0) * ROW + c * W32;
  const int n_vec = (1 << (k + lg)) * (W32 / 4);

  // slot s: tile row s >> lg, lane group (bottom) or column (upper) s % 2^lg
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    const int s = i / (W32 / 4), j = i % (W32 / 4);
    const uint32_t* src = tile + (s >> lg) * row_stride +
                          (s & ((1 << lg) - 1)) * unit;
    *reinterpret_cast<uint4*>(slot_vec(sm, s, j)) =
        *reinterpret_cast<const uint4*>(src + 4 * j);
  }
  __syncthreads();

  // the k row stages, then in the bottom group stage 6 as pass st == k
  const int passes = k + (LOW ? 1 : 0);
  for (int st = 0; st < passes; ++st) {
    const bool s6 = LOW && st == k;
    const int p = s6 ? 0 : k - 1 - st;
    const uint32_t lowm = (1u << p) - 1u;
    const bool zero = (zero_mask >> st) & 1;
    const int n = s6 ? 2 << k : 1 << (k + lg - 1);
    const uint32_t* mt = s6 ? mlo_t : mtile + st * W32;
    const uint32_t* mi = s6 ? mlo_i : minst + st * W32;
#pragma unroll 1
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      int su, sv;
      uint32_t w[W32];
      if (s6) {                        // (row t, h): lane groups h, h + 2
        const uint32_t t = i >> 1;
        const int h = i & 1;
        su = 4 * t + h;
        sv = su + 2;
        if (!zero) {
#pragma unroll
          for (int e = 0; e < W32; ++e)
            w[e] = twiddle_plane(t, __ldg(mt + e), q, __ldg(mi + e)) ^
                   __ldg(cpl + h * W32 + e);
        }
      } else {
        const int cc = i & ((1 << lg) - 1);
        const uint32_t b = i >> lg;     // butterfly index in [0, 2^(k-1))
        const uint32_t t = ((b & ~lowm) << 1) | (b & lowm);   // bit p clear
        su = (t << lg) + cc;
        sv = su + ((1 << lg) << p);
        if (!zero) {
          const uint32_t bb = t >> (p + 1);
#pragma unroll
          for (int e = 0; e < W32; ++e)
            w[e] = twiddle_plane(bb, __ldg(mt + e), q, __ldg(mi + e));
        }
      }
      slot_butterfly(sm, su, sv, w, zero);
    }
    __syncthreads();
  }

  if constexpr (LOW) {                 // stage 5 and stages 4..0, per pair
    const int zero_low = zero_mask >> k;
#pragma unroll 1
    for (int i = threadIdx.x; i < (2 << k); i += blockDim.x) {
      const uint32_t t = i >> 1;
      const int h = i & 1;
      uint32_t x0[W32], x1[W32];
      lds_slot(sm, 4 * t + 2 * h, x0);
      lds_slot(sm, 4 * t + 2 * h + 1, x1);
      pair_walk(x0, x1, t, q, h, mlo_t, mlo_i, cpl, lpl, zero_low);
      sts_slot(sm, 4 * t + 2 * h, x0);
      sts_slot(sm, 4 * t + 2 * h + 1, x1);
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    const int s = i / (W32 / 4), j = i % (W32 / 4);
    uint32_t* dst = tile + (s >> lg) * row_stride +
                    (s & ((1 << lg) - 1)) * unit;
    *reinterpret_cast<uint4*>(dst + 4 * j) =
        *reinterpret_cast<const uint4*>(slot_vec(sm, s, j));
  }
}

}  // namespace

// x: (n_inst, 2^k, post, 128) uint32, updated in place; mtile, minst:
// (k, 32); with include_low (then post == 1) mlo_t, mlo_i, lpl: (7, 32)
// and cpl: (7, 4, 32), else null.  Bit st of zero_mask marks stage st (row
// stages first, then the seven low stages) as all-zero.  An upper group
// takes a block per (instance, `cols` columns, lane group) and
// 2^k * cols * 128 bytes of shared memory (cols a power of two dividing
// post, picked on the host: ntt/cuda_fused32.py::group_cols32), the bottom
// group (cols == 1) a block per instance and 2^k * 512 bytes; a tile above
// SMEM_LIMIT is refused.  Returns cudaErrorInvalidValue for arguments the
// kernel cannot take, else cudaGetLastError() after the launch (0 =
// launched).
extern "C" int bntt_stage_group32(void* x, const void* mtile,
                                  const void* minst, const void* mlo_t,
                                  const void* mlo_i, const void* cpl,
                                  const void* lpl, int n_inst, int k,
                                  int post, int cols, int include_low,
                                  int zero_mask, void* stream) {
  if (k < 0 || k > 24 || n_inst < 1 || post < 1 || cols < 1 ||
      (cols & (cols - 1)) != 0 || post % cols != 0 ||
      (!include_low && k < 1) ||
      (include_low && (post != 1 || mlo_t == nullptr || mlo_i == nullptr ||
                       cpl == nullptr || lpl == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tile =
      (static_cast<long long>(include_low ? PACK : cols) << k) * W32 * 4;
  if (tile > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(tile);
  int lgc = 0;
  while ((1 << lgc) < cols) ++lgc;
  const long long blocks = static_cast<long long>(n_inst) * (post / cols) *
                           (include_low ? 1 : PACK);
  // units of a pass: 2^(k-1) row pairs a lane group and column; 2^(k+1)
  // (row, pair) units in the bottom group's stage 6 and register walk
  const int work = include_low ? (2 << k) : (cols << (k - 1));
  const int cap = 2 * (smem + SMEM_RESERVED) <= SM_SMEM ? MAX_THREADS / 2
                                                        : MAX_THREADS;
  const int threads = work < cap ? work : cap;
  uint32_t* xx = static_cast<uint32_t*>(x);
  const uint32_t* mt = static_cast<const uint32_t*>(mtile);
  const uint32_t* mi = static_cast<const uint32_t*>(minst);
  const uint32_t* lt = static_cast<const uint32_t*>(mlo_t);
  const uint32_t* li = static_cast<const uint32_t*>(mlo_i);
  const uint32_t* cp = static_cast<const uint32_t*>(cpl);
  const uint32_t* lp = static_cast<const uint32_t*>(lpl);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (include_low) {
    cudaFuncSetAttribute(stage_group32_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    stage_group32_kernel<true><<<(unsigned)blocks, threads, smem, s>>>(
        xx, mt, mi, lt, li, cp, lp, k, post, 0, zero_mask);
  } else {
    cudaFuncSetAttribute(stage_group32_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    stage_group32_kernel<false><<<(unsigned)blocks, threads, smem, s>>>(
        xx, mt, mi, lt, li, cp, lp, k, post, lgc, zero_mask);
  }
  return static_cast<int>(cudaGetLastError());
}
