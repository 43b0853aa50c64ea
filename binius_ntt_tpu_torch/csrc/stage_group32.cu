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
//   * Row stage st (0-based; rbit = k-1-st, global stage 7 + t0 + rbit)
//     pairs rows t and t + 2^rbit.  Plane p of the twiddle is
//     parity((t >> (rbit+1)) & mtile[st][p]) ^ parity(q & minst[st][p]),
//     the same for all four lane groups; a butterfly is one (row pair, lane
//     group, column): u' = u ^ w*v, v' = u' ^ v over 32 planes.
//   * The bottom group (include_low, post == 1) then runs the seven low
//     stages on each row, with base twiddle parity(t & mlo_t[i]) ^
//     parity(q & mlo_i[i]): stage 6 pairs lane groups c and c + 2, stage 5
//     pairs c and c + 1 and adds cpl[1][c]; stages 4..0 are in-word, and
//     lane groups (0, 1) and (2, 3) pack their v-halves into one composite
//     multiply, with lpl[i] adding the per-lane part (_cj_stages32).
//
// Bound on this card: integer ALU.  A butterfly is one GF(2^32) bit-sliced
// multiply (tower_mul32: 243 AND plus the combine XORs, 1,388 two-input
// gates, 1,059 three-input LOP3 operations) against 512 bytes of row
// traffic, which stays in L2 between stages
// as long as the tiles of all resident blocks fit in it (the plan in
// ntt/cuda_fused32.py).
//
// Design: one thread block per (instance, tile column), the tile in global
// memory (L2) with a __syncthreads() between row stages, as
// csrc/stage_group.cu does for GF(2^128).  Each thread runs whole
// butterflies, one multiply each, with the loop kept rolled so that ptxas
// gives the circuit all 255 registers.  In the low section a thread owns a
// whole row for all seven stages (14 multiplies, two per stage), so those
// stages need no barrier.  Stages flagged in zero_mask have an all-zero
// twiddle and skip the multiply.
#include <cuda_runtime.h>

#include <cstdint>

#include "tower_mul.cuh"

namespace {

constexpr int W32 = 32;            // planes of one block
constexpr int PACK = 4;            // blocks (lane groups) per packed row
constexpr int ROW = PACK * W32;    // words per packed row
constexpr int N_LOW = 7;           // low stages 6..0
constexpr int MAX_THREADS = 256;

__device__ __forceinline__ uint32_t parity_plane(uint32_t idx, uint32_t mask) {
  return 0u - static_cast<uint32_t>(__popc(idx & mask) & 1);
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

__device__ __forceinline__ void load32(const uint32_t* src, uint32_t* dst) {
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < W32 / 4; ++i) {
    const uint4 v = s4[i];
    dst[4 * i] = v.x; dst[4 * i + 1] = v.y;
    dst[4 * i + 2] = v.z; dst[4 * i + 3] = v.w;
  }
}

__device__ __forceinline__ void store32(uint32_t* dst, const uint32_t* src) {
  uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < W32 / 4; ++i)
    d4[i] = make_uint4(src[4 * i], src[4 * i + 1], src[4 * i + 2],
                       src[4 * i + 3]);
}

// u' = u ^ w*v, v' = u' ^ v on one lane group; w is plane-wise `w`
__device__ __forceinline__ void group_butterfly(uint32_t* u, uint32_t* v,
                                                const uint32_t* w,
                                                bool zero) {
  uint32_t a[W32], b[W32], prod[W32];
  load32(v, b);
  if (zero) {
#pragma unroll
    for (int p = 0; p < W32; ++p) prod[p] = 0u;
  } else {
    tower_mul32(w, b, prod);
  }
  load32(u, a);
#pragma unroll
  for (int p = 0; p < W32; ++p) {
    a[p] ^= prod[p];
    b[p] ^= a[p];
  }
  store32(u, a);
  store32(v, b);
}

// one in-word stage s on lane groups x0 = 2h and x1 = 2h + 1 of a row:
// the v-lanes of x0 shift into the u-slots, those of x1 stay in the
// v-slots, and one multiply serves both (pallas_fused32.py:301-322)
__device__ __forceinline__ void inword_butterfly(uint32_t* x0, uint32_t* x1,
                                                 const uint32_t* w0,
                                                 const uint32_t* w1, int s,
                                                 bool zero) {
  const int sh = 1 << s;
  const uint32_t um = lane_mask(s);
  const uint32_t vm = um << sh;
  uint32_t a[W32], b[W32], prod[W32];
  if (zero) {
#pragma unroll
    for (int p = 0; p < W32; ++p) prod[p] = 0u;
  } else {
    uint32_t wc[W32];
    load32(x0, a);
    load32(x1, b);
#pragma unroll
    for (int p = 0; p < W32; ++p) {
      b[p] = ((a[p] >> sh) & um) | (b[p] & vm);
      wc[p] = (w0[p] & um) | ((w1[p] & um) << sh);
    }
    tower_mul32(wc, b, prod);
  }
  load32(x0, a);
  load32(x1, b);
#pragma unroll
  for (int p = 0; p < W32; ++p) {
    const uint32_t un0 = a[p] ^ (prod[p] & um);
    const uint32_t un1 = b[p] ^ ((prod[p] & vm) >> sh);
    a[p] = (un0 & um) | ((a[p] ^ (un0 << sh)) & vm);
    b[p] = (un1 & um) | ((b[p] ^ (un1 << sh)) & vm);
  }
  store32(x0, a);
  store32(x1, b);
}

__device__ __forceinline__ void low_base(uint32_t* w, uint32_t t, uint32_t q,
                                         const uint32_t* __restrict__ mt,
                                         const uint32_t* __restrict__ mi) {
#pragma unroll
  for (int p = 0; p < W32; ++p)
    w[p] = parity_plane(t, __ldg(mt + p)) ^ parity_plane(q, __ldg(mi + p));
}

__global__ void __launch_bounds__(MAX_THREADS)
    stage_group32_kernel(uint32_t* __restrict__ x,
                         const uint32_t* __restrict__ mtile,
                         const uint32_t* __restrict__ minst,
                         const uint32_t* __restrict__ mlo_t,
                         const uint32_t* __restrict__ mlo_i,
                         const uint32_t* __restrict__ cpl,
                         const uint32_t* __restrict__ lpl, int k, int post,
                         int include_low, int zero_mask) {
  const uint32_t q = blockIdx.x / post;
  const int j0 = blockIdx.x % post;
  const int kk = 1 << k;
  const size_t row_stride = static_cast<size_t>(post) * ROW;
  uint32_t* tile =
      x + (static_cast<size_t>(q) * kk * post + j0) * static_cast<size_t>(ROW);
  const int n_bfly = (kk >> 1) * PACK;

  for (int st = 0; st < k; ++st) {
    const int p = k - 1 - st;
    const uint32_t lowm = (1u << p) - 1u;
    const bool zero = (zero_mask >> st) & 1;
    const uint32_t* mt = mtile + st * W32;
    const uint32_t* mi = minst + st * W32;
#pragma unroll 1
    for (int i = threadIdx.x; i < n_bfly; i += blockDim.x) {
      const int c = i % PACK;        // neighbouring threads: one row's groups
      const uint32_t b = i / PACK;   // butterfly index in [0, 2^(k-1))
      const uint32_t t = ((b & ~lowm) << 1) | (b & lowm);   // bit p clear
      uint32_t* u = tile + t * row_stride + c * W32;
      uint32_t w[W32];
      if (!zero) low_base(w, t >> (p + 1), q, mt, mi);
      group_butterfly(u, u + (static_cast<size_t>(1) << p) * row_stride, w,
                      zero);
    }
    __syncthreads();
  }

  if (!include_low) return;
  // post == 1: the tile's rows are contiguous
#pragma unroll 1
  for (int t = threadIdx.x; t < kk; t += blockDim.x) {
    uint32_t* row = tile + static_cast<size_t>(t) * ROW;
    // stage 6 (i = 0): groups h, h + 2; stage 5 (i = 1): 2h, 2h + 1, and
    // the twiddle gains cpl[1][2h] (cpl[0] is zero)
#pragma unroll 1
    for (int m = 0; m < 4; ++m) {
      const int i = m >> 1, h = m & 1;
      const int cu = i == 0 ? h : 2 * h;
      const int cv = i == 0 ? h + 2 : 2 * h + 1;
      const bool zero = (zero_mask >> (k + i)) & 1;
      uint32_t w[W32];
      if (!zero) {
        low_base(w, t, q, mlo_t + i * W32, mlo_i + i * W32);
#pragma unroll
        for (int p = 0; p < W32; ++p)
          w[p] ^= __ldg(cpl + (i * PACK + cu) * W32 + p);
      }
      group_butterfly(row + cu * W32, row + cv * W32, w, zero);
    }
    // stages 4..0 (i = 2..6), in-word, lane groups (0, 1) then (2, 3)
#pragma unroll 1
    for (int m = 4; m < 2 * N_LOW; ++m) {
      const int i = m >> 1, h = m & 1;
      const bool zero = (zero_mask >> (k + i)) & 1;
      uint32_t w0[W32], w1[W32];
      if (!zero) {
        low_base(w0, t, q, mlo_t + i * W32, mlo_i + i * W32);
#pragma unroll
        for (int p = 0; p < W32; ++p) {
          const uint32_t l = __ldg(lpl + i * W32 + p);
          w1[p] = w0[p] ^ l ^ __ldg(cpl + (i * PACK + 2 * h + 1) * W32 + p);
          w0[p] ^= l ^ __ldg(cpl + (i * PACK + 2 * h) * W32 + p);
        }
      }
      inword_butterfly(row + 2 * h * W32, row + (2 * h + 1) * W32, w0, w1,
                       6 - i, zero);
    }
  }
}

}  // namespace

// x: (n_inst, 2^k, post, 128) uint32, updated in place; mtile, minst:
// (k, 32); with include_low (then post == 1) mlo_t, mlo_i, lpl: (7, 32)
// and cpl: (7, 4, 32), else null.  Bit st of zero_mask marks stage st (row
// stages first, then the seven low stages) as all-zero.  One block per
// (instance, column).  Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int bntt_stage_group32(void* x, const void* mtile,
                                  const void* minst, const void* mlo_t,
                                  const void* mlo_i, const void* cpl,
                                  const void* lpl, int n_inst, int k,
                                  int post, int include_low, int zero_mask,
                                  void* stream) {
  if (k < 0 || k > 24 || n_inst < 1 || post < 1 ||
      (include_low && (post != 1 || mlo_t == nullptr || mlo_i == nullptr ||
                       cpl == nullptr || lpl == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(n_inst) * post;
  const int rows_work = (1 << k) / 2 * PACK;
  const int low_work = include_low ? (1 << k) : 0;
  const int work = rows_work > low_work ? rows_work : low_work;
  if (work < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = work < MAX_THREADS ? work : MAX_THREADS;
  stage_group32_kernel<<<(unsigned)blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(x), static_cast<const uint32_t*>(mtile),
      static_cast<const uint32_t*>(minst),
      static_cast<const uint32_t*>(mlo_t),
      static_cast<const uint32_t*>(mlo_i), static_cast<const uint32_t*>(cpl),
      static_cast<const uint32_t*>(lpl), k, post, include_low, zero_mask);
  return static_cast<int>(cudaGetLastError());
}
