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
// Bound on this card: integer ALU, then local memory.  Every butterfly is
// one 128-plane multiply, 10,326 three-input LOP3 operations (13,448
// two-input gates; chip_smoke.tower_mul_ops) for 2 KB of row traffic that
// stays in L2 between stages; the circuit spills to local memory (see
// tower_mul.cuh).
//
// Design: one thread block per (instance, chunk of `cols` columns).  The
// block loops over the group's high stages with a __syncthreads() between
// them; each thread runs whole butterflies, and the tile stays in global
// memory (a k = 8 tile is 128 KB per column, served from the 50 MB L2).
// The in-word stages are thread-local: one thread owns a row pair for all
// five of them.  Stages flagged in zero_mask have an all-zero twiddle and
// skip the multiply.
#include <cuda_runtime.h>

#include <cstdint>

#include "tower_mul.cuh"

namespace {

constexpr int W = 128;
constexpr int MAX_THREADS = 256;
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

__device__ __forceinline__ void load_row(const uint32_t* src, uint32_t* dst) {
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < W / 4; ++i) {
    const uint4 v = s4[i];
    dst[4 * i] = v.x; dst[4 * i + 1] = v.y; dst[4 * i + 2] = v.z; dst[4 * i + 3] = v.w;
  }
}

// u' = u ^ w*v, v' = u' ^ v for one row pair at one high stage
__device__ __forceinline__ void butterfly(uint32_t* u, uint32_t* v,
                                          uint32_t blk, uint32_t q,
                                          const uint32_t* __restrict__ mt,
                                          const uint32_t* __restrict__ mi,
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
      w[i] = parity_plane(blk, __ldg(mt + i)) ^ parity_plane(q, __ldg(mi + i));
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
__device__ __forceinline__ void low_step(uint32_t* r0, uint32_t* r1,
                                         uint32_t t0, uint32_t q,
                                         const uint32_t* __restrict__ mt,
                                         const uint32_t* __restrict__ mi,
                                         const uint32_t* __restrict__ ln,
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
      const uint32_t base = parity_plane(q, __ldg(mi + i)) ^ __ldg(ln + i);
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

__global__ void __launch_bounds__(MAX_THREADS)
    stage_group_kernel(uint32_t* __restrict__ x,
                       const uint32_t* __restrict__ mtile,
                       const uint32_t* __restrict__ minst,
                       const uint32_t* __restrict__ lanes, int k, int post,
                       int cols, int n_chunks, int include_low,
                       int zero_mask) {
  const uint32_t q = blockIdx.x / n_chunks;
  const int j0 = (blockIdx.x % n_chunks) * cols;
  const int half = 1 << (k - 1);
  const size_t row_stride = static_cast<size_t>(post) * W;
  uint32_t* tile = x + (static_cast<size_t>(q) * (2 * half) * post + j0) * W;
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
      butterfly(u, u + (static_cast<size_t>(1) << p) * row_stride,
                t >> (p + 1), q, mtile + st * W, minst + st * W, zero);
    }
    __syncthreads();
  }

  if (include_low) {   // post == cols == 1: rows are contiguous
    for (int j = threadIdx.x; j < half; j += blockDim.x) {
      uint32_t* r0 = tile + static_cast<size_t>(2 * j) * W;
      for (int i = 0; i < 5; ++i) {
        const int st = k + i;
        low_step(r0, r0 + W, 2 * j, q, mtile + st * W, minst + st * W,
                 lanes + i * W, (zero_mask >> st) & 1);
      }
    }
  }
}

}  // namespace

// x: (n_inst, 2^k, post, 128) uint32, updated in place; mtile, minst:
// (k + 5*include_low, 128); lanes: (5, 128) or null.  Each block covers
// `cols` columns (cols divides post; post == cols == 1 when include_low).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int bntt_stage_group(void* x, const void* mtile, const void* minst,
                                const void* lanes, int n_inst, int k,
                                int post, int cols, int include_low,
                                int zero_mask, void* stream) {
  if (k < 1 || cols < 1 || post % cols != 0 ||
      (include_low && (post != 1 || lanes == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = post / cols;
  const long long blocks = static_cast<long long>(n_inst) * n_chunks;
  const int work = (1 << (k - 1)) * cols;
  const int threads = work < MAX_THREADS ? work : MAX_THREADS;
  stage_group_kernel<<<(unsigned)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(x), static_cast<const uint32_t*>(mtile),
      static_cast<const uint32_t*>(minst),
      static_cast<const uint32_t*>(lanes), k, post, cols, n_chunks,
      include_low, zero_mask);
  return static_cast<int>(cudaGetLastError());
}
