// sumcheck_round: one round of the bit-sliced GF(2^128) sumcheck prover.
//
// Replaces binius_ntt_tpu/sumcheck/pallas_round.py::round_kernel
// (pallas_call at :270; bodies _work_rolled :118 and the unrolled
// column-outer body :231-262).
//
// evals is (C, B, 128) uint32 bit-sliced batches, of which the first `rows`
// are live; half = rows / 2.  For every lower row r < half and its partner
// r + half, the thread forms the composition products (the product over
// the C columns) of
//   point 0: the lower rows;  point 1: the upper rows;
//   point p >= 2: lo ^ p * (lo ^ up), per column,
// and XORs them into its partials: out[0] = total (points 0 ^ 1), out[1 + p]
// = point p.  Multiplying by the constant p of the height-2 subfield is a
// GF(2)-linear map on each 4-plane chunk, so the fold is the 4x4 matrix of
// mul-by-p (4-bit row masks from the host, FoldMasks) applied with XORs.
//
// In-word rounds (rows = 1, the last rounds of the protocol, 32 or fewer
// evaluations): the first `lanes` lanes of batch 0 are live, and lane j
// pairs with lane j + lanes/2.  The upper operand is then the lower one
// shifted right by lanes/2 (the reference's fold_small, core.cu:58-82), and
// the products keep only their live lanes: out[0] = the lower product on
// `lanes` lanes, the points on lanes/2.  Summing the 32 lanes of each output
// batch gives the round's message in both modes.
//
// Bound on this card: integer ALU, then local memory.  A row pair costs
// (C - 1) * (C + 1) multiplies of 10,326 LOP3 operations (13,448 two-input
// gates) for 2 * C * 512 bytes of reads: ~15 ops per byte at C = 2, ~38 at
// C = 4, against a balance of ~5 for this card; the multiply spills to
// local memory (tower_mul.cuh).
//
// Design: one thread per row pair, grid-stride over the live half, column
// outer like the reference's unrolled body: each column is loaded once and
// feeds all C + 1 running products.  C is a runtime argument and the loops
// over columns and points stay rolled: a kernel templated on C, with those
// loops unrolled, made ptxas fall back to 32 registers (the multiply then
// spills ~7 KB) at C <= 5 and built in 62 s for C = 2..8.  Blocks run in
// no order, so the Pallas accumulator that carries from one grid step to
// the next becomes a block reduction (warp shuffles, then shared memory)
// and one atomicXor per word into the (C + 2, 128) output, which the
// wrapper zeroes.  XOR is order-free, so the result is exact and
// deterministic.  `rows` is a runtime argument: no row past it is read,
// and any even rows >= 2 runs, down to the in-word rounds in one thread.
#include <cuda_runtime.h>

#include <cstdint>

#include "tower_mul.cuh"

namespace {

constexpr int W = 128;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_C = 8;
constexpr long long MAX_BLOCKS = 1024;

// matrix of point 2 + e: bits 4j .. 4j+3 of m[e] are row j
struct FoldMasks {
  uint32_t m[MAX_C - 1];
};

__device__ __forceinline__ void load_row(const uint32_t* src, uint32_t* dst) {
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < W / 4; ++i) {
    const uint4 v = s4[i];
    dst[4 * i] = v.x; dst[4 * i + 1] = v.y; dst[4 * i + 2] = v.z; dst[4 * i + 3] = v.w;
  }
}

// dst = lo ^ M(xh) on every 4-plane chunk
__device__ __forceinline__ void fold_point(const uint32_t* lo,
                                           const uint32_t* xh, uint32_t m,
                                           uint32_t* dst) {
#pragma unroll
  for (int c = 0; c < W / 4; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t v = lo[4 * c + j];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v ^= xh[4 * c + k] & (0u - ((m >> (4 * j + k)) & 1u));
      dst[4 * c + j] = v;
    }
  }
}

// acc = acc * x (tmp is scratch)
__device__ __forceinline__ void mul_into(uint32_t* acc, const uint32_t* x,
                                         uint32_t* tmp) {
  tower_mul128(acc, x, tmp);
#pragma unroll
  for (int i = 0; i < W; ++i) acc[i] = tmp[i];
}

// acc = x (the first column starts every running product)
__device__ __forceinline__ void start_or_mul(bool first, uint32_t* acc,
                                             const uint32_t* x,
                                             uint32_t* tmp) {
  if (first) {
#pragma unroll
    for (int i = 0; i < W; ++i) acc[i] = x[i];
  } else {
    mul_into(acc, x, tmp);
  }
}

__global__ void __launch_bounds__(THREADS)
    sumcheck_round_kernel(const uint32_t* __restrict__ evals, int comp,
                          long long col_stride, long long half, int in_word,
                          int lanes, FoldMasks fm, uint32_t* __restrict__ out) {
  const int ne = comp - 1;      // points 2 .. C
  const int nout = comp + 2;    // total, points 0 .. C
  const int shift = lanes / 2;  // in-word: lane j + shift pairs with lane j
  const uint32_t keep_all = lanes == 32 ? ~0u : (1u << lanes) - 1u;
  const uint32_t keep = in_word ? (1u << shift) - 1u : ~0u;
  uint32_t part[MAX_C + 2][W];
#pragma unroll 1
  for (int o = 0; o < nout; ++o)
#pragma unroll
    for (int i = 0; i < W; ++i) part[o][i] = 0u;

  uint32_t lo[W], up[W], xh[W], f[W], tmp[W], plo[W], pup[W];
  uint32_t acc[MAX_C - 1][W];
  for (long long r = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       r < half; r += static_cast<long long>(gridDim.x) * THREADS) {
#pragma unroll 1
    for (int cc = 0; cc < comp; ++cc) {
      const uint32_t* col = evals + cc * col_stride;
      load_row(col + r * W, lo);
      if (in_word) {
#pragma unroll
        for (int i = 0; i < W; ++i) up[i] = lo[i] >> shift;
      } else {
        load_row(col + (r + half) * W, up);
      }
#pragma unroll
      for (int i = 0; i < W; ++i) xh[i] = lo[i] ^ up[i];
      start_or_mul(cc == 0, plo, lo, tmp);
      start_or_mul(cc == 0, pup, up, tmp);
#pragma unroll 1
      for (int e = 0; e < ne; ++e) {
        fold_point(lo, xh, fm.m[e], f);
        start_or_mul(cc == 0, acc[e], f, tmp);
      }
    }
#pragma unroll
    for (int i = 0; i < W; ++i) {
      part[0][i] ^= in_word ? plo[i] & keep_all : plo[i] ^ pup[i];
      part[1][i] ^= plo[i] & keep;
      part[2][i] ^= pup[i] & keep;
    }
#pragma unroll 1
    for (int e = 0; e < ne; ++e)
#pragma unroll
      for (int i = 0; i < W; ++i) part[3 + e][i] ^= acc[e][i] & keep;
  }

  // block reduction: warp shuffles, then across the warps in shared memory
  __shared__ uint32_t red[WARPS][(MAX_C + 2) * W];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll 1
  for (int w = 0; w < nout * W; ++w) {
    uint32_t v = part[w / W][w % W];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v ^= __shfl_xor_sync(0xffffffffu, v, s);
    if (lane == 0) red[warp][w] = v;
  }
  __syncthreads();
  for (int w = threadIdx.x; w < nout * W; w += THREADS) {
    uint32_t v = 0u;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) v ^= red[k][w];
    if (v) atomicXor(out + w, v);
  }
}

}  // namespace

// evals: (comp, b, 128) uint32, 16-byte aligned, rows live (even, 2..b,
// with lanes = 32; or rows = 1 with lanes 1, 2, 4, .., 32 live lanes);
// out: (comp + 2, 128) uint32, zeroed by the caller; masks: comp - 1 host
// words, the fold matrices of points 2 .. comp.  Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int bntt_sumcheck_round(const void* evals, void* out, int comp,
                                   long long b, long long rows, int lanes,
                                   const uint32_t* masks, void* stream) {
  const bool in_word = rows == 1;
  const bool lanes_ok = in_word ? (lanes >= 1 && lanes <= 32 &&
                                   (lanes & (lanes - 1)) == 0)
                                : lanes == 32;
  if (comp < 2 || comp > MAX_C || rows < 1 || rows > b || !lanes_ok ||
      (!in_word && rows % 2 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  FoldMasks fm = {};
  for (int e = 0; e < comp - 1; ++e) fm.m[e] = masks[e];
  const long long half = in_word ? 1 : rows / 2;
  long long blocks = (half + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  sumcheck_round_kernel<<<(unsigned)blocks, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(evals), comp, b * W, half, in_word ? 1 : 0,
      lanes, fm, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
