// sumcheck_round: one round of the bit-sliced GF(2^128) sumcheck prover.
//
// Replaces binius_ntt_tpu/sumcheck/pallas_round.py::round_kernel
// (pallas_call at :270; bodies _work_rolled :118 and the unrolled
// column-outer body :231-262).
//
// evals is (C, B, 128) uint32 bit-sliced batches, of which the first `rows`
// are live; half = rows / 2.  For every lower row r < half and its partner
// r + half, the thread forms the composition products (the product over
// the C columns) of every point p = 0 .. C: each column folded at p,
// lo ^ p * (lo ^ up), which is the lower row at p = 0 and the upper one at
// p = 1.  out[0] = total (points 0 ^ 1), out[1 + p] = point p.
// Multiplying by the constant p of the height-2 subfield is a GF(2)-linear
// map on each 4-plane chunk, so the fold is the 4x4 matrix of mul-by-p
// (4-bit row masks; points 2 .. C from the host, FoldMasks) applied with
// XORs.
//
// In-word rounds (rows = 1, the last rounds of the protocol, 32 or fewer
// evaluations): the first `lanes` lanes of batch 0 are live, and lane j
// pairs with lane j + lanes/2.  The upper operand is then the lower one
// shifted right by lanes/2 (the reference's fold_small, core.cu:58-82), and
// the products keep only their live lanes: out[0] = the lower product on
// `lanes` lanes, the points on lanes/2.  Summing the 32 lanes of each output
// batch gives the round's message in both modes.
//
// Bound on this card: integer ALU.  A row pair costs (C - 1) * (C + 1)
// multiplies of 10,326 LOP3 operations (13,448 two-input gates) for
// 2 * C * 512 bytes of reads: ~15 ops per byte at C = 2, ~38 at C = 4,
// against a balance of ~5 for this card.
//
// Design: a warp's unit of work is one point of 32 row pairs, a row pair
// a lane (idle lanes past the half add nothing); warps grid-stride over
// the units, the C + 1 points of a group of row pairs next to each other.
//
//   * Point outer: a thread keeps one running product, where a
//     column-outer body keeps C + 1 of them.  The columns are read again
//     for each point, by neighbouring warps at about the same time, and
//     the in-word rounds (one row pair) spread their points over C + 1
//     warps.
//   * Each GF(2^128) product is nine GF(2^32) leaf products, made in place
//     (csrc/tower_leaf32.cuh, shared with the fold): one inline tower_mul32
//     call site in a rolled loop over the leaves, no spills.
//   * A thread's words live in shared memory, plane-major and thread-minor
//     (word i at [i * THREADS + t], free of bank conflicts): the running
//     product, the folded column and zm, 1.25 KB a thread, so two 64-thread
//     blocks an SM.  Two blocks of 64 (or one of 128) ran faster than five
//     of 32 or one of 160 (5 warps), and loading the next leaf's operands
//     early gained nothing (PERF.md, PR 9).
//   * After each point the warp reduce-scatters its 32 products (five
//     __shfl_xor_sync halvings of 64 .. 4 words), so that lane l owns words
//     4l .. 4l+3 of the point summed over the warp, and XORs them into the
//     block's (C + 2, 128) sums in shared memory.  The masks of the in-word
//     rounds and of total-vs-point are constants over the lanes' words and
//     commute with the XOR, so they are applied to the owned words.
//
// C is a runtime argument and the loops over units, columns and leaves
// stay rolled around the multiply (unrolled, ptxas fell back to 32
// registers).  Blocks run in no order, so the Pallas accumulator that
// carries from one grid step to the next becomes one atomicXor per word of
// each block's sums into the (C + 2, 128) output, which the wrapper zeroes;
// the grid is at most what the card holds at once, balanced so that every
// warp runs the same number of units.  XOR is order-free, so the result is
// exact and deterministic.  `rows` is a runtime argument: no row past it is
// read, and any even rows >= 2 runs, down to the in-word rounds' one row
// pair.
#include <cuda_runtime.h>

#include <cstdint>

#include "tower_leaf32.cuh"

namespace {

constexpr int W = 128;
using leaf32::C32;
constexpr int THREADS = 64;
constexpr int WARPS = THREADS / 32;
// words a thread keeps: the running product, the folded column and zm
constexpr int NWORDS = 2 * W + 2 * C32;
constexpr int MAX_C = 8;
constexpr uint32_t FULL = 0xffffffffu;
// fold matrix of point 1, the identity: bit 4j + j of row j
constexpr uint32_t IDENTITY = 0x8421u;

// matrix of point p, p = 0 .. C: bits 4j .. 4j+3 of m[p] are row j
struct FoldMasks {
  uint32_t m[MAX_C + 1];
};

// dst[i * THREADS] = word i of lo ^ M(lo ^ up): one row of a column at the
// point of matrix m.  up is the row at lo + up_off shifted right by
// `shift` (0 outside the in-word rounds, where up_off is the half).
__device__ __forceinline__ void fold_row(const uint32_t* lo, long long up_off,
                                         int shift, uint32_t m,
                                         uint32_t* dst) {
  uint32_t mm[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) mm[k] = 0u - ((m >> k) & 1u);
  const uint4* l4 = reinterpret_cast<const uint4*>(lo);
  const uint4* u4 = reinterpret_cast<const uint4*>(lo + up_off);
#pragma unroll 8
  for (int c = 0; c < W / 4; ++c) {
    const uint4 l = l4[c], u = u4[c];
    const uint32_t x[4] = {l.x, l.y, l.z, l.w};
    const uint32_t h[4] = {l.x ^ (u.x >> shift), l.y ^ (u.y >> shift),
                           l.z ^ (u.z >> shift), l.w ^ (u.w >> shift)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t v = x[j];
#pragma unroll
      for (int k = 0; k < 4; ++k) v ^= h[k] & mm[4 * j + k];
      dst[(4 * c + j) * THREADS] = v;
    }
  }
}

// one step of reduce_scatter: t[0, N) = the half of t[0, 2N) that lane bit
// D selects, plus the partner lane's copy of that half
template <int N, int D>
__device__ __forceinline__ void halve(uint32_t* t) {
  const bool top = threadIdx.x & D;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t a = t[i], b = t[N + i];
    t[i] = (top ? b : a) ^ __shfl_xor_sync(FULL, top ? a : b, D);
  }
}

// XOR of the 32 lanes' 128-word rows v (word i at v[i * THREADS]),
// scattered: lane l gets words 4l .. 4l+3 in s.  Each of the five steps
// halves the words a lane holds (124 shuffles in all).  A lane that is not
// live takes its row as zeros.
__device__ __forceinline__ void reduce_scatter(const uint32_t* v, bool live,
                                               uint32_t* s) {
  uint32_t t[W / 2];
  const bool top = threadIdx.x & 16;
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    const uint32_t a = live ? v[i * THREADS] : 0u;
    const uint32_t b = live ? v[(W / 2 + i) * THREADS] : 0u;
    t[i] = (top ? b : a) ^ __shfl_xor_sync(FULL, top ? a : b, 16);
  }
  halve<32, 8>(t);
  halve<16, 4>(t);
  halve<8, 2>(t);
  halve<4, 1>(t);
#pragma unroll
  for (int k = 0; k < 4; ++k) s[k] = t[k];
}

// the block's sums: sum[q][4 * lane + k] ^= s[k] & mask
__device__ __forceinline__ void add_owned(uint32_t* sum, int q,
                                          const uint32_t* s, uint32_t mask) {
  uint32_t* dst = sum + q * W + 4 * (threadIdx.x % 32);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (s[k] & mask) atomicXor(dst + k, s[k] & mask);
}

__global__ void __launch_bounds__(THREADS)
    sumcheck_round_kernel(const uint32_t* __restrict__ evals, int comp,
                          long long col_stride, long long half,
                          long long up_off, int lanes, FoldMasks fm,
                          uint32_t* __restrict__ out) {
  extern __shared__ uint4 smem4[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* sum = sm + NWORDS * THREADS;
  const bool in_word = up_off == 0;
  const int nout = comp + 2;    // total, points 0 .. C
  const int shift = in_word ? lanes / 2 : 0;
  const uint32_t keep_all = lanes == 32 ? ~0u : (1u << lanes) - 1u;
  const uint32_t keep = in_word ? (1u << shift) - 1u : ~0u;
  for (int w = threadIdx.x; w < nout * W; w += THREADS) sum[w] = 0u;
  __syncthreads();

  // this thread's words: word i of a buffer at buf[i * THREADS]
  uint32_t* const mine = sm + threadIdx.x;
  uint32_t* const f = mine + W * THREADS;
  uint32_t* const t = mine + 2 * W * THREADS;
  const int npts = comp + 1;
  const long long units = (half + 31) / 32 * npts;
  const long long nwarps = static_cast<long long>(gridDim.x) * WARPS;
  for (long long u = static_cast<long long>(blockIdx.x) * WARPS +
                     threadIdx.x / 32;
       u < units; u += nwarps) {
    const int o = static_cast<int>(u % npts);
    const long long r = u / npts * 32 + threadIdx.x % 32;
    const bool live = r < half;
    uint32_t m = 0u;    // fm.m[o], picked without a local copy of fm
#pragma unroll
    for (int q = 0; q <= MAX_C; ++q) m = q == o ? fm.m[q] : m;
    uint32_t* const acc = mine;
    if (live) {
      fold_row(evals + r * W, up_off, shift, m, acc);
#pragma unroll 1
      for (int cc = 1; cc < comp; ++cc) {
        fold_row(evals + cc * col_stride + r * W, up_off, shift, m, f);
        leaf32::mul_in_place<THREADS>(
            acc, leaf32::GatherLeaf<THREADS>{f}, t);
      }
    }
    uint32_t s[4];
    reduce_scatter(acc, live, s);
    if (o == 0) {
      add_owned(sum, 0, s, in_word ? keep_all : ~0u);
      add_owned(sum, 1, s, keep);
    } else if (o == 1) {
      if (!in_word) add_owned(sum, 0, s, ~0u);
      add_owned(sum, 2, s, keep);
    } else {
      add_owned(sum, 1 + o, s, keep);
    }
  }

  __syncthreads();
  for (int w = threadIdx.x; w < nout * W; w += THREADS)
    if (sum[w]) atomicXor(out + w, sum[w]);
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
  fm.m[1] = IDENTITY;
  for (int e = 0; e < comp - 1; ++e) fm.m[2 + e] = masks[e];
  const long long half = in_word ? 1 : rows / 2;
  const int smem = (NWORDS * THREADS + (comp + 2) * W) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      sumcheck_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sumcheck_round_kernel, THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // at most as many blocks as the card holds at once, each warp with the
  // same number of units (one fewer for some)
  const long long slots =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const long long units = (half + 31) / 32 * (comp + 1);
  long long blocks = (units + WARPS - 1) / WARPS;
  if (blocks > slots) {
    const long long iters = (blocks + slots - 1) / slots;
    blocks = (blocks + iters - 1) / iters;
  }
  sumcheck_round_kernel<<<(unsigned)blocks, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(evals), comp, b * W, half,
      in_word ? 0 : half * W, lanes, fm, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
