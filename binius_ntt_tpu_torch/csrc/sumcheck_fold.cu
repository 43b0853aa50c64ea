// sumcheck_fold: the challenge fold of the bit-sliced GF(2^128) sumcheck
// prover, in place.
//
// Replaces binius_ntt_tpu/sumcheck/pallas_round.py::fold_kernel_impl
// (pallas_call at :367).
//
// evals is (C, B, 128) uint32 bit-sliced batches with the first `rows`
// live; half = rows / 2.  Every lower row r < half of every column becomes
// lo ^ w * (lo ^ up), with up = row r + half and w the 128-bit challenge
// broadcast to all 32 lanes: plane i of w is 0xFFFFFFFF where bit i of the
// challenge is set (the Pallas kernel's host-side `planes`, :319-320).
//
// In-word folds (rows = 1, 32 or fewer evaluations): the first `lanes` lanes
// of batch 0 are live and up is lo shifted right by lanes/2, so lane j folds
// with lane j + lanes/2 (the reference's fold_small, core.cu:58-82).  Every
// lane is written, as there: the lanes past lanes/2 hold what the reference
// leaves in them, so a saved state matches its words.  The mode is a
// template argument: a run-time branch in the load loop raised the row
// instance's spills from 352 to 2,724 bytes and its time by half.
//
// Bound on this card: integer ALU.  A row costs one multiply of 10,326 LOP3
// operations for 1.5 KB of traffic (~6.7 ops per byte, above the card's ~5).
//
// Design: one thread per (column, lower row).  The fold runs in place at
// the original stride, as the reference CUDA does: a thread writes only row
// r, which no other thread reads (the other threads read rows r' < half
// and r' + half >= half).  The Pallas kernel writes a fresh buffer only to
// keep XLA from copying a twice-read donated input (:374-381); here the
// state never needs a second buffer.
//
//   * The product w * (lo ^ up) is csrc/tower_leaf32.cuh's in-place nine
//     GF(2^32) leaves, as in the round kernel: xh = lo ^ up and zm's 64
//     planes of scratch in shared memory, plane-major and thread-minor
//     (word i at [i * THREADS + t]), 768 B a thread; lo is read again from
//     global memory for the last XOR.  224 registers, no spills; four
//     64-thread blocks (8 warps) an SM.  Four warps an SM, by padding or
//     by keeping lo in shared memory (1.25 KB a thread), ran 20-30% slower
//     (PERF.md, section 6).
//   * w is the same for every thread, and each of its planes is all ones
//     or all zeros, so its leaf operands are a table: word i of leaf l is
//     all ones where the XOR of the challenge words in chunk subset
//     GROUPED[l] has bit i set.  The block forms the 9 x 32 words in shared
//     memory at entry, and every thread reads them at one address (a
//     broadcast).
//   * The row's load and store loops are unrolled by 8: fully unrolled,
//     ptxas spilled ~1.1 KB a thread and the fold ran 36-40% slower.
#include <cuda_runtime.h>

#include <cstdint>

#include "tower_leaf32.cuh"

namespace {

constexpr int W = 128;
using leaf32::C32;
using leaf32::N_LEAF;
constexpr int THREADS = 64;
// words a thread keeps: xh and zm
constexpr int NWORDS = W + 2 * C32;
// words of the challenge's leaf table
constexpr int TABLE = N_LEAF * C32;

// w's leaf l, read from the block's table
struct TableLeaf {
  const uint32_t* table;
  __device__ __forceinline__ void operator()(int l, uint32_t* y) const {
#pragma unroll
    for (int i = 0; i < C32; ++i) y[i] = table[l * C32 + i];
  }
};

template <bool IN_WORD>
__global__ void __launch_bounds__(THREADS)
    sumcheck_fold_kernel(uint32_t* __restrict__ evals, long long col_stride,
                         long long half, long long total, int shift,
                         uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3) {
  extern __shared__ uint4 smem4[];
  uint32_t* const table = reinterpret_cast<uint32_t*>(smem4);
  for (int w = threadIdx.x; w < TABLE; w += THREADS) {
    const uint32_t s = leaf32::GROUPED[w / C32];
    const uint32_t v = ((s & 1u) ? c0 : 0u) ^ ((s & 2u) ? c1 : 0u) ^
                       ((s & 4u) ? c2 : 0u) ^ ((s & 8u) ? c3 : 0u);
    table[w] = 0u - ((v >> (w % C32)) & 1u);
  }
  __syncthreads();
  const long long idx = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= total) return;
  const long long c = idx / half;
  const long long r = idx % half;
  uint4* lo4 = reinterpret_cast<uint4*>(evals + c * col_stride + r * W);
  const uint4* up4 = reinterpret_cast<const uint4*>(
      evals + c * col_stride + (IN_WORD ? r : r + half) * W);
  // this thread's words: word i of a buffer at buf[i * THREADS]
  uint32_t* const xh = table + TABLE + threadIdx.x;
  uint32_t* const t = xh + W * THREADS;
#pragma unroll 8
  for (int i = 0; i < W / 4; ++i) {
    const uint4 a = lo4[i];
    const uint4 b = IN_WORD ? make_uint4(a.x >> shift, a.y >> shift,
                                         a.z >> shift, a.w >> shift)
                            : up4[i];
    xh[(4 * i) * THREADS] = a.x ^ b.x;
    xh[(4 * i + 1) * THREADS] = a.y ^ b.y;
    xh[(4 * i + 2) * THREADS] = a.z ^ b.z;
    xh[(4 * i + 3) * THREADS] = a.w ^ b.w;
  }
  leaf32::mul_in_place<THREADS>(xh, TableLeaf{table}, t);
#pragma unroll 8
  for (int i = 0; i < W / 4; ++i) {
    const uint4 a = lo4[i];
    lo4[i] = make_uint4(a.x ^ xh[(4 * i) * THREADS],
                        a.y ^ xh[(4 * i + 1) * THREADS],
                        a.z ^ xh[(4 * i + 2) * THREADS],
                        a.w ^ xh[(4 * i + 3) * THREADS]);
  }
}

}  // namespace

// evals: (comp, b, 128) uint32, 16-byte aligned, updated in place; rows
// live (even, 2..b, with lanes = 32; or rows = 1 with lanes 2, 4, .., 32
// live lanes); c0..c3: the challenge, little-endian words.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int bntt_sumcheck_fold(void* evals, int comp, long long b,
                                  long long rows, int lanes, uint32_t c0,
                                  uint32_t c1, uint32_t c2, uint32_t c3,
                                  void* stream) {
  const bool in_word = rows == 1;
  const bool lanes_ok = in_word ? (lanes >= 2 && lanes <= 32 &&
                                   (lanes & (lanes - 1)) == 0)
                                : lanes == 32;
  if (comp < 1 || rows < 1 || rows > b || !lanes_ok ||
      (!in_word && rows % 2 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long half = in_word ? 1 : rows / 2;
  const long long total = comp * half;
  const long long blocks = (total + THREADS - 1) / THREADS;
  auto kernel = in_word ? sumcheck_fold_kernel<true>
                        : sumcheck_fold_kernel<false>;
  const int smem = (TABLE + NWORDS * THREADS) * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(unsigned)blocks, THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(evals), b * W, half, total, lanes / 2, c0, c1,
      c2, c3);
  return static_cast<int>(cudaGetLastError());
}
