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
// challenge is set (the Pallas kernel's host-side `planes`, :319-320, built
// here from the 4 challenge words).
//
// In-word folds (rows = 1, 32 or fewer evaluations): the first `lanes` lanes
// of batch 0 are live and up is lo shifted right by lanes/2, so lane j folds
// with lane j + lanes/2 (the reference's fold_small, core.cu:58-82).  Every
// lane is written, as there: the lanes past lanes/2 hold what the reference
// leaves in them, so a saved state matches its words.  The mode is a
// template argument: a run-time branch in the load loop raised the row
// instance's spills from 352 to 2,724 bytes and its time by half.
//
// Bound on this card: integer ALU, then local memory.  A row costs one
// multiply of 10,326 LOP3 operations for 1.5 KB of traffic (~6.7 ops per
// byte, above the card's ~5); the multiply spills (tower_mul.cuh).
//
// Design: one thread per (column, lower row).  The fold runs in place at
// the original stride, as the reference CUDA does: a thread writes only row
// r, which no other thread reads (the other threads read rows r' < half
// and r' + half >= half).  The Pallas kernel writes a fresh buffer only to
// keep XLA from copying a twice-read donated input (:374-381); here the
// state never needs a second buffer.
#include <cuda_runtime.h>

#include <cstdint>

#include "tower_mul.cuh"

namespace {

constexpr int W = 128;
constexpr int THREADS = 128;

template <bool IN_WORD>
__global__ void __launch_bounds__(THREADS)
    sumcheck_fold_kernel(uint32_t* __restrict__ evals, long long col_stride,
                         long long half, long long total, int shift,
                         uint32_t c0, uint32_t c1, uint32_t c2, uint32_t c3) {
  const long long idx = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= total) return;
  const long long c = idx / half;
  const long long r = idx % half;
  uint4* lo4 = reinterpret_cast<uint4*>(evals + c * col_stride + r * W);
  const uint4* up4 = reinterpret_cast<const uint4*>(
      evals + c * col_stride + (IN_WORD ? r : r + half) * W);
  const uint32_t ch[4] = {c0, c1, c2, c3};
  uint32_t lo[W], xh[W], w[W], prod[W];
#pragma unroll
  for (int i = 0; i < W / 4; ++i) {
    const uint4 a = lo4[i];
    const uint4 b = IN_WORD ? make_uint4(a.x >> shift, a.y >> shift,
                                         a.z >> shift, a.w >> shift)
                            : up4[i];
    lo[4 * i] = a.x; lo[4 * i + 1] = a.y; lo[4 * i + 2] = a.z; lo[4 * i + 3] = a.w;
    xh[4 * i] = a.x ^ b.x; xh[4 * i + 1] = a.y ^ b.y;
    xh[4 * i + 2] = a.z ^ b.z; xh[4 * i + 3] = a.w ^ b.w;
  }
#pragma unroll
  for (int i = 0; i < W; ++i) w[i] = 0u - ((ch[i / 32] >> (i % 32)) & 1u);
  tower_mul128(w, xh, prod);
#pragma unroll
  for (int i = 0; i < W / 4; ++i)
    lo4[i] = make_uint4(lo[4 * i] ^ prod[4 * i], lo[4 * i + 1] ^ prod[4 * i + 1],
                        lo[4 * i + 2] ^ prod[4 * i + 2],
                        lo[4 * i + 3] ^ prod[4 * i + 3]);
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
  kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(evals), b * W, half, total, lanes / 2, c0, c1,
      c2, c3);
  return static_cast<int>(cudaGetLastError());
}
