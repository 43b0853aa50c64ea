// prime_round: one round of the QM31 sumcheck prover (two columns, degree-2
// product composition).
//
// Replaces binius_ntt_tpu/sumcheck/pallas_prime_round.py::round_kernel_impl
// (pallas_call at :187).
//
// evals is the reference's public AoS layout, (2, B, 4) uint32: column c,
// row i is one QM31 value, one 16-byte word.  The first `rows` rows are
// live; half = rows / 2.  For every pair i < half the round polynomial's
// three evaluations gather
//   p(0) += lo0 * lo1,  p(1) += up0 * up1,  p(2) += t0 * t1,
// with lo = row i, up = row i + half and t = (up - lo) + up = 2 up - lo
// (kernels.cu:44-63, pallas_prime_round.py:163-168).
//
// Bound on this card: at 2^24 rows, the first round reads 512 MB (0.16 ms
// at 3.35 TB/s) and does three QM31 products of 9 M31 multiplies each, ~3e9
// integer operations (~0.18 ms at the int32 lane rate): both matter.  The
// design reads each value once as one 16-byte load and keeps the sums in
// registers.
//
// Design: the TPU kernel's planar (2, 4, R, 128) layout exists to fill
// (8, 128) vector registers (pallas_prime_round.py:14-18) and is not kept;
// its scalar-prefetch clamp of dead grid steps (:138-145) becomes the
// run-time `rows`, so one kernel serves every round down to rows = 2.  Each
// thread walks a grid-stride loop over pairs and keeps the 12 components
// of its three sums as lazy 64-bit integers, as the reference CUDA does
// (kernels.cu:65-77, qm31.cuh:75-78): at most 2^23 terms below 2^31 at
// 2^24 rows, so below 2^54.  Blocks run in no order, so the Pallas
// accumulator carried across grid steps becomes warp shuffles, a
// shared-memory sum over the block's warps and one atomicAdd per component
// into a (3, 4) uint64 scratch that the wrapper zeroes and reduces mod P
// once.  Integer addition is order-free, so the result is exact and
// deterministic.
#include <cuda_runtime.h>

#include <cstdint>

#include "m31.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr long long MAX_BLOCKS = 1056;  // 8 blocks of 256 on each of 132 SMs

__global__ void __launch_bounds__(THREADS)
    prime_round_kernel(const uint4* __restrict__ evals,
                       unsigned long long* __restrict__ acc, long long b,
                       long long half) {
  unsigned long long s[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) s[q] = 0;
  const uint4* col0 = evals;
  const uint4* col1 = evals + b;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       i < half; i += static_cast<long long>(gridDim.x) * THREADS) {
    const uint4 lo0 = __ldg(col0 + i), lo1 = __ldg(col1 + i);
    const uint4 up0 = __ldg(col0 + i + half), up1 = __ldg(col1 + i + half);
    const uint4 t0 = m31::qm31_add(m31::qm31_sub(up0, lo0), up0);
    const uint4 t1 = m31::qm31_add(m31::qm31_sub(up1, lo1), up1);
    const uint4 p[3] = {m31::qm31_mul(lo0, lo1), m31::qm31_mul(up0, up1),
                        m31::qm31_mul(t0, t1)};
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      s[4 * e] += p[e].x;
      s[4 * e + 1] += p[e].y;
      s[4 * e + 2] += p[e].z;
      s[4 * e + 3] += p[e].w;
    }
  }
#pragma unroll
  for (int q = 0; q < 12; ++q)
    for (int off = 16; off > 0; off >>= 1)
      s[q] += __shfl_down_sync(0xFFFFFFFFu, s[q], off);
  __shared__ unsigned long long part[WARPS][12];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < 12; ++q) part[warp][q] = s[q];
  }
  __syncthreads();
  if (threadIdx.x < 12) {
    unsigned long long total = 0;
    for (int w = 0; w < WARPS; ++w) total += part[w][threadIdx.x];
    atomicAdd(acc + threadIdx.x, total);
  }
}

}  // namespace

// evals: (2, b, 4) uint32 QM31 values, 16-byte aligned, components
// canonical; rows live (even, 2..b).  acc: (3, 4) uint64, zeroed by the
// caller; the kernel adds the lazy sums of p(0), p(1), p(2).  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int bntt_prime_round(const void* evals, void* acc, long long b,
                                long long rows, void* stream) {
  if (rows < 2 || rows > b || rows % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long half = rows / 2;
  long long blocks = (half + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  prime_round_kernel<<<(unsigned)blocks, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(evals),
      static_cast<unsigned long long*>(acc), b, half);
  return static_cast<int>(cudaGetLastError());
}
