// prime_fold: the challenge fold of the QM31 sumcheck prover, in place.
//
// Replaces binius_ntt_tpu/sumcheck/pallas_prime_round.py::fold_kernel_impl
// (pallas_call at :253).
//
// evals is (2, B, 4) uint32 QM31 values (AoS, one 16-byte word each) with
// the first `rows` rows live; half = rows / 2.  Every row i < half of both
// columns becomes lo + (up - lo) * r, lo = row i, up = row i + half, r the
// challenge (kernels.cu:5-25).
//
// Bound on this card: memory.  At 2^24 rows the first fold reads 512 MB and
// writes 256 MB (0.23 ms at 3.35 TB/s) for one 9-multiply QM31 product per
// 32 bytes read.
//
// Design: one thread per (column, row i < half), one 16-byte load of each
// operand and one 16-byte store.  The fold runs in place at the original
// stride: a thread writes only row i, which no other thread reads (they
// read rows i' < half and i' + half >= half), so the state needs no second
// buffer; the Pallas kernel writes a fresh one only to keep XLA from
// copying a twice-read donated input (pallas_prime_round.py:261-264).  The
// challenge arrives as four scalar arguments.
#include <cuda_runtime.h>

#include <cstdint>

#include "m31.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    prime_fold_kernel(uint4* __restrict__ evals, long long b, long long half,
                      uint4 r) {
  const long long idx = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= 2 * half) return;
  const long long c = idx / half;
  const long long i = idx - c * half;
  uint4* col = evals + c * b;
  const uint4 lo = col[i];
  const uint4 up = col[i + half];
  col[i] = m31::qm31_add(lo, m31::qm31_mul(m31::qm31_sub(up, lo), r));
}

}  // namespace

// evals: (2, b, 4) uint32 QM31 values, 16-byte aligned, updated in place;
// rows live (even, 2..b); r0..r3: the challenge's components, canonical.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int bntt_prime_fold(void* evals, long long b, long long rows,
                               uint32_t r0, uint32_t r1, uint32_t r2,
                               uint32_t r3, void* stream) {
  if (rows < 2 || rows > b || rows % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long half = rows / 2;
  const long long blocks = (2 * half + THREADS - 1) / THREADS;
  prime_fold_kernel<<<(unsigned)blocks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(evals), b, half, make_uint4(r0, r1, r2, r3));
  return static_cast<int>(cudaGetLastError());
}
