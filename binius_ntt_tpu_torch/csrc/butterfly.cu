// butterfly_high / butterfly_low: one stage of the per-stage bit-sliced
// GF(2^128) additive NTT, in place.
//
// Replace binius_ntt_tpu/ntt/pallas_kernels.py::butterfly_high (pallas_call
// at :158) and ::butterfly_low (pallas_call at :190), the per-stage path of
// AdditiveNTT128 (additive_bitsliced.py:214-267).
//
// x is the (R, 128) uint32 working buffer of the transform: C cosets of nb
// bit-sliced batches, flattened (R = C * nb), each batch 32 elements as 128
// bit-planes.
//
// * High stage s >= 5: batches pair across bit s-5 of the batch index.  With
//   db = 2^(s-5) the rows form R / (2 db) blocks of 2 db rows; in block t,
//   row i < db (u) pairs with row db + i (v), and u' = u ^ w v, v' = u' ^ v
//   with w = w4[t], one 128-bit twiddle per block (t = coset * groups +
//   group, the order of the doubling table).  The twiddle is constant over
//   the 32 lanes, so its planes are all-ones or all-zeros: plane 32 j + b =
//   -((w4[t][j] >> b) & 1) (the reference's _expand_bits), built here in
//   registers from 16 bytes instead of read as 512 host-expanded bytes.
// * Low stage s < 5: lanes pair inside each batch, lane j (bit 2^s of j
//   clear) with lane j + 2^s.  The twiddle of lane j is the batch part
//   a4[row] (all lanes) XOR the lane part (a fixed 128-word plane set,
//   lane_planes), so the planes are expand(a4[row]) ^ lane_planes.  The
//   butterfly is un = x ^ w (x >> 2^s), x' = (un & umask) | ((x ^ (un <<
//   2^s)) & vmask), with logical shifts on uint32.  The reference expands
//   these planes on the host (pallas_kernels.py:171-175) only because
//   Mosaic rejects the in-kernel reshape; here the lane planes sit in shared
//   memory and the batch part is expanded in registers.
//
// Bound on this card: integer ALU.  A high stage is R / 2 multiplies of 32
// products (10,326 three-input LOP3 operations each) for 2 x R x 512 bytes
// of traffic, ~10 operations a byte.  A low stage needs as many: only the
// u lanes of its product reach the output (the v lanes are rebuilt from
// them), though this kernel multiplies all 32 lanes of a row, twice the
// work.  The card's balance is ~5 (1.67e13 int32 operations/s over 3.35
// TB/s).  The multiply keeps ~510 planes live and spills to local memory
// (tower_mul.cuh), which the first design accepts.
//
// Design: one thread per (u, v) row pair (high) or per row (low), in place:
// a thread reads and writes only its own rows.  The reference writes a
// fresh array only because XLA's functional semantics ask for one.  The
// low stage number is a template argument (five instantiations), so no
// run-time mode branch sits next to the multiply.
#include <cuda_runtime.h>

#include <cstdint>

#include "tower_mul.cuh"
#include "tower_simd.cuh"

namespace {

constexpr int W = 128;
constexpr int THREADS = 128;

__device__ __forceinline__ void expand_bits(const uint32_t* __restrict__ w4,
                                            uint32_t* w) {
  const uint4 t = *reinterpret_cast<const uint4*>(w4);
  const uint32_t words[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < W; ++i) w[i] = 0u - ((words[i / 32] >> (i % 32)) & 1u);
}

__global__ void __launch_bounds__(THREADS)
    butterfly_high_kernel(uint32_t* __restrict__ x,
                          const uint32_t* __restrict__ w4, long long pairs,
                          int log_db) {
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p >= pairs) return;
  const long long t = p >> log_db;                     // block = twiddle
  const long long u_row = (t << (log_db + 1)) + (p & ((1LL << log_db) - 1));
  uint4* u4 = reinterpret_cast<uint4*>(x + u_row * W);
  uint4* v4 = reinterpret_cast<uint4*>(x + (u_row + (1LL << log_db)) * W);
  uint32_t w[W], v[W], prod[W];
#pragma unroll
  for (int i = 0; i < W / 4; ++i) {
    const uint4 b = v4[i];
    v[4 * i] = b.x; v[4 * i + 1] = b.y;
    v[4 * i + 2] = b.z; v[4 * i + 3] = b.w;
  }
  expand_bits(w4 + t * 4, w);
  tower_mul128(w, v, prod);
#pragma unroll
  for (int i = 0; i < W / 4; ++i) {
    const uint4 a = u4[i];
    const uint4 u2 = make_uint4(a.x ^ prod[4 * i], a.y ^ prod[4 * i + 1],
                                a.z ^ prod[4 * i + 2], a.w ^ prod[4 * i + 3]);
    u4[i] = u2;
    v4[i] = make_uint4(u2.x ^ v[4 * i], u2.y ^ v[4 * i + 1],
                       u2.z ^ v[4 * i + 2], u2.w ^ v[4 * i + 3]);
  }
}

template <int S>
__global__ void __launch_bounds__(THREADS)
    butterfly_low_kernel(uint32_t* __restrict__ x,
                         const uint32_t* __restrict__ a4,
                         const uint32_t* __restrict__ lane_planes,
                         long long rows) {
  constexpr int SHIFT = 1 << S;
  constexpr uint32_t UMASK = tower_simd::mask(S);   // the even lanes
  constexpr uint32_t VMASK = UMASK << SHIFT;
  __shared__ uint32_t lanes[W];
  for (int i = threadIdx.x; i < W; i += THREADS) lanes[i] = lane_planes[i];
  __syncthreads();
  const long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (r >= rows) return;
  uint4* x4 = reinterpret_cast<uint4*>(x + r * W);
  uint32_t w[W], xv[W], xs[W], prod[W];
#pragma unroll
  for (int i = 0; i < W / 4; ++i) {
    const uint4 a = x4[i];
    xv[4 * i] = a.x; xv[4 * i + 1] = a.y;
    xv[4 * i + 2] = a.z; xv[4 * i + 3] = a.w;
    xs[4 * i] = a.x >> SHIFT; xs[4 * i + 1] = a.y >> SHIFT;
    xs[4 * i + 2] = a.z >> SHIFT; xs[4 * i + 3] = a.w >> SHIFT;
  }
  expand_bits(a4 + r * 4, w);
#pragma unroll
  for (int i = 0; i < W; ++i) w[i] ^= lanes[i];
  tower_mul128(w, xs, prod);
#pragma unroll
  for (int i = 0; i < W / 4; ++i) {
    uint32_t o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t xi = xv[4 * i + k];
      const uint32_t un = xi ^ prod[4 * i + k];
      o[k] = (un & UMASK) | ((xi ^ (un << SHIFT)) & VMASK);
    }
    x4[i] = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + THREADS - 1) / THREADS);
}

}  // namespace

// x: (rows, 128) uint32, updated in place; w4: (rows / 2^(log_db+1), 4)
// uint32, one twiddle per block of 2^(log_db+1) rows; both 16-byte aligned
// on the current device.  Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int bntt_butterfly_high(void* x, const void* w4, long long rows,
                                   int log_db, void* stream) {
  if (log_db < 0 || log_db > 40 || rows < 0 ||
      rows % (2LL << log_db) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = rows / 2;
  if (pairs == 0) return 0;
  butterfly_high_kernel<<<blocks_for(pairs), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(x), static_cast<const uint32_t*>(w4), pairs,
      log_db);
  return static_cast<int>(cudaGetLastError());
}

// x: (rows, 128) uint32, updated in place; a4: (rows, 4) uint32, the batch
// part of each row's twiddle; lane_planes: (128,) uint32, the lane part as
// bit-planes; stage 0..4.  Returns cudaGetLastError() after the launch.
extern "C" int bntt_butterfly_low(void* x, const void* a4,
                                  const void* lane_planes, long long rows,
                                  int stage, void* stream) {
  if (rows < 0 || stage < 0 || stage > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  auto kernel = stage == 0   ? butterfly_low_kernel<0>
                : stage == 1 ? butterfly_low_kernel<1>
                : stage == 2 ? butterfly_low_kernel<2>
                : stage == 3 ? butterfly_low_kernel<3>
                             : butterfly_low_kernel<4>;
  kernel<<<blocks_for(rows), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(x), static_cast<const uint32_t*>(a4),
      static_cast<const uint32_t*>(lane_planes), rows);
  return static_cast<int>(cudaGetLastError());
}
