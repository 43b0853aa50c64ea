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
//   clear, a u lane) with lane j + 2^s (a v lane).  The twiddle of lane j
//   is the batch part a4[row] (all lanes) XOR the lane part (a fixed
//   128-word plane set, lane_planes), so the planes are expand(a4[row]) ^
//   lane_planes.  The butterfly is un = x ^ w (x >> 2^s), x' = (un & umask)
//   | ((x ^ (un << 2^s)) & vmask), with logical shifts on uint32: only the
//   u lanes of un reach x'.  The reference expands these planes on the host
//   (pallas_kernels.py:171-175) only because Mosaic rejects the in-kernel
//   reshape; here the lane planes sit in shared memory and the batch part
//   is expanded in registers.
//
// Bound on this card.  A high stage is R / 2 multiplies of 32 products for
// 2 x R x 512 bytes of traffic; a low stage needs as many (the u lanes of
// two rows fill one multiply).  Every twiddle of a domain of at most 2^32
// points lies in the subfield GF(2^32), and then a multiply is four
// GF(2^32) products on 32-plane chunks that never mix, 4 x 1,059
// three-input LOP3 operations (fields/bitsliced.py::mul_subfield_chunks)
// for the 2 KB a row pair reads and writes: ~2 operations a byte, under
// the card's balance of ~5 (1.67e13 int32 operations/s over 3.35 TB/s), so
// bytes bound a stage.  One GF(2^128)
// product is 10,326 operations and keeps ~510 planes live, spilling to
// local memory (tower_mul.cuh).
//
// Design: the high stage is one thread per (u, v) row pair with one
// tower_mul128, in place: a thread reads and writes only its own rows.  The
// reference writes a fresh array only because XLA's functional semantics
// ask for one.  The low stage number is a template argument (five
// instantiations), so no run-time mode branch sits next to the multiply,
// and so is its route, chosen on the host from the tables (a stage's
// twiddles lie in GF(2^32) when words 1..3 of a4 and lane planes 32..127
// are zero):
//
//   * CHUNK32: persistent 64-thread blocks, as many as the card holds at
//     once, walk tiles of 32 rows; each tile comes into shared memory with
//     16-byte cp.async copies into one half of a double buffer while the
//     tile before it is computed in the other half, and goes back with
//     coalesced stores.  One thread per (row pair, 32-plane chunk), rows
//     A = 2i and B = 2i + 1: the u lanes of both rows share one multiply,
//     as the fused kernel's in-word stages do (stage_group.cu,
//     low_step32).  The packed operand cp holds A's v lanes moved down
//     into the u positions and B's v lanes where they are, the packed
//     twiddle wp A's u-lane twiddles and B's moved up, and one inline
//     tower_mul32 (wp, cp) gives both rows' products, in registers with no
//     local memory.  lo = both rows' u lanes packed the same way; un = lo
//     ^ prod and vn = cp ^ un are u' and v' of both rows, unpacked into
//     place.  A last row without a partner (R odd: R = 1 at log_h 5, rate
//     0) is packed with zeros and only it is written.  Measured on an
//     H100 with tools/torch_butterfly_ab.py (PERF.md section 6): staging
//     the rows beat reading each thread's 128-byte chunks from global
//     memory by 20%, and the prefetch beat staging without it by 17-21%.
//   * general, for tables with higher planes: one thread per row, one
//     GF(2^128) product of all 32 lanes (tower_mul128, the v lanes' half
//     thrown away).
#include <cuda_runtime.h>

#include <cstdint>

#include "tower_mul.cuh"
#include "tower_simd.cuh"

namespace {

constexpr int W = 128;
constexpr int C32 = 32;             // planes of one GF(2^32) chunk
constexpr int NCHUNK = W / C32;     // chunks of a row
constexpr int THREADS = 128;

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + THREADS - 1) / THREADS);
}

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

// A CHUNK32 tile: ROWS_B rows as uint4 in shared memory, vector j of chunk
// c of row r at r * 32 + c * 8 + (j ^ (c | ((r >> 1) & 1) << 2)), so that
// the 8 lanes of a quarter warp (two row pairs, four chunks) read distinct
// banks, and 8 lanes copying one chunk do too
constexpr int LOW_THREADS = 64;
constexpr int ROWS_B = LOW_THREADS / 2;
constexpr int TILE_V = ROWS_B * W / 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ int slot(int v) {
  const int r = v >> 5, c = (v >> 3) & 3, j = v & 7;
  return (v & ~7) | (j ^ (c | (((r >> 1) & 1) << 2)));
}

// CHUNK32 low stage on chunk c of tile rows A = 2 * pl and B = A + 1 (B
// only if has_b); a4 from the block's first row; lanes: planes 0..31
template <int S>
__device__ __forceinline__ void low_pair32(uint4* tile,
                                           const uint32_t* __restrict__ a4,
                                           const uint32_t* lanes, int pl,
                                           int c, bool has_b) {
  constexpr int SHIFT = 1 << S;
  constexpr uint32_t UMASK = tower_simd::mask(S);   // the even lanes
  constexpr uint32_t VMASK = UMASK << SHIFT;
  const int va = (2 * pl) * (W / 4) + c * (C32 / 4), vb = va + W / 4;
  uint32_t lo[C32], cp[C32], wp[C32], prod[C32];
#pragma unroll
  for (int i = 0; i < C32 / 4; ++i) {
    const uint4 a = tile[slot(va + i)];
    const uint4 b = has_b ? tile[slot(vb + i)] : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t xa[4] = {a.x, a.y, a.z, a.w};
    const uint32_t xb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      lo[4 * i + k] = (xa[k] & UMASK) | ((xb[k] << SHIFT) & VMASK);
      cp[4 * i + k] = ((xa[k] >> SHIFT) & UMASK) | (xb[k] & VMASK);
    }
  }
  const uint32_t wa = a4[2 * pl * 4];
  const uint32_t wb = has_b ? a4[(2 * pl + 1) * 4] : 0u;
#pragma unroll
  for (int i = 0; i < C32; ++i) {
    const uint32_t sel = ((0u - ((wa >> i) & 1u)) & UMASK) |
                         ((0u - ((wb >> i) & 1u)) & VMASK);
    const uint32_t l = lanes[i] & UMASK;
    wp[i] = sel ^ l ^ (l << SHIFT);
  }
  tower_mul32(wp, cp, prod);
#pragma unroll
  for (int i = 0; i < C32 / 4; ++i) {
    uint32_t oa[4], ob[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t un = lo[4 * i + k] ^ prod[4 * i + k];   // u' of A, B
      const uint32_t vn = cp[4 * i + k] ^ un;                // v' of A, B
      oa[k] = (un & UMASK) | ((vn << SHIFT) & VMASK);
      ob[k] = ((un >> SHIFT) & UMASK) | (vn & VMASK);
    }
    tile[slot(va + i)] = make_uint4(oa[0], oa[1], oa[2], oa[3]);
    if (has_b) tile[slot(vb + i)] = make_uint4(ob[0], ob[1], ob[2], ob[3]);
  }
}

// general low stage on one row r: one GF(2^128) product of all 32 lanes
template <int S>
__device__ __forceinline__ void low_row128(uint32_t* __restrict__ x,
                                           const uint32_t* __restrict__ a4,
                                           const uint32_t* lanes,
                                           long long r) {
  constexpr int SHIFT = 1 << S;
  constexpr uint32_t UMASK = tower_simd::mask(S);
  constexpr uint32_t VMASK = UMASK << SHIFT;
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

// rows of tile t (at most ROWS_B)
__device__ __forceinline__ int tile_rows(long long t, long long rows) {
  const long long left = rows - t * ROWS_B;
  return static_cast<int>(left < ROWS_B ? left : ROWS_B);
}

// CHUNK32: persistent blocks of LOW_THREADS walk the tiles, the next one
// fetched while this one is computed.  General: one thread per row.
template <int S, bool CHUNK32>
__global__ void __launch_bounds__(CHUNK32 ? LOW_THREADS : THREADS)
    butterfly_low_kernel(uint32_t* __restrict__ x,
                         const uint32_t* __restrict__ a4,
                         const uint32_t* __restrict__ lane_planes,
                         long long rows) {
  if constexpr (CHUNK32) {
    __shared__ uint32_t lanes[C32];
    __shared__ uint4 tiles[2][TILE_V];
    for (int i = threadIdx.x; i < C32; i += LOW_THREADS)
      lanes[i] = lane_planes[i];
    const long long n_tiles = (rows + ROWS_B - 1) / ROWS_B;
    auto fetch = [&](long long t, int buf) {
      const uint4* g = reinterpret_cast<const uint4*>(x + t * ROWS_B * W);
      for (int v = threadIdx.x; v < tile_rows(t, rows) * (W / 4);
           v += LOW_THREADS)
        cp_async16(&tiles[buf][slot(v)], g + v);
    };
    long long t = blockIdx.x;
    int buf = 0;
    fetch(t, buf);
    cp_async_commit();
    for (; t < n_tiles; t += gridDim.x, buf ^= 1) {
      if (t + gridDim.x < n_tiles) fetch(t + gridDim.x, buf ^ 1);
      cp_async_commit();
      cp_async_wait1();              // tile t has landed
      __syncthreads();
      const int n = tile_rows(t, rows);
      const int pl = threadIdx.x / NCHUNK;
      if (2 * pl < n)
        low_pair32<S>(tiles[buf], a4 + t * ROWS_B * 4, lanes, pl,
                      threadIdx.x % NCHUNK, 2 * pl + 1 < n);
      __syncthreads();
      uint4* g = reinterpret_cast<uint4*>(x + t * ROWS_B * W);
      for (int v = threadIdx.x; v < n * (W / 4); v += LOW_THREADS)
        g[v] = tiles[buf][slot(v)];
      __syncthreads();               // before buf is fetched into again
    }
  } else {
    __shared__ uint32_t lanes[W];
    for (int i = threadIdx.x; i < W; i += THREADS) lanes[i] = lane_planes[i];
    __syncthreads();
    const long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (r >= rows) return;
    low_row128<S>(x, a4, lanes, r);
  }
}

template <int S, bool CHUNK32>
int launch_low(uint32_t* x, const uint32_t* a4, const uint32_t* lane_planes,
               long long rows, cudaStream_t stream) {
  const auto kernel = butterfly_low_kernel<S, CHUNK32>;
  long long blocks = blocks_for(rows);
  if constexpr (CHUNK32) {   // one block per tile, at most what fits at once
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          LOW_THREADS, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long n_tiles = (rows + ROWS_B - 1) / ROWS_B;
    const long long resident = static_cast<long long>(sms) * per_sm;
    blocks = n_tiles < resident ? n_tiles : resident;
  }
  kernel<<<static_cast<unsigned>(blocks), CHUNK32 ? LOW_THREADS : THREADS, 0,
           stream>>>(x, a4, lane_planes, rows);
  return static_cast<int>(cudaGetLastError());
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
// bit-planes; stage 0..4.  chunk32 != 0 takes the CHUNK32 route, valid only
// when words 1..3 of a4 and lane planes 32..127 are zero.  Returns
// cudaGetLastError() after the launch.
extern "C" int bntt_butterfly_low(void* x, const void* a4,
                                  const void* lane_planes, long long rows,
                                  int stage, int chunk32, void* stream) {
  if (rows < 0 || stage < 0 || stage > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  using Launch = int (*)(uint32_t*, const uint32_t*, const uint32_t*,
                        long long, cudaStream_t);
  static constexpr Launch launch[2][5] = {
      {launch_low<0, false>, launch_low<1, false>, launch_low<2, false>,
       launch_low<3, false>, launch_low<4, false>},
      {launch_low<0, true>, launch_low<1, true>, launch_low<2, true>,
       launch_low<3, true>, launch_low<4, true>}};
  return launch[chunk32 != 0][stage](
      static_cast<uint32_t*>(x), static_cast<const uint32_t*>(a4),
      static_cast<const uint32_t*>(lane_planes), rows,
      static_cast<cudaStream_t>(stream));
}
