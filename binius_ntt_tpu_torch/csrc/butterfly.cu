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
// Design: both stages work in place (a thread reads and writes only its own
// rows; the reference writes a fresh array only because XLA's functional
// semantics ask for one), and each has two routes, chosen on the host from
// the tables: CHUNK32 when every twiddle of the stage lies in GF(2^32)
// (words 1..3 of w4 or a4 and lane planes 32..127 zero, true of every real
// table), else the general one.  The route, and the low stage number, are
// template arguments, so no run-time mode branch sits next to the multiply.
//
//   * CHUNK32, both stages: persistent 64-thread blocks, as many as the card
//     holds at once, walk tiles of 32 rows (walk_tiles); each tile comes into
//     shared memory with 16-byte cp.async copies into one half of a double
//     buffer while the tile before it is computed in the other half, and
//     goes back with coalesced stores.  One thread per (row pair, 32-plane
//     chunk), one inline tower_mul32 a thread, in registers with no local
//     memory.  Measured on an H100 with tools/torch_butterfly_ab.py
//     (PERF.md section 6): staging the rows beat reading each thread's
//     128-byte chunks from global memory by 20% (low stage) and 35%
//     (high), and the prefetch beat staging without it by 17-21% (low);
//     at a high stage it held every stage level (0.21-0.25 ms at 2^24)
//     where a block a tile slowed from 0.21 to 0.27 ms as db fell.
//   * CHUNK32 high stage: a tile holds 16 row pairs.  For db >= 16 they are
//     the u rows [b, b + 16) of one block and their v rows [b + db, b + db +
//     16), under one twiddle; for db < 16, 32 consecutive rows, 16 / db
//     whole blocks (nb is a multiple of 2 db, so no block straddles a coset
//     or a tile), each under its own twiddle.  Either way a tile is two runs
//     of 16 rows, max(db, 16) rows apart, and in the tile a pair's rows sit
//     min(db, 16) apart.  The twiddle's 32 planes come from word 0 of
//     w4[t]; prod = tower_mul32(w, v[c]), then u[c] ^= prod, v[c] ^= u[c].
//   * CHUNK32 low stage: rows A = 2i and B = 2i + 1 of a tile share one
//     multiply, as the fused kernel's in-word stages do (stage_group.cu,
//     low_step32).  The packed operand cp holds A's v lanes moved down into
//     the u positions and B's v lanes where they are, the packed twiddle wp
//     A's u-lane twiddles and B's moved up, and tower_mul32 (wp, cp) gives
//     both rows' products.  lo = both rows' u lanes packed the same way; un
//     = lo ^ prod and vn = cp ^ un are u' and v' of both rows, unpacked
//     into place.  A last row without a partner (R odd: R = 1 at log_h 5,
//     rate 0) is packed with zeros and only it is written.
//   * general, for tables with higher planes (only synthetic ones): one
//     thread per row pair (high) or row (low) and one GF(2^128) product
//     (tower_mul128; at a low stage the v lanes' half is thrown away).
#include <cuda_runtime.h>

#include <cstdint>

#include "tower_mul.cuh"
#include "tower_simd.cuh"

namespace {

constexpr int W = 128;
constexpr int C32 = 32;             // planes of one GF(2^32) chunk
constexpr int NCHUNK = W / C32;     // chunks of a row
constexpr int THREADS = 128;        // the general routes' blocks

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

// A CHUNK32 tile: ROWS_B rows as uint4 in shared memory, vector j of chunk
// c of tile row r at r * 32 + c * 8 + (j ^ (c | ((r >> 1) & 1) << 2)), so
// that the 8 lanes of a quarter warp (two row pairs, four chunks) read
// distinct banks at a low stage, and 8 lanes copying one chunk do too.
constexpr int TILE_THREADS = 64;
constexpr int ROWS_B = TILE_THREADS / 2;
constexpr int PAIRS_B = ROWS_B / 2;     // row pairs of a high stage's tile
constexpr int TILE_V = ROWS_B * W / 4;
constexpr int RUN_V = TILE_V / 2;       // vectors of a high tile's run

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

// items of tile t when tiles hold per items of total (at most per)
__device__ __forceinline__ int tile_len(long long t, long long total,
                                        int per) {
  const long long left = total - t * per;
  return static_cast<int>(left < per ? left : per);
}

// The CHUNK32 routes' loop: the block walks tiles blockIdx.x, + gridDim.x,
// ... of n_tiles; tile t has rows_of(t) rows, and its vector v lies at
// at(t)(v) in global memory.  The next tile is fetched with cp.async while
// compute(tile, t, n) works on this one in shared memory, which then goes
// back with coalesced 16-byte stores.
template <class RowsOf, class At, class Compute>
__device__ __forceinline__ void walk_tiles(long long n_tiles, RowsOf rows_of,
                                           At at, Compute compute) {
  __shared__ uint4 tiles[2][TILE_V];
  auto fetch = [&](long long t, int buf) {
    const auto g = at(t);
    for (int v = threadIdx.x; v < rows_of(t) * (W / 4); v += TILE_THREADS)
      cp_async16(&tiles[buf][slot(v)], g(v));
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
    const int n = rows_of(t);
    compute(tiles[buf], t, n);
    __syncthreads();
    const auto g = at(t);
    for (int v = threadIdx.x; v < n * (W / 4); v += TILE_THREADS)
      *g(v) = tiles[buf][slot(v)];
    __syncthreads();               // before buf is fetched into again
  }
}

// blocks of a CHUNK32 launch: one per tile, at most what fits at once
template <class Kernel>
int persistent_blocks(Kernel kernel, long long n_tiles, long long* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        TILE_THREADS, 0);
  const long long resident = static_cast<long long>(sms) * per_sm;
  *blocks = n_tiles < resident ? n_tiles : resident;
  return static_cast<int>(err);
}

// CHUNK32 high stage on chunk c of tile rows u and v: w the twiddle's word
// 0.  u is read only after the product, so that it is not live across it
__device__ __forceinline__ void high_pair32(uint4* tile, uint32_t w, int u,
                                            int v, int c) {
  const int vu = u * (W / 4) + c * (C32 / 4), vv = v * (W / 4) + c * (C32 / 4);
  uint32_t b[C32], wp[C32], prod[C32];
#pragma unroll
  for (int i = 0; i < C32 / 4; ++i) {
    const uint4 y = tile[slot(vv + i)];
    b[4 * i] = y.x; b[4 * i + 1] = y.y; b[4 * i + 2] = y.z; b[4 * i + 3] = y.w;
  }
#pragma unroll
  for (int i = 0; i < C32; ++i) wp[i] = 0u - ((w >> i) & 1u);
  tower_mul32(wp, b, prod);
#pragma unroll
  for (int i = 0; i < C32 / 4; ++i) {
    const uint4 a = tile[slot(vu + i)];
    const uint4 u2 = make_uint4(a.x ^ prod[4 * i], a.y ^ prod[4 * i + 1],
                                a.z ^ prod[4 * i + 2], a.w ^ prod[4 * i + 3]);
    tile[slot(vu + i)] = u2;
    tile[slot(vv + i)] =
        make_uint4(u2.x ^ b[4 * i], u2.y ^ b[4 * i + 1], u2.z ^ b[4 * i + 2],
                   u2.w ^ b[4 * i + 3]);
  }
}

// CHUNK32: persistent blocks of TILE_THREADS walk tiles of PAIRS_B row
// pairs.  General: one thread per row pair.
template <bool CHUNK32>
__global__ void __launch_bounds__(CHUNK32 ? TILE_THREADS : THREADS)
    butterfly_high_kernel(uint32_t* __restrict__ x,
                          const uint32_t* __restrict__ w4, long long pairs,
                          int log_db) {
  if constexpr (CHUNK32) {
    const int ldb = log_db < 4 ? log_db : 4;    // the pair distance in a tile
    const long long gap = 1LL << (log_db > 4 ? log_db : 4);  // run 0 to 1
    uint4* x4 = reinterpret_cast<uint4*>(x);
    walk_tiles(
        (pairs + PAIRS_B - 1) / PAIRS_B,
        [=](long long t) { return 2 * tile_len(t, pairs, PAIRS_B); },
        [=](long long t) {     // two runs of PAIRS_B rows, gap rows apart
          const long long p = t * PAIRS_B;   // run 0 starts at its first u row
          uint4* g0 = x4 + (((p >> log_db) << (log_db + 1)) +
                            (p & ((1LL << log_db) - 1))) * (W / 4);
          uint4* g1 = g0 + gap * (W / 4) - RUN_V;
          return [=](int v) { return (v < RUN_V ? g0 : g1) + v; };
        },
        [=](uint4* tile, long long t, int n) {
          const int q = threadIdx.x / NCHUNK;
          if (2 * q >= n) return;
          const int u = ((q >> ldb) << (ldb + 1)) | (q & ((1 << ldb) - 1));
          high_pair32(tile, w4[((t * PAIRS_B + q) >> log_db) * 4], u,
                      u + (1 << ldb), threadIdx.x % NCHUNK);
        });
  } else {
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
      const uint4 u2 =
          make_uint4(a.x ^ prod[4 * i], a.y ^ prod[4 * i + 1],
                     a.z ^ prod[4 * i + 2], a.w ^ prod[4 * i + 3]);
      u4[i] = u2;
      v4[i] = make_uint4(u2.x ^ v[4 * i], u2.y ^ v[4 * i + 1],
                         u2.z ^ v[4 * i + 2], u2.w ^ v[4 * i + 3]);
    }
  }
}

template <bool CHUNK32>
int launch_high(uint32_t* x, const uint32_t* w4, long long pairs, int log_db,
                cudaStream_t stream) {
  const auto kernel = butterfly_high_kernel<CHUNK32>;
  long long blocks = blocks_for(pairs);
  if constexpr (CHUNK32) {
    const int err = persistent_blocks(
        kernel, (pairs + PAIRS_B - 1) / PAIRS_B, &blocks);
    if (err != 0) return err;
  }
  kernel<<<static_cast<unsigned>(blocks), CHUNK32 ? TILE_THREADS : THREADS,
           0, stream>>>(x, w4, pairs, log_db);
  return static_cast<int>(cudaGetLastError());
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
    const uint4 b = has_b ? tile[slot(vb + i)]
                          : make_uint4(0u, 0u, 0u, 0u);
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
    if (has_b)
      tile[slot(vb + i)] = make_uint4(ob[0], ob[1], ob[2], ob[3]);
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

// CHUNK32: persistent blocks of TILE_THREADS walk tiles of ROWS_B rows.
// General: one thread per row.
template <int S, bool CHUNK32>
__global__ void __launch_bounds__(CHUNK32 ? TILE_THREADS : THREADS)
    butterfly_low_kernel(uint32_t* __restrict__ x,
                         const uint32_t* __restrict__ a4,
                         const uint32_t* __restrict__ lane_planes,
                         long long rows) {
  if constexpr (CHUNK32) {
    __shared__ uint32_t lanes[C32];
    for (int i = threadIdx.x; i < C32; i += TILE_THREADS)
      lanes[i] = lane_planes[i];
    const uint32_t* lp = lanes;
    uint4* x4 = reinterpret_cast<uint4*>(x);
    walk_tiles(
        (rows + ROWS_B - 1) / ROWS_B,
        [=](long long t) { return tile_len(t, rows, ROWS_B); },
        [=](long long t) {     // ROWS_B consecutive rows
          uint4* g = x4 + t * TILE_V;
          return [=](int v) { return g + v; };
        },
        [=](uint4* tile, long long t, int n) {
          const int pl = threadIdx.x / NCHUNK;
          if (2 * pl < n)
            low_pair32<S>(tile, a4 + t * ROWS_B * 4, lp, pl,
                          threadIdx.x % NCHUNK, 2 * pl + 1 < n);
        });
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
  if constexpr (CHUNK32) {
    const int err = persistent_blocks(kernel, (rows + ROWS_B - 1) / ROWS_B,
                                      &blocks);
    if (err != 0) return err;
  }
  kernel<<<static_cast<unsigned>(blocks), CHUNK32 ? TILE_THREADS : THREADS,
           0, stream>>>(x, a4, lane_planes, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (rows, 128) uint32, updated in place; w4: (rows / 2^(log_db+1), 4)
// uint32, one twiddle per block of 2^(log_db+1) rows; both 16-byte aligned
// on the current device.  chunk32 != 0 takes the CHUNK32 route, valid only
// when words 1..3 of w4 are zero.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int bntt_butterfly_high(void* x, const void* w4, long long rows,
                                   int log_db, int chunk32, void* stream) {
  if (log_db < 0 || log_db > 40 || rows < 0 ||
      rows % (2LL << log_db) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = rows / 2;
  if (pairs == 0) return 0;
  return (chunk32 ? launch_high<true> : launch_high<false>)(
      static_cast<uint32_t*>(x), static_cast<const uint32_t*>(w4), pairs,
      log_db, static_cast<cudaStream_t>(stream));
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
