// mul_tiles: out[n] = a[n] * b[n] over (N, 128) bit-sliced GF(2^128) rows.
//
// Replaces binius_ntt_tpu/ntt/pallas_kernels.py::mul_tiles (pallas_call at
// :210), whose body is the straight-line multiply _mul_vmem_sl/_mul_planes.
//
// Bound on this card: integer ALU, with memory close behind.  A row is 32
// products for 3 x 512 bytes of HBM traffic and 10,326 three-input LOP3
// operations: at 2^18 rows 0.162 ms of operations against 0.120 ms of bytes
// (1.67e13 int32 operations/s, 3.35e12 B/s; data-sheet estimates).  So the
// copies have to overlap the product, or their time adds to it.
//
// Design: the product is csrc/tower_leaf32.cuh's nine GF(2^32) leaves,
// spread over the nine warps of a block.  A row is planes already, so the
// nine leaves of a row need not share a thread, and no thread holds the
// 64-plane sums of leaf32::mul_in_place (168 registers, nine warps an SM).
//   1. Persistent blocks walk tiles of ROWS = 32 rows (tiles blockIdx.x,
//      + gridDim.x, ...), one barrier a tile.  After it, the six combining
//      warps fetch the next tile's rows of a and b with 16-byte cp.async
//      into the other half of a double buffer; chunk k of tile row r sits
//      at slot r CPR + (k ^ (r % 8)).
//   2. Each warp makes one leaf for the tile's 32 rows, lane = row: the XOR
//      of a's chunks in GROUPED[l] times the XOR of the same chunks of b,
//      one inline tower_mul32.  It stores the product P_l, and alpha P_l
//      (tower::mul_alpha<5>) where the combine reads it, and alpha^2 P_7,
//      into this tile's half of double-buffered leaf vectors: vector v,
//      plane i of row r at (v 32 + i) VSTRIDE + r.
//   3. The combining warps then form the previous tile's rows from the
//      other half: lane i makes plane i of each output chunk c as the XOR
//      of the vectors that COMBINE(c) names (mul_body<7>'s combine of the
//      leaves, plane by plane since step 2 applied the alpha maps), and
//      stores it, 128 bytes a warp store.  The last tile is combined by
//      every warp after the loop.
// The SM's four schedulers each run the warps w of one residue w % 4, so
// one of them holds three of the nine leaf warps (0, 4, 8): those take the
// three leaves that need no alpha and gather fewest chunks (LEAF_OF_WARP),
// and neither copy nor combine.  Free of bank conflicts: a quarter warp's
// 16-byte copies (8 chunks of one row) and 16-byte reads (one chunk of 8
// rows) hit 8 distinct slots mod 8; leaf stores (lanes = rows) and combine
// reads (lanes = planes) hit 32 distinct banks through the stride of 33
// words, and a store's address is one base register and an immediate.
// Shared memory a block: 2 x 32 KB of tiles and 2 x 78.4 KB of leaf
// vectors (226,048 B), one block an SM.
//
// Measured on an H100 80GB HBM3 at 700 W (tools/torch_mul_tiles_ab.py,
// PERF.md section 6): 0.259 ms a call back to back at 2^18 rows, 62% of
// the bound.  A thread a row (mul_in_place on shared-memory planes, four
// warps an SM) took about 0.33 ms, as did these leaves with a second
// barrier before a combine by all nine warps; the three GF(2^16) products
// of the ninth leaf on three more warps gained nothing.
#include <cuda_runtime.h>

#include <cstdint>

#include "tower_leaf32.cuh"

namespace {

constexpr int W = 128;                  // planes of a row
constexpr int ROWS = 32;                // rows of a tile, a lane each
constexpr int CPR = W / 4;              // 16-byte chunks of a row
constexpr int TILE = ROWS * CPR;        // chunks of a tile of a or of b
constexpr int C32 = leaf32::C32;
constexpr int WARPS = leaf32::N_LEAF;   // a leaf a warp
constexpr int THREADS = 32 * WARPS;
constexpr int COMBINERS = WARPS - 3;    // the warps w % 4 != 0

// the leaf of warp w: warps 0, 4, 8 take leaves 3, 5, 0
__host__ __device__ constexpr int LEAF_OF_WARP(int w) {
  return w == 0 ? 3 : w == 3 ? 4 : w == 4 ? 5 : w == 5 ? 6 : w == 6 ? 7
         : w == 7 ? 8 : w == 8 ? 0 : w;
}
// 0..5 for the combining warps 1, 2, 3, 5, 6, 7
__device__ __forceinline__ int combiner(int w) {
  return (w / 4) * 3 + w % 4 - 1;
}

// Leaf vectors: P_l at 2 l, alpha P_l at 2 l + 1, alpha^2 P_7 at 2 N_LEAF.
constexpr int N_VEC = 2 * leaf32::N_LEAF + 1;
constexpr uint32_t ALPHA_LEAVES = 0b111010010;  // leaves 1, 4, 6, 7, 8
constexpr int ALPHA2_LEAF = 7;

// Output chunk c of a row is the XOR of the vectors whose bits COMBINE(c)
// sets.  With lo_g = P_3g ^ P_3g+1 and hi_g = P_3g ^ (1 + alpha) P_3g+1 ^
// P_3g+2 (mul_in_place's sums; g = 0, 1, 2 for zm, z0, z2), mul_body<7>
// gives [lo_1 ^ lo_2, hi_1 ^ hi_2, lo_0 ^ lo_1 ^ lo_2 ^ hi_2, hi_0 ^ hi_1 ^
// hi_2 ^ lo_2 ^ alpha hi_2]:
//   chunk 0: P3 P4 P6 P7
//   chunk 1: P3 P4 aP4 P5 P6 P7 aP7 P8
//   chunk 2: P0 P1 P3 P4 aP7 P8
//   chunk 3: P0 P1 aP1 P2 P3 P4 aP4 P5 aP6 a2P7 P8 aP8
__host__ __device__ constexpr uint32_t COMBINE(int c) {
  return c == 0   ? 0x05140u
         : c == 1 ? 0x1D740u
         : c == 2 ? 0x18145u
                  : 0x7275Du;
}
constexpr uint32_t USED = COMBINE(0) | COMBINE(1) | COMBINE(2) | COMBINE(3);

constexpr int TILES_BYTES = 2 * 2 * TILE * 16;  // [buffer][a, b][chunk]
constexpr int VSTRIDE = ROWS + 1;               // words a plane of a vector
constexpr int VEC_WORDS = N_VEC * C32 * VSTRIDE;
constexpr int SMEM = TILES_BYTES + 2 * VEC_WORDS * 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until every committed group has landed
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ int slot(int r, int k) {
  return r * CPR + (k ^ (r & 7));
}

// live rows of tile t
__device__ __forceinline__ int tile_rows(long long t, long long n) {
  const long long left = n - t * ROWS;
  return left < ROWS ? static_cast<int>(left) : ROWS;
}

// d = XOR of the 32-plane chunks of tile row r in subset s
__device__ __forceinline__ void gather(const uint4* tile, int r, uint32_t s,
                                       uint32_t* d) {
#pragma unroll
  for (int i = 0; i < C32; ++i) d[i] = 0u;
#pragma unroll
  for (int c = 0; c < leaf32::NCHUNK; ++c) {
    if ((s >> c) & 1u) {
#pragma unroll
      for (int j = 0; j < C32 / 4; ++j) {
        const uint4 v = tile[slot(r, c * (C32 / 4) + j)];
        d[4 * j] ^= v.x;
        d[4 * j + 1] ^= v.y;
        d[4 * j + 2] ^= v.z;
        d[4 * j + 3] ^= v.w;
      }
    }
  }
}

__device__ __forceinline__ void store_vec(uint32_t* vecs, int v, int r,
                                          const uint32_t* p) {
#pragma unroll
  for (int i = 0; i < C32; ++i) vecs[(v * C32 + i) * VSTRIDE + r] = p[i];
}

// step 2: leaf l for tile row r (the lane)
__device__ __forceinline__ void leaf(const uint4* ta, const uint4* tb,
                                     uint32_t* vecs, int l, int r) {
  uint32_t x[C32], y[C32], p[C32];
  gather(ta, r, leaf32::GROUPED[l], x);
  gather(tb, r, leaf32::GROUPED[l], y);
  tower_mul32(x, y, p);
  store_vec(vecs, 2 * l, r, p);
  if ((ALPHA_LEAVES >> l) & 1u) {
    tower::mul_alpha<5>(p, x);
    store_vec(vecs, 2 * l + 1, r, x);
    if (l == ALPHA2_LEAF) {
      tower::mul_alpha<5>(x, y);
      store_vec(vecs, N_VEC - 1, r, y);
    }
  }
}

// step 3: plane i (the lane) of every output chunk of tile row r
__device__ __forceinline__ void combine(const uint32_t* vecs,
                                       uint32_t* __restrict__ row, int r,
                                       int i) {
  uint32_t v[N_VEC];
#pragma unroll
  for (int k = 0; k < N_VEC; ++k)
    v[k] = (USED >> k) & 1u ? vecs[(k * C32 + i) * VSTRIDE + r] : 0u;
#pragma unroll
  for (int c = 0; c < leaf32::NCHUNK; ++c) {
    uint32_t z = 0u;
#pragma unroll
    for (int k = 0; k < N_VEC; ++k)
      if ((COMBINE(c) >> k) & 1u) z ^= v[k];
    row[c * C32 + i] = z;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    mul_tiles_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b,
                     uint32_t* __restrict__ out, long long n) {
  extern __shared__ uint4 smem[];
  uint32_t* vecs = reinterpret_cast<uint32_t*>(smem + 4 * TILE);
  const long long n_tiles = (n + ROWS - 1) / ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool combining = warp % 4 != 0;
  // tile t's rows into half buf of the tile buffer, by the combining warps
  auto fetch = [&](long long t, int buf) {
    if (!combining) return;
    const long long w0 = t * ROWS * W;
    const int chunks = tile_rows(t, n) * CPR;
    for (int q = combiner(warp) * 32 + lane; q < chunks; q += COMBINERS * 32) {
      const int s = slot(q / CPR, q % CPR);
      cp_async16(&smem[2 * buf * TILE + s], a + w0 + 4 * q);
      cp_async16(&smem[(2 * buf + 1) * TILE + s], b + w0 + 4 * q);
    }
  };
  long long t = blockIdx.x, prev = -1;
  int buf = 0;
  fetch(t, buf);
  cp_async_commit();
  for (; t < n_tiles; prev = t, t += gridDim.x, buf ^= 1) {
    cp_async_wait0();                   // tile t has landed
    __syncthreads();                    // ... for every warp; the leaves of
                                        // prev are stored, half buf ^ 1 free
    if (t + gridDim.x < n_tiles) fetch(t + gridDim.x, buf ^ 1);
    cp_async_commit();
    leaf(smem + 2 * buf * TILE, smem + (2 * buf + 1) * TILE,
         vecs + buf * VEC_WORDS, LEAF_OF_WARP(warp), lane);
    if (combining && prev >= 0) {
      const int rows = tile_rows(prev, n);
      for (int r = combiner(warp); r < rows; r += COMBINERS)
        combine(vecs + (buf ^ 1) * VEC_WORDS, out + (prev * ROWS + r) * W,
                r, lane);
    }
  }
  __syncthreads();                      // the last tile's leaves are stored
  const int rows = tile_rows(prev, n);
  for (int r = warp; r < rows; r += WARPS)
    combine(vecs + (buf ^ 1) * VEC_WORDS, out + (prev * ROWS + r) * W, r,
            lane);
}

}  // namespace

// a, b, out: (n, 128) uint32, 16-byte aligned, on the current device.
// Returns the first CUDA error of the launch (0 = launched); a pointer not
// on 16 bytes, or n < 0, is cudaErrorInvalidValue.
extern "C" int bntt_mul_tiles(const void* a, const void* b, void* out,
                              long long n, void* stream) {
  if (n < 0 || (reinterpret_cast<uintptr_t>(a) |
                reinterpret_cast<uintptr_t>(b) |
                reinterpret_cast<uintptr_t>(out)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      mul_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mul_tiles_kernel, THREADS, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long n_tiles = (n + ROWS - 1) / ROWS;
  const long long resident = static_cast<long long>(sms) * per_sm;
  mul_tiles_kernel<<<static_cast<unsigned>(n_tiles < resident ? n_tiles
                                                              : resident),
                     THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
