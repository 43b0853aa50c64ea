// mul_compact: out[n] = a[n] * b[n] over compact GF(2^(2^H)) elements of
// NL = 2^(H-5) uint32 limbs each (little-endian), H = 5, 6, 7.
//
// Replaces binius_ntt_tpu/fields/tower_compact.py::mul_compact_tiles
// (pallas_call at :116), whose body is the limb Karatsuba _mul_limbs /
// _alpha_limbs (:32-61) down to the SWAR height-5 multiply.
//
// Bound on this card: integer ALU.  In the bit-sliced form a product
// takes a 32nd of a bit-sliced multiply (tower_mul.cuh: 10,326 LOP3
// operations for 32 GF(2^128) products) plus the 32 x 32 transposes of a,
// b and out, ~443 operations at H = 7 for 48 bytes of traffic, far above
// the card's ~5 operations a byte.
//
// Design: the bit-sliced form.  A batch is 32 consecutive elements, owned
// by one thread; a block takes a tile of THREADS batches.
//   1. The tile's rows (a batch's 32 NL words) of a and b come into shared
//      memory with 16-byte cp.async copies, coalesced, chunk k of row r at
//      slot k ^ (r % 8) so that 8 lanes reading one chunk of 8 rows hit
//      distinct banks.  Past the last element the copies fill zeros.
//   2. Each thread reads its row into registers and transposes limb c of
//      its 32 elements (csrc/transpose32.cuh, in_thread) into planes 32c ..
//      32c + 31: plane i holds bit i of the 32 elements.
//   3. H = 5: one tower_mul32 in registers.  H = 6, 7: the planes go to
//      shared memory plane-major, thread-minor (word i at [i * THREADS]),
//      over the rows once every thread has read its own, and the product
//      is csrc/tower_leaf32.cuh's in place, nine GF(2^32) leaves at H = 7
//      (with 64 planes of scratch) and z0's three at H = 6, one rolled
//      tower_mul32 call site.
//   4. The product's planes go back through the same transpose into the
//      thread's row, and coalesced 16-byte stores write the live chunks (a
//      chunk that holds the last element word by word).
// Shared memory a block: 32 NL words of a and of b a thread (plus 64 at H =
// 7), 80 KB at H = 7 with 64 threads, two blocks an SM.
#include <cuda_runtime.h>

#include <cstdint>

#include "tower_leaf32.cuh"
#include "transpose32.cuh"

namespace {

constexpr int THREADS = 64;             // a batch a thread

// shared-memory words a thread at height H
template <int H>
constexpr int smem_words() {
  return 2 * 32 * (1 << (H - 5)) + (H == 7 ? 2 * 32 : 0);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// The thread's and the block's index, read again in each phase: kept live
// across the product, with the tile's addressing derived from them, they
// pushed the leaf loop past 255 registers (144-272 B of spills at H = 6,
// 7).  asm volatile keeps the compiler from reusing an earlier read.
__device__ __forceinline__ int thread_index() {
  int v;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(v));
  return v;
}

// the block's tile: its first word, and its live words (a multiple of NL)
struct Tile {
  long long w0;
  int live;
};
template <int WORDS_PER_TILE>
__device__ __forceinline__ Tile this_tile(long long n_words) {
  unsigned b;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(b));
  const long long w0 = static_cast<long long>(b) * WORDS_PER_TILE;
  const long long left = n_words - w0;
  return {w0, left < WORDS_PER_TILE ? static_cast<int>(left)
                                    : WORDS_PER_TILE};
}

// slot of chunk k of tile row r, CPR chunks a row (a multiple of 8)
template <int CPR>
__device__ __forceinline__ int slot(int r, int k) {
  return r * CPR + (k ^ (r & 7));
}

// the thread's row (32 NL words, word e NL + c limb c of element e) from
// its slots, or back to them
template <int CPR>
__device__ __forceinline__ void read_row(const uint4* rows, int r,
                                         uint32_t* w) {
#pragma unroll
  for (int k = 0; k < CPR; ++k) {
    const uint4 v = rows[slot<CPR>(r, k)];
    w[4 * k] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
}
template <int CPR>
__device__ __forceinline__ void write_row(uint4* rows, int r,
                                          const uint32_t* w) {
#pragma unroll
  for (int k = 0; k < CPR; ++k)
    rows[slot<CPR>(r, k)] =
        make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
}

// limbs <-> planes in registers: limb c of element e at w[e NL + c] <->
// plane 32 c + p at w[p NL + c] (the transpose is its own inverse)
template <int NL>
__device__ __forceinline__ void transpose_limbs(uint32_t* w) {
#pragma unroll
  for (int c = 0; c < NL; ++c) transpose32::in_thread<NL>(w + c);
}

// planes of registers w (plane 32 c + p at w[p NL + c]) <-> the thread's
// column of shared memory (plane i at s[i * THREADS])
template <int NL>
__device__ __forceinline__ void store_planes(uint32_t* s, const uint32_t* w) {
#pragma unroll
  for (int c = 0; c < NL; ++c)
#pragma unroll
    for (int p = 0; p < 32; ++p) s[(32 * c + p) * THREADS] = w[p * NL + c];
}
template <int NL>
__device__ __forceinline__ void load_planes(const uint32_t* s, uint32_t* w) {
#pragma unroll
  for (int c = 0; c < NL; ++c)
#pragma unroll
    for (int p = 0; p < 32; ++p) w[p * NL + c] = s[(32 * c + p) * THREADS];
}

template <int H>
__global__ void __launch_bounds__(THREADS)
    mul_compact_kernel(const uint32_t* __restrict__ a,
                       const uint32_t* __restrict__ b,
                       uint32_t* __restrict__ out, long long n) {
  constexpr int NL = 1 << (H - 5);
  constexpr int WORDS = 32 * NL;        // of a row, = planes of a thread
  constexpr int CPR = WORDS / 4;        // chunks of a row
  constexpr int CHUNKS = THREADS * CPR;  // of a tile
  extern __shared__ uint4 smem[];
  uint4* rows_a = smem;
  uint4* rows_b = smem + CHUNKS;
  int t = thread_index();
  Tile tile = this_tile<CHUNKS * 4>(n * NL);

#pragma unroll 4
  for (int q = t; q < CHUNKS; q += THREADS) {
    const int bytes = 4 * min(max(tile.live - 4 * q, 0), 4);
    const long long g = bytes ? tile.w0 + 4 * q : 0;
    const int s = slot<CPR>(q / CPR, q % CPR);
    cp_async16(&rows_a[s], a + g, bytes);
    cp_async16(&rows_b[s], b + g, bytes);
  }
  cp_async_wait_all();
  __syncthreads();

  uint32_t w[WORDS];
  if constexpr (H == 5) {
    uint32_t y[32], p[32];
    read_row<CPR>(rows_a, t, w);
    read_row<CPR>(rows_b, t, y);
    transpose_limbs<NL>(w);
    transpose_limbs<NL>(y);
    tower_mul32(w, y, p);
    transpose_limbs<NL>(p);
    write_row<CPR>(rows_a, t, p);       // only this thread reads row t
  } else {
    uint32_t* planes_a = reinterpret_cast<uint32_t*>(smem);
    uint32_t* planes_b = planes_a + WORDS * THREADS;
    uint32_t* scratch = planes_b + WORDS * THREADS;
    read_row<CPR>(rows_a, t, w);
    transpose_limbs<NL>(w);
    __syncthreads();                    // every row of a read
    store_planes<NL>(planes_a + t, w);
    read_row<CPR>(rows_b, t, w);
    transpose_limbs<NL>(w);
    __syncthreads();                    // every row of b read
    store_planes<NL>(planes_b + t, w);
    t = thread_index();
    leaf32::mul_in_place<THREADS, H>(
        planes_a + t, leaf32::GatherLeaf<THREADS>{planes_b + t},
        scratch + t);
    t = thread_index();
    load_planes<NL>(planes_a + t, w);
    transpose_limbs<NL>(w);
    __syncthreads();                    // every column of a read
    write_row<CPR>(rows_a, t, w);
  }
  __syncthreads();

  t = thread_index();
  tile = this_tile<CHUNKS * 4>(n * NL);
  uint4* out4 = reinterpret_cast<uint4*>(out + tile.w0);
#pragma unroll 4
  for (int q = t; q < CHUNKS; q += THREADS) {
    const uint4 v = rows_a[slot<CPR>(q / CPR, q % CPR)];
    if (4 * q + 4 <= tile.live) {
      out4[q] = v;
    } else if (4 * q < tile.live) {     // the chunk of the last element
      uint32_t* o = out + tile.w0 + 4 * q;
      const int m = tile.live - 4 * q;
      o[0] = v.x;
      if (m > 1) o[1] = v.y;
      if (m > 2) o[2] = v.z;
    }
  }
}

template <int H>
int launch(const void* a, const void* b, void* out, long long n,
           cudaStream_t stream) {
  constexpr int SMEM = smem_words<H>() * THREADS * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      mul_compact_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long per = 32LL * THREADS;  // elements of a tile
  const unsigned blocks = static_cast<unsigned>((n + per - 1) / per);
  mul_compact_kernel<H><<<blocks, THREADS, SMEM, stream>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b, out: (n, 2^(height-5)) uint32, 16-byte aligned, on the current
// device; height 5, 6 or 7.  Returns the first CUDA error of the launch (0
// = launched).
extern "C" int bntt_mul_compact(const void* a, const void* b, void* out,
                                long long n, int height, void* stream) {
  if (n < 0 || height < 5 || height > 7 ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return height == 5   ? launch<5>(a, b, out, n, s)
         : height == 6 ? launch<6>(a, b, out, n, s)
                       : launch<7>(a, b, out, n, s);
}
