// stage_group_r2: one stage group of the radix-2 BB31 NTT, in place.
//
// Replaces binius_ntt_tpu/ntt/pallas_fused_bb31.py::stage_group_r2
// (pallas_call at :266).
//
// x is the flat (n,) array of Montgomery words (BB31, P = 15 * 2^27 + 1).
// The group runs the DIF stages s0 .. s0+k-1 (gpuntt.cuh:65-124): at stage
// s, element i with bit s clear pairs with i + 2^s, the twiddle is
// w = tw[i >> (s+1)] from the bit-reversed (n/2,) table, and the butterfly
// is U = u + v, V = (u - v) * w.  The top stage (s = log_n - 1) has
// w = tw[0] = enc(1) and skips the multiply (pallas_fused_bb31.py:122).
// Flags: bit 0 encodes the canonical input on load (the first group), bit 1
// decodes on store (the last group), bit 2 loads element i from
// src[bitrev(i)] (the transform's input permutation, gpuntt.cuh:163-168,
// which the reference runs as a gather outside its kernels; the group is
// then out of place, src != x), bit 3 copies the tile into shared memory
// with 16-byte cp.async copies (an upper group with rows of 4 or more
// consecutive words).
//
// Bound on this card: a butterfly compiles to about 17 integer
// instructions (a 32x32->64 multiply and REDC, two modular add/subtracts),
// so at 2^24 the 24 x 2^23 butterflies issue in ~0.1 ms at the card's
// instruction rate, and each pass over the array moves 2 x 64 MiB, 0.04 ms
// at 3.35 TB/s, plus the twiddle table, which the first group reads.  The
// design keeps both low: few passes, and few instructions besides the
// butterflies' own.
//
// Design: a block holds a tile of 2^k rows (stride 2^s0) by 2^c
// consecutive columns, up to 2^15 words (128 KB) of dynamic shared memory,
// where the TPU kernel split lane stages from row stages to suit Mosaic;
// so two launches cover 2^24.  The group's k stages run in rounds of r <= 4
// stages: in a round a thread holds the 2^r words whose tile rows differ
// only in the round's row bits, runs its r stages on them in registers
// with no barrier, and writes them back; the tile goes through shared
// memory only between rounds, one barrier a round, and the index
// arithmetic is done once a round.  The tile word e lies at shared word
// e ^ ((e >> r0) & mask) (r0 the first round's size; the mask keeps 16-byte
// chunks whole where the tile is copied in by chunks), so that the 32
// lanes of a warp, which take the round's lowest other bits, use distinct
// banks.  The block's twiddles are a few contiguous slices of the table
// (stage j's 2^(k-j-1) words from tw[hi << (k-j-1)]): those of stages
// 1 .. k-1 are staged in shared memory with 16-byte cp.async copies at the
// block's start, stage j's at words 2^(k-j-1) .. 2^(k-j)-1; stage 0's,
// each used by one column's butterfly, are read from the table together
// with the round's words.  No global load sits between a subtract and its
// product.  Upper groups copy their tile in with 16-byte cp.async copies;
// the first group loads its round-0 words straight into registers (the
// bit-reversing gather).  Its tile's 2^c columns are row blocks whose
// sources for a row are consecutive words, so a warp's gather reads 4 * 2^c
// bytes of each 32-byte sector, and its blocks take their row blocks in
// bit-reversed order, so that blocks in flight together read the rest of
// those sectors from L2.  Every group stores its last round's words
// straight from registers, each warp store whole sectors.  One tile a
// block: persistent blocks walking the tiles with a second tile buffer
// fetched ahead, and a gather by 4-byte cp.async, were slower on the H100.  The Montgomery product uses the card's
// 32x32->64 multiply and the reference's REDC (baby_bear.py:83-99) with
// one conditional subtract.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t P = 0x78000001u;
constexpr uint32_t M = 0x88000001u;  // P^-1 mod 2^32
constexpr uint32_t R2 = 1172168163u;  // 2^64 mod P
constexpr int TILE_LOG = 15;
constexpr int ROUND_LOG = 4;
constexpr int MAX_THREADS = 1024;
constexpr int SMEM_LIMIT = 232448;

__device__ __forceinline__ uint32_t bb_add(uint32_t a, uint32_t b) {
  const uint32_t r = a + b;
  return r >= P ? r - P : r;
}

__device__ __forceinline__ uint32_t bb_sub(uint32_t a, uint32_t b) {
  const uint32_t r = a - b;
  return r > P ? r + P : r;
}

// REDC(a * b) = a * b * 2^-32 mod P for a * b < 2^32 * P; risc0_baby_bear.h
// :172-179: ret = hi(ab) + hi(red * P) + (lo(ab) != 0), red = -(lo(ab) * M).
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b) {
  const uint64_t ab = static_cast<uint64_t>(a) * b;
  const uint32_t lo = static_cast<uint32_t>(ab);
  const uint32_t red = 0u - lo * M;
  const uint32_t ret = static_cast<uint32_t>(ab >> 32) + __umulhi(red, P) +
                       (lo != 0u ? 1u : 0u);
  return ret >= P ? ret - P : ret;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// lowest set bit of m > 0, and m's low R bits reversed (compile-time)
__host__ __device__ constexpr int ctz(int m) {
  return m & 1 ? 0 : 1 + ctz(m >> 1);
}
template <int R>
__host__ __device__ constexpr uint32_t rev_bits(int m) {
  uint32_t r = 0;
  for (int b = 0; b < R; ++b) r |= ((m >> b) & 1u) << (R - 1 - b);
  return r;
}

// n consecutive words from src to dst: 16-byte loads where n >= 4 (both
// 16-byte aligned), else one word at a time
template <int N>
__device__ __forceinline__ void load_words(uint32_t* dst, const uint32_t* s,
                                           bool global) {
  if constexpr (N >= 4) {
#pragma unroll
    for (int v = 0; v < N / 4; ++v) {
      const uint4 t = global ? __ldg(reinterpret_cast<const uint4*>(s) + v)
                             : reinterpret_cast<const uint4*>(s)[v];
      dst[4 * v] = t.x;
      dst[4 * v + 1] = t.y;
      dst[4 * v + 2] = t.z;
      dst[4 * v + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int v = 0; v < N; ++v) dst[v] = global ? __ldg(s + v) : s[v];
  }
}

// One block's view of the group.
struct Group {
  uint32_t* x;
  const uint32_t* src;
  const uint32_t* tw;
  uint32_t* tile;       // 2^K words, word e at slot(e)
  const uint32_t* tws;  // twiddles of stages 1 .. k-1, 2^(k-1) a row block
  uint32_t hi;          // the tile's row block (column 0's in the first group)
  uint32_t base;        // global index of tile word 0 (upper groups)
  int log_n, s0, k, c, K, flags, shift;
  uint32_t mask;

  __device__ __forceinline__ uint32_t slot(uint32_t e) const {
    return e ^ ((e >> shift) & mask);
  }
  // In the first group (s0 = 0) column v of the tile is a row block of its
  // own, hi + rev(v) << (log_n - K), so that the bit-reversing gather
  // reads the 2^c words of a column's row from 4 * 2^c consecutive bytes;
  // in an upper group the columns are consecutive words of one row block.
  __device__ __forceinline__ uint32_t col(uint32_t e) const {
    return e & ((1u << c) - 1u);
  }
  __device__ __forceinline__ uint32_t hi_of(uint32_t e) const {
    return s0 == 0 && c > 0
               ? hi | ((__brev(col(e)) >> (32 - c)) << (log_n - K))
               : hi;
  }
  __device__ __forceinline__ uint32_t global(uint32_t e) const {
    return s0 == 0 ? (hi_of(e) << k) + (e >> c)
                   : base + ((e >> c) << s0) + col(e);
  }
  __device__ __forceinline__ const uint32_t* twiddles(uint32_t e) const {
    return s0 == 0 ? tws + (col(e) << (k - 1)) : tws;
  }
};

// Stage j + I of a round of R stages, on a register group's 2^R words w:
// butterfly (m, m + 2^I) multiplies by its twiddle, entry m >> (I+1) of the
// stage's 2^(R-I-1) for this register group (hid: its tile row bits above
// the round's).  skip: the transform's top stage, no multiply.
template <int R, int I>
__device__ __forceinline__ void run_stages(const Group& g, uint32_t* w,
                                           int j, uint32_t hid, bool skip,
                                           uint32_t hi, const uint32_t* tws) {
  constexpr int N = 1 << (R - I - 1);
  uint32_t t[N];
  if (I == 0 && j == 0)   // the group's stage 0: from the table
    load_words<N>(t, g.tw + (hi << (g.k - 1)) + (hid << (R - 1)), true);
  else
    load_words<N>(t, tws + (1u << (g.k - j - I - 1)) + hid * N, false);
  const bool no_mul = skip && I == R - 1;
#pragma unroll
  for (int b = 0; b < (1 << (R - 1)); ++b) {
    const int m = ((b >> I) << (I + 1)) | (b & ((1 << I) - 1));
    const uint32_t u = w[m], v = w[m + (1 << I)];
    const uint32_t d = bb_sub(u, v);
    w[m] = bb_add(u, v);
    w[m + (1 << I)] = no_mul ? d : mont_mul(d, t[m >> (I + 1)]);
  }
  if constexpr (I + 1 < R) run_stages<R, I + 1>(g, w, j, hid, skip, hi, tws);
}

// Round of R stages j .. j+R-1 of the group: each register group id (the
// tile word bits outside the round's, low ones first) holds the 2^R words
// e0 | m << a, a = c + j, and runs the round's butterflies on them.
template <int R>
__device__ __forceinline__ void run_round(const Group& g, int j, bool first,
                                          bool last) {
  constexpr int W = 1 << R;
  const int a = g.c + j;
  const uint32_t n_ids = 1u << (g.K - R);
  const bool from_global = first && !(g.flags & 8);
  const bool bitrev = g.flags & 4;
  const bool encode = first && (g.flags & 1);
  const bool decode = last && (g.flags & 2);
  // the round's last stage is the transform's top one: no multiply
  const bool top = last && g.s0 + g.k == g.log_n;
  const uint32_t gstep = 1u << (g.s0 + j);
  // the slot map is XOR-linear: slot(e0 | m << a) = slot(e0) ^ the slots
  // of m's bits
  uint32_t dslot[R];
#pragma unroll
  for (int b = 0; b < R; ++b) dslot[b] = g.slot(1u << (a + b));
  // a bit-reversing load reads src[rev(g0 + m * gstep)], and g0 has no bit
  // of m * gstep: rev(g0) | rev(m) << (log_n - s0 - j - R)
  const int rshift = g.log_n - g.s0 - j - R;
#pragma unroll 1
  for (uint32_t id = threadIdx.x; id < n_ids; id += blockDim.x) {
    const uint32_t hid = id >> a;
    const uint32_t e0 = (id & ((1u << a) - 1u)) | (hid << (a + R));
    const uint32_t g0 = g.global(e0);
    uint32_t w[W], sl[W];
    sl[0] = g.slot(e0);
#pragma unroll
    for (int m = 1; m < W; ++m) sl[m] = sl[m & (m - 1)] ^ dslot[ctz(m)];
    if (from_global) {
      if (bitrev) {
        const uint32_t rbase = __brev(g0) >> (32 - g.log_n);
#pragma unroll
        for (int m = 0; m < W; ++m)
          w[m] = __ldg(g.src + (rbase | (rev_bits<R>(m) << rshift)));
      } else {
#pragma unroll
        for (int m = 0; m < W; ++m) w[m] = g.x[g0 + m * gstep];
      }
    } else {
#pragma unroll
      for (int m = 0; m < W; ++m) w[m] = g.tile[sl[m]];
    }
    if (encode) {
#pragma unroll
      for (int m = 0; m < W; ++m) w[m] = mont_mul(w[m], R2);
    }
    run_stages<R, 0>(g, w, j, hid, top, g.hi_of(e0), g.twiddles(e0));
    if (decode) {
#pragma unroll
      for (int m = 0; m < W; ++m) w[m] = mont_mul(w[m], 1u);
    }
    if (last) {
#pragma unroll
      for (int m = 0; m < W; ++m) g.x[g0 + m * gstep] = w[m];
    } else {
#pragma unroll
      for (int m = 0; m < W; ++m) g.tile[sl[m]] = w[m];
    }
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
    stage_group_r2_kernel(uint32_t* __restrict__ x,
                          const uint32_t* src,  // may be x
                          const uint32_t* __restrict__ tw, int log_n, int s0,
                          int k, int log_cols, int flags, unsigned rounds) {
  extern __shared__ uint4 smem[];
  Group g;
  g.x = x;
  g.src = src;
  g.tw = tw;
  g.log_n = log_n;
  g.s0 = s0;
  g.k = k;
  g.c = log_cols;
  g.K = k + log_cols;
  g.flags = flags;
  g.tile = reinterpret_cast<uint32_t*>(smem);
  g.tws = g.tile + (1u << g.K);
  g.shift = rounds & 15;
  g.mask = (flags & 8) ? 0x1Cu : 0x1Fu;
  // A bit-reversing load reads word rev(i): the first group's blocks take
  // their row blocks in bit-reversed order, so that blocks launched
  // together read neighbouring words and share 32-byte sectors in L2.
  const int tile_bits = log_n - g.K;
  const uint32_t tile_id = s0 == 0 && tile_bits > 0
                               ? __brev(blockIdx.x) >> (32 - tile_bits)
                               : blockIdx.x;
  const int chunk_bits = s0 - log_cols;  // column chunks per row block
  g.hi = s0 == 0 ? tile_id : tile_id >> chunk_bits;
  g.base = s0 == 0 ? 0u : (g.hi << (s0 + k)) +
                              ((tile_id & ((1u << chunk_bits) - 1u))
                               << log_cols);

  // twiddles of stages 1 .. k-1 for each row block of the tile (the
  // first group's columns, else one): slot p in [2^h, 2^(h+1)) holds
  // tw[(hi << h) + p - 2^h], stage k-1-h's
  uint32_t* tws = g.tile + (1u << g.K);
  const uint32_t n_tws = k > 1 ? 1u << (k - 1) : 0u;
  const uint32_t n_blocks = s0 == 0 ? 1u << log_cols : 1u;
  for (uint32_t q = threadIdx.x; q < 3 * n_blocks; q += blockDim.x) {
    const uint32_t v = q / 3, p = 1 + q % 3;
    if (p >= n_tws) continue;
    const int h = 31 - __clz(p);
    tws[(v << (k - 1)) + p] = __ldg(tw + (g.hi_of(v) << h) + p - (1u << h));
  }
  for (uint32_t q = 4 * threadIdx.x; q < n_blocks * n_tws;
       q += 4 * blockDim.x) {
    const uint32_t p = q & (n_tws - 1);
    if (p < 4) continue;
    const int h = 31 - __clz(p);
    const uint32_t hi = g.hi_of(q >> (k - 1));
    cp_async16(tws + q, tw + (hi << h) + p - (1u << h));
  }
  if (flags & 8) {
    for (uint32_t e = 4 * threadIdx.x; e < (1u << g.K); e += 4 * blockDim.x)
      cp_async16(g.tile + g.slot(e), x + g.global(e));
  }
  cp_async_wait_all();
  __syncthreads();

  int j = 0;
  for (int q = 0; j < k; ++q) {
    const int r = (rounds >> (4 * q)) & 15;
    const bool first = q == 0, last = j + r == k;
    switch (r) {
      case 1: run_round<1>(g, j, first, last); break;
      case 2: run_round<2>(g, j, first, last); break;
      case 3: run_round<3>(g, j, first, last); break;
      default: run_round<4>(g, j, first, last); break;
    }
    j += r;
    if (!last) __syncthreads();
  }
}

}  // namespace

// x, src: (2^log_n,) uint32 (src == x unless flags bit 2); tw: (2^log_n/2,)
// bit-reversed Montgomery twiddles; all three 16-byte aligned.  Stages
// s0 .. s0+k-1, tiles of 2^k rows by 2^log_cols columns (k + log_cols <=
// 15, log_cols <= s0; flags bit 3 needs log_cols >= 2 and no bit 2), in
// rounds of rounds' nibbles (each 1 .. 4, summing to k), blocks of
// `threads` threads (a power of two, at most 1024 and at most the register
// groups of any round).  Returns the launch's cudaError_t (0 = launched).
extern "C" int bntt_stage_group_r2(void* x, const void* src, const void* tw,
                                   int log_n, int s0, int k, int log_cols,
                                   int flags, unsigned rounds, int threads,
                                   void* stream) {
  int sum = 0, most = 0;
  for (int q = 0; q < 8 && sum < k; ++q) {
    const int r = (rounds >> (4 * q)) & 15;
    if (r < 1 || r > ROUND_LOG) return static_cast<int>(cudaErrorInvalidValue);
    sum += r;
    most = r > most ? r : most;
  }
  const int K = k + log_cols;
  if (log_n < 1 || log_n > 30 || k < 1 || s0 < 0 || s0 + k > log_n ||
      log_cols < 0 || (s0 > 0 && log_cols > s0) || K > TILE_LOG ||
      K > log_n || sum != k ||
      ((flags & 4) && src == x) || ((flags & 8) && (log_cols < 2 ||
                                                     (flags & 4))) ||
      threads < 1 || threads > MAX_THREADS || (threads & (threads - 1)) ||
      threads > (1 << (K - most)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 4 * ((1 << K) + (k > 1 ? (s0 == 0 ? 1 << log_cols : 1)
                                              << (k - 1)
                                        : 0));
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  // the limit belongs to the current device, so it is raised on every
  // launch, as the other kernels that take more than 48 KB do
  const cudaError_t err = cudaFuncSetAttribute(
      stage_group_r2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_LIMIT);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = 1u << (log_n - K);
  stage_group_r2_kernel<<<blocks, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(x), static_cast<const uint32_t*>(src),
      static_cast<const uint32_t*>(tw), log_n, s0, k, log_cols, flags,
      rounds);
  return static_cast<int>(cudaGetLastError());
}
