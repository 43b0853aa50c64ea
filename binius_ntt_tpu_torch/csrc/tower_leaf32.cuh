// The GF(2^128) product as nine GF(2^32) leaf products, made in place in
// shared memory.  Shared by csrc/sumcheck_round.cu (a product of two folded
// columns), csrc/sumcheck_fold.cu (a row by the challenge) and
// csrc/mul_compact.cu (compact products, and their GF(2^64) case).
//
// The product is the two-level Karatsuba of tower::mul_body<7> -> <6> ->
// <5>.  With a and b in 32-plane chunks a0 .. a3, a leaf multiplies the XOR
// of a chunk subset of a by the XOR of the same subset of b.  The leaves go
// by level-6 product (zm, z0, z2; GROUPED), each product's three summed in
// registers, so the product is made in place: zm waits in 64 planes of
// scratch, z0 overwrites chunks 0 and 1 of a (no later leaf reads them),
// and z2 and mul_body<7>'s combine give all four chunks.  One inline
// tower_mul32 call site in a rolled loop over the leaves keeps a kernel
// within a thread's 255 registers with no spills (the round 255, the fold
// 224), where the GF(2^128) circuit (~510 planes live) goes through local
// memory.  tests/test_torch_sumcheck_round_leaf32.py derives the leaves
// from the recursion and holds this form to it; the fold's table is held
// in tests/test_torch_sumcheck_fold_leaf32.py.
//
// A thread's words live in shared memory, plane-major and thread-minor:
// word i of a buffer at [i * STRIDE], STRIDE the threads of a block, free of
// bank conflicts.  How b's leaf operand is had is the caller's: the round
// gathers it from its folded column (GatherLeaf), the fold reads it from a
// table formed once a block.
#pragma once

#include <cstdint>

#include "tower_mul.cuh"

namespace leaf32 {

constexpr int C32 = 32;              // planes of a GF(2^32) chunk
constexpr int NCHUNK = 4;            // chunks of a GF(2^128) element

// the leaves as chunk subsets of a (and of b), by level-6 product: zm =
// (a_lo ^ a_hi)(b_lo ^ b_hi), z0 = a_lo b_lo, z2 = a_hi b_hi, each as its
// operands' subsets s0, s1 and then s0 ^ s1
constexpr int N_LEAF = 9;
static __constant__ uint32_t GROUPED[N_LEAF] = {0b0101, 0b1010, 0b1111, 0b0001,
                                                0b0010, 0b0011, 0b0100, 0b1000,
                                                0b1100};

// d = XOR of the chunks of src (word i at src[i * STRIDE]) in subset s
template <int STRIDE>
__device__ __forceinline__ void gather(const uint32_t* src, uint32_t s,
                                       uint32_t* d) {
#pragma unroll
  for (int i = 0; i < C32; ++i) d[i] = 0u;
#pragma unroll
  for (int c = 0; c < NCHUNK; ++c) {
    if ((s >> c) & 1u) {
#pragma unroll
      for (int i = 0; i < C32; ++i) d[i] ^= src[(c * C32 + i) * STRIDE];
    }
  }
}

// b's leaf l gathered from a thread's 128 planes
template <int STRIDE>
struct GatherLeaf {
  const uint32_t* b;
  __device__ __forceinline__ void operator()(int l, uint32_t* y) const {
    gather<STRIDE>(b, GROUPED[l], y);
  }
};

// a = a * b in GF(2^128), in place, as the three level-6 products of
// tower::mul_body<7>, zm = (a_lo ^ a_hi)(b_lo ^ b_hi), z0 = a_lo b_lo and
// z2 = a_hi b_hi, each as three leaves summed into registers (r).  zm goes
// to t (64 planes); z0 replaces chunks 0, 1 of a, which no later leaf
// reads; z2 and the combine then give all four chunks.  leaf_b(l, y) puts
// b's operand of leaf l (the XOR of its chunks in GROUPED[l]) in y.
//
// H = 6 is a = a * b in GF(2^64) on chunks 0 and 1 (csrc/mul_compact.cu):
// z0's three leaves alone (l = 3, 4, 5) are tower::mul_body<6> on those
// chunks, and write the product over them; t is not used.
template <int STRIDE, int H = 7, class LeafB>
__device__ __forceinline__ void mul_in_place(uint32_t* a, const LeafB& leaf_b,
                                             uint32_t* t) {
  static_assert(H == 6 || H == 7, "GF(2^64) or GF(2^128)");
  constexpr int FIRST = H == 7 ? 0 : 3, LAST = H == 7 ? N_LEAF : 6;
  uint32_t r[2 * C32];
#pragma unroll 1
  for (int l = FIRST; l < LAST; ++l) {
    const int g = l / 3, k = l % 3;
    uint32_t x[C32], y[C32], p[C32], p1[C32];
    gather<STRIDE>(a, GROUPED[l], x);
    leaf_b(l, y);
    tower_mul32(x, y, p);
    // lo = L(s0) ^ L(s1), hi = L(s0 ^ s1) ^ L(s0) ^ L(s1) ^ alpha L(s1)
    if (k == 0) {
#pragma unroll
      for (int i = 0; i < C32; ++i) r[i] = r[C32 + i] = p[i];
    } else if (k == 1) {
      tower::mul_alpha<5>(p, p1);
#pragma unroll
      for (int i = 0; i < C32; ++i) {
        r[i] ^= p[i];
        r[C32 + i] ^= p[i] ^ p1[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < C32; ++i) r[C32 + i] ^= p[i];
      if (g == 0) {
#pragma unroll
        for (int i = 0; i < 2 * C32; ++i) t[i * STRIDE] = r[i];
      } else if (g == 1) {
#pragma unroll
        for (int i = 0; i < 2 * C32; ++i) a[i * STRIDE] = r[i];
      } else {
        tower::mul_alpha<5>(r + C32, p1);
#pragma unroll
        for (int i = 0; i < C32; ++i) {
          const uint32_t c0 = a[i * STRIDE] ^ r[i];
          const uint32_t c1 = a[(C32 + i) * STRIDE] ^ r[C32 + i];
          a[i * STRIDE] = c0;
          a[(C32 + i) * STRIDE] = c1;
          a[(2 * C32 + i) * STRIDE] = t[i * STRIDE] ^ c0 ^ r[C32 + i];
          a[(3 * C32 + i) * STRIDE] =
              t[(C32 + i) * STRIDE] ^ c1 ^ r[i] ^ p1[i];
        }
      }
    }
  }
}

}  // namespace leaf32
