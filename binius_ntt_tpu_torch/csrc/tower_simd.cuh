// Packed (SWAR) binary-tower multiply of one uint32 word, per thread.
//
// Same function as fields/tower_simd.py::mul_packed (the representation of
// the upstream library's mul_binary_tower_32b_simd): a word holds 32 / 2^H
// GF(2^(2^H)) elements, all multiplied at once with AND, XOR and shifts.
// At H = 5 a word is one GF(2^32) element.  Karatsuba's two half-width
// products that share an operand pattern run two to a word in the even and
// odd lanes, so a product costs 2^H leaf ANDs instead of 3^H.
//
// Written as a template recursion on H with the masks as constants, so nvcc
// unrolls it into straight-line code of a few hundred operations (no arrays,
// no local memory) and folds a constant operand (multiply-by-alpha) into it.
#pragma once

#include <cstdint>

namespace tower_simd {

__host__ __device__ constexpr uint32_t mask(int h) {
  return h == 0 ? 0x55555555u
       : h == 1 ? 0x33333333u
       : h == 2 ? 0x0F0F0F0Fu
       : h == 3 ? 0x00FF00FFu
                : 0x0000FFFFu;
}

__host__ __device__ constexpr uint32_t alphas(int h) {
  return h == 0 ? 0x55555555u
       : h == 1 ? 0x22222222u
       : h == 2 ? 0x04040404u
       : h == 3 ? 0x00100010u
                : 0x00000100u;
}

// z = a * b, lane by lane, over the 2^H-bit lanes of the words.
template <int H>
__device__ __forceinline__ uint32_t mul_packed(uint32_t a, uint32_t b) {
  if constexpr (H == 0) {
    return a & b;
  } else {
    constexpr int h = H - 1;
    constexpr int BLEN = 1 << h;
    constexpr uint32_t EVEN = mask(h);
    constexpr uint32_t ODD = EVEN << BLEN;
    const uint32_t z0_even_z2_odd = mul_packed<h>(a, b);
    // interleave(a, b): lo = [a0, b0], hi = [a1, b1] per lane pair
    const uint32_t t0 = ((a >> BLEN) ^ b) & EVEN;
    const uint32_t lo_plus_hi = (a ^ (t0 << BLEN)) ^ (b ^ t0);
    const uint32_t alpha_even_z2_odd = alphas(h) ^ (z0_even_z2_odd & ODD);
    // interleave(lo_plus_hi, alpha_even_z2_odd)
    const uint32_t t1 = ((lo_plus_hi >> BLEN) ^ alpha_even_z2_odd) & EVEN;
    const uint32_t z1 = mul_packed<h>(lo_plus_hi ^ (t1 << BLEN),
                                      alpha_even_z2_odd ^ t1);
    const uint32_t zero_even_sum_odd = (z1 ^ (z1 << BLEN)) & ODD;
    // xor_adjacent(z0_even_z2_odd)
    const uint32_t t2 = ((z0_even_z2_odd >> BLEN) ^ z0_even_z2_odd) & EVEN;
    return (t2 ^ (t2 << BLEN)) ^ zero_even_sum_odd;
  }
}

}  // namespace tower_simd
