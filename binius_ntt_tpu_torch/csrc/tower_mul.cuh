// Bit-sliced GF(2^(2^h)) tower multiply, per thread, over uint32 planes.
//
// Same function as binius_ntt_tpu/ntt/pallas_kernels.py::_mul_planes (the
// straight-line Karatsuba the Pallas kernels inline) and as
// fields/bitsliced.py::multiply: plane i of an operand holds bit i of 32
// field elements, one per bit-lane, and a product costs 3^h leaf ANDs plus
// the XORs of the Karatsuba combine (2,187 AND + 11,261 XOR at h = 7).
//
// Written as a template recursion on h over local arrays with constant
// indices, so nvcc unrolls it into the straight-line circuit.  Heights above
// TOWER_INLINE_H become out-of-line calls that pass operands through local
// memory.  At h = 7 the circuit keeps ~510 planes live, far above the 255
// registers of a thread.  Measured on an H100 SXM (700 W): fully unrolled
// (TOWER_INLINE_H = 7 or 6), ptxas gives the huge function 32 registers
// and ~40 KB of spills, builds in 55 s and runs the 2^24 NTT's stage groups
// in 184 ms; unrolled only up to GF(2^32) (TOWER_INLINE_H = 5), each 32-bit
// leaf product runs in 255 registers without spills, the build takes 16 s
// and the same groups 34.8 ms (40.0 ms at 4, 52.7 ms at 3).
//
// tower_mul128 is the GF(2^128) entry point.  It is out of line so that a
// kernel with several call sites carries a single copy of the circuit.
// tower_mul32 is the GF(2^32) one (3^5 = 243 AND + the combine XORs): it
// is inline, with no outlined level, at each of its call sites.
#pragma once

#include <cstdint>

namespace tower {

constexpr int TOWER_INLINE_H = 5;

// y = alpha_h * x:  [x0, x1] -> [x1, x0 ^ alpha_{h-1}(x1)]
template <int H>
__device__ __forceinline__ void mul_alpha(const uint32_t* x, uint32_t* y) {
  if constexpr (H == 0) {
    y[0] = x[0];
  } else {
    constexpr int HALF = 1 << (H - 1);
    uint32_t t[HALF];
    mul_alpha<H - 1>(x + HALF, t);
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      y[i] = x[HALF + i];
      y[HALF + i] = x[i] ^ t[i];
    }
  }
}

template <int H>
__device__ __forceinline__ void mul(const uint32_t* a, const uint32_t* b,
                                    uint32_t* z);

template <int H>
__device__ __noinline__ void mul_outlined(const uint32_t* a,
                                          const uint32_t* b, uint32_t* z);

// z = a * b in GF(2^(2^H)); z must not alias a or b.
template <int H>
__device__ __forceinline__ void mul_body(const uint32_t* a, const uint32_t* b,
                                         uint32_t* z) {
  constexpr int HALF = 1 << (H - 1);
  uint32_t sa[HALF], sb[HALF];
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    sa[i] = a[i] ^ a[HALF + i];
    sb[i] = b[i] ^ b[HALF + i];
  }
  uint32_t z0[HALF], z2[HALF], zm[HALF], z2a[HALF];
  mul<H - 1>(a, b, z0);
  mul<H - 1>(a + HALF, b + HALF, z2);
  mul<H - 1>(sa, sb, zm);
  mul_alpha<H - 1>(z2, z2a);
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const uint32_t lo = z0[i] ^ z2[i];
    z[i] = lo;
    z[HALF + i] = zm[i] ^ lo ^ z2a[i];
  }
}

template <int H>
__device__ __noinline__ void mul_outlined(const uint32_t* a,
                                          const uint32_t* b, uint32_t* z) {
  mul_body<H>(a, b, z);
}

template <int H>
__device__ __forceinline__ void mul(const uint32_t* a, const uint32_t* b,
                                    uint32_t* z) {
  if constexpr (H == 0) {
    z[0] = a[0] & b[0];
  } else if constexpr (H > TOWER_INLINE_H) {
    mul_outlined<H>(a, b, z);
  } else {
    mul_body<H>(a, b, z);
  }
}

}  // namespace tower

// z = a * b over 128 planes (GF(2^128), 32 products per call).
static __device__ __noinline__ void tower_mul128(const uint32_t* a,
                                                 const uint32_t* b,
                                                 uint32_t* z) {
  tower::mul_body<7>(a, b, z);
}

// z = a * b over 32 planes (GF(2^32), 32 products per call).
static __device__ __forceinline__ void tower_mul32(const uint32_t* a,
                                                   const uint32_t* b,
                                                   uint32_t* z) {
  static_assert(tower::TOWER_INLINE_H >= 5, "GF(2^32) must stay inline");
  tower::mul<5>(a, b, z);
}
