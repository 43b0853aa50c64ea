// m31.cuh: Mersenne-31 and its degree-4 extension QM31 on the card, shared
// by csrc/prime_round.cu and csrc/prime_fold.cu.
//
// Port of the field arithmetic of binius_ntt_tpu/fields/m31.py and
// binius_ntt_tpu/sumcheck/pallas_prime_round.py (qm31_mul_planar): M31 =
// GF(2^31 - 1), CM31 = M31[i] with i^2 = -1, QM31 = CM31[j] with
// j^2 = 2 + i (src/ulvt/finite_fields/m31.cuh, cm31.cuh, qm31.cuh).  A QM31
// value is a uint4 (x, y, z, w) = (x + y i) + (z + w i) j, every component
// canonical in [0, P).
//
// The TPU builds its 31x31 product from 16-bit limbs (no 64-bit multiply on
// its vector unit); here it is one 32x32->64 multiply and two Mersenne
// folds.  The QM31 product is Karatsuba at both extension levels, 9 M31
// multiplies (pallas_prime_round.py:73-100); the plain torch version
// (fields/m31.py::qm31_mul) is the schoolbook form, so the two are
// independent formulations.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace m31 {

constexpr uint32_t P = 0x7FFFFFFFu;

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;  // < 2^32
  return s >= P ? s - P : s;
}

__device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
  return a >= b ? a - b : a - b + P;
}

__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  const uint64_t v = static_cast<uint64_t>(a) * b;  // < 2^62
  uint32_t s = static_cast<uint32_t>(v & P) + static_cast<uint32_t>(v >> 31);
  s = (s & P) + (s >> 31);  // <= P
  return s == P ? 0u : s;
}

// (ax + ay i)(bx + by i), i^2 = -1, Karatsuba: 3 multiplies.
__device__ __forceinline__ void cm31_mul(uint32_t ax, uint32_t ay, uint32_t bx,
                                         uint32_t by, uint32_t& re,
                                         uint32_t& im) {
  const uint32_t t0 = mul(ax, bx), t1 = mul(ay, by);
  const uint32_t t2 = mul(add(ax, ay), add(bx, by));
  re = sub(t0, t1);
  im = sub(t2, add(t0, t1));
}

// (u + v j)(s + t j) = (us + R vt) + ((u + v)(s + t) - us - vt) j, R = 2 + i.
__device__ __forceinline__ uint4 qm31_mul(uint4 a, uint4 b) {
  uint32_t us_re, us_im, vt_re, vt_im, st_re, st_im;
  cm31_mul(a.x, a.y, b.x, b.y, us_re, us_im);
  cm31_mul(a.z, a.w, b.z, b.w, vt_re, vt_im);
  cm31_mul(add(a.x, a.z), add(a.y, a.w), add(b.x, b.z), add(b.y, b.w), st_re,
           st_im);
  const uint32_t rvt_re = sub(add(vt_re, vt_re), vt_im);
  const uint32_t rvt_im = add(vt_re, add(vt_im, vt_im));
  return make_uint4(add(us_re, rvt_re), add(us_im, rvt_im),
                    sub(st_re, add(us_re, vt_re)),
                    sub(st_im, add(us_im, vt_im)));
}

__device__ __forceinline__ uint4 qm31_add(uint4 a, uint4 b) {
  return make_uint4(add(a.x, b.x), add(a.y, b.y), add(a.z, b.z),
                    add(a.w, b.w));
}

__device__ __forceinline__ uint4 qm31_sub(uint4 a, uint4 b) {
  return make_uint4(sub(a.x, b.x), sub(a.y, b.y), sub(a.z, b.z),
                    sub(a.w, b.w));
}

}  // namespace m31
