// mul_compact: out[n] = a[n] * b[n] over compact GF(2^(2^H)) elements of
// L = 2^(H-5) uint32 limbs each (little-endian), H = 5, 6, 7.
//
// Replaces binius_ntt_tpu/fields/tower_compact.py::mul_compact_tiles
// (pallas_call at :116), whose body is the limb Karatsuba _mul_limbs /
// _alpha_limbs (:32-61) down to the SWAR height-5 multiply.
//
// Bound on this card: integer ALU.  The product needs ~443 operations in
// the bit-sliced form (a 32nd of tower_mul.cuh's 10,326 LOP3 operations,
// plus the 32 x 32 transposes of a, b and out) for 48 bytes of traffic;
// the card's balance is ~5 operations a byte.  This SWAR design issues
// far more: 13 height-5 SWAR products (9 leaf products and 4
// multiply-by-alpha) plus the limb XORs, ~8,000 operations a GF(2^128)
// product.  Everything stays in registers: an element is 4 limbs, and the
// SWAR multiply works on one word at a time.
//
// Design: one thread per element, limbs on the last axis as the tensors
// hold them.  The thread loads its L limbs with one vector load (uint2 at
// H = 6, uint4 at H = 7), runs the limb recursion as a template recursion
// in registers and stores the L result limbs.  The reference moves the
// limb axis onto sublanes (a.T, :104-105) for the TPU's lane tiling; a
// thread that owns a whole element has no such need.  H is a template
// argument, one instantiation per height.
#include <cuda_runtime.h>

#include <cstdint>

#include "tower_simd.cuh"

namespace {

constexpr int THREADS = 256;

// y = alpha_H * x over limbs: [x0, x1] -> [x1, x0 ^ alpha_{H-1} x1]
template <int H>
__device__ __forceinline__ void alpha_limbs(const uint32_t* x, uint32_t* y) {
  if constexpr (H <= 5) {
    y[0] = tower_simd::mul_packed<H>(x[0], 1u << (1 << (H - 1)));
  } else {
    constexpr int HALF = 1 << (H - 6);
    uint32_t t[HALF];
    alpha_limbs<H - 1>(x + HALF, t);
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      y[i] = x[HALF + i];
      y[HALF + i] = x[i] ^ t[i];
    }
  }
}

// z = a * b over limbs (Karatsuba, binary_tower.cuh:35-50 on limb vectors)
template <int H>
__device__ __forceinline__ void mul_limbs(const uint32_t* a, const uint32_t* b,
                                          uint32_t* z) {
  if constexpr (H <= 5) {
    z[0] = tower_simd::mul_packed<H>(a[0], b[0]);
  } else {
    constexpr int HALF = 1 << (H - 6);
    uint32_t sa[HALF], sb[HALF], z0[HALF], z2[HALF], zm[HALF], z2a[HALF];
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      sa[i] = a[i] ^ a[HALF + i];
      sb[i] = b[i] ^ b[HALF + i];
    }
    mul_limbs<H - 1>(a, b, z0);
    mul_limbs<H - 1>(a + HALF, b + HALF, z2);
    mul_limbs<H - 1>(sa, sb, zm);
    alpha_limbs<H - 1>(z2, z2a);
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const uint32_t lo = z0[i] ^ z2[i];
      z[i] = lo;
      z[HALF + i] = zm[i] ^ lo ^ z2a[i];
    }
  }
}

template <int H>
struct Limbs;
template <>
struct Limbs<5> {
  using T = uint32_t;
  static __device__ __forceinline__ void get(T v, uint32_t* x) { x[0] = v; }
  static __device__ __forceinline__ T put(const uint32_t* x) { return x[0]; }
};
template <>
struct Limbs<6> {
  using T = uint2;
  static __device__ __forceinline__ void get(T v, uint32_t* x) {
    x[0] = v.x; x[1] = v.y;
  }
  static __device__ __forceinline__ T put(const uint32_t* x) {
    return make_uint2(x[0], x[1]);
  }
};
template <>
struct Limbs<7> {
  using T = uint4;
  static __device__ __forceinline__ void get(T v, uint32_t* x) {
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  static __device__ __forceinline__ T put(const uint32_t* x) {
    return make_uint4(x[0], x[1], x[2], x[3]);
  }
};

template <int H>
__global__ void __launch_bounds__(THREADS)
    mul_compact_kernel(const uint32_t* __restrict__ a,
                       const uint32_t* __restrict__ b,
                       uint32_t* __restrict__ out, long long n) {
  using L = Limbs<H>;
  using T = typename L::T;
  constexpr int NL = 1 << (H - 5);
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t ra[NL], rb[NL], rz[NL];
  L::get(reinterpret_cast<const T*>(a)[i], ra);
  L::get(reinterpret_cast<const T*>(b)[i], rb);
  mul_limbs<H>(ra, rb, rz);
  reinterpret_cast<T*>(out)[i] = L::put(rz);
}

}  // namespace

// a, b, out: (n, 2^(height-5)) uint32, aligned to a whole element, on the
// current device; height 5, 6 or 7.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int bntt_mul_compact(const void* a, const void* b, void* out,
                                long long n, int height, void* stream) {
  if (n < 0 || height < 5 || height > 7)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  auto kernel = height == 5   ? mul_compact_kernel<5>
                : height == 6 ? mul_compact_kernel<6>
                              : mul_compact_kernel<7>;
  const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
