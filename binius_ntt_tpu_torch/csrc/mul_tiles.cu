// mul_tiles: out[n] = a[n] * b[n] over (N, 128) bit-sliced GF(2^128) rows.
//
// Replaces binius_ntt_tpu/ntt/pallas_kernels.py::mul_tiles (pallas_call at
// :210), whose body is the straight-line multiply _mul_vmem_sl/_mul_planes.
//
// Bound on this card: integer ALU, then local memory.  A row is 32 products
// for 3 x 512 bytes of HBM traffic and 10,326 three-input LOP3 operations
// (13,448 two-input gates), ~6.7 ops per byte, against a balance of ~5 for
// the H100 SXM (132 SMs x 64 int32 lanes x 1.98 GHz over 3.35 TB/s;
// estimate from the data sheet).  The circuit
// keeps ~510 planes live, so a thread spills to local memory; the first
// design accepts that.
//
// Design: one thread per row.  The thread loads its two rows with 16-byte
// loads, runs the per-thread circuit of tower_mul.cuh and stores its row.
#include <cuda_runtime.h>

#include <cstdint>

#include "tower_mul.cuh"

namespace {

constexpr int W = 128;
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
    mul_tiles_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b,
                     uint32_t* __restrict__ out, long long n) {
  const long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (r >= n) return;
  uint32_t ra[W], rb[W], rz[W];
  const uint4* a4 = reinterpret_cast<const uint4*>(a + r * W);
  const uint4* b4 = reinterpret_cast<const uint4*>(b + r * W);
#pragma unroll
  for (int i = 0; i < W / 4; ++i) {
    const uint4 va = a4[i];
    const uint4 vb = b4[i];
    ra[4 * i] = va.x; ra[4 * i + 1] = va.y; ra[4 * i + 2] = va.z; ra[4 * i + 3] = va.w;
    rb[4 * i] = vb.x; rb[4 * i + 1] = vb.y; rb[4 * i + 2] = vb.z; rb[4 * i + 3] = vb.w;
  }
  tower_mul128(ra, rb, rz);
  uint4* o4 = reinterpret_cast<uint4*>(out + r * W);
#pragma unroll
  for (int i = 0; i < W / 4; ++i)
    o4[i] = make_uint4(rz[4 * i], rz[4 * i + 1], rz[4 * i + 2], rz[4 * i + 3]);
}

}  // namespace

// a, b, out: (n, 128) uint32, 16-byte aligned, on the current device.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int bntt_mul_tiles(const void* a, const void* b, void* out,
                              long long n, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + THREADS - 1) / THREADS;
  mul_tiles_kernel<<<(unsigned)blocks, THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
