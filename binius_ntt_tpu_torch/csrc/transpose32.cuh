// The 32x32 bit transpose of a group of 32 words, as device functions for
// the lane mappings of csrc/bitslice_lane_groups.cu, csrc/mul_compact.cu
// and csrc/bitslice128.cu.
//
// The function is layout/bitslicing.py::transpose32: word i of the group is
// row i of the bit matrix, little-endian, and after the transpose bit j of
// word p is bit p of input word j.  It is its own inverse.  The Hacker's
// Delight ladder pairs words i and i + J (bit J of i clear) for J = 16, 8,
// 4, 2, 1 and swaps the J x J blocks between them under mask(J); each
// stage takes a shift and a LOP3 for t, and an XOR and a shift-XOR to apply
// it, on each pair.
//
// Mappings:
//   * in_thread: all 32 words in one thread (a batch's limb in mul_compact),
//     80 swaps in registers and no exchange between lanes;
//   * lanes4: four consecutive words 4 (l % 8) .. 4 (l % 8) + 3 of group
//     l / 8 in lane l, so a warp holds four groups (512 contiguous bytes,
//     one 16-byte load a lane).  Stages J = 16, 8, 4 pair lane l with
//     lane l ^ (J / 4) through __shfl_xor_sync, on each of the four words;
//     J = 2, 1 are swaps inside the thread;
//   * lanes1: word l of each of N groups in lane l (csrc/bitslice128.cu:
//     element l's N = 4 words of a GF(2^128) row, one group a word).  All
//     five stages pair lane l with lane l ^ J through __shfl_xor_sync, on
//     each of the N words, and apply the partner's half in two operations
//     (rotate_select).
#pragma once

#include <cstdint>

namespace transpose32 {

__host__ __device__ constexpr uint32_t mask(int j) {
  return j == 16 ? 0x0000FFFFu
       : j == 8  ? 0x00FF00FFu
       : j == 4  ? 0x0F0F0F0Fu
       : j == 2  ? 0x33333333u
                 : 0x55555555u;
}

// one stage on a pair held by one thread; lo is the word whose index has
// bit J clear
template <int J>
__device__ __forceinline__ void swap(uint32_t& lo, uint32_t& hi) {
  const uint32_t t = ((lo >> J) ^ hi) & mask(J);
  hi ^= t;
  lo ^= t << J;
}

// one stage on a pair split between two lanes: x is this lane's word, y its
// partner's; upper when this word's index has bit J set
template <int J>
__device__ __forceinline__ uint32_t exchange(uint32_t x, uint32_t y,
                                             bool upper) {
  return upper ? x ^ (((y >> J) ^ x) & mask(J))
               : x ^ ((((x >> J) ^ y) & mask(J)) << J);
}

// exchange<J> in two operations, given rot and keep for this lane: the
// partner's half is y rotated left by rot = J (this word's index has bit J
// clear) or 32 - J (set), which puts each of its bits where this word takes
// it; the bits that wrap around land where the select keeps this word's own
// bits, keep = mask(J) (clear) or its complement (set)
__device__ __forceinline__ uint32_t rotate_select(uint32_t x, uint32_t y,
                                                  int rot, uint32_t keep) {
  return (x & keep) | (__funnelshift_l(y, y, rot) & ~keep);
}

// the group's word i at w[i * S], all in this thread (stages J and below)
template <int S, int J = 16>
__device__ __forceinline__ void in_thread(uint32_t* w) {
#pragma unroll
  for (int i = 0; i < 32; ++i)
    if (!(i & J)) swap<J>(w[i * S], w[(i + J) * S]);
  if constexpr (J > 1) in_thread<S, J / 2>(w);
}

template <int J>
__device__ __forceinline__ void lanes4_stage(uint32_t (&v)[4], int lane) {
  const bool upper = lane & (J / 4);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    v[q] = exchange<J>(v[q], __shfl_xor_sync(0xFFFFFFFFu, v[q], J / 4),
                       upper);
}

// word 4 (lane % 8) + q of group lane / 8 in v[q]; every lane of the warp
// takes part
__device__ __forceinline__ void lanes4(uint32_t (&v)[4]) {
  const int lane = threadIdx.x & 31;
  lanes4_stage<16>(v, lane);
  lanes4_stage<8>(v, lane);
  lanes4_stage<4>(v, lane);
  swap<2>(v[0], v[2]);
  swap<2>(v[1], v[3]);
  swap<1>(v[0], v[1]);
  swap<1>(v[2], v[3]);
}

template <int J, int N>
__device__ __forceinline__ void lanes1_stage(uint32_t (&v)[N], int lane) {
  const bool upper = lane & J;
  const int rot = upper ? 32 - J : J;
  const uint32_t keep = upper ? ~mask(J) : mask(J);
#pragma unroll
  for (int q = 0; q < N; ++q)
    v[q] = rotate_select(v[q], __shfl_xor_sync(0xFFFFFFFFu, v[q], J), rot,
                         keep);
}

// word lane of group q in v[q]; after the ladder v[q] is the transposed
// group's word lane; every lane of the warp takes part
template <int N>
__device__ __forceinline__ void lanes1(uint32_t (&v)[N]) {
  const int lane = threadIdx.x & 31;
  lanes1_stage<16>(v, lane);
  lanes1_stage<8>(v, lane);
  lanes1_stage<4>(v, lane);
  lanes1_stage<2>(v, lane);
  lanes1_stage<1>(v, lane);
}

}  // namespace transpose32
