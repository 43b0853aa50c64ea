"""Packed (SWAR) binary-tower multiply on int32 words (torch).

Port of binius_ntt_tpu/fields/tower_simd.py.  A word holds ``32 / 2^h``
packed GF(2^(2^h)) elements, all multiplied at once with XOR, AND and
shifts (the representation of ``mul_binary_tower_32b_simd`` in the
upstream CUDA library).  At height 5 a word is one GF(2^32) element, so
``mul_packed`` is the compact-layout multiply of the GF(2^32) additive NTT.

Words are int32 tensors with uint32 bits (utils/bits.py): every right
shift is :func:`lsr`, and the one mask >= 2^31 goes through :func:`u32`.
"""

from __future__ import annotations

import torch

from ..utils.bits import lsr, u32

__all__ = ["mul_packed", "inverse_packed", "interleave_32b",
           "xor_adjacent_32b", "MASKS", "ALPHAS"]

MASKS = (0x55555555, 0x33333333, 0x0F0F0F0F, 0x00FF00FF, 0x0000FFFF)
ALPHAS = (0x55555555, 0x22222222, 0x04040404, 0x00100010, 0x00000100)


def interleave_32b(a: torch.Tensor, b: torch.Tensor, height: int):
    """Swap the odd 2^height-bit lanes of ``a`` with the even ones of ``b``."""
    mask = MASKS[height]
    blen = 1 << height
    t = (lsr(a, blen) ^ b) & mask
    return a ^ (t << blen), b ^ t


def xor_adjacent_32b(a: torch.Tensor, height: int) -> torch.Tensor:
    """Each 2^height-bit lane pair holds the XOR of the pair, twice."""
    mask = MASKS[height]
    blen = 1 << height
    t = (lsr(a, blen) ^ a) & mask
    return t ^ (t << blen)


def mul_packed(a: torch.Tensor, b: torch.Tensor, height: int) -> torch.Tensor:
    """Lane-parallel tower multiply of int32 words (broadcasting)."""
    if height == 0:
        return a & b
    h = height - 1
    z0_even_z2_odd = mul_packed(a, b, h)

    lo, hi = interleave_32b(a, b, h)
    lo_plus_hi = lo ^ hi

    blen = 1 << h
    odd_mask = u32(MASKS[h] << blen)

    alpha_even_z2_odd = ALPHAS[h] ^ (z0_even_z2_odd & odd_mask)
    a_lh_even_alpha_odd, b_lh_even_z2_odd = interleave_32b(
        lo_plus_hi, alpha_even_z2_odd, h)
    z1z0z2_even_z2a_odd = mul_packed(a_lh_even_alpha_odd, b_lh_even_z2_odd, h)

    zero_even_sum_odd = (
        z1z0z2_even_z2a_odd ^ (z1z0z2_even_z2a_odd << blen)) & odd_mask
    z0_plus_z2_dup = xor_adjacent_32b(z0_even_z2_odd, h)
    return z0_plus_z2_dup ^ zero_even_sum_odd


def inverse_packed(x: torch.Tensor, height: int) -> torch.Tensor:
    """Tower-field inverse of one element per word (its low 2^height bits,
    upper bits zero); inverse(0) = 0.  delta = a0*(a0 ^ alpha*a1) ^ a1^2,
    then recurse; GF(16) by Fermat, x^14 = x^2 * x^4 * x^8."""
    if height <= 2:
        x2 = mul_packed(x, x, 2)
        x4 = mul_packed(x2, x2, 2)
        x8 = mul_packed(x4, x4, 2)
        return mul_packed(x2, mul_packed(x4, x8, 2), 2)
    h = height - 1
    half = 1 << h
    a0 = x & u32((1 << half) - 1)
    a1 = lsr(x, half)
    alpha = 1 << (1 << (h - 1))           # the x_h basis element
    intermediate = a0 ^ mul_packed(a1, torch.full_like(a1, alpha), h)
    delta = mul_packed(a0, intermediate, h) ^ mul_packed(a1, a1, h)
    dinv = inverse_packed(delta, h)
    out0 = mul_packed(dinv, intermediate, h)
    out1 = mul_packed(dinv, a1, h)
    return (out1 << half) | out0
