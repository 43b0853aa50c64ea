"""Scalar Fan-Paar binary tower field GF(2^(2^h)) over Python ints.

This is the framework's *reference oracle*: a straightforward, unvectorised
implementation of the tower-field recursion used to validate every
vectorised / bit-sliced / Pallas code path, and to run host-side precomputes
(subspace evaluations, normalisation inverses).

Semantics match the reference CUDA library exactly:
  - multiply / square / inverse / multiply_alpha recursion:
    reference src/ulvt/finite_fields/binary_tower.cuh:35-105 (heights <= 5,
    uint32), src/ulvt/sumcheck/test/utils/unbitsliced_mul.cuh (heights <= 6,
    uint64), src/ulvt/sumcheck/test/utils/tower_7_mul.cu:4-24 (height 7).
  - element encoding: little-endian bits, the height-(h-1) subfield occupies
    the low 2^(h-1) bits, the alpha coefficient the high 2^(h-1) bits.

Python ints have no width limit, so a single implementation covers all
heights (the reference needs three separate ones for 32/64/128-bit storage).
"""

from __future__ import annotations

from functools import lru_cache

__all__ = [
    "multiply",
    "square",
    "inverse",
    "multiply_alpha",
    "add",
    "n_bits",
    "is_valid",
    "pow_field",
]


def n_bits(height: int) -> int:
    return 1 << height


def is_valid(a: int, height: int) -> bool:
    return a >> (1 << height) == 0


def add(a: int, b: int) -> int:
    return a ^ b


def _split(a: int, height: int) -> tuple[int, int]:
    """(a0, a1) with a = a0 + alpha_height * a1; halves are 2^(height-1) bits."""
    half = 1 << (height - 1)
    mask = (1 << half) - 1
    return a & mask, (a >> half) & mask


def _join(a0: int, a1: int, height: int) -> int:
    half = 1 << (height - 1)
    return a0 | (a1 << half)


@lru_cache(maxsize=1 << 20)
def multiply(a: int, b: int, height: int) -> int:
    """Tower multiply; cf. binary_tower.cuh:35-50 (generic_multiply)."""
    if height == 0:
        return a & b & 1
    a0, a1 = _split(a, height)
    b0, b1 = _split(b, height)
    z0 = multiply(a0, b0, height - 1)
    z2 = multiply(a1, b1, height - 1)
    z1 = multiply(a0 ^ a1, b0 ^ b1, height - 1) ^ z0 ^ z2
    z2a = multiply_alpha(z2, height - 1)
    return _join(z0 ^ z2, z1 ^ z2a, height)


@lru_cache(maxsize=1 << 16)
def square(a: int, height: int) -> int:
    """cf. binary_tower.cuh:52-61 (generic_square)."""
    if height == 0:
        return a & 1
    a0, a1 = _split(a, height)
    z0 = square(a0, height - 1)
    z2 = square(a1, height - 1)
    z2a = multiply_alpha(z2, height - 1)
    return _join(z0 ^ z2, z2a, height)


@lru_cache(maxsize=1 << 16)
def multiply_alpha(a: int, height: int) -> int:
    """Multiply by the tower generator alpha_height; cf. binary_tower.cuh:83-93."""
    if height == 0:
        return a & 1
    a0, a1 = _split(a, height)
    z1 = multiply_alpha(a1, height - 1)
    return _join(a1, a0 ^ z1, height)


@lru_cache(maxsize=1 << 16)
def inverse(a: int, height: int) -> int:
    """cf. binary_tower.cuh:63-81 (generic_inverse); inverse(0) returns 0."""
    if a == 0:
        return 0
    if height == 0:
        return a & 1
    if is_valid(a, height - 1):
        return inverse(a, height - 1)
    a0, a1 = _split(a, height)
    inter = a0 ^ multiply_alpha(a1, height - 1)
    delta = multiply(a0, inter, height - 1) ^ square(a1, height - 1)
    delta_inv = inverse(delta, height - 1)
    inv0 = multiply(delta_inv, inter, height - 1)
    inv1 = multiply(delta_inv, a1, height - 1)
    return _join(inv0, inv1, height)


def pow_field(a: int, e: int, height: int) -> int:
    """Square-and-multiply exponentiation in the tower field."""
    result = 1
    base = a
    while e:
        if e & 1:
            result = multiply(result, base, height)
        base = square(base, height)
        e >>= 1
    return result
