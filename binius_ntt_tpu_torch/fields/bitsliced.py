"""Bit-sliced binary-tower multiply as a stacked Karatsuba pipeline (torch).

Port of binius_ntt_tpu/fields/bitsliced.py (``multiply``,
``multiply_alpha``, ``square``, ``mul_subfield_chunks``).  It is the plain
version behind the port's CUDA multiply kernels:
``cuda_kernels.mul_tiles_plain``, ``cuda_fused.stage_group_plain`` and the
sumcheck's ``cuda_round.round_plain``/``fold_plain`` are built on it, and
the CPU tests hold it word for word against the JAX functions.

The Karatsuba recursion is evaluated level-synchronously: at level ``d``
all ``3^d`` pending half-width products are stacked along one axis, so the
whole multiply is O(height^2) tensor ops performing the same 3^h leaf ANDs
as the straight-line circuit.  It is bitwise only (AND/XOR, no shifts), so
the int32 storage of utils/bits.py needs no care here.

Layout: a tensor of shape ``(..., W)``, ``W = 2^height``; the last axis is
the bit-plane index and each bit-lane of a word is one of 32 field elements.
"""

from __future__ import annotations

import torch

__all__ = ["multiply", "multiply_alpha", "square", "mul_subfield_chunks"]


def multiply_alpha(x: torch.Tensor, height: int) -> torch.Tensor:
    """Bit-sliced multiply by the tower generator alpha_height:
    [a0, a1] -> [a1, a0 ^ alpha_{h-1}(a1)]."""
    if height == 0:
        return x
    half = x.shape[-1] // 2
    x0, x1 = x[..., :half], x[..., half:]
    return torch.cat([x1, x0 ^ multiply_alpha(x1, height - 1)], dim=-1)


def multiply(a: torch.Tensor, b: torch.Tensor, height: int) -> torch.Tensor:
    """Bit-sliced tower multiply of (..., 2^height) bit-plane tensors
    (broadcasting over the leading axes)."""
    w = 1 << height
    if a.shape[-1] != w or b.shape[-1] != w:
        raise ValueError(f"multiply: shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)} need last axis {w}")
    a, b = torch.broadcast_tensors(a, b)

    # forward sweep: [all z0 operands | all z2 operands | all middles]
    A = a.unsqueeze(-2)
    B = b.unsqueeze(-2)
    for _ in range(height):
        half = A.shape[-1] // 2
        a0, a1 = A[..., :half], A[..., half:]
        b0, b1 = B[..., :half], B[..., half:]
        A = torch.cat([a0, a1, a0 ^ a1], dim=-2)
        B = torch.cat([b0, b1, b0 ^ b1], dim=-2)

    z = A & B  # (..., 3^height, 1): every leaf AND in one op

    # unwind: lo = z0 ^ z2 ; hi = zm ^ lo ^ alpha_{d-1}(z2)
    for d in range(1, height + 1):
        k = z.shape[-2] // 3
        z0 = z[..., :k, :]
        z2 = z[..., k:2 * k, :]
        zm = z[..., 2 * k:, :]
        lo = z0 ^ z2
        hi = zm ^ lo ^ multiply_alpha(z2, d - 1)
        z = torch.cat([lo, hi], dim=-1)

    return z[..., 0, :]


def square(a: torch.Tensor, height: int) -> torch.Tensor:
    """Bit-sliced squaring: [a0, a1] -> [s0 ^ s2, alpha(s2)] with s = a^2.

    Squaring is GF(2)-linear, so this is XOR-only (no ANDs)."""
    if height == 0:
        return a
    half = a.shape[-1] // 2
    s0 = square(a[..., :half], height - 1)
    s2 = square(a[..., half:], height - 1)
    return torch.cat([s0 ^ s2, multiply_alpha(s2, height - 1)], dim=-1)


def mul_subfield_chunks(x: torch.Tensor, coeff_planes: torch.Tensor,
                        full_height: int, sub_height: int) -> torch.Tensor:
    """Multiply a bit-sliced batch by a subfield scalar, chunk-wise.

    GF(2^(2^full)) is a vector space over GF(2^(2^sub)), so multiplying by
    a subfield element acts on each 2^sub-plane chunk on its own.
    ``x``: (..., 2^full) planes; ``coeff_planes``: (..., 2^sub) planes of
    the subfield-valued coefficient batch.
    """
    wf, ws = 1 << full_height, 1 << sub_height
    lead = x.shape[:-1]
    chunks = x.reshape(lead + (wf // ws, ws))
    prod = multiply(chunks, coeff_planes.unsqueeze(-2), sub_height)
    return prod.reshape(lead + (wf,))
