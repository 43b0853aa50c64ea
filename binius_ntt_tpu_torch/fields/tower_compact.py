"""Compact-layout tower multiply above 32 bits (torch): one element is
2^(h-5) uint32 limbs (little-endian), limbs on the last axis.

Port of binius_ntt_tpu/fields/tower_compact.py:

  * heights <= 5 delegate to the SWAR form (one element per word,
    ``tower_simd.mul_packed``);
  * heights 6 and 7 run the Fan-Paar Karatsuba recursion over the limb
    axis: split into halves, three sub-multiplies plus multiply-by-alpha,
    down to the height-5 SWAR multiply.

``mul_compact`` and ``multiply_alpha_compact`` are plain torch over limb
lists.  ``mul_compact_tiles`` is the kernel entry point on (N, L) int32
tensors: a CPU tensor runs ``mul_compact``, a CUDA tensor launches the
kernel of csrc/mul_compact.cu or raises.  Nothing falls back.  The kernel
works in the bit-sliced form: 32 elements a thread, each limb transposed
into 32 planes, the product as GF(2^32) leaves, and back
(tests/test_torch_mul_compact_sliced.py models it in torch).  The
reference's structure-of-arrays transpose (``a.T``) serves the TPU's lane
tiling and is not ported.
"""

from __future__ import annotations

import torch

from .. import _build
from .tower_simd import mul_packed

__all__ = ["mul_compact", "multiply_alpha_compact", "mul_compact_tiles"]


def _alpha_limbs(x: list, height: int) -> list:
    """multiply_alpha over a limb-major list of tensors."""
    if height == 0:
        return [x[0]]                    # alpha = 1 at height 0
    if height <= 5:
        # one limb: multiply by the constant alpha element
        return [mul_packed(x[0], 1 << (1 << (height - 1)), height)]
    half = len(x) // 2
    x0, x1 = x[:half], x[half:]
    t = _alpha_limbs(x1, height - 1)
    return list(x1) + [a ^ b for a, b in zip(x0, t)]


def _mul_limbs(a: list, b: list, height: int) -> list:
    """Karatsuba over limb lists (binary_tower.cuh:35-50 on limb vectors)."""
    if height <= 5:
        return [mul_packed(a[0], b[0], height)]
    h = height - 1
    half = len(a) // 2
    a0, a1 = a[:half], a[half:]
    b0, b1 = b[:half], b[half:]
    z0 = _mul_limbs(a0, b0, h)
    z2 = _mul_limbs(a1, b1, h)
    zm = _mul_limbs([x ^ y for x, y in zip(a0, a1)],
                    [x ^ y for x, y in zip(b0, b1)], h)
    z2a = _alpha_limbs(z2, h)
    lo = [x ^ y for x, y in zip(z0, z2)]
    hi = [m ^ l ^ x for m, l, x in zip(zm, lo, z2a)]
    return lo + hi


def mul_compact(a: torch.Tensor, b: torch.Tensor,
                height: int = 7) -> torch.Tensor:
    """Tower product of compact element tensors (int32 words).

    a, b: shape (..., 2^(height-5)) for height > 5, or any broadcastable
    shape for height <= 5 (one element per word)."""
    if height <= 5:
        return mul_packed(a, b, height)
    nl = 1 << (height - 5)
    la = [a[..., i] for i in range(nl)]
    lb = [b[..., i] for i in range(nl)]
    return torch.stack(_mul_limbs(la, lb, height), dim=-1)


def multiply_alpha_compact(x: torch.Tensor, height: int = 7) -> torch.Tensor:
    """x * alpha_height for compact element tensors."""
    if height <= 5:
        return _alpha_limbs([x], height)[0]
    nl = 1 << (height - 5)
    return torch.stack(
        _alpha_limbs([x[..., i] for i in range(nl)], height), dim=-1)


def _check_tiles(a: torch.Tensor, b: torch.Tensor, height: int) -> None:
    if height not in (5, 6, 7):
        raise ValueError(f"mul_compact_tiles: height {height} not in 5..7")
    nl = 1 << (height - 5)
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != nl:
            raise ValueError(f"mul_compact_tiles: {name} must be (N, {nl}) "
                             f"int32 at height {height}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if a.shape != b.shape:
        raise ValueError(f"mul_compact_tiles: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ")
    if a.device != b.device:
        raise ValueError(f"mul_compact_tiles: a is on {a.device}, b on "
                         f"{b.device}")


def mul_compact_tiles(a: torch.Tensor, b: torch.Tensor,
                      height: int = 7) -> torch.Tensor:
    """out[n] = a[n] * b[n] for (N, 2^(height-5)) int32 limb tensors,
    height 5, 6 or 7.  On the card, a and b must start on a whole element;
    the kernel moves 16-byte vectors, so an operand that does not start on
    16 bytes is copied first."""
    _check_tiles(a, b, height)
    if a.device.type == "cpu":
        return mul_compact(a, b, height)
    if a.device.type != "cuda":
        raise ValueError(f"mul_compact_tiles: unsupported device {a.device}")
    for name, t in (("a", a), ("b", b)):
        if not t.is_contiguous() or t.data_ptr() % (4 * t.shape[1]):
            raise ValueError(f"mul_compact_tiles: {name} must be contiguous "
                             f"and aligned to a whole element")
    a, b = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (a, b))
    out = torch.empty_like(a)
    lib = _build.library()
    with torch.cuda.device(a.device):
        rc = lib.bntt_mul_compact(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                  a.shape[0], height,
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "mul_compact")
    mul_compact_tiles.launches += 1
    return out


mul_compact_tiles.launches = 0
