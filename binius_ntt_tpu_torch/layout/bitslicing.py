"""Bit-slicing layout transforms on int32 tensors.

Port of binius_ntt_tpu/layout/bitslicing.py (``transpose32``,
``bitslice_transpose``, ``bitslice_untranspose``,
``repeat_value_bitsliced``).  These are plain tensor
ops in the reference too (jnp, not Pallas), so they stay torch ops here and
run on whatever device the tensor lies on.

Layout contract (little-endian, identical to the reference):
  * an *unbitsliced* batch is ``W`` words holding 32 field elements of
    ``W`` bits each, element-major: element ``j`` occupies words
    ``[j*IPV, (j+1)*IPV)``, ``IPV = W // 32``, word 0 least significant;
  * a *bitsliced* batch is the 32 x W bit-matrix transpose of that: bit
    ``j`` of sliced word ``i`` is bit ``i`` of element ``j``.

Words are int32 with uint32 bits (utils/bits.py); right shifts are logical.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.bits import lsr, to_torch

__all__ = ["transpose32", "bitslice_transpose", "bitslice_untranspose",
           "repeat_value_bitsliced"]


def transpose32(a: torch.Tensor) -> torch.Tensor:
    """Transpose the 32x32 bit matrix held in the last axis (32 words).

    Vectorised Hacker's Delight transpose; accepts shape (..., 32).
    """
    if a.shape[-1] != 32:
        raise ValueError(f"transpose32 needs a last axis of 32, got "
                         f"{tuple(a.shape)}")
    lead = a.shape[:-1]
    m = 0x0000FFFF
    j = 16
    while j != 0:
        # rows with bit j of the index clear pair with rows where it is set
        a = a.reshape(lead + (32 // (2 * j), 2, j))
        lo = a[..., 0, :]
        hi = a[..., 1, :]
        t = (lsr(lo, j) ^ hi) & m
        lo = lo ^ (t << j)
        hi = hi ^ t
        a = torch.stack([lo, hi], dim=-2).reshape(lead + (32,))
        j >>= 1
        m = (m ^ (m << j)) & 0xFFFFFFFF if j else m
    return a


def bitslice_transpose(arr: torch.Tensor) -> torch.Tensor:
    """Unbitsliced (..., W) -> bitsliced (..., W)."""
    w = arr.shape[-1]
    ipv = w // 32
    lead = arr.shape[:-1]
    # new[32*(i % ipv) + i // ipv] = old[i]
    a = arr.reshape(lead + (32, ipv)).transpose(-1, -2)
    return transpose32(a).reshape(lead + (w,))


def bitslice_untranspose(arr: torch.Tensor) -> torch.Tensor:
    """Bitsliced (..., W) -> unbitsliced (..., W)."""
    w = arr.shape[-1]
    ipv = w // 32
    lead = arr.shape[:-1]
    a = transpose32(arr.reshape(lead + (ipv, 32)))
    # new[ipv * (i % 32) + i // 32] = tmp[i]
    return a.transpose(-1, -2).reshape(lead + (w,))


def repeat_value_bitsliced(value, bits_width: int,
                           device=None) -> torch.Tensor:
    """Broadcast one value (``bits_width // 32`` uint32 words) into a
    bit-sliced batch: a (bits_width,) int32 tensor on ``device`` whose
    plane i is all ones where bit i of the value is set."""
    value = np.asarray(value, dtype=np.uint32)
    ipv = bits_width // 32
    if value.shape != (ipv,):
        raise ValueError(f"repeat_value_bitsliced: expected {ipv} words, "
                         f"got shape {value.shape}")
    return bitslice_transpose(to_torch(np.tile(value, 32), device))
