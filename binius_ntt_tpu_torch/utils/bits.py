"""Word storage rules of the port.

Every word of the bit-sliced layout is a uint32 in the reference.  Torch has
no ``>>``, ``<<``, ``+`` or comparisons for ``uint32`` on the CPU, so the
port stores words as ``int32`` tensors with the same bits:

  * ``&``, ``|``, ``^`` and ``<<`` act on the bits exactly as on uint32;
  * ``>>`` on int32 is arithmetic — every logical right shift goes through
    :func:`lsr`;
  * a constant >= 2^31 is written as its int32 bit pattern, :func:`u32`;
  * numpy ``uint32`` arrays cross into torch as ``int32`` views and back
    (:func:`to_torch`, :func:`to_numpy`), never by value conversion.

CUDA sources use ``uint32_t`` throughout; the tensors they receive are these
int32 tensors, reinterpreted.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["lsr", "u32", "to_torch", "to_numpy"]


def u32(c: int) -> int:
    """The int32 value whose bits are the uint32 constant ``c``."""
    c &= 0xFFFFFFFF
    return c - (1 << 32) if c >= 1 << 31 else c


def lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical shift right of int32 words by a static ``s`` in [0, 31]."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (32 - s)) - 1)


def to_torch(a, device=None) -> torch.Tensor:
    """numpy uint32 (or int32) array -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:    # torch tensors over numpy memory are writable
        a = a.copy()
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype != np.int32:
        raise TypeError(f"expected uint32 or int32 words, got {a.dtype}")
    return torch.from_numpy(a).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> numpy uint32 array with the same bits (host copy)."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected int32 words, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint32)
