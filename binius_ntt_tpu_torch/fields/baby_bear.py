"""Baby Bear prime field F_p, p = 15*2^27 + 1, Montgomery form (torch).

Port of binius_ntt_tpu/fields/baby_bear.py: the reference's vendored RISC
Zero ``Fp`` (src/ulvt/finite_fields/risc0_baby_bear.h:43-190) with
M = 0x88000001 = P^-1 mod 2^32, R = 2^32, R2 = R^2 mod P.

Words are int32 tensors with uint32 bits (utils/bits.py); every function
here widens them to int64, works there, and returns int32 words.  Canonical
values are below P < 2^31, so they read the same either way.

``mont_mul`` computes a*b*R^-1 mod P as ``(a*b mod P) * R^-1 mod P`` in
int64: the same canonical word as the REDC the kernel runs
(csrc/stage_group_r2.cu), by an independent formulation.  The JAX
package's 16-bit-limb ``_mulhi32`` and ``_mulhi_P`` stand in for a 32x32->64
multiply the TPU's vector unit lacks; the card has one, so they are not
ported.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["P", "M", "R2", "R_INV", "add", "sub", "mont_mul", "encode",
           "decode", "pow_host", "inv_host", "encode_host"]

P = 15 * (1 << 27) + 1          # 0x78000001
M = 0x88000001                  # P^-1 mod 2^32 (REDC's constant)
R2 = 1172168163                 # (2^32)^2 mod P
R_INV = pow(1 << 32, P - 2, P)  # R^-1 mod P

_U32 = 0xFFFFFFFF


def _wide(a: torch.Tensor) -> torch.Tensor:
    """int32 words -> their uint32 values as int64."""
    return a.to(torch.int64) & _U32


def _words(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 words with the same bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod P for canonical words; risc0_baby_bear.h:160-163."""
    return _words((_wide(a) + _wide(b)) % P)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod P for canonical words; risc0_baby_bear.h:166-169."""
    return _words((_wide(a) - _wide(b)) % P)


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * R^-1 mod P, canonical; takes one operand below 2^32 and the
    other below P (a*b < 2^63), as REDC does."""
    return _words(_wide(a) * _wide(b) % P * R_INV % P)


def encode(a: torch.Tensor) -> torch.Tensor:
    """uint32 words -> Montgomery form a*R mod P; a >= P wraps, as the
    reference's constructor does (raw mt19937 words are welcome)."""
    return _words(_wide(a) % P * ((1 << 32) % P) % P)


def decode(a: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> canonical words: a*R^-1 mod P."""
    return _words(_wide(a) * R_INV % P)


# ---- host-side scalar helpers (twiddle precompute, test oracles) ----

def pow_host(x: int, n: int) -> int:
    return pow(x % P, n, P)


def inv_host(x: int) -> int:
    """Fermat inverse, x^(P-2); risc0_baby_bear.h:149."""
    return pow(x % P, P - 2, P)


def encode_host(v: np.ndarray) -> np.ndarray:
    """Vectorised host-side Montgomery encode of canonical uint32 values."""
    v = np.asarray(v).astype(np.uint64)
    return ((v << np.uint64(32)) % np.uint64(P)).astype(np.uint32)
