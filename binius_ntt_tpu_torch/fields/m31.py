"""Mersenne-31 tower: M31, CM31 = M31[i], QM31 = CM31[j] (torch + host).

Port of binius_ntt_tpu/fields/m31.py, matching the reference's fields:

  * M31 = GF(2^31 - 1) (src/ulvt/finite_fields/m31.cuh:6-77);
  * CM31 with i^2 = -1 (cm31.cuh:48-53);
  * QM31 with j^2 = R = 2 + i (qm31.cuh:6, :38-43).

A QM31 tensor is (..., 4) int32 words, components (a, b, c, d) = (a + bi) +
(c + di)j, each canonical in [0, P).  The torch ops widen to int64 and
reduce with ``%``: the product of two components is below 2^62, so nothing
overflows.  ``qm31_mul`` is the reference's schoolbook form (16 M31
multiplies); the kernels (csrc/m31.cuh) use Karatsuba, so the two are
independent formulations.  The JAX package's 16-bit-limb ``_mul64`` stands
in for a 64-bit multiply the TPU lacks and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

P = (1 << 31) - 1

__all__ = ["P", "m31_add", "m31_sub", "m31_mul", "qm31_add", "qm31_sub",
           "qm31_mul", "qm31_scalar", "qm31_add_host", "qm31_sub_host",
           "qm31_mul_host"]


def _wide(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.int64) & 0xFFFFFFFF


def m31_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod P, canonical inputs; m31.cuh:23-27."""
    return ((_wide(a) + _wide(b)) % P).to(torch.int32)


def m31_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod P, canonical inputs; m31.cuh:36-40."""
    return ((_wide(a) - _wide(b)) % P).to(torch.int32)


def m31_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod P, canonical inputs; m31.cuh:49-51."""
    return (_wide(a) * _wide(b) % P).to(torch.int32)


def qm31_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return m31_add(x, y)


def qm31_sub(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return m31_sub(x, y)


def qm31_mul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """QM31 product of (..., 4) words; qm31.cuh:38-43, schoolbook.

    (u + vj)(s + tj) = (us + R vt) + (ut + vs) j,  R = 2 + i, each CM31
    product (ax + ay i)(bx + by i) = (ax bx - ay by) + (ax by + ay bx) i.
    """
    a = [_wide(x[..., k]) for k in range(4)]
    b = [_wide(y[..., k]) for k in range(4)]

    def cm(ax, ay, bx, by):
        return (ax * bx - ay * by) % P, (ax * by + ay * bx) % P

    us = cm(a[0], a[1], b[0], b[1])
    vt = cm(a[2], a[3], b[2], b[3])
    ut = cm(a[0], a[1], b[2], b[3])
    vs = cm(a[2], a[3], b[0], b[1])
    # R * vt = (2 + i)(re + im i) = (2 re - im) + (re + 2 im) i
    return torch.stack([
        (us[0] + 2 * vt[0] - vt[1]) % P,
        (us[1] + vt[0] + 2 * vt[1]) % P,
        (ut[0] + vs[0]) % P,
        (ut[1] + vs[1]) % P,
    ], dim=-1).to(torch.int32)


def qm31_scalar(v: int) -> np.ndarray:
    """QM31(uint32 v) — the scalar embedding (qm31.cuh:20)."""
    return np.array([v % P, 0, 0, 0], dtype=np.uint32)


# ---- host-side scalar helpers (protocol checks, test oracles) ----

def qm31_mul_host(x, y) -> np.ndarray:
    a = [int(v) for v in np.asarray(x).reshape(4)]
    b = [int(v) for v in np.asarray(y).reshape(4)]
    us = (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])
    vt = (a[2] * b[2] - a[3] * b[3], a[2] * b[3] + a[3] * b[2])
    ut = (a[0] * b[2] - a[1] * b[3], a[0] * b[3] + a[1] * b[2])
    vs = (a[2] * b[0] - a[3] * b[1], a[2] * b[1] + a[3] * b[0])
    return np.array([(us[0] + 2 * vt[0] - vt[1]) % P,
                     (us[1] + vt[0] + 2 * vt[1]) % P,
                     (ut[0] + vs[0]) % P, (ut[1] + vs[1]) % P],
                    dtype=np.uint32)


def qm31_add_host(x, y) -> np.ndarray:
    return ((np.asarray(x, np.uint64) + np.asarray(y, np.uint64))
            % np.uint64(P)).astype(np.uint32)


def qm31_sub_host(x, y) -> np.ndarray:
    return ((np.asarray(x, np.uint64) + np.uint64(P)
             - np.asarray(y, np.uint64) % np.uint64(P))
            % np.uint64(P)).astype(np.uint32)
