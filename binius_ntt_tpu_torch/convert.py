"""Carry the JAX package's state across to the port.

The transform has no weights: its state is the twiddle rows and the
per-group parity-mask tables.  ``tables_from_jax`` turns the tuple that
``binius_ntt_tpu.ntt.pallas_fused.build_tables`` returns into the port's
``cuda_fused.build_tables`` form, so a test can feed both packages the same
tables.  This module imports no JAX: each array goes through
``np.asarray``.
"""

from __future__ import annotations

import numpy as np

from .utils.bits import to_torch

__all__ = ["tables_from_jax"]


def tables_from_jax(jax_tables, device=None):
    """(t0, k, include_low, mtile, minst, lanes, zero_flags) per group, JAX
    arrays -> the same tuple with int32 tensors on ``device``."""
    out = []
    for (t0, k, include_low, mtile, minst, lanes, zero_flags) in jax_tables:
        out.append((int(t0), int(k), bool(include_low),
                    to_torch(np.asarray(mtile), device),
                    to_torch(np.asarray(minst), device),
                    None if lanes is None
                    else to_torch(np.asarray(lanes), device),
                    tuple(bool(z) for z in zero_flags)))
    return tuple(out)
