"""Host-side twiddle rows of the additive (Gao–Mateer / LCH) NTT.

Port of binius_ntt_tpu/ntt/additive.py (``precompute_subspace_evals``,
``stage_twiddles``): Python-int tower arithmetic through the scalar oracle,
run once per (log_h, log_rate) when a transform is built.  At log_h = 24
this takes seconds of host time, so callers keep it out of timed windows.
"""

from __future__ import annotations

import numpy as np

from ..fields import tower_scalar as ts

__all__ = ["precompute_subspace_evals", "stage_twiddles"]


def precompute_subspace_evals(log_h: int, log_rate: int, height: int = 5):
    """Normalised subspace evaluation table, rows = stages.

    Row ``i`` has ``log_h + log_rate - 1 - i`` valid entries.
    Returns a list of Python-int lists.
    """
    width = log_h + log_rate - 1
    rows: list[list[int]] = [[0] * width for _ in range(log_h)]

    # row 0: the field elements 2^i for i = 1..log_h+log_rate-1
    for i in range(1, log_rate + log_h):
        rows[0][i - 1] = 1 << i
    norm_consts = [1]

    def subspace_map(x, c):
        # q(x) = x^2 + c*x
        return ts.square(x, height) ^ ts.multiply(c, x, height)

    for i in range(1, log_h):
        norm_prev = norm_consts[-1]
        prev = rows[i - 1]
        norm_i = subspace_map(prev[0], norm_prev)
        for j in range(1, log_h + log_rate - i):
            rows[i][j - 1] = subspace_map(prev[j], norm_prev)
        norm_consts.append(norm_i)

    for i in range(log_h):
        inv_norm = ts.inverse(norm_consts[i], height)
        for j in range(log_h + log_rate - i - 1):
            rows[i][j] = ts.multiply(inv_norm, rows[i][j], height)

    return rows


def stage_twiddles(constants_row, num_bits: int) -> np.ndarray:
    """All twiddles for one stage by the XOR doubling construction.

    twiddle[ind] = XOR over set bits k of ind of constants_row[k]; output
    shape (2^num_bits,), index = ``coset << (log_h-1-stage) | block``.
    Values must fit 32 bits (the GF(2^32) transform's rows).
    """
    table = np.zeros(1, dtype=np.uint32)
    for k in range(num_bits):
        table = np.concatenate([table, table ^ np.uint32(constants_row[k])])
    return table
