"""Scalar (Python-int) additive-NTT reference — the test oracle.

Port of binius_ntt_tpu/ntt/reference.py: the algorithm written out
directly (stages descending, butterfly u' = u + w*v, v' = u' + v, twiddle
the XOR-subset-sum of the normalised subspace evaluations over the
indicator bits) at any tower height.
"""

from __future__ import annotations

from ..fields import tower_scalar as ts
from .additive import precompute_subspace_evals

__all__ = ["additive_ntt_scalar"]


def additive_ntt_scalar(values, log_h: int, log_rate: int, height: int):
    """values: list of 2^log_h Python ints -> list of 2^(log_h+log_rate)."""
    n = 1 << log_h
    assert len(values) == n
    rows = precompute_subspace_evals(log_h, log_rate, height)
    out = []
    for coset in range(1 << log_rate):
        data = list(values)
        for s in range(log_h - 1, -1, -1):
            for block in range(n >> (s + 1)):
                indicator = (coset << (log_h - 1 - s)) | block
                w = 0
                for k in range(log_h + log_rate - 1 - s):
                    if (indicator >> k) & 1:
                        w ^= rows[s][k]
                base = block << (s + 1)
                for b in range(1 << s):
                    u = data[base + b]
                    v = data[base + b + (1 << s)]
                    u2 = u ^ ts.multiply(w, v, height)
                    data[base + b] = u2
                    data[base + b + (1 << s)] = u2 ^ v
        out.extend(data)
    return out
