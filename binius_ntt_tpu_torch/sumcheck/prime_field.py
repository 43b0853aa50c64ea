"""Sumcheck prover over the QM31 prime extension field (torch).

Port of binius_ntt_tpu/sumcheck/prime_field.py::PrimeFieldSumcheck, with the
reference prime-field prover's protocol
(src/ulvt/prime_field_sumcheck/sumcheck.cuh:8-97, core/kernels.cu:5-78):

  * two multilinear columns, degree-2 composition (their product);
  * ``round_messages()`` returns the round polynomial at X = 0, 1, 2:
    p(0) = sum of the lower products, p(1) = of the upper ones, p(2) with
    every column at (upper - lower) + upper (kernels.cu:44-63);
  * ``fold(challenge)``: lower' = lower + (upper - lower) * challenge
    (kernels.cu:5-25).

The state is a (2, 2^num_vars, 4) int32 tensor of QM31 values (the
reference's AoS layout, components canonical mod 2^31 - 1) on ``device``.
Every round is one launch of ``cuda_prime_round.round_kernel`` and one of
``cuda_prime_round.fold_kernel``; on a CPU tensor those run their plain
versions.  The fold works in place at the original stride, so the buffer
keeps its size for the whole protocol and the live rows are its first
``2^(num_vars - round)``.

The reference's ``use_pallas`` switch and its planar-to-AoS hand-off at
32,768 rows (prime_field.py:127-142, 185-189) follow the TPU's tiling; both
kernels here take every round down to 2 rows, so the state never leaves
its device and each round reads back only its (3, 4) words.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.m31 import P, qm31_add_host, qm31_mul_host, qm31_sub_host
from ..utils.bits import to_numpy, to_torch
from ..utils.capabilities import default_device
from . import cuda_prime_round

__all__ = ["PrimeFieldSumcheck", "interpolate_at_host", "check_transcript"]

# 2^30 == 1/2 mod P (prime_field_sumcheck/utils/interpolate.hpp:3)
ONE_HALF = 0x40000000


def _as_state(evals, device) -> torch.Tensor:
    """(2, B, 4) numpy uint32 or int32 tensor -> a NEW int32 tensor (the
    folds work in place, so never on the caller's memory).  For device=None
    a tensor keeps its own device and numpy words go to the default device
    (utils/capabilities.default_device)."""
    if isinstance(evals, torch.Tensor):
        if evals.dtype != torch.int32:
            raise ValueError(f"evals must be int32 words, got {evals.dtype}")
        if device is None:
            device = evals.device
    else:
        device = default_device(device)
        evals = to_torch(np.asarray(evals, dtype=np.uint32))
    if evals.dim() != 3 or evals.shape[0] != 2 or evals.shape[2] != 4:
        raise ValueError(f"evals must be (2, 2^n, 4) QM31 values, got "
                         f"{tuple(evals.shape)}")
    rows = evals.shape[1]
    if rows < 1 or rows & (rows - 1):
        raise ValueError(f"the row count {rows} is not a power of two")
    return evals.to(device, copy=True).contiguous()


class PrimeFieldSumcheck:
    """QM31 sumcheck prover for the degree-2 two-column composition.

    Parameters
    ----------
    evals : (2, 2^n, 4) QM31 columns, components canonical (numpy uint32 or
        an int32 tensor; copied).
    device : where the state lives (default: the device of a tensor
        ``evals``; for numpy ``cuda:0``, and off the card the caller passes
        ``device="cpu"``).
    """

    def __init__(self, evals, device=None):
        self._evals = _as_state(evals, device)
        self._num_rows = self._evals.shape[1]
        self.round = 0

    @property
    def device(self) -> torch.device:
        return self._evals.device

    # ---- checkpoint / resume -------------------------------------------
    # (round, live folded rows) is the complete protocol state, in the
    # reference's AoS layout as numpy uint32, so a state saved by either
    # package loads in the other.

    def state_dict(self) -> dict:
        return {"round": self.round,
                "evals": to_numpy(self._evals[:, :self._num_rows])}

    @classmethod
    def from_state_dict(cls, d: dict, device=None) -> "PrimeFieldSumcheck":
        self = cls(d["evals"], device=device)
        self.round = int(d["round"])
        return self

    def round_messages(self) -> np.ndarray:
        """Round polynomial at X = 0, 1, 2 as a (3, 4) uint32 array."""
        if self._num_rows < 2:
            raise ValueError("the protocol has ended: one row is left "
                             "(state_dict()['evals'] holds it)")
        return to_numpy(cuda_prime_round.round_kernel(self._evals,
                                                      self._num_rows))

    def fold(self, challenge) -> None:
        """Fold both columns at the challenge: 4 canonical components
        (uint32 or int32 words)."""
        if self._num_rows < 2:
            raise ValueError("the protocol has ended: nothing to fold")
        cuda_prime_round.fold_kernel(self._evals, challenge, self._num_rows)
        self._num_rows //= 2
        self.round += 1


def interpolate_at_host(challenge, points) -> np.ndarray:
    """Quadratic interpolation at ``challenge`` given p(0), p(1), p(2).

    cf. interpolate_at (prime_field_sumcheck/utils/interpolate.hpp:5-8):
    p(x) = x(x-1)e2/2 - x(x-2)e1 + (x-1)(x-2)e0/2.
    """
    x = np.asarray(challenge, dtype=np.uint32)
    e0, e1, e2 = (np.asarray(p, dtype=np.uint32) for p in points)
    one = np.array([1, 0, 0, 0], np.uint32)
    two = np.array([2, 0, 0, 0], np.uint32)
    half = np.array([ONE_HALF, 0, 0, 0], np.uint32)
    xm1 = qm31_sub_host(x, one)
    xm2 = qm31_sub_host(x, two)
    t2 = qm31_mul_host(qm31_mul_host(qm31_mul_host(x, xm1), e2), half)
    t1 = qm31_mul_host(qm31_mul_host(x, xm2), e1)
    t0 = qm31_mul_host(qm31_mul_host(qm31_mul_host(xm1, xm2), e0), half)
    return qm31_add_host(qm31_sub_host(t2, t1), t0)


def check_transcript(messages, challenges, final_evals,
                     claim=None) -> np.ndarray:
    """The verifier's checks on a whole QM31 protocol transcript.

    messages: the (3, 4) round polynomial of every round; challenges: one
    (4,) challenge per round; final_evals: the (2, 4) column values left
    after the last fold.  In every round p(0) + p(1) must equal the claim
    (the given ``claim``, or from round 1 on the previous round's points
    interpolated at its challenge), and the product of the two final
    values must equal the last claim (cf. the reference protocol test,
    prime_field_sumcheck/test_sumcheck.cu:9-99).  Returns the claim of
    round 0 (the sum over the hypercube); raises ValueError at the first
    check that fails.
    """
    if len(messages) != len(challenges):
        raise ValueError(f"{len(messages)} messages for {len(challenges)} "
                         f"challenges")
    first = None
    for rnd, (pts, ch) in enumerate(zip(messages, challenges)):
        pts = np.asarray(pts, dtype=np.uint32)
        if pts.shape != (3, 4) or (pts >= P).any():
            raise ValueError(f"round {rnd}: malformed points")
        p01 = qm31_add_host(pts[0], pts[1])
        if claim is not None and not np.array_equal(p01, claim):
            raise ValueError(f"round {rnd}: p(0) + p(1) != the claim")
        if first is None:
            first = p01
        claim = interpolate_at_host(ch, pts)
    final = np.asarray(final_evals, dtype=np.uint32).reshape(2, 4)
    if not np.array_equal(qm31_mul_host(final[0], final[1]), claim):
        raise ValueError("the product of the final values != the last "
                         "claim")
    return first
