"""Sumcheck verifier — the host oracle for the prover.

Port of binius_ntt_tpu/sumcheck/verifier.py, over Python ints through the
port's scalar tower (fields/tower_scalar.py).  The tests and chip_smoke.py
check the protocol with it.  The interpolation points 0..k live in the
height-2 subfield, so the Lagrange denominators are inverted there
(inverse_at_interpolation_point, test/utils/tower_7_mul.cu:22-24).
"""

from __future__ import annotations

from ..fields import tower_scalar as ts

HEIGHT = 7

__all__ = [
    "evaluate_univariate_given_points",
    "evaluate_multilinear_given_point",
    "evaluate_multilinear_composition",
    "words_to_int",
    "int_to_words",
    "check_transcript",
]


def words_to_int(words) -> int:
    """Little-endian 32-bit words -> int.  Each word is read as its uint32
    bits, so int32 words (the port's storage) give the same value."""
    out = 0
    for i, w in enumerate(words):
        out |= (int(w) & 0xFFFFFFFF) << (32 * i)
    return out


def int_to_words(value: int, count: int = 4):
    return [(value >> (32 * i)) & 0xFFFFFFFF for i in range(count)]


def evaluate_univariate_given_points(challenge: int, points,
                                     num_points: int) -> int:
    """Lagrange interpolation at `challenge` over x = 0..num_points-1.

    cf. verifier.cu:9-31.
    """
    evaluation = 0
    for cur in range(num_points):
        prod = points[cur]
        for other in range(num_points):
            if other == cur:
                continue
            prod = ts.multiply(prod, challenge ^ other, HEIGHT)
            prod = ts.multiply(prod, ts.inverse(cur ^ other, 2), HEIGHT)
        evaluation ^= prod
    return evaluation


def evaluate_multilinear_given_point(basis_evals, challenges) -> int:
    """Brute-force multilinear evaluation; cf. verifier_kernel.cu:5-37.

    basis_evals: list of 2^n 128-bit ints; challenges: list of n ints,
    challenge[0] binds the *most significant* index bit (the kernel walks
    bits LSB-first against challenges in reverse order).
    """
    n = len(challenges)
    evaluation = 0
    for idx, val in enumerate(basis_evals):
        prod = val
        shifted = idx
        for var in range(n):
            c = challenges[n - 1 - var]
            prod = ts.multiply(prod, c if (shifted & 1) else c ^ 1, HEIGHT)
            shifted >>= 1
        evaluation ^= prod
    return evaluation


def evaluate_multilinear_composition(columns, challenges) -> int:
    """Product over columns of their multilinear evaluations;
    verifier.cu:88-107."""
    product = 1
    for col in columns:
        product = ts.multiply(
            product, evaluate_multilinear_given_point(col, challenges), HEIGHT
        )
    return product


def check_transcript(messages, challenges, num_points: int) -> int:
    """The verifier's checks on a whole protocol transcript.

    messages: one (sum, points) per round, then the (sum, points) the
    prover gives after the last fold; challenges: one 4-word challenge per
    round.  Every round's sum must equal p(0) ^ p(1) and, after the first
    round, the claim carried from the previous one: that round's points
    interpolated at its challenge (cf. the reference protocol test,
    sumcheck/test/test.cu:13-101).  The final sum must equal the last
    claim.  Returns the final claim, for a check against a direct
    evaluation of the composition; raises ValueError at the first check
    that fails.
    """
    if len(messages) != len(challenges) + 1:
        raise ValueError(f"{len(messages)} messages for {len(challenges)} "
                         f"challenges")
    claim = None
    for rnd, ((sm, pts), ch) in enumerate(zip(messages, challenges)):
        sm_i = words_to_int(sm)
        pts_i = [words_to_int(pts[p]) for p in range(num_points)]
        if claim is not None and sm_i != claim:
            raise ValueError(f"round {rnd}: sum != the previous claim")
        if sm_i != pts_i[0] ^ pts_i[1]:
            raise ValueError(f"round {rnd}: sum != p(0) + p(1)")
        claim = evaluate_univariate_given_points(words_to_int(ch), pts_i,
                                                 num_points)
    if words_to_int(messages[-1][0]) != claim:
        raise ValueError("the final sum != the last claim")
    return claim
