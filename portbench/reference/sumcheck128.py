"""Plain GF(2^128) sumcheck prover and its Fiat–Shamir challenges.

The state is C columns of 2^num_vars evaluations.  Round r, with n live
evaluations a column, pairs evaluation j < n/2 (lower) with j + n/2
(upper), and its message is

  * sum: the XOR over all n of the product of the C columns;
  * points p = 0 .. C: the XOR over the pairs of the product of the
    columns folded at p, lower + p (lower + upper), p a small field
    element (point 0 the lower half, point 1 the upper half).

Then every column folds at the round's challenge ch: lower' = lower +
ch (lower + upper), n halves.  After num_vars rounds one evaluation a
column is left; a last message (its product, points all 0) closes the
protocol.

The challenge of a round is the first 16 bytes of a BLAKE2b over the run's
seed, the protocol's index and every message so far (:class:`Challenger`).

Columns of 64 evaluations or more are bit planes (reference/tower.py),
processed ``BLOCK`` batches at a time; the last rounds run on integers.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from . import tower

BLOCK = 1 << 18                 # batches of a column a step


class Challenger:
    """Fiat–Shamir challenges of one protocol: BLAKE2b-128 over the
    seed, the protocol's index and the messages observed so far."""

    def __init__(self, seed: int, index: int):
        self._h = hashlib.blake2b(digest_size=16, person=b"portbench-sc")
        self._h.update((seed % (1 << 64)).to_bytes(8, "little"))
        self._h.update((index % (1 << 64)).to_bytes(8, "little"))

    def observe(self, total, points) -> None:
        self._h.update(np.asarray(total, dtype="<u4").tobytes())
        self._h.update(np.asarray(points, dtype="<u4").tobytes())

    def challenge(self) -> np.ndarray:
        """(4,) uint32 words of a little-endian 128-bit value."""
        return np.frombuffer(self._h.copy().digest(), dtype="<u4").copy()


def words_of(v: int) -> list[int]:
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(tower.WORDS)]


def int_of(words) -> int:
    return sum(int(w) << (32 * i) for i, w in enumerate(words))


def _xor_columns(x: torch.Tensor) -> torch.Tensor:
    """XOR over the columns of (128, N) -> (128,)."""
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        y = x[:, :h] ^ x[:, h:2 * h]
        if x.shape[1] % 2:
            y[:, 0] ^= x[:, 2 * h]
        x = y
    return x[:, 0]


def _product(cols, mul):
    prod = cols[0]
    for c in cols[1:]:
        prod = mul(prod, c)
    return prod


def _plane_message(S, rows: int, points, mul) -> list[int]:
    """[sum, p0 .. pC] of a round over the first ``rows`` batches of the
    (C, 128, B) planes."""
    half = rows // 2
    acc = torch.zeros((3 + len(points), tower.BITS), dtype=torch.int32,
                      device=S.device)
    for i in range(0, half, BLOCK):
        j = min(i + BLOCK, half)
        lo = [S[c, :, i:j] for c in range(S.shape[0])]
        up = [S[c, :, half + i:half + j] for c in range(S.shape[0])]
        p_lo, p_up = _product(lo, mul), _product(up, mul)
        acc[0] ^= _xor_columns(p_lo ^ p_up)
        acc[1] ^= _xor_columns(p_lo)
        acc[2] ^= _xor_columns(p_up)
        del p_lo, p_up
        for k, pk in enumerate(points):
            f = [a ^ mul(a ^ b, pk) for a, b in zip(lo, up)]
            acc[3 + k] ^= _xor_columns(_product(f, mul))
    return [tower.parity_value(a) for a in acc]


def _plane_fold(S, rows: int, ch, mul) -> None:
    half = rows // 2
    for c in range(S.shape[0]):
        for i in range(0, half, BLOCK):
            j = min(i + BLOCK, half)
            lo, up = S[c, :, i:j], S[c, :, half + i:half + j]
            lo ^= mul(lo ^ up, ch)


def _int_message(E, num_points: int, mul_int) -> list[int]:
    n = len(E[0])
    half = n // 2

    def comp(vals):
        p = vals[0]
        for v in vals[1:]:
            p = mul_int(p, v)
        return p

    total = 0
    for j in range(n):
        total ^= comp([col[j] for col in E])
    msg = [total]
    for p in range(num_points):
        acc = 0
        for j in range(half):
            acc ^= comp([col[j] ^ mul_int(p, col[j] ^ col[half + j])
                         for col in E])
        msg.append(acc)
    return msg


def prove(columns: torch.Tensor, num_vars: int, seed: int, index: int,
          mul=tower.mul_planes, mul_int=tower.mul):
    """The whole protocol on (C, B, 128) int32 batches (not modified).
    Returns (messages, finals): num_vars + 1 lists [sum, p0 .. pC] of
    integers, and the C evaluations left after the last fold.  ``mul``,
    ``mul_int``: the products of planes and of integers (a control passes
    others)."""
    C = columns.shape[0]
    num_points = C + 1
    S = columns.transpose(1, 2).contiguous()          # (C, 128, B)
    chal = Challenger(seed, index)
    consts = [tower.const_planes([p], S.device) for p in range(2, num_points)]
    messages = []
    n = 1 << num_vars
    r = 0
    while n >= 64:
        msg = _plane_message(S, n // 32, consts, mul)
        messages.append(msg)
        chal.observe(words_of(msg[0]), [words_of(v) for v in msg[1:]])
        ch = tower.const_planes([int_of(chal.challenge())], S.device)
        _plane_fold(S, n // 32, ch, mul)
        n //= 2
        r += 1
    E = [tower.ints_of_batch(S[c, :, 0])[:n] for c in range(C)]
    del S
    while True:
        msg = _int_message(E, num_points, mul_int)
        messages.append(msg)
        if r == num_vars:
            break
        chal.observe(words_of(msg[0]), [words_of(v) for v in msg[1:]])
        ch = int_of(chal.challenge())
        half = len(E[0]) // 2
        E = [[col[j] ^ mul_int(ch, col[j] ^ col[half + j])
              for j in range(half)] for col in E]
        r += 1
    return messages, [col[0] for col in E]
