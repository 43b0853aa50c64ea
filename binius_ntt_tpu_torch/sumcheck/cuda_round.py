"""Sumcheck round and challenge fold: CUDA kernels and plain versions.

Port of binius_ntt_tpu/sumcheck/pallas_round.py (``round_kernel``,
``fold_kernel_impl``), paired with it the way ntt/cuda_fused.py pairs with
pallas_fused.py.  The state is (C, B, 128) int32 bit-sliced batches, C
multilinear columns of B batches each; only its first ``rows`` batches are
live in a round.  In the last rounds (32 evaluations or fewer) ``rows`` is 1
and only the first ``lanes`` lanes of batch 0 are live: lane j pairs with
lane j + lanes/2, the upper operand being the batch shifted right by
lanes/2 (the reference's host ``_fold_small``).  Both kernels take these
in-word rounds, so the whole protocol stays on the state's device.

  * ``round_kernel`` (csrc/sumcheck_round.cu) computes one round's batch
    sums, (1 + P, 128): the total over both halves, then points 0 .. P-1.
    Points 0 and 1 are the composition products of the lower and upper
    halves themselves; a point p >= 2 folds every column at p first, which
    is a 4x4 GF(2) matrix on each 4-plane chunk (``_fold_matrix``).  In an
    in-word round the products keep only their live lanes (the total
    ``lanes``, the points ``lanes/2``), so the 32 lanes of every output
    batch sum to the round's message in both modes.
  * ``fold_kernel`` (csrc/sumcheck_fold.cu) folds the live rows in half at
    the challenge r, lo' = lo ^ r * (lo ^ up), IN PLACE: the folded rows
    land at the front of each column and the stale rows behind them are
    never read again.

``round_plain`` and ``fold_plain`` are the same functions in plain torch
(the reference's ``_round_kernel_tiled`` and challenge fold, restricted to
the live rows): the plain round folds at p with a subfield multiply, not
with the kernel's matrices, so the two are independent formulations.
Dispatch is by the tensor's device: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel or raises.  Nothing falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..fields import bitsliced
from ..fields import tower_scalar as ts
from ..layout.bitslicing import repeat_value_bitsliced
from ..utils.bits import lsr
from ..utils.timing import span

__all__ = ["HEIGHT", "W", "MAX_COMPOSITION", "challenge_words",
           "round_plain", "round_kernel", "fold_plain", "fold_kernel"]

HEIGHT = 7
W = 1 << HEIGHT
# the round kernel's fold matrices (points 0 .. C) and its block's (C + 2)
# sums are sized for C <= MAX_COMPOSITION
MAX_COMPOSITION = 8


def _fold_matrix(p: int) -> tuple:
    """4x4 GF(2) matrix of mul-by-p in the height-2 subfield.

    rows[j] = tuple of k with bit j of (p * 2^k) set.
    """
    cols = [ts.multiply(p, 1 << k, 2) for k in range(4)]
    return tuple(
        tuple(k for k in range(4) if (cols[k] >> j) & 1) for j in range(4))


def _matrix_mask(p: int) -> int:
    """The matrix of point p as the kernel reads it: bits 4j .. 4j+3 of
    the word are row j (bit k set: k in row j)."""
    return sum(1 << (4 * j + k) for j, row in enumerate(_fold_matrix(p))
               for k in row)


def _fold_masks(num_points: int) -> list[int]:
    """The matrices of points 2 .. num_points-1, the host's words for the
    kernel (which holds those of points 0 and 1, zero and the identity)."""
    return [_matrix_mask(p) for p in range(2, num_points)]


def challenge_words(challenge) -> np.ndarray:
    """A 128-bit challenge as (4,) uint32 words, little-endian.  Takes
    uint32 or int32 words (an array, a list or a CPU tensor)."""
    if isinstance(challenge, torch.Tensor):
        if challenge.device.type != "cpu":
            raise ValueError(f"challenge must be host words, got a tensor "
                             f"on {challenge.device}")
        challenge = challenge.numpy()
    words = np.asarray(challenge, dtype=np.int64).reshape(-1)
    if words.shape != (4,):
        raise ValueError(f"challenge must be 4 words, got {words.shape}")
    return (words & 0xFFFFFFFF).astype(np.uint32)


def _check_evals(name: str, evals: torch.Tensor, rows: int, lanes: int,
                 min_lanes: int) -> int:
    """Validate the state and the live rows and lanes; return C."""
    if evals.dtype != torch.int32 or evals.dim() != 3 or evals.shape[2] != W:
        raise ValueError(f"{name}: evals must be (C, B, {W}) int32, got "
                         f"{tuple(evals.shape)} {evals.dtype}")
    if not evals.is_contiguous():
        raise ValueError(f"{name}: evals must be contiguous")
    if not (rows == 1 or (2 <= rows <= evals.shape[1] and rows % 2 == 0)):
        raise ValueError(f"{name}: rows={rows} must be 1 or even and in "
                         f"[2, {evals.shape[1]}]")
    allowed = ([1 << k for k in range(6) if 1 << k >= min_lanes]
               if rows == 1 else [32])
    if lanes not in allowed:
        raise ValueError(f"{name}: lanes={lanes} at rows={rows} must be one "
                         f"of {allowed}")
    return evals.shape[0]


def _halves(evals: torch.Tensor, rows: int, lanes: int):
    """The lower and upper operands of a round or fold: rows [0, rows/2)
    and [rows/2, rows), or in-word, batch 0 and batch 0 shifted right by
    lanes/2."""
    if rows == 1:
        lower = evals[:, :1]
        return lower, lsr(lower, lanes // 2)
    half = rows // 2
    return evals[:, :half], evals[:, half:rows]


def _lane_mask(n: int) -> int:
    """int32 word with the low n lanes (bits) set."""
    return -1 if n == 32 else (1 << n) - 1


def _check_card(name: str, evals: torch.Tensor) -> None:
    if evals.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {evals.device}")
    if evals.data_ptr() % 16:
        raise ValueError(f"{name}: evals must be 16-byte aligned")


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR over the leading axis (pairwise tree)."""
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        y = x[:h] ^ x[h:2 * h]
        if x.shape[0] % 2:
            y[0] ^= x[2 * h]
        x = y
    return x[0]


def _composition(cols: torch.Tensor) -> torch.Tensor:
    """Product of the column batches: (C, ..., 128) -> (..., 128)."""
    prod = cols[0]
    for c in range(1, cols.shape[0]):
        prod = bitsliced.multiply(prod, cols[c], HEIGHT)
    return prod


def round_plain(evals: torch.Tensor, rows: int, num_points: int,
                lanes: int = 32) -> torch.Tensor:
    """Plain torch version of :func:`round_kernel`, on any device."""
    _check_evals("round_plain", evals, rows, lanes, 1)
    if num_points < 2:
        raise ValueError(f"round_plain: num_points={num_points} < 2")
    lower, upper = _halves(evals, rows, lanes)
    comp_lo, comp_up = _composition(lower), _composition(upper)
    if rows == 1:
        keep = _lane_mask(lanes // 2)
        total = comp_lo & _lane_mask(lanes)
        comp_lo, comp_up = comp_lo & keep, comp_up & keep
    else:
        keep, total = -1, comp_lo ^ comp_up
    out = [_xor_reduce(total), _xor_reduce(comp_lo), _xor_reduce(comp_up)]
    xh = lower ^ upper
    for p in range(2, num_points):
        # p lives in the height-2 subfield: its batch has 4 live planes
        coeff = repeat_value_bitsliced([p, 0, 0, 0], W, evals.device)[:4]
        folded = lower ^ bitsliced.mul_subfield_chunks(xh, coeff, HEIGHT, 2)
        out.append(_xor_reduce(_composition(folded) & keep))
    return torch.stack(out)


def round_kernel(evals: torch.Tensor, rows: int, num_points: int,
                 lanes: int = 32) -> torch.Tensor:
    """One sumcheck round over the first ``rows`` rows of evals (C, B, 128),
    or at rows = 1 over the first ``lanes`` lanes of batch 0.

    Returns (1 + num_points, 128) int32 batch sums [total, p0, p1, ...] on
    the device of evals.  The kernel takes num_points = C + 1 (the degree
    of the protocol's round polynomial) and C <= MAX_COMPOSITION.  Each
    call is a ``sumcheck.round_launch`` span (utils/timing.py, host clock).
    """
    with span("sumcheck.round_launch"):
        if evals.device.type == "cpu":
            return round_plain(evals, rows, num_points, lanes)
        _check_card("round_kernel", evals)
        c = _check_evals("round_kernel", evals, rows, lanes, 1)
        if not 2 <= c <= MAX_COMPOSITION or num_points != c + 1:
            raise ValueError(f"round_kernel: takes 2 <= C <= "
                             f"{MAX_COMPOSITION} and num_points = C + 1, "
                             f"got C={c}, num_points={num_points}")
        masks = _fold_masks(num_points)
        masks_c = (ctypes.c_uint32 * len(masks))(*masks)
        out = torch.zeros((1 + num_points, W), dtype=torch.int32,
                          device=evals.device)
        lib = _build.library()
        with torch.cuda.device(evals.device):
            rc = lib.bntt_sumcheck_round(
                evals.data_ptr(), out.data_ptr(), c, evals.shape[1], rows,
                lanes, masks_c, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "sumcheck_round")
    round_kernel.launches += 1
    return out


round_kernel.launches = 0


def fold_plain(evals: torch.Tensor, challenge, rows: int,
               lanes: int = 32) -> torch.Tensor:
    """Plain torch version of :func:`fold_kernel`, on any device.  Works in
    place like the kernel: evals is updated and returned."""
    _check_evals("fold_plain", evals, rows, lanes, 2)
    coeff = repeat_value_bitsliced(challenge_words(challenge), W,
                                   evals.device)
    for col in evals:                 # one column at a time bounds the
        lo, up = _halves(col[None], rows, lanes)   # multiply's temporaries
        lo.copy_(lo ^ bitsliced.multiply(lo ^ up, coeff, HEIGHT))
    return evals


def fold_kernel(evals: torch.Tensor, challenge, rows: int,
                lanes: int = 32) -> torch.Tensor:
    """Fold the first ``rows`` rows of evals (C, B, 128) at the challenge
    (4 words), IN PLACE: rows [0, rows/2) of every column become
    lo ^ r * (lo ^ up); at rows = 1 every lane of batch 0 does, with up
    the batch shifted right by lanes/2.  Returns evals."""
    if evals.device.type == "cpu":
        return fold_plain(evals, challenge, rows, lanes)
    _check_card("fold_kernel", evals)
    c = _check_evals("fold_kernel", evals, rows, lanes, 2)
    words = [int(w) for w in challenge_words(challenge)]
    lib = _build.library()
    with torch.cuda.device(evals.device):
        rc = lib.bntt_sumcheck_fold(
            evals.data_ptr(), c, evals.shape[1], rows, lanes, *words,
            torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "sumcheck_fold")
    fold_kernel.launches += 1
    return evals


fold_kernel.launches = 0
