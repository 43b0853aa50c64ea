"""QM31 sumcheck round and challenge fold: CUDA kernels and plain versions.

Port of binius_ntt_tpu/sumcheck/pallas_prime_round.py (``round_kernel_impl``,
``fold_kernel_impl``), paired with it the way sumcheck/cuda_round.py pairs
with pallas_round.py.  The state is the reference's public AoS layout,
(2, B, 4) int32 words: two columns of B QM31 values, components canonical
mod P = 2^31 - 1.  Only the first ``rows`` rows are live in a round; lo is
row i < rows/2 and up is row i + rows/2.

  * ``round_kernel`` (csrc/prime_round.cu) returns the round polynomial at
    X = 0, 1, 2 as (3, 4) int32 words on the state's device: the sums over
    the live pairs of lo0*lo1, up0*up1 and t0*t1, t = (up - lo) + up.
  * ``fold_kernel`` (csrc/prime_fold.cu) folds the live rows in half at the
    challenge r, lo' = lo + (up - lo) * r, IN PLACE: the folded rows land
    at the front of each column and the stale rows behind them are never
    read again.

Both take any even ``rows`` from 2 to B, so one kernel serves every round.
``round_plain`` and ``fold_plain`` are the same functions in plain torch,
with the schoolbook QM31 product of fields/m31.py where the kernels use
Karatsuba.  Dispatch is by the tensor's device: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel or raises.  Nothing falls back.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..fields.m31 import P, m31_add, m31_sub, qm31_mul
from . import cuda_round

__all__ = ["challenge_words", "round_plain", "round_kernel", "fold_plain",
           "fold_kernel"]


def challenge_words(challenge) -> np.ndarray:
    """A QM31 challenge as (4,) uint32 canonical components.  Takes uint32
    or int32 words (an array, a list or a CPU tensor)."""
    words = cuda_round.challenge_words(challenge)
    if (words >= P).any():
        raise ValueError("challenge components must be canonical (< 2^31 "
                         "- 1)")
    return words


def _check_evals(name: str, evals: torch.Tensor, rows: int) -> None:
    if (evals.dtype != torch.int32 or evals.dim() != 3
            or evals.shape[0] != 2 or evals.shape[2] != 4):
        raise ValueError(f"{name}: evals must be (2, B, 4) int32, got "
                         f"{tuple(evals.shape)} {evals.dtype}")
    if not evals.is_contiguous():
        raise ValueError(f"{name}: evals must be contiguous")
    if not (2 <= rows <= evals.shape[1] and rows % 2 == 0):
        raise ValueError(f"{name}: rows={rows} must be even and in "
                         f"[2, {evals.shape[1]}]")


def _check_card(name: str, evals: torch.Tensor) -> None:
    if evals.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {evals.device}")
    if evals.data_ptr() % 16:
        raise ValueError(f"{name}: evals must be 16-byte aligned")


def round_plain(evals: torch.Tensor, rows: int) -> torch.Tensor:
    """Plain torch version of :func:`round_kernel`, on any device."""
    _check_evals("round_plain", evals, rows)
    half = rows // 2
    lo, up = evals[:, :half], evals[:, half:rows]
    t = m31_add(m31_sub(up, lo), up)
    products = (qm31_mul(lo[0], lo[1]), qm31_mul(up[0], up[1]),
                qm31_mul(t[0], t[1]))
    # at most 2^30 terms below 2^31: the int64 sums cannot overflow
    return torch.stack([p.to(torch.int64).sum(dim=0) % P
                        for p in products]).to(torch.int32)


def round_kernel(evals: torch.Tensor, rows: int) -> torch.Tensor:
    """One QM31 sumcheck round over the first ``rows`` rows of evals
    (2, B, 4): the round polynomial at X = 0, 1, 2 as (3, 4) int32 words,
    canonical, on the device of evals."""
    if evals.device.type == "cpu":
        return round_plain(evals, rows)
    _check_card("round_kernel", evals)
    _check_evals("round_kernel", evals, rows)
    acc = torch.zeros((3, 4), dtype=torch.int64, device=evals.device)
    lib = _build.library()
    with torch.cuda.device(evals.device):
        rc = lib.bntt_prime_round(evals.data_ptr(), acc.data_ptr(),
                                  evals.shape[1], rows,
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "prime_round")
    round_kernel.launches += 1
    return (acc % P).to(torch.int32)


round_kernel.launches = 0


def fold_plain(evals: torch.Tensor, challenge, rows: int) -> torch.Tensor:
    """Plain torch version of :func:`fold_kernel`, on any device.  Works in
    place like the kernel: evals is updated and returned."""
    _check_evals("fold_plain", evals, rows)
    r = torch.from_numpy(challenge_words(challenge).view(np.int32)).to(
        evals.device)
    half = rows // 2
    lo, up = evals[:, :half], evals[:, half:rows]
    lo.copy_(m31_add(lo, qm31_mul(m31_sub(up, lo), r)))
    return evals


def fold_kernel(evals: torch.Tensor, challenge, rows: int) -> torch.Tensor:
    """Fold the first ``rows`` rows of evals (2, B, 4) at the challenge (4
    canonical components), IN PLACE: rows [0, rows/2) of both columns
    become lo + (up - lo) * r.  Returns evals."""
    if evals.device.type == "cpu":
        return fold_plain(evals, challenge, rows)
    _check_card("fold_kernel", evals)
    _check_evals("fold_kernel", evals, rows)
    words = [int(w) for w in challenge_words(challenge)]
    lib = _build.library()
    with torch.cuda.device(evals.device):
        rc = lib.bntt_prime_fold(evals.data_ptr(), evals.shape[1], rows,
                                 *words,
                                 torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "prime_fold")
    fold_kernel.launches += 1
    return evals


fold_kernel.launches = 0
