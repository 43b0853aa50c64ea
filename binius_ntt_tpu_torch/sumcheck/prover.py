"""Sumcheck prover over GF(2^128), bit-sliced (torch).

Port of binius_ntt_tpu/sumcheck/prover.py::Sumcheck, with the same
protocol and API:

  * the state is C (composition_size) multilinear columns of 2^num_vars
    evaluations, bit-sliced in 32-element batches: a (C, B, 128) int32
    tensor on ``device`` (words with uint32 bits, utils/bits.py);
  * ``round_messages()`` returns (sum, points): sum = XOR over all rows of
    the composition product; points[p] = the same after folding every
    column at the interpolation point p;
  * ``move_to_next_round(challenge)`` folds every column in half:
    lower' = lower + challenge * (lower + upper).

Every round is one launch of ``cuda_round.round_kernel`` and one of
``cuda_round.fold_kernel``; on a CPU tensor those run their plain versions.
The kernels take any live row count, so unlike the reference's Pallas path
no round is sent elsewhere for being small.  The fold works in place at
the original stride, so the (C, B, 128) buffer keeps its size for the
whole protocol and the live rows are its first ``2^(num_vars - round) /
32``.

The last five rounds (32 evaluations or fewer, one batch per column) fold
lanes inside batch 0: the reference CUDA prover moves them to the host
(sumcheck.cuh:160-195, 283-297), and the JAX package shifts and XORs in
numpy but multiplies on the accelerator.  Here both kernels take these
in-word rounds (``lanes``), so the state never leaves its device; each
round reads back only its (1 + P, 128) batch sums.

Spans (utils/timing.py, when on; host clock): ``sumcheck.round_messages``,
in it the round kernel's launch (``sumcheck.round_launch``, in
cuda_round.py), ``sumcheck.readback`` (the copy of the batch sums to the
host, which waits for the kernels before it) and ``sumcheck.message_sum``
(their XOR on the host); ``sumcheck.fold_launch`` over
``move_to_next_round``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..layout.bitslicing import bitslice_transpose, bitslice_untranspose
from ..utils.bits import to_numpy, to_torch
from ..utils.capabilities import default_device
from ..utils.timing import span
from . import cuda_round

__all__ = ["Sumcheck"]

TOWER_HEIGHT = 7
BITS_WIDTH = 1 << TOWER_HEIGHT          # 128 bit-planes per batch
INTS_PER_VALUE = BITS_WIDTH // 32       # 4 words per value


def _compute_sum(batch: torch.Tensor) -> np.ndarray:
    """XOR the 32 values of each bit-sliced (..., 128) CPU batch into
    (..., 4) uint32 words (cf. compute_sum, sumcheck/core/core.cu:84-96).
    The kernels zero the dead lanes of an in-word round, so every round
    sums all 32."""
    with span("sumcheck.message_sum"):
        words = to_numpy(bitslice_untranspose(batch))
        values = words.reshape(words.shape[:-1] + (-1, INTS_PER_VALUE))
        return np.bitwise_xor.reduce(values, axis=-2)


def _as_words(a, device) -> torch.Tensor:
    """numpy uint32 or an int32 tensor -> a NEW int32 tensor on ``device``
    (the folds work in place, so never on the caller's memory).  For
    device=None a tensor keeps its own device and numpy words go to the
    default device (utils/capabilities.default_device)."""
    if isinstance(a, torch.Tensor):
        if a.dtype != torch.int32:
            raise ValueError(f"state words must be int32, got {a.dtype}")
        if device is None:
            device = a.device
    else:
        device = default_device(device)
        a = to_torch(np.asarray(a, dtype=np.uint32))
    return a.to(device, copy=True)


class Sumcheck:
    """Bit-sliced GF(2^128) sumcheck prover.

    Parameters
    ----------
    evals : flat words, INTS_PER_VALUE * 2^num_vars * composition_size of
        them (numpy uint32 or an int32 tensor): composition_size
        concatenated multilinear columns, each 2^num_vars evaluations in
        32-element batches, element-major little-endian unless
        ``data_is_transposed``.  Or a (C, B, 128) int32 tensor already
        bit-sliced (``data_is_transposed=True``), which the prover then
        owns and folds in place: the capacity entry, with no second copy
        of the state.
    data_is_transposed : the batches are already bit-sliced.
    device : where the state lives (default: the device of a tensor
        ``evals``; for numpy words ``cuda:0``, and off the card the caller
        passes ``device="cpu"``).
    """

    def __init__(self, evals, composition_size: int, num_vars: int,
                 data_is_transposed: bool = False, device=None):
        if num_vars < 6:
            raise ValueError("num_vars must be >= 6 (at least two batches)")
        if composition_size < 2:
            raise ValueError("composition_size must be >= 2")
        self.num_vars = num_vars
        self.composition_size = composition_size
        self.num_points = composition_size + 1
        self.round = 0

        b = (1 << num_vars) // 32
        shape = (composition_size, b, BITS_WIDTH)
        if isinstance(evals, torch.Tensor) and evals.dim() == 3:
            # device-resident, already bit-sliced columns
            if not data_is_transposed:
                raise ValueError(
                    "device-resident evals must be pre-bit-sliced "
                    "(data_is_transposed=True)")
            if tuple(evals.shape) != shape:
                raise ValueError(f"device evals shape {tuple(evals.shape)} "
                                 f"!= {shape}")
            if evals.dtype != torch.int32:
                # int32 words with uint32 bits are the port's storage; any
                # other type would pass the shape check and corrupt the math
                raise ValueError(f"device evals dtype {evals.dtype} != "
                                 f"torch.int32")
            if (device is not None
                    and torch.empty(0, device=device).device != evals.device):
                raise ValueError(f"device evals are on {evals.device}, not "
                                 f"{device}")
            arr = evals.contiguous()
        else:
            words = _as_words(evals, device)
            if words.numel() != INTS_PER_VALUE * (1 << num_vars) \
                    * composition_size:
                raise ValueError(
                    f"evals hold {words.numel()} words, expected "
                    f"{INTS_PER_VALUE} * 2^{num_vars} * {composition_size}")
            arr = words.reshape(shape)
            if not data_is_transposed:
                arr = bitslice_transpose(arr)
        self._evals = arr                   # (C, B, 128), folded in place

    # ---- checkpoint / resume -------------------------------------------
    # The complete protocol state is (round, folded evaluations).  The
    # dict has the reference's keys and numpy uint32 arrays, so a state
    # saved by either package loads in the other: the live rows as
    # "device_evals" while more than 32 evaluations remain, then batch 0 of
    # every column as "host_evals" (where the reference keeps its tail).

    def state_dict(self) -> dict:
        rows, _ = self._live()
        tail = self._num_evals <= 32
        return {
            "num_vars": self.num_vars,
            "composition_size": self.composition_size,
            "round": self.round,
            "device_evals": None if tail
            else to_numpy(self._evals[:, :rows, :]),
            "host_evals": to_numpy(self._evals[:, 0, :]) if tail else None,
        }

    @classmethod
    def from_state_dict(cls, d: dict, device=None) -> "Sumcheck":
        """Resume from a state_dict (numpy uint32 or int32 tensor arrays,
        copied) with the state on ``device`` (default: where tensor arrays
        are; ``cuda:0`` for numpy arrays)."""
        if d["device_evals"] is not None:
            state = _as_words(d["device_evals"], device)
        else:
            state = _as_words(d["host_evals"], device)[:, None, :]
        return cls._from_state(state, d["composition_size"], d["num_vars"],
                               d["round"])

    @classmethod
    def _from_state(cls, evals: torch.Tensor, composition_size: int,
                    num_vars: int, round_: int) -> "Sumcheck":
        """Resume from mid-protocol state (C, B', 128), its live rows
        first."""
        self = cls.__new__(cls)
        self.num_vars = num_vars
        self.composition_size = composition_size
        self.num_points = composition_size + 1
        self.round = round_
        self._evals = evals.contiguous()
        return self

    @property
    def _num_evals(self) -> int:
        return (1 << self.num_vars) >> self.round

    def _live(self) -> tuple[int, int]:
        """(rows, lanes) of the state: live batches, and at one batch its
        live lanes."""
        num = self._num_evals
        return max(num // 32, 1), min(num, 32)

    def round_messages(self):
        """Returns (sum, points): sum (4,) uint32 words; points (P, 4)."""
        with span("sumcheck.round_messages"):
            rows, lanes = self._live()
            parts = cuda_round.round_kernel(self._evals, rows,
                                            self.num_points, lanes)
            with span("sumcheck.readback"):
                parts = parts.cpu()
            sums = _compute_sum(parts)
            return sums[0], sums[1:]

    def move_to_next_round(self, challenge):
        """Fold every column at the challenge: 4 words (uint32 or int32)
        of a little-endian 128-bit value."""
        with span("sumcheck.fold_launch"):
            rows, lanes = self._live()
            cuda_round.fold_kernel(self._evals, cuda_round.challenge_words(
                challenge), rows, lanes)
            self.round += 1
