"""Additive (Gao–Mateer / LCH) NTT over GF(2^32) words, and its twiddles.

Port of binius_ntt_tpu/ntt/additive.py.  ``precompute_subspace_evals`` and
``stage_twiddles`` are the host-side twiddle rows (Python-int tower
arithmetic through the scalar oracle, run once per (log_h, log_rate) when
a transform is built; at log_h = 24 this takes seconds of host time, so
callers keep it out of timed windows).  ``AdditiveNTT`` is the transform
over compact words, one GF(2^(2^height)) element per uint32:

  * ``apply(x)`` takes 2^log_h IN_ORDER elements and returns the
    2^(log_h+log_rate) IN_ORDER evaluation: the input is replicated into
    2^log_rate coset rows, then stages run from log_h-1 down to 0 (DIT),
    butterfly u' = u + w*v, v' = u' + v;
  * the twiddle of a butterfly is the XOR of ``rows[s][k]`` over the set
    bits k of its indicator ``coset << (log_h-1-s) | block``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import tower_scalar as ts
from ..fields.tower_simd import mul_packed
from ..utils.bits import to_torch
from ..utils.capabilities import default_device
from . import cuda_fused32
from .nttdata import DataOrder, NTTData

__all__ = ["AdditiveNTT", "precompute_subspace_evals", "stage_twiddles"]


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


class AdditiveNTT(torch.nn.Module):
    """Additive NTT over GF(2^(2^height)) elements, one per word.

    Supports height <= 5 (uint32 storage, like the upstream
    ``FanPaarTowerField<5>`` instantiation).  The tables are buffers of
    this module, made on ``device`` (default ``cuda:0``; off the card pass
    ``device="cpu"``); every call runs on that device.

    Two paths, chosen by configuration as the reference chooses them:

      * fused (``height == 5 and log_h >= 7``, the default on any device):
        the compact words go to the packed bit-sliced layout
        (``cuda_fused32.bitslice_lane_groups``), through the chain of
        ``cuda_fused32.stage_group32`` groups, and back.  On a CUDA device
        each step launches its kernel; on the CPU it runs its plain torch
        version.  The reference takes this path only on a TPU; the bits
        are the same.
      * compact (``log_h < 7``, ``height < 5`` or ``use_fused=False``):
        one whole-tensor butterfly stage at a time on the compact words,
        multiplying through ``fields.tower_simd.mul_packed``, with one
        twiddle table per stage.  Nothing switches to it on an error.

    Left out: the reference's ``per_stage_jit`` and its transposed
    small-span stages, which work around XLA compile times.

    ``apply`` is the transform (it shadows ``nn.Module.apply``, which this
    module, having no submodules, does not need).
    """

    def __init__(self, log_h: int, log_rate: int = 0, height: int = 5,
                 use_fused: bool | None = None, device=None):
        super().__init__()
        if not log_h >= 1:
            raise ValueError("log_h must be >= 1")
        if not log_h + log_rate <= (1 << height):
            raise ValueError("log_h + log_rate must be <= field bits")
        if not 0 <= log_rate <= 4:
            raise ValueError("log_rate must be in [0, 4]")
        if height > 5:
            raise ValueError("compact layout supports height <= 5")
        self.log_h = log_h
        self.log_rate = log_rate
        self.height = height
        device = default_device(device)
        rows = precompute_subspace_evals(log_h, log_rate, height)
        # None: fused wherever the packed layout applies, on any device
        self.use_fused = (use_fused is not False and height == 5
                          and log_h >= 7)
        self._groups = []
        if self.use_fused:
            tables = cuda_fused32.build_tables32(rows, log_h, log_rate,
                                                 device)
            for g, (t0, k, low, tabs) in enumerate(tables):
                names = [name for name in tabs if name != "zero"]
                for name in names:
                    self.register_buffer(f"{name}{g}", tabs[name])
                self._groups.append((t0, k, low, names, tabs["zero"]))
            return
        for s in range(log_h):
            self.register_buffer(f"tw{s}", to_torch(
                stage_twiddles(rows[s], log_h + log_rate - 1 - s), device))

    @property
    def device(self) -> torch.device:
        return next(self.buffers()).device

    @property
    def tables(self):
        """The fused path's per-group tables in build_tables32() form."""
        return tuple(
            (t0, k, low, dict({name: getattr(self, f"{name}{g}")
                               for name in names}, zero=zero))
            for g, (t0, k, low, names, zero) in enumerate(self._groups))

    def apply(self, x):
        """x: (2^log_h,) words IN_ORDER (numpy uint32, or an int32 tensor
        on the module's device) -> int32 tensor of (2^(log_h+log_rate),)
        words IN_ORDER on the module's device.

        Accepts an NTTData wrapper: the transform requires IN_ORDER input,
        and a BIT_REVERSED wrapper raises."""
        if isinstance(x, NTTData):
            if x.order is not DataOrder.IN_ORDER:
                raise ValueError("AdditiveNTT.apply requires IN_ORDER input")
            return NTTData(self.apply(x.data), DataOrder.IN_ORDER)
        n = 1 << self.log_h
        if isinstance(x, torch.Tensor):
            if x.dtype != torch.int32 or x.device != self.device:
                raise ValueError(f"apply: expected int32 words on "
                                 f"{self.device}, got {x.dtype} on "
                                 f"{x.device}")
        else:
            x = to_torch(np.asarray(x, dtype=np.uint32), self.device)
        if tuple(x.shape) != (n,):
            raise ValueError(f"apply: input shape {tuple(x.shape)} != "
                             f"(2^log_h,) = ({n},)")
        if self.use_fused:
            packed = cuda_fused32.bitslice_lane_groups(
                x.reshape(n // cuda_fused32.W, cuda_fused32.W))
            out = cuda_fused32.apply_fused32(packed, self.tables,
                                             log_h=self.log_h,
                                             log_rate=self.log_rate)
            return cuda_fused32.bitslice_lane_groups(out).reshape(-1)
        twiddles = [getattr(self, f"tw{s}") for s in range(self.log_h)]
        return _additive_ntt_apply(x, twiddles, log_h=self.log_h,
                                   log_rate=self.log_rate,
                                   height=self.height)


def _stage_body(data, tw, *, s: int, log_h: int, log_rate: int,
                height: int):
    """One butterfly stage on (cosets, n) compact words."""
    n = 1 << log_h
    cosets = 1 << log_rate
    nblocks = n >> (s + 1)
    w = tw.view(cosets, nblocks)
    v4 = data.reshape(cosets, nblocks, 2, 1 << s)
    u, v = v4[:, :, 0, :], v4[:, :, 1, :]
    u2 = u ^ mul_packed(w[:, :, None], v, height)
    v2 = u2 ^ v
    return torch.stack([u2, v2], dim=2).reshape(cosets, n)


def _additive_ntt_apply(x, twiddles, *, log_h: int, log_rate: int,
                        height: int):
    """The compact path: replicate into the cosets (indicator = coset <<
    (log_h-1-s) | block, so each stage's table views as (cosets, nblocks)
    coset-major), then every stage."""
    n = 1 << log_h
    cosets = 1 << log_rate
    data = x[None, :].expand(cosets, n)
    for s in range(log_h - 1, -1, -1):
        data = _stage_body(data, twiddles[s], s=s, log_h=log_h,
                           log_rate=log_rate, height=height)
    return data.reshape(cosets * n)
