"""Additive NTT over GF(2^128), bit-sliced, on one device (torch).

Port of binius_ntt_tpu/ntt/additive_bitsliced.py::AdditiveNTT128, fused
path: the host builds the twiddle rows (ntt/additive.py) and the per-group
parity-mask tables (ntt/cuda_fused.py) once, and each transform runs one
stage_group kernel per group.

  * an element batch is 32 GF(2^128) values as 128 bit-planes (bit j of
    plane i = bit i of element j) — shape (batches, 128), int32 words with
    uint32 bits (utils/bits.py);
  * stages descend log_h-1 .. 0 (DIT), butterfly u' = u + w*v, v' = u' + v;
  * the input is replicated into 2^log_rate coset rows, giving the
    rate-1/2^log_rate Reed–Solomon extension.

The per-stage path of the reference (``use_pallas``/``use_fused=False``)
and its host-side capacity gate are not ported yet, so the transform needs
log_h >= 6 (a bottom tile of at least two batches).
"""

from __future__ import annotations

import numpy as np
import torch

from ..layout.bitslicing import bitslice_transpose, bitslice_untranspose
from ..utils.bits import to_torch
from ..utils.capabilities import default_device
from . import cuda_fused
from .additive import precompute_subspace_evals
from .nttdata import DataOrder, NTTData

__all__ = ["AdditiveNTT128"]

HEIGHT = 7
W = 1 << HEIGHT            # 128 bit-planes
IPV = W // 32              # 4 words per compact value


class AdditiveNTT128(torch.nn.Module):
    """Additive NTT over GF(2^128), bit-sliced layout.

    The stage-group tables are buffers of this module, made on ``device``
    (default ``cuda:0``; off the card pass ``device="cpu"``); every call
    runs on that device.  On a CUDA device the groups run the CUDA kernel,
    on the CPU its plain torch version.

    ``apply`` is the transform (it shadows ``nn.Module.apply``, which this
    module, having no submodules, does not need).
    """

    def __init__(self, log_h: int, log_rate: int = 0, device=None):
        super().__init__()
        if not log_h >= 6:
            raise ValueError("log_h must be >= 6 (the fused path needs a "
                             "tile of two 32-element batches)")
        if not 0 <= log_rate <= 4:
            raise ValueError("log_rate must be in [0, 4]")
        self.log_h = log_h
        self.log_rate = log_rate
        device = default_device(device)
        rows = precompute_subspace_evals(log_h, log_rate, HEIGHT)
        self._groups = []
        tables = cuda_fused.build_tables(rows, log_h, log_rate, device)
        for g, (t0, k, low, mtile, minst, lanes, zero) in enumerate(tables):
            self.register_buffer(f"mtile{g}", mtile)
            self.register_buffer(f"minst{g}", minst)
            self.register_buffer(f"lanes{g}", lanes)
            self._groups.append((t0, k, low, zero))

    @property
    def device(self) -> torch.device:
        return self.mtile0.device

    @property
    def tables(self):
        """The per-group tables in cuda_fused.build_tables() form."""
        return tuple(
            (t0, k, low, getattr(self, f"mtile{g}"),
             getattr(self, f"minst{g}"), getattr(self, f"lanes{g}"), zero)
            for g, (t0, k, low, zero) in enumerate(self._groups))

    def apply_sliced(self, data: torch.Tensor) -> torch.Tensor:
        """data: (2^log_h/32, 128) int32 bit-sliced IN_ORDER input on the
        module's device.  Returns (2^(log_h+log_rate)/32, 128)."""
        nb = (1 << self.log_h) // 32
        if (data.dtype != torch.int32 or tuple(data.shape) != (nb, W)
                or data.device != self.device):
            raise ValueError(
                f"apply_sliced: expected ({nb}, {W}) int32 on "
                f"{self.device}, got {tuple(data.shape)} {data.dtype} on "
                f"{data.device}")
        return cuda_fused.apply_fused(data.contiguous(), self.tables,
                                      log_rate=self.log_rate)

    def apply(self, x_words):
        """Compact interface: (2^log_h * 4,) words, little-endian
        element-major (numpy uint32 or an int32 tensor) -> int32 tensor of
        (2^(log_h+log_rate) * 4,) words on the module's device.

        Accepts an NTTData wrapper (IN_ORDER required)."""
        if isinstance(x_words, NTTData):
            if x_words.order is not DataOrder.IN_ORDER:
                raise ValueError("AdditiveNTT128.apply requires IN_ORDER "
                                 "input")
            return NTTData(self.apply(x_words.data), DataOrder.IN_ORDER)
        n = 1 << self.log_h
        if isinstance(x_words, torch.Tensor):
            if x_words.dtype != torch.int32:
                raise ValueError(f"apply: expected int32 words, got "
                                 f"{x_words.dtype}")
            x = x_words.to(self.device)
        else:
            x = to_torch(np.asarray(x_words, dtype=np.uint32), self.device)
        if tuple(x.shape) != (n * IPV,):
            raise ValueError(
                f"apply: input shape {tuple(x.shape)} != (2^log_h * {IPV},) "
                f"= ({n * IPV},)")
        sliced = bitslice_transpose(x.reshape(n // 32, W))
        out = self.apply_sliced(sliced)
        return bitslice_untranspose(out).reshape(-1)
