"""Standalone bit-sliced GF(2^128) multiply: CUDA kernel and plain version.

Port of binius_ntt_tpu/ntt/pallas_kernels.py::mul_tiles.  The kernel
(csrc/mul_tiles.cu) runs the per-thread straight-line circuit of
csrc/tower_mul.cuh, the device multiply that csrc/stage_group.cu inlines
too, so this entry point gives that circuit a test of its own.

Dispatch is by the tensor's device: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel or raises.  Nothing falls back.
"""

from __future__ import annotations

import torch

from .. import _build
from ..fields import bitsliced

__all__ = ["HEIGHT", "W", "mul_tiles", "mul_tiles_plain"]

HEIGHT = 7
W = 1 << HEIGHT


def mul_tiles_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain torch version: the stacked Karatsuba of fields/bitsliced.py."""
    return bitsliced.multiply(a, b, HEIGHT)


def _check_rows(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != W:
        raise ValueError(f"{name}: expected (N, {W}) int32, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def mul_tiles(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[n] = a[n] * b[n] for (N, 128) int32 bit-sliced rows."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mul_tiles_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"mul_tiles: unsupported device {a.device}")
    _check_rows("a", a, a.device)
    _check_rows("b", b, a.device)
    if a.shape != b.shape:
        raise ValueError(f"mul_tiles: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ")
    out = torch.empty_like(a)
    lib = _build.library()
    with torch.cuda.device(a.device):
        rc = lib.bntt_mul_tiles(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                a.shape[0],
                                torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "mul_tiles")
    mul_tiles.launches += 1
    return out


mul_tiles.launches = 0
