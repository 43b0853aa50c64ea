"""Bit-slicing layout transforms on int32 tensors.

Port of binius_ntt_tpu/layout/bitslicing.py (``transpose32``,
``bitslice_transpose``, ``bitslice_untranspose``,
``repeat_value_bitsliced``, and the streamed forms
``bitslice_transpose_streamed``, ``bitslice_untranspose_streamed`` and
``bitslice_transpose_streamed_cols``).  These are plain tensor ops in the
reference too (jnp, not Pallas), so they stay torch ops here and run on
whatever device the tensor lies on.

The whole-array transforms make several array-sized temporaries a level
of ``transpose32``.  The streamed forms move a host array to the device (or
back) in chunks of rows, transposing each on the device into a
preallocated result, so that the device holds the result plus one chunk
and its temporaries: every 32-element batch row transposes on its own.

Layout contract (little-endian, identical to the reference):
  * an *unbitsliced* batch is ``W`` words holding 32 field elements of
    ``W`` bits each, element-major: element ``j`` occupies words
    ``[j*IPV, (j+1)*IPV)``, ``IPV = W // 32``, word 0 least significant;
  * a *bitsliced* batch is the 32 x W bit-matrix transpose of that: bit
    ``j`` of sliced word ``i`` is bit ``i`` of element ``j``.

Words are int32 with uint32 bits (utils/bits.py); right shifts are logical.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.bits import lsr, to_torch
from ..utils.capabilities import default_device

__all__ = ["transpose32", "bitslice_transpose", "bitslice_untranspose",
           "bitslice_transpose_streamed", "bitslice_untranspose_streamed",
           "bitslice_transpose_streamed_cols", "repeat_value_bitsliced"]

CHUNK_ROWS = 1 << 18        # rows of a streamed chunk: 128 MiB at W = 128


def transpose32(a: torch.Tensor) -> torch.Tensor:
    """Transpose the 32x32 bit matrix held in the last axis (32 words).

    Vectorised Hacker's Delight transpose; accepts shape (..., 32).
    """
    if a.shape[-1] != 32:
        raise ValueError(f"transpose32 needs a last axis of 32, got "
                         f"{tuple(a.shape)}")
    lead = a.shape[:-1]
    m = 0x0000FFFF
    j = 16
    while j != 0:
        # rows with bit j of the index clear pair with rows where it is set
        a = a.reshape(lead + (32 // (2 * j), 2, j))
        lo = a[..., 0, :]
        hi = a[..., 1, :]
        t = (lsr(lo, j) ^ hi) & m
        lo = lo ^ (t << j)
        hi = hi ^ t
        a = torch.stack([lo, hi], dim=-2).reshape(lead + (32,))
        j >>= 1
        m = (m ^ (m << j)) & 0xFFFFFFFF if j else m
    return a


def bitslice_transpose(arr: torch.Tensor) -> torch.Tensor:
    """Unbitsliced (..., W) -> bitsliced (..., W)."""
    w = arr.shape[-1]
    ipv = w // 32
    lead = arr.shape[:-1]
    # new[32*(i % ipv) + i // ipv] = old[i]
    a = arr.reshape(lead + (32, ipv)).transpose(-1, -2)
    return transpose32(a).reshape(lead + (w,))


def bitslice_untranspose(arr: torch.Tensor) -> torch.Tensor:
    """Bitsliced (..., W) -> unbitsliced (..., W)."""
    w = arr.shape[-1]
    ipv = w // 32
    lead = arr.shape[:-1]
    a = transpose32(arr.reshape(lead + (ipv, 32)))
    # new[ipv * (i % 32) + i // 32] = tmp[i]
    return a.transpose(-1, -2).reshape(lead + (w,))


def _pick_chunk(rows: int, chunk_rows: int) -> int:
    """The largest divisor of ``rows`` reached by halving
    min(chunk_rows, rows): the chunk of a streamed transform.

    Every buffer of the NTTs and the prover has a power-of-two row count,
    where this ends at a large chunk.  Another row count could end at a
    chunk of one row (a device round trip a row), so a chunk below half of
    ``chunk_rows`` for rows above it raises."""
    if rows < 1 or chunk_rows < 1:
        raise ValueError(f"streamed transform: rows={rows} and "
                         f"chunk_rows={chunk_rows} must be >= 1")
    chunk = min(chunk_rows, rows)
    while rows % chunk:
        chunk //= 2
    if rows > chunk_rows and chunk < chunk_rows // 2:
        raise ValueError(
            f"streamed transform: {rows} rows split by halving "
            f"chunk_rows={chunk_rows} only into chunks of {chunk} rows; "
            f"pass a row count with a divisor in [chunk_rows/2, chunk_rows] "
            f"(a power of two does)")
    return chunk


def _as_words(x) -> torch.Tensor:
    """numpy uint32 / int32 or an int32 tensor -> int32 tensor (a view where
    it can be one)."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int32:
            raise ValueError(f"expected int32 words, got {x.dtype}")
        return x
    return to_torch(np.asarray(x))


def _stream_rows(fn, src: torch.Tensor, out: torch.Tensor, chunk_rows: int,
                 on: torch.device) -> torch.Tensor:
    """out[i:i+c] = fn(src[i:i+c]), computed on device ``on``, for every
    chunk of the leading axis; returns out."""
    rows = src.shape[0]
    chunk = _pick_chunk(rows, chunk_rows)
    for i in range(0, rows, chunk):
        out[i:i + chunk].copy_(fn(src[i:i + chunk].to(on)))
    return out


def bitslice_transpose_streamed(x, chunk_rows: int = CHUNK_ROWS,
                                device=None) -> torch.Tensor:
    """Host (rows, W) unbitsliced words (numpy uint32 or a CPU int32
    tensor; a tensor on ``device`` is transposed there chunk by chunk) ->
    bit-sliced (rows, W) int32 tensor on ``device`` (default the card,
    utils/capabilities.default_device).

    The output is allocated once; each chunk of rows is uploaded,
    transposed on the device and copied into its rows, so the device peak
    is the output plus one chunk and its temporaries."""
    src = _as_words(x)
    out = torch.empty(tuple(src.shape), dtype=torch.int32,
                      device=default_device(device))
    return _stream_rows(bitslice_transpose, src, out, chunk_rows, out.device)


def bitslice_untranspose_streamed(dev: torch.Tensor,
                                  chunk_rows: int = CHUNK_ROWS) -> np.ndarray:
    """Device (rows, W) bit-sliced int32 tensor -> host (rows, W) numpy
    uint32, untransposed chunk by chunk on the device."""
    src = _as_words(dev)
    out = np.empty(tuple(src.shape), dtype=np.uint32)
    _stream_rows(bitslice_untranspose, src,
                 torch.from_numpy(out.view(np.int32)), chunk_rows, src.device)
    return out


def bitslice_transpose_streamed_cols(cols, chunk_rows: int = CHUNK_ROWS,
                                     device=None) -> torch.Tensor:
    """Host (C, rows, W) unbitsliced words -> bit-sliced (C, rows, W) int32
    tensor on ``device`` (default the card), column by column and chunk by
    chunk: the device peak is the output plus one chunk."""
    src = _as_words(cols)
    if src.dim() != 3:
        raise ValueError(f"bitslice_transpose_streamed_cols: expected "
                         f"(C, rows, W), got {tuple(src.shape)}")
    out = torch.empty(tuple(src.shape), dtype=torch.int32,
                      device=default_device(device))
    for c in range(src.shape[0]):
        _stream_rows(bitslice_transpose, src[c], out[c], chunk_rows,
                     out.device)
    return out


def repeat_value_bitsliced(value, bits_width: int,
                           device=None) -> torch.Tensor:
    """Broadcast one value (``bits_width // 32`` uint32 words) into a
    bit-sliced batch: a (bits_width,) int32 tensor on ``device`` whose
    plane i is all ones where bit i of the value is set."""
    value = np.asarray(value, dtype=np.uint32)
    ipv = bits_width // 32
    if value.shape != (ipv,):
        raise ValueError(f"repeat_value_bitsliced: expected {ipv} words, "
                         f"got shape {value.shape}")
    return bitslice_transpose(to_torch(np.tile(value, 32), device))
