"""Plain batched additive NTT over GF(2^128): a batch of independent
columns, each transformed alone by reference/ntt128.ntt_sliced, as
Binius's NTTShape log_z counts independent transforms.  Products are exact
GF(2^128) products of plain integer planes (reference/tower.py)."""

from __future__ import annotations

import torch

from . import ntt128, tower


def ntt_sliced_batch(data: torch.Tensor, log_h: int, log_rate: int,
                     rows=None, mul=tower.mul_planes) -> torch.Tensor:
    """data (B, nb, 128) batches of B columns -> (B, 2^log_rate nb, 128):
    column b is ntt128.ntt_sliced(data[b]).  ``mul``: the planes' product
    (a control passes another)."""
    if data.dim() != 3:
        raise ValueError(f"ntt_sliced_batch: expected (B, nb, 128), got "
                         f"{tuple(data.shape)}")
    if rows is None:
        rows = ntt128.twiddle_rows(log_h, log_rate)
    b, nb, width = data.shape
    out = torch.empty((b, nb << log_rate, width), dtype=data.dtype,
                      device=data.device)
    for i in range(b):
        out[i] = ntt128.ntt_sliced(data[i], log_h, log_rate, rows, mul)
    return out
