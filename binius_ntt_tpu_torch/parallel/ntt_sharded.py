"""Compact GF(2^32) additive NTT with its element axis sharded over a mesh.

Port of binius_ntt_tpu/parallel/ntt_sharded.py.  Shard d holds columns
[d S, (d+1) S) of the (cosets, n) array, S = n / D, as a (C, S) int32
tensor of its own.  A stage s >= log2(S) pairs elements on shards d and
d ^ 2^(s - log2 S): the two exchange shards (``mesh.exchange``) and each
computes its half of the butterfly with one product, w * v, where the
whole shard lies in one butterfly block, so w is one value a coset.  The
stages below are shard-local, the single-device stage with the twiddle
table sliced at the shard's block offset.  Every product is the SWAR
multiply of ``fields/tower_simd.mul_packed``, as the reference's is
``mul_packed``; no kernel of the port is on this path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.tower_simd import mul_packed
from ..ntt.additive import precompute_subspace_evals, stage_twiddles
from ..utils.bits import to_torch

__all__ = ["ShardedAdditiveNTT"]


class ShardedAdditiveNTT:
    """Additive NTT over GF(2^(2^height)), one element a word, sharded over
    ``mesh`` (parallel/mesh.py); the tables live on ``mesh.device``."""

    def __init__(self, log_h: int, log_rate: int, mesh, height: int = 5):
        if not 0 <= log_rate <= 4 or height > 5:
            raise ValueError("log_rate must be in [0, 4] and height <= 5")
        self.log_h = log_h
        self.log_rate = log_rate
        self.height = height
        self.mesh = mesh
        self.log_d = mesh.size.bit_length() - 1
        if log_h <= self.log_d:
            raise ValueError("need at least 2 elements a shard")
        rows = precompute_subspace_evals(log_h, log_rate, height)
        self._twiddles = tuple(
            to_torch(stage_twiddles(rows[s], log_h + log_rate - 1 - s),
                     mesh.device) for s in range(log_h))

    def apply(self, x) -> torch.Tensor:
        """x: (2^log_h,) IN_ORDER words (numpy uint32 or an int32 tensor) ->
        the (2^(log_h+log_rate),) IN_ORDER evaluation as an int32 tensor,
        on every process (one all_gather under a process group)."""
        n, cosets = 1 << self.log_h, 1 << self.log_rate
        if isinstance(x, torch.Tensor):
            x = x.to(self.mesh.device)
        else:
            x = to_torch(np.asarray(x, dtype=np.uint32), self.mesh.device)
        if tuple(x.shape) != (n,):
            raise ValueError(f"apply: expected ({n},) words, got "
                             f"{tuple(x.shape)}")
        s_shard = n >> self.log_d
        data = {d: x[d * s_shard:(d + 1) * s_shard].repeat(cosets, 1)
                for d in self.mesh.shards}
        data = self.apply_shards(data)
        return torch.cat(self.mesh.all_gather(data), dim=1).reshape(-1)

    def apply_shards(self, data: dict) -> dict:
        """The transform on sharded data, {d: (C, S)} in and out."""
        log_h, h = self.log_h, self.height
        n, cosets = 1 << log_h, 1 << self.log_rate
        log_s = log_h - self.log_d
        s_shard = 1 << log_s
        dev = self.mesh.device
        coset_ids = torch.arange(cosets, device=dev)
        for s in range(log_h - 1, log_s - 1, -1):
            bit = s - log_s
            recvs = self.mesh.exchange({d: [t] for d, t in data.items()},
                                       1 << bit)
            new = {}
            for d in self.mesh.shards:
                ind = (coset_ids << (log_h - 1 - s)) | (d >> (bit + 1))
                w = self._twiddles[s][ind][:, None]             # (C, 1)
                (recv,) = recvs[d]
                if (d >> bit) & 1:     # the v side: v' = recv ^ w v ^ v
                    new[d] = recv ^ mul_packed(w, data[d], h) ^ data[d]
                else:                  # the u side: u' = u ^ w v
                    new[d] = data[d] ^ mul_packed(w, recv, h)
            data = new
        for s in range(log_s - 1, -1, -1):
            nb_local, nb_global = s_shard >> (s + 1), n >> (s + 1)
            for d in self.mesh.shards:
                w = self._twiddles[s].view(cosets, nb_global)[
                    :, d * nb_local:(d + 1) * nb_local]
                v4 = data[d].view(cosets, nb_local, 2, 1 << s)
                u, v = v4[:, :, 0], v4[:, :, 1]
                u2 = u ^ mul_packed(w[:, :, None], v, h)
                data[d] = torch.stack([u2, u2 ^ v], dim=2).reshape(
                    cosets, s_shard)
        return data
