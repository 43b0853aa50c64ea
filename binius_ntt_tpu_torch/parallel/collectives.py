"""All-reduces for binary-field and M31 sums across the shards of a mesh.

Port of binius_ntt_tpu/parallel/collectives.py.  Neither NCCL nor gloo
reduces with XOR or with addition mod 2^31 - 1, so each all-reduce is one
all_gather of every shard's partial sums followed by a pairwise tree on
every shard: the same words on every shard, whatever the backend.  The
payloads are a round's few hundred bytes.
"""

from __future__ import annotations

import torch

from ..fields.m31 import m31_add

__all__ = ["xor_all_reduce", "m31_all_reduce"]


def _tree(parts: list, op) -> torch.Tensor:
    while len(parts) > 1:
        nxt = [op(parts[i], parts[i + 1])
               for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def xor_all_reduce(mesh, vals: dict) -> torch.Tensor:
    """XOR of every shard's tensor ({shard: tensor} for the shards this
    process owns); the result is the same on every shard."""
    return _tree(mesh.all_gather(vals), torch.bitwise_xor)


def m31_all_reduce(mesh, vals: dict) -> torch.Tensor:
    """Sum mod 2^31 - 1 of every shard's canonical int32 components; the
    result is canonical and the same on every shard."""
    return _tree(mesh.all_gather(vals), m31_add)
