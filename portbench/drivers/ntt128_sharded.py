"""GF(2^128) additive NTT sharded over the ranks of a process group:
``ShardedAdditiveNTT128.apply_shards`` of binius_ntt_tpu_torch on a
``DistMesh`` (NCCL on the cards), one shard a rank.

Configuration keys: log_h, log_rate, columns (distinct columns the calls
cycle through).  Traffic keys: warm_calls.

Rank d keeps its slice of each column resident: the batches [d sb,
(d + 1) sb), sb = 2^log_h / 32 / world, made on its card from the seed
(slice j of column k from a generator of its own, so any rank can make
any slice again).  A call makes the rank's fresh (2^log_rate, sb, 128)
shard from the slice as ``shard_input`` does (the slice repeated into the
cosets), and every rank runs ``apply_shards`` in step; the output stays
sharded.

The check keeps one output of the window (reservoir sampling over its
calls, drawn from the seed: the same call on every rank).  Each rank
makes the whole column again and compares every word of its output shard
with the plain reference's shard (reference/ntt128.ntt_shard_planes).
"""

from __future__ import annotations

import random

import torch

from ..reference import ntt128, tower
from .ntt128 import LATENCY, RATE, rate  # noqa: F401  (the cell's metrics)

W = tower.BITS


def _slice(config, seed: int, k: int, j: int, world: int, device):
    sb = (1 << config["log_h"]) // 32 // world
    gen = torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + k * 64 + j) % (1 << 63))
    return torch.randint(-2 ** 31, 2 ** 31, (sb, W), dtype=torch.int32,
                         device=device, generator=gen)


def make_inputs(config, traffic, seed: int, device, rank: int = 0,
                world: int = 1) -> list[torch.Tensor]:
    return [_slice(config, seed, k, rank, world, device)
            for k in range(config["columns"])]


class Program:
    """The system under test: this rank's part of one sharded transform
    a call."""

    def __init__(self, config, traffic, device, seed: int):
        from binius_ntt_tpu_torch.parallel.mesh import make_mesh
        from binius_ntt_tpu_torch.parallel.ntt128_sharded import \
            ShardedAdditiveNTT128
        self.mesh = make_mesh(device=device)
        self.ntt = ShardedAdditiveNTT128(config["log_h"], config["log_rate"],
                                         self.mesh)
        self.rank = self.mesh.shards[0]
        self.cosets = 1 << config["log_rate"]

    def call(self, inputs, i: int):
        x = inputs[i % len(inputs)]
        shard = x.repeat(self.cosets, 1).view(self.cosets, x.shape[0], W)
        return self.ntt.apply_shards({self.rank: shard})[self.rank]

    def release(self) -> None:
        del self.ntt, self.mesh


class Sampler:
    """One output of the window, uniform over its calls (reservoir
    sampling); the same draws on every rank."""

    def __init__(self, traffic, seed: int):
        self.rng = random.Random(seed ^ 0x4E544B34)
        self.seen = 0
        self.kept = {}

    def offer(self, i: int, answer) -> None:
        self.seen += 1
        if self.rng.random() * self.seen < 1:
            self.kept = {i: answer}

    def answers(self) -> dict:
        """{call: output}."""
        return self.kept


def _rank_world(rank, world):
    """The given shard, or this process's rank in its group."""
    import torch.distributed as dist
    if rank is not None:
        return rank, world
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _reference_shard(config, seed, k, rank, world, device, mul):
    log_h, log_rate = config["log_h"], config["log_rate"]
    full = torch.cat([_slice(config, seed, k, j, world, device)
                      for j in range(world)])
    planes = full.T.contiguous()
    del full
    out = ntt128.ntt_shard_planes(planes, log_h, log_rate, rank, world,
                                  mul=mul)
    return out.permute(1, 2, 0)         # (cosets, sb, 128)


def control_answers(config, traffic, inputs, seed: int, rank=None,
                    world=None) -> dict:
    """The reference in the program's place, every product cut to
    GF(2^32): this rank's shard of one column's transform (``rank`` and
    ``world`` name a shard outside a process group)."""
    rank, world = _rank_world(rank, world)
    k = random.Random(seed).randrange(config["columns"])
    return {k: _reference_shard(config, seed, k, rank, world,
                                inputs[0].device, tower.mul_planes_gf32)}


def check(config, traffic, inputs, answers: dict, seed: int, rank=None,
          world=None):
    """Every word of this rank's kept output shard ({call: output}; call
    i transformed column i mod columns) against the reference's.  Returns
    (checks {name: (value, op, limit)}, compared, failed)."""
    rank, world = _rank_world(rank, world)
    wrong, failed = 0, 0
    for i, out in answers.items():
        want = _reference_shard(config, seed, i % len(inputs), rank, world,
                                inputs[0].device, tower.mul_planes)
        bad = (want.numel() if out.shape != want.shape
               else int((out != want).sum()))
        del want
        wrong += bad
        failed += bad > 0
    checks = {"outputs_compared": (len(answers), ">=", 1),
              "wrong_words": (wrong, "<=", 0)}
    return checks, len(answers), failed
