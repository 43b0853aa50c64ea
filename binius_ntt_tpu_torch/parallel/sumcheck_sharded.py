"""GF(2^128) sumcheck prover with its rows sharded cyclically over a mesh.

Port of binius_ntt_tpu/parallel/sumcheck_sharded.py.  Shard d holds the
global batch rows r with r mod D == d, as a (C, B/D, 128) int32 tensor of
its own, so that every fold's pairs (r, r + rows/2) lie on one shard until
one row a shard is left.  A round is the port's ``cuda_round.round_kernel``
on each shard's live rows, which gives the same [total, p0, p1, ...]
batch sums as the reference's local round, then one ``xor_all_reduce`` of
those (1 + P, 128) words: the only communication of a round.  The fold is
``cuda_round.fold_kernel`` on every shard, in place, with no
communication.

When one row a shard is left, the shards' rows are gathered (row r = d,
already in order) and the single-device ``Sumcheck`` runs the rest, as the
reference hands its tail to one device.  ``state_dict`` keeps the global
row order, so a run can resume on a mesh of another size.
"""

from __future__ import annotations

from ..layout.bitslicing import bitslice_transpose
from ..sumcheck import cuda_round
from ..sumcheck.prover import (BITS_WIDTH, INTS_PER_VALUE, Sumcheck,
                               _as_words, _compute_sum)
from ..utils.bits import to_numpy
from .collectives import xor_all_reduce
from .mesh import cyclic_shards, gather_cyclic

__all__ = ["ShardedSumcheck"]


class ShardedSumcheck:
    """Bit-sliced GF(2^128) sumcheck prover over ``mesh``
    (parallel/mesh.py): the same protocol and messages as
    ``sumcheck.prover.Sumcheck``, with the state on ``mesh.device``.

    evals: flat words as ``Sumcheck`` takes them (numpy uint32 or an int32
    tensor), bit-sliced already if ``data_is_transposed``.
    """

    def __init__(self, evals, composition_size: int, num_vars: int, mesh,
                 data_is_transposed: bool = False):
        self.mesh = mesh
        self.num_vars = num_vars
        self.composition_size = composition_size
        self.num_points = composition_size + 1
        self.round = 0
        self.n_dev = mesh.size
        b = (1 << num_vars) // 32
        if b % (2 * self.n_dev):
            raise ValueError(f"2^{num_vars} evaluations give {b} batch rows: "
                             f"need at least two a shard ({self.n_dev} "
                             f"shards)")
        words = _as_words(evals, mesh.device)
        if words.numel() != INTS_PER_VALUE * (1 << num_vars) \
                * composition_size:
            raise ValueError(f"evals hold {words.numel()} words, expected "
                             f"{INTS_PER_VALUE} * 2^{num_vars} * "
                             f"{composition_size}")
        arr = words.view(composition_size, b, BITS_WIDTH)
        if not data_is_transposed:
            arr = bitslice_transpose(arr)
        self._shards = cyclic_shards(arr, self.n_dev, mesh.shards)
        self._rows = b // self.n_dev          # live rows a shard
        self._tail: Sumcheck | None = None

    # ---- checkpoint / resume -------------------------------------------
    # The state is (round, folded evaluations) in the GLOBAL row order, as
    # numpy uint32 with the reference's keys, so that a run resumes on a
    # mesh of another size, or from the JAX package's dict
    # (convert.sharded_sumcheck_state_from_jax).

    def state_dict(self) -> dict:
        d = {"num_vars": self.num_vars,
             "composition_size": self.composition_size,
             "round": self.round}
        if self._tail is not None:
            d["evals"] = None
            d["tail"] = self._tail.state_dict()
            return d
        d["evals"] = to_numpy(gather_cyclic(self.mesh, self._shards,
                                            self._rows))
        d["tail"] = None
        return d

    @classmethod
    def from_state_dict(cls, d: dict, mesh) -> "ShardedSumcheck":
        """Resume on ``mesh`` (of any size) from a state_dict."""
        self = cls.__new__(cls)
        self.mesh = mesh
        self.num_vars = int(d["num_vars"])
        self.composition_size = int(d["composition_size"])
        self.num_points = self.composition_size + 1
        self.round = int(d["round"])
        self.n_dev = mesh.size
        self._shards, self._rows, self._tail = {}, 0, None
        if d["evals"] is None:
            self._tail = Sumcheck.from_state_dict(d["tail"],
                                                  device=mesh.device)
            return self
        glob = _as_words(d["evals"], mesh.device)
        b = glob.shape[1]
        if b < 2 * self.n_dev:
            # too few live rows for this mesh: the single-device tail
            self._tail = Sumcheck._from_state(
                glob, self.composition_size, self.num_vars, self.round)
            return self
        self._shards = cyclic_shards(glob, self.n_dev, mesh.shards)
        self._rows = b // self.n_dev
        return self

    def round_messages(self):
        """Returns (sum, points): sum (4,) uint32 words; points (P, 4)."""
        if self._tail is not None:
            return self._tail.round_messages()
        parts = {d: cuda_round.round_kernel(x, self._rows, self.num_points)
                 for d, x in self._shards.items()}
        sums = _compute_sum(xor_all_reduce(self.mesh, parts).cpu())
        return sums[0], sums[1:]

    def move_to_next_round(self, challenge):
        """Fold every shard's columns at the challenge (4 words)."""
        if self._tail is not None:
            self._tail.move_to_next_round(challenge)
            self.round += 1
            return
        for x in self._shards.values():
            cuda_round.fold_kernel(x, challenge, self._rows)
        self._rows //= 2
        self.round += 1
        if self._rows == 1:
            # one row a shard: global row r = d
            self._tail = Sumcheck._from_state(
                gather_cyclic(self.mesh, self._shards, 1),
                self.composition_size, self.num_vars, self.round)
            self._shards = {}
