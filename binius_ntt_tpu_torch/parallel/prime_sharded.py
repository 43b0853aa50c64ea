"""QM31 sumcheck prover with its rows sharded cyclically over a mesh.

Port of binius_ntt_tpu/parallel/prime_sharded.py, the prime-field
counterpart of parallel/sumcheck_sharded.py: shard d holds the rows r with
r mod D == d of both columns, as a (2, B/D, 4) int32 tensor of its own.  A
round is the port's ``cuda_prime_round.round_kernel`` on each shard's live
rows, then one ``m31_all_reduce`` of the (3, 4) canonical words; the fold
is ``cuda_prime_round.fold_kernel`` on every shard, in place.  Addition
mod P is associative and commutative, so the messages equal the
single-device prover's word for word.  When one row a shard is left, the
rows are gathered (row r = d) and the single-device
``PrimeFieldSumcheck`` runs the rest; ``state_dict`` keeps the global row
order.
"""

from __future__ import annotations

import numpy as np

from ..sumcheck import cuda_prime_round
from ..sumcheck.prime_field import PrimeFieldSumcheck, _as_state
from ..utils.bits import to_numpy
from .collectives import m31_all_reduce
from .mesh import cyclic_shards, gather_cyclic

__all__ = ["ShardedPrimeFieldSumcheck"]


class ShardedPrimeFieldSumcheck:
    """QM31 sumcheck prover over ``mesh`` (parallel/mesh.py), the state on
    ``mesh.device``; its messages equal ``PrimeFieldSumcheck``'s.

    evals: (2, 2^n, 4) QM31 columns, components canonical (numpy uint32 or
    an int32 tensor; copied).
    """

    def __init__(self, evals, mesh):
        self.mesh = mesh
        self.n_dev = mesh.size
        self.round = 0
        state = _as_state(evals, mesh.device)
        b = state.shape[1]
        if b < 2 * self.n_dev:
            raise ValueError(f"evals rows ({b}) must be a power of two with "
                             f">= 2 rows a shard ({self.n_dev} shards)")
        self._num_rows = b                 # live rows, all shards together
        self._shards = cyclic_shards(state, self.n_dev, mesh.shards)
        self._tail: PrimeFieldSumcheck | None = None

    @property
    def _rows(self) -> int:
        return self._num_rows // self.n_dev

    # ---- checkpoint / resume -------------------------------------------

    def state_dict(self) -> dict:
        d = {"round": self.round}
        if self._tail is not None:
            d["evals"] = None
            d["tail"] = self._tail.state_dict()
            return d
        d["evals"] = to_numpy(gather_cyclic(self.mesh, self._shards,
                                            self._rows))
        d["tail"] = None
        return d

    @classmethod
    def from_state_dict(cls, d: dict, mesh) -> "ShardedPrimeFieldSumcheck":
        """Resume on ``mesh`` (of any size) from a state_dict."""
        if d["evals"] is not None and d["evals"].shape[1] >= 2 * mesh.size:
            self = cls(d["evals"], mesh)
            self.round = int(d["round"])
            return self
        self = cls.__new__(cls)
        self.mesh = mesh
        self.n_dev = mesh.size
        self.round = int(d["round"])
        self._shards = {}
        if d["evals"] is not None:
            self._tail = PrimeFieldSumcheck(d["evals"], device=mesh.device)
            self._tail.round = self.round
        else:
            self._tail = PrimeFieldSumcheck.from_state_dict(
                d["tail"], device=mesh.device)
        self._num_rows = self._tail._num_rows
        return self

    def round_messages(self) -> np.ndarray:
        """Round polynomial at X = 0, 1, 2 as a (3, 4) uint32 array."""
        if self._tail is not None:
            return self._tail.round_messages()
        parts = {d: cuda_prime_round.round_kernel(x, self._rows)
                 for d, x in self._shards.items()}
        # m31_add keeps every component canonical, 0 never as P
        return to_numpy(m31_all_reduce(self.mesh, parts))

    def fold(self, challenge) -> None:
        """Fold every shard's columns at the challenge (4 canonical
        components)."""
        if self._tail is not None:
            self._tail.fold(challenge)
            self.round += 1
            return
        for x in self._shards.values():
            cuda_prime_round.fold_kernel(x, challenge, self._rows)
        self._num_rows //= 2
        self.round += 1
        if self._num_rows == self.n_dev:
            # one row a shard: global row r = d
            self._tail = PrimeFieldSumcheck(
                gather_cyclic(self.mesh, self._shards, 1))
            self._tail.round = self.round
            self._shards = {}
