"""GF(2^128) sumcheck cells: ``Sumcheck`` of binius_ntt_tpu_torch.

Configuration keys: num_vars, composition_size.  Traffic keys: entry
(``prove``: a whole protocol a call), sample (protocols the check runs
through the reference).

The C columns of 2^num_vars evaluations are made on the device from the
seed, bit-sliced ((C, B, 128) int32, ``data_is_transposed=True``).  A
call copies them into the buffer the prover folds in place, then runs
every round: ``round_messages``, a Fiat–Shamir challenge the benchmark
derives on the host from the seed, the protocol's index and the messages
so far (reference/sumcheck128.Challenger), ``move_to_next_round``; a last
``round_messages`` closes the protocol, and the prover's folded
evaluations are read back.  The index makes every protocol's challenges,
after the first round, its own.

The check compares, once the window has closed, every protocol's first
message with the reference's, and every message and the final
evaluations of ``sample`` protocols drawn from the seed.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from ..reference import sumcheck128, tower

RATE = ("sumcheck_proofs_per_s", "proofs/s")
LATENCY = ("sumcheck_p95_ms", "ms")


def rate(config, calls: int, window_s: float) -> float:
    return calls / window_s


def make_inputs(config, traffic, seed: int, device, rank: int = 0,
                world: int = 1) -> torch.Tensor:
    shape = (config["composition_size"], (1 << config["num_vars"]) // 32,
             128)
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                         device=device, generator=gen)


class Program:
    """The system under test: one whole protocol a call."""

    def __init__(self, config, traffic, device, seed: int):
        from binius_ntt_tpu_torch.sumcheck.prover import Sumcheck
        self.Sumcheck = Sumcheck
        self.num_vars = config["num_vars"]
        self.comp = config["composition_size"]
        self.seed = seed
        self.work = None

    def call(self, columns, i: int):
        if self.work is None:
            self.work = torch.empty_like(columns)
        self.work.copy_(columns)
        prover = self.Sumcheck(self.work, self.comp, self.num_vars,
                               data_is_transposed=True)
        chal = sumcheck128.Challenger(self.seed, i)
        messages = []
        for _ in range(self.num_vars):
            total, points = prover.round_messages()
            messages.append((total, points))
            chal.observe(total, points)
            prover.move_to_next_round(chal.challenge())
        messages.append(prover.round_messages())
        return messages, prover.state_dict()["host_evals"]

    def release(self) -> None:
        self.work = None


class Sampler:
    """Every protocol's transcript (a few hundred words) is kept."""

    def __init__(self, traffic, seed: int):
        self.kept = {}

    def offer(self, i: int, answer) -> None:
        self.kept[i] = answer

    def answers(self) -> dict:
        return self.kept


def _words(msg) -> np.ndarray:
    """[sum, p0 .. pC] integers -> (2 + C, 4) uint32 words."""
    return np.array([sumcheck128.words_of(v) for v in msg], dtype=np.uint32)


def _program_words(msg) -> np.ndarray:
    total, points = msg
    return np.concatenate([np.asarray(total, dtype=np.uint32)[None],
                           np.asarray(points, dtype=np.uint32)])


def _final_words(host_evals) -> np.ndarray:
    """The program's folded state, (C, 128) plane words -> the words of
    each column's evaluation in lane 0."""
    lane0 = np.asarray(host_evals, dtype=np.uint32) & 1
    vals = [sum(int(b) << i for i, b in enumerate(col)) for col in lane0]
    return _words(vals)


def _sample(answers: dict, traffic, seed: int) -> list[int]:
    rng = random.Random(seed ^ 0x5C5C5C5C)
    done = sorted(answers)
    return sorted(rng.sample(done, min(traffic["sample"], len(done))))


def control_answers(config, traffic, columns, seed: int,
                    indices=(0, 1)) -> dict:
    """The reference in the program's place with every product taken in
    GF(2^32): the transcripts of protocols ``indices``."""
    out = {}
    for i in indices:
        msgs, finals = sumcheck128.prove(
            columns, config["num_vars"], seed, i,
            mul=tower.mul_planes_gf32, mul_int=tower.mul_gf32)
        out[i] = ([(m[0], m[1:]) for m in map(_words, msgs)],
                  _planes_of_finals(finals))
    return out


def _planes_of_finals(finals) -> np.ndarray:
    """Final evaluations as the program's (C, 128) plane words, lane 0."""
    return np.array([[(v >> i) & 1 for i in range(tower.BITS)]
                     for v in finals], dtype=np.uint32)


def check(config, traffic, columns, answers: dict, seed: int):
    """Returns (checks {name: (value, op, limit)}, compared, failed)."""
    sample = _sample(answers, traffic, seed)
    wrong_first = 0
    first = None
    wrong, failed = 0, 0
    for i in sample:
        msgs, finals = sumcheck128.prove(columns, config["num_vars"], seed,
                                         i)
        want = [_words(m) for m in msgs]
        first = want[0]
        got_msgs, got_finals = answers[i]
        bad = sum(int((_program_words(g) != w).sum())
                  for g, w in zip(got_msgs, want))
        bad += 4 * abs(len(got_msgs) - len(want)) * (2 + columns.shape[0])
        bad += int((_final_words(got_finals) != _words(finals)).sum())
        wrong += bad
        failed += bad > 0
    if first is not None:
        for i, (got_msgs, _) in answers.items():
            if i not in sample:
                bad = int((_program_words(got_msgs[0]) != first).sum())
                wrong_first += bad
                failed += bad > 0
    checks = {"protocols_compared": (len(sample), ">=", 1),
              "wrong_words": (wrong, "<=", 0),
              "wrong_first_round_words": (wrong_first, "<=", 0)}
    return checks, len(answers), failed
