"""GF(2^128) additive NTT cells: ``AdditiveNTT128`` of binius_ntt_tpu_torch.

Configuration keys: log_h, log_rate, columns (the columns of a batch the
card holds, with their codewords, while it commits them).  Traffic keys:
entry (``apply`` on compact element words, or ``apply_sliced`` on
bit-sliced batches), sample (outputs the check compares), warm_calls.

Inputs are made on the device from the seed.  The calls cycle through the
columns, and each column's newest codeword stays on the card until the
next call on that column replaces it, as a prover keeps its codewords
for the Merkle tree and the openings.  The check keeps ``sample``
outputs of the window drawn from the seed (reservoir sampling over its
calls) and compares every word of each with the plain reference
(reference/ntt128.py) once the window has closed.
"""

from __future__ import annotations

import random

import torch

from ..reference import ntt128, tower

RATE = ("ntt_gbfly_per_s", "Gbfly/s")
LATENCY = ("ntt_p95_ms", "ms")


def butterflies(config) -> int:
    """Butterflies of one transform: 2^(log_h+log_rate-1) a stage."""
    return (1 << (config["log_h"] + config["log_rate"] - 1)) * config["log_h"]


def rate(config, calls: int, window_s: float) -> float:
    return calls * butterflies(config) / window_s * 1e-9


def make_inputs(config, traffic, seed: int, device, rank: int = 0,
                world: int = 1) -> list[torch.Tensor]:
    n = 1 << config["log_h"]
    shape = (4 * n,) if traffic["entry"] == "apply" else (n // 32, 128)
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                          device=device, generator=gen)
            for _ in range(config["columns"])]


class Program:
    """The system under test: one transform a call; each column's newest
    codeword kept."""

    def __init__(self, config, traffic, device, seed: int):
        from binius_ntt_tpu_torch.ntt.additive_bitsliced import \
            AdditiveNTT128
        self.ntt = AdditiveNTT128(config["log_h"], config["log_rate"],
                                  device=device)
        self.entry = getattr(self.ntt, traffic["entry"])
        self.codewords = [None] * config["columns"]
        self.sample = traffic["sample"]

    def warm(self, inputs) -> None:
        """One call on every column, then as many outputs held at once
        as the check's sample keeps beside the codewords: the window finds
        every block it needs in the allocator's cache."""
        for k in range(len(inputs)):
            self.call(inputs, k)
        held = [self.entry(inputs[k % len(inputs)])
                for k in range(self.sample + 1)]
        del held

    def call(self, inputs, i: int):
        k = i % len(inputs)
        out = self.entry(inputs[k])
        self.codewords[k] = out
        return out

    def release(self) -> None:
        del self.ntt, self.entry, self.codewords


class Sampler:
    """``sample`` outputs of the window, uniform over its calls (reservoir
    sampling drawn from the seed), each with its column."""

    def __init__(self, traffic, seed: int):
        self.rng = random.Random(seed ^ 0x5A5A5A5A)
        self.size = traffic["sample"]
        self.seen = 0
        self.kept = []

    def offer(self, i: int, answer) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append((i, answer))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.size:
                self.kept[j] = (i, answer)

    def answers(self) -> dict:
        """{call: output}."""
        return dict(self.kept)


def _reference(config, traffic, x, rows, mul):
    log_h, log_rate = config["log_h"], config["log_rate"]
    if traffic["entry"] == "apply":
        return ntt128.ntt_words(x, log_h, log_rate, rows, mul)
    return ntt128.ntt_sliced(x, log_h, log_rate, rows, mul)


def control_answers(config, traffic, inputs, seed: int) -> dict:
    """The reference in the program's place with every product taken in
    GF(2^32) (both operands cut to their low 32 bits): one answer a
    column, as the calls 0 .. columns - 1 would give."""
    rows = ntt128.twiddle_rows(config["log_h"], config["log_rate"])
    return {k: _reference(config, traffic, x, rows, tower.mul_planes_gf32)
            for k, x in enumerate(inputs)}


def check(config, traffic, inputs, answers: dict, seed: int):
    """Every word of each kept output ({call: output}; call i transformed
    column i mod columns) against the reference's.  Returns (checks
    {name: (value, op, limit)}, compared, failed)."""
    rows = ntt128.twiddle_rows(config["log_h"], config["log_rate"])
    wrong, failed = 0, 0
    for i, out in sorted(answers.items()):
        want = _reference(config, traffic, inputs[i % len(inputs)], rows,
                          tower.mul_planes)
        got = out.reshape(want.shape) if out.numel() == want.numel() \
            else None
        bad = want.numel() if got is None else int((got != want).sum())
        del want
        wrong += bad
        failed += bad > 0
    checks = {"outputs_compared": (len(answers), ">=", 1),
              "wrong_words": (wrong, "<=", 0)}
    return checks, len(answers), failed
